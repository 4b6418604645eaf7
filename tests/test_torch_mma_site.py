"""The wide-head eval site (``fused_site_mma``, head widths 16 and 32) on
the CPU: its route (``site_kernels``) at every site of the flagship and the
pyramid and where it keeps the bias, its shared-memory fit and launch plan,
its wrapper's refusals, and its plain version. The CUDA kernel itself is
held to the plain versions on the card in test_torch_kernels.py."""

import collections

import pytest
import torch
from test_torch_wide_site import FLAGSHIP, PYRAMID, _site_calls

from bevrender_tpu_torch.ops import deform_attn as tda
from bevrender_tpu_torch.ops import kernels
from bevrender_tpu_torch.ops.kernels import fused_site_mma as mma
from bevrender_tpu_torch.ops.kernels._launch import (
    SMEM_PER_BLOCK,
    padded_width,
)

EVAL = tda.SiteOptions()
# (q shape, table shape, H) at the registration cell's call shapes (B=32)
FLAGSHIP_TSA_32 = ((32, 1, 2, 784, 32), (1, 2, 55, 55), 28)
FLAGSHIP_TSA_16 = ((32, 2, 2, 784, 16), (2, 2, 55, 55), 28)
FLAGSHIP_SCA_32 = ((32, 1, 2, 784, 32), (1, 2, 55, 279), 28)
FLAGSHIP_SCA_16 = ((32, 2, 2, 784, 16), (2, 2, 55, 279), 28)
PYRAMID_SCA_56 = ((2, 1, 2, 3136, 32), (1, 2, 111, 559), 56)
PYRAMID_SCA_7 = ((6, 8, 2, 49, 32), (8, 2, 13, 69), 7)
WIDE_HEAD_SITES = [FLAGSHIP_TSA_32, FLAGSHIP_TSA_16, FLAGSHIP_SCA_32,
                   FLAGSHIP_SCA_16, PYRAMID_SCA_56, PYRAMID_SCA_7]
# a head width 32 at BEV 64 with depth 5: a 127 x 639 table
OVERSIZED = ((1, 1, 2, 4096, 32), (1, 2, 127, 639), 64)


def _pass_launches(mc, B: int, options, training: bool) -> dict:
    counts = collections.Counter()
    for q, t, H, W, n in _site_calls(mc, B):
        for name in tda.site_kernels(q, t, H, W, options, training=training):
            counts[name] += n
    return dict(counts)


@pytest.mark.parametrize("site", WIDE_HEAD_SITES)
def test_wide_head_eval_sites_take_the_mma_site(site):
    """An eval site of head width 16 or 32 with no dropout takes the fused
    tensor-core site on "auto", at the flagship's TSA and SCA shapes and
    the pyramid's (its SCA at BEV 56, the largest table, and BEV 7, an odd
    side), whatever ``bias_forward`` and ``fused_bwd`` say."""
    q, t, H = site
    for bias_forward in tda.BIAS_FORWARDS:
        for fused_bwd in (False, True):
            opts = tda.SiteOptions(bias_forward=bias_forward,
                                   fused_bwd=fused_bwd)
            assert tda.site_kernels(q, t, H, H, opts, training=False) == (
                "fused_site_mma",)


@pytest.mark.parametrize("site", WIDE_HEAD_SITES)
def test_wide_head_sites_keep_the_bias_elsewhere(site):
    """Training passes (with or without ``fused_bwd``, whose site backward
    is built for head widths 4 and 8), attention dropout and the "wide"
    route keep the bias route at head widths 16 and 32."""
    q, t, H = site
    bias = ("lattice_bias" if tda.bias_route(t, H, H) == "whole"
            else "lattice_bias_wide")
    for fused_bwd in (False, True):
        opts = tda.SiteOptions(fused_bwd=fused_bwd)
        assert tda.site_kernels(q, t, H, H, opts, training=True) == (
            bias, bias, f"{bias}_bwd")
        none = tda.SiteOptions(fused_bwd=fused_bwd, site_remat="none")
        assert tda.site_kernels(q, t, H, H, none, training=True) == (
            bias, f"{bias}_bwd")
        assert tda.site_kernels(q, t, H, H, opts, training=False,
                                dropout=True) == (bias,)
    wide = tda.SiteOptions(lattice_route="wide")
    assert tda.site_kernels(q, t, H, H, wide, training=False) == (
        "lattice_bias_wide",)


def test_a_table_over_the_fit_keeps_the_bias():
    """Where one head's padded table and the kernel's key stages overflow a
    block, an eval site keeps the bias route (the wide bias here, as
    ``bias_route`` says)."""
    q, t, H = OVERSIZED
    assert not mma.fits(t[2], padded_width(t[3]), 32)
    assert tda.site_kernels(q, t, H, H, EVAL, training=False) == (
        "lattice_bias_wide",)


def test_shared_memory_fit_follows_the_layout():
    """Two stages of 64 keys (K and V rows of ch bf16, four words of
    geometry a key) and one head's padded table: the flagship's SCA at ch 32
    leaves room for three blocks an SM, the pyramid's SCA at BEV 56 fits a
    block, a table one row of 849 entries more than fits does not."""
    Xp = padded_width(279)
    assert mma.smem_bytes(55, Xp, 32) == 2 * (2 * 64 * 32 * 2 + 64 * 16) \
        + 63 * Xp * 2 == 72486
    assert mma.smem_bytes(55, Xp, 16) == 64294
    assert 3 * (72486 + 1024) <= 233472
    Xp56 = padded_width(559)
    assert mma.smem_bytes(111, Xp56, 32) == 220494 <= SMEM_PER_BLOCK
    assert mma.fits(111, Xp56, 32)
    # the tallest table of that pitch that fits, and one row more
    rows = (SMEM_PER_BLOCK - mma.smem_bytes(-8, Xp56, 32)) // (2 * Xp56)
    assert mma.fits(rows - 8, Xp56, 32)
    assert not mma.fits(rows - 8 + 1, Xp56, 32)


@pytest.mark.parametrize("heads,H,want", [(64, 28, 5), (128, 28, 7)])
def test_plan_spreads_the_warps(heads, H, want):
    """The warps a block at the registration cell's SCA calls on a 132-SM
    card (stage 0: 64 heads, stage 1: 128), and every plan's grid covers
    each head's query pairs with no block left without a query."""
    assert mma.plan(heads, H, H, 132) == want
    for q, t, Hs, _, _ in _site_calls(FLAGSHIP, 32) + _site_calls(PYRAMID, 2):
        warps = mma.plan(q[0] * q[1] * q[2], Hs, Hs, 132)
        assert 4 <= warps <= mma.MAX_WARPS
        tasks = -(-mma.pairs(Hs, Hs) // 8)
        blocks = -(-tasks // warps)
        assert blocks * warps * 8 >= mma.pairs(Hs, Hs) == (Hs + 1) // 2 * Hs
        assert (blocks - 1) * warps < tasks


def test_flagship_eval_pass_launches():
    """An eval pass of the flagship launches the new kernel once at each of
    its 32 wide-head sites (stages 0, 1, 5 and 6: 8 layers x (TSA + 3 SCA
    views)) and the bias kernel nowhere; the registration cell's request
    (T=4) runs four such passes. A training step's final pass keeps the
    bias kernels."""
    got = _pass_launches(FLAGSHIP, 32, EVAL, False)
    assert got == dict(fused_site=12, fused_site_mma=32)
    assert "lattice_bias" not in got
    train = _pass_launches(FLAGSHIP, 8, EVAL, True)
    assert train == dict(lattice_bias=2 * 44, lattice_bias_bwd=44)
    assert _pass_launches(PYRAMID, 2, EVAL, False) == dict(fused_site_mma=44)


def _site_inputs(B, G, Hpg, H, Wt, N, ch, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(G, Hpg, 2 * H - 1, Wt, generator=g) * 0.25,
            torch.rand(B, G, N, 2, generator=g) * 2.4 - 1.2,
            torch.randn(B, G, Hpg, H * H, ch, generator=g) * 0.5,
            torch.randn(B, G, Hpg, N, ch, generator=g) * 0.5,
            torch.randn(B, G, Hpg, N, ch, generator=g) * 0.5)


@pytest.mark.parametrize("ch,H", [(16, 6), (32, 5)])
def test_cpu_tensors_take_the_plain_version(ch, H):
    """``fused_site(..., kernel="fused_site_mma")`` and an eval site through
    ``streamed_deform_attention`` on CPU tensors are ``site_plain``, and
    count no launch."""
    table, k_pos, q, k, v = _site_inputs(2, 1, 2, H, 2 * H - 1, 9, ch)
    scale = ch ** -0.5
    before = kernels.counts()["fused_site_mma"]
    with torch.no_grad():
        ref = tda.site_plain(q, k, v, k_pos, table, H, H, scale)
        out = tda.fused_site(q, k, v, k_pos, table, H, H, scale,
                             kernel="fused_site_mma")
        site = tda.streamed_deform_attention(q, k, v, k_pos, table, H, H,
                                             scale=scale, fuse_site=True)
    assert torch.equal(out, ref) and torch.equal(site, ref)
    assert kernels.counts()["fused_site_mma"] == before


def _wrapper_args(ch=32, H=4, Wt=7, N=5, Hpg=2):
    table, k_pos, q, k, v = _site_inputs(1, 1, Hpg, H, Wt, N, ch)
    bf = torch.bfloat16
    return (tda._kernel_args(table, k_pos, H, H)
            + tuple(t.to(bf).contiguous() for t in (q, k, v)) + (H, H, 0.25))


def _misaligned(x):
    """``x`` as a contiguous tensor that starts 2 bytes past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype)
    start = next(i for i in range(8) if (buf.data_ptr() + 2 * i) % 16 == 2)
    out = buf[start:start + x.numel()].view(x.shape)
    out.copy_(x)
    return out


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """The wrapper launches or raises: CPU tensors, a head width other than
    16 or 32, q, k or v off a 16-byte boundary, and a table whose padded
    copy and key stages overflow a block."""
    before = kernels.counts()["fused_site_mma"]
    args = _wrapper_args()
    with pytest.raises(ValueError, match="CUDA"):
        mma.fused_site_mma_cuda(*args)
    for ch in (4, 8, 24, 64):
        with pytest.raises(ValueError, match="head widths"):
            mma.fused_site_mma_cuda(*_wrapper_args(ch=ch))
    for i in (8, 9, 10):  # q, k, v
        bad = list(args)
        bad[i] = _misaligned(args[i])
        assert bad[i].is_contiguous() and torch.equal(bad[i], args[i])
        with pytest.raises(ValueError, match="16-byte boundary"):
            mma.fused_site_mma_cuda(*bad)
    H, Wt = 64, 639  # the OVERSIZED table
    big = _wrapper_args(H=H, Wt=Wt, N=3, Hpg=1)
    with pytest.raises(ValueError, match="shared memory"):
        mma.fused_site_mma_cuda(*big)
    assert kernels.counts()["fused_site_mma"] == before
