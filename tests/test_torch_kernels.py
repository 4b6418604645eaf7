"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest sets up JAX). Tests marked ``cuda``
skip without a card; the rest run anywhere.
"""

import numpy as np
import pytest
import torch

from bevrender_tpu_torch.ops import deform_attn as tda
from bevrender_tpu_torch.ops import kernels
from bevrender_tpu_torch.ops.kernels import build


def _inputs(seed, B, G, Hpg, H, W, Wt, N, ch, device, table_std=0.01):
    rng = np.random.default_rng(seed)
    arrays = (
        rng.standard_normal((G, Hpg, 2 * H - 1, Wt)) * table_std,
        rng.uniform(-1.3, 1.3, (B, G, N, 2)),
        rng.standard_normal((B, G, Hpg, H * W, ch)) * 0.5,
        rng.standard_normal((B, G, Hpg, N, ch)) * 0.5,
        rng.standard_normal((B, G, Hpg, N, ch)) * 0.5,
    )
    return [torch.from_numpy(a).float().to(device) for a in arrays]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel tests run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("G,N,Wt", [(1, 1960, 279), (2, 49, 55), (1, 10, 15)])
def test_lattice_bias_kernel_matches_plain(cuda_device, G, N, Wt):
    """Equal bit for bit to the plain version on the bf16 table with
    float32 lerps (the same arithmetic, rounded once at the end) and to the
    two wide forwards on the same inputs; one launch."""
    H = W = 28 if Wt != 15 else 8
    table, k_pos, *_ = _inputs(1, 4, G, 2, H, W, Wt, N, 4, cuda_device)
    before = kernels.counts()["lattice_bias"]
    with torch.no_grad():
        out = tda.lattice_bias(table, k_pos, H, W)
        assert kernels.counts()["lattice_bias"] == before + 1
        ref = tda.lattice_bias_plain(table.bfloat16().float(), k_pos, H, W,
                                     torch.float32).bfloat16()
        args = tda._kernel_args(table, k_pos, H, W)[:7]
        fwd = kernels.lattice_bias
        wide = fwd.lattice_bias_wide_cuda(*args, H, W)
        pre = fwd.lattice_bias_wide_prefetch_cuda(*args, H, W)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert torch.equal(out, ref)
    assert torch.equal(out, wide) and torch.equal(out, pre)


@pytest.mark.cuda
@pytest.mark.parametrize("ch,N,Wt,table_std", [
    (4, 1960, 279, 0.01), (8, 196, 55, 0.01), (4, 10, 15, 0.01),
    (4, 1960, 279, 1.0), (8, 196, 55, 1.0)])
def test_fused_site_kernel_matches_plain(cuda_device, ch, N, Wt, table_std):
    """Against the plain version (p rounded after normalising) and against
    ``site_consumer_online`` (the kernel's own roundings). A table of std 1
    makes the bias outweigh q . k, so a wrong bias cannot pass."""
    H = W = 28 if Wt != 15 else 8
    table, k_pos, q, k, v = _inputs(2, 4, 4, 2, H, W, Wt, N, ch, cuda_device,
                                    table_std)
    scale = ch ** -0.5
    before = kernels.counts()["fused_site"]
    with torch.no_grad():
        out = tda.fused_site(q, k, v, k_pos, table, H, W, scale)
        bias = tda.lattice_bias_plain(table.bfloat16().float(), k_pos, H, W,
                                      torch.float32)
        ref = tda.site_consumer(q, k, v, bias, scale)
        online = tda.site_consumer_online(q, k, v, bias, scale)
        # p-weighted |v|: both versions round p to bf16 (the kernel before
        # normalising), each off by at most 2^-8 of it
        wabs = tda.site_consumer(q, k, v.abs(), bias, scale)
    torch.cuda.synchronize()
    assert bool(((out - ref).abs() <= 2.0 ** -7 * wabs + 1e-5).all())
    # same roundings: only the order of the float32 sums of l and O differs
    assert bool(((out - online).abs() <= 2.0 ** -15 * wabs + 1e-7).all())
    assert kernels.counts()["fused_site"] == before + 1


# fused_site_mma (head widths 16 and 32) against site_consumer_online, which
# rounds where the kernel rounds but sums q . k as an fmaf chain where the
# kernel's tensor cores sum in their own order: s moves by a few float32
# ulps of the products' sum, which now and then flips the bf16 rounding of
# one p by one bf16 ulp (2^-7 of p at most) and so moves the output by at
# most 2^-7 of that key's share of the p-weighted |v|. Every element is
# held to one such flip, and the share of elements beyond 2^-12 of the
# p-weighted |v|, which only flips reach, to MMA_FLIP_SHARE (chip_smoke's
# MMA_* constants).
MMA_ONLINE_TOL = 2.0 ** -7
MMA_FLIP_TOL = 2.0 ** -12
MMA_FLIP_SHARE = 1e-3
# (B, G, ch, N, Wt, H): the flagship's stage-0 and stage-1 SCA view calls and
# its two TSA calls at the registration cell's B=32, the pyramid's SCA at
# BEV 56 (its largest table) and at BEV 7 (an odd side: the last row's
# lower query masked)
MMA_SITES = [(32, 1, 32, 1960, 279, 28), (32, 2, 16, 1960, 279, 28),
             (32, 1, 32, 16, 55, 28), (32, 2, 16, 49, 55, 28),
             (2, 1, 32, 7840, 559, 56), (6, 8, 32, 140, 69, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("table_std", [0.01, 1.0])
@pytest.mark.parametrize("B,G,ch,N,Wt,H", MMA_SITES)
def test_mma_site_matches_plain_and_online(cuda_device, B, G, ch, N, Wt, H,
                                           table_std):
    """The eval site at a wide head takes ``fused_site_mma`` (one launch)
    and computes the plain version's site (p rounded before normalising,
    2^-7 of the p-weighted |v| as for the narrow fused site) and
    ``site_consumer_online``'s within the flips of its tensor-core sums."""
    table, k_pos, q, k, v = _inputs(40, B, G, 2, H, H, Wt, N, ch,
                                    cuda_device, table_std)
    scale = ch ** -0.5
    before = kernels.counts()["fused_site_mma"]
    with torch.no_grad():
        out = tda.streamed_deform_attention(q, k, v, k_pos, table, H, H,
                                            scale=scale, fuse_site=True)
        assert kernels.counts()["fused_site_mma"] == before + 1
        bias = tda.lattice_bias_plain(table.bfloat16().float(), k_pos, H, H,
                                      torch.float32)
        ref = tda.site_consumer(q, k, v, bias, scale)
        wabs = tda.site_consumer(q, k, v.abs(), bias, scale)
        d_plain = (out - ref).abs()
        d_online = (out - tda.site_consumer_online(q, k, v, bias,
                                                   scale)).abs()
    torch.cuda.synchronize()
    assert out.shape == (B, G, 2, H * H, ch)
    assert bool((d_plain <= 2.0 ** -7 * wabs + 1e-5).all())
    assert bool((d_online <= MMA_ONLINE_TOL * wabs + 1e-6).all())
    flips = float((d_online > MMA_FLIP_TOL * wabs + 1e-7).float().mean())
    assert flips <= MMA_FLIP_SHARE


@pytest.mark.cuda
def test_mma_site_over_its_fit_keeps_the_bias_route(cuda_device):
    """A head width 32 at BEV 64 with depth 5 (a 127 x 639 table) overflows
    the kernel's block: the wrapper refuses it, and the eval site takes the
    wide bias kernel with the plain consumer, which computes the same
    site."""
    H, Wt = 64, 639
    table, k_pos, q, k, v = _inputs(41, 1, 1, 1, H, H, Wt, 40, 32,
                                    cuda_device)
    scale = 32 ** -0.5
    kargs = _site_kargs(table, k_pos, q, k, v, H, H)
    before = kernels.counts()
    with pytest.raises(ValueError, match="shared memory"):
        kernels.fused_site_mma.fused_site_mma_cuda(*kargs, H, H, scale)
    with torch.no_grad():
        out = tda.streamed_deform_attention(q, k, v, k_pos, table, H, H,
                                            scale=scale, fuse_site=True)
        ref = tda.site_plain(q, k, v, k_pos, table.bfloat16().float(), H, H,
                             scale, torch.float32)
        wabs = tda.site_consumer(q, k, v.abs(), tda.lattice_bias_plain(
            table.bfloat16().float(), k_pos, H, H, torch.float32), scale)
    torch.cuda.synchronize()
    after = kernels.counts()
    assert after["fused_site_mma"] == before["fused_site_mma"]
    assert after["lattice_bias_wide"] == before["lattice_bias_wide"] + 1
    # both round the normalised p to bf16, from biases that differ by the
    # bias kernel's bf16 rounding of its output: where that flips a p's
    # rounding, one bf16 ulp of p (2^-7 of the p-weighted |v|), and the
    # scores' shift itself (under 2^-9 of a bias of |table| <= 0.05) far
    # below another 2^-7
    assert bool(((out - ref).abs() <= 2.0 ** -6 * wabs + 1e-5).all())


@pytest.mark.cuda
def test_mma_history_pass_replays_in_a_cuda_graph(cuda_device):
    """A streaming encoder pass (``encode_step``, the history pass) of a
    small model whose stage 0 has head width 16, captured in a CUDA graph:
    the capture launches ``fused_site_mma``, and a replay equals the eager
    pass bit for bit."""
    from bevrender_tpu_torch.config import Config, tiny_model_config
    from bevrender_tpu_torch.data.synthetic import SyntheticDataset
    from bevrender_tpu_torch.inference.register import RegistrationPipeline

    cfg = Config()
    cfg.model = tiny_model_config(embed_dims=(32, 32, 32), n_heads=(2, 8),
                                  n_groups=(1, 4))
    pipe = RegistrationPipeline(cfg, device="cuda", seed=0)
    batch = SyntheticDataset(n_items=2, num_views=2, window_num_imgs=1,
                             img_height=32, img_width=32,
                             map_tile=32).batch(2)
    frame = pipe._device(batch["camera"])[:, 0].contiguous()
    pose = pipe._device(batch["vehicle_pose"])[:, 0:2].contiguous()
    vtype = pipe._device(batch["vehicle_type"])
    net = pipe.net
    with torch.no_grad():
        eager = net.encode_step(frame, None, pose, vtype)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                net.encode_step(frame, None, pose, vtype)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = kernels.counts()["fused_site_mma"]
        with torch.cuda.graph(graph):
            out = net.encode_step(frame, None, pose, vtype)
        captured = kernels.counts()["fused_site_mma"] - before
        out.zero_()
        graph.replay()
    torch.cuda.synchronize()
    assert captured > 0
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_wrappers_refuse_bad_inputs(cuda_device):
    table, k_pos, q, k, v = _inputs(3, 2, 1, 2, 8, 8, 15, 10, 4, cuda_device)
    args = tda._kernel_args(table, k_pos, 8, 8)
    bad_table = args[0].float()
    with pytest.raises(TypeError, match="table"):
        kernels.lattice_bias.lattice_bias_cuda(bad_table, *args[1:], 8, 8)
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="head widths"):
        kernels.fused_site.fused_site_cuda(
            *args, q.repeat(1, 1, 1, 1, 4).to(bf), k.repeat(1, 1, 1, 1, 4).to(bf),
            v.repeat(1, 1, 1, 1, 4).to(bf), 8, 8, 0.25)
    with pytest.raises(NotImplementedError, match="forward-only"):
        tda.fused_site(q, k, v, k_pos, table.requires_grad_(), 8, 8, 0.5)


# Backward kernels against autograd through the plain versions fed as the
# kernels are (bf16-rounded table, float32 lerps). lattice_bias_bwd does the
# plain version's float32 arithmetic and differs only in the order of its
# float32 sums (atomics): 2e-5 of the largest entry.
BWD_SUM_TOL = 2e-5
# fused_site_bwd rounds p, ds and dO to bf16 before they multiply, autograd
# through site_plain rounds the normalised p and the cotangents of the bf16
# casts instead: 8e-3 of the largest entry, the bound the JAX package holds
# its own flash backward to.
SITE_BWD_TOL = 8e-3
# against site_bwd_online, which rounds where the kernel rounds: only the
# order of float32 sums and a rare flipped bf16 rounding of p or ds remain
SITE_BWD_ONLINE_TOL = 1e-4


def _close(a, b, rel):
    return float((a - b).abs().max()) <= rel * float(b.abs().max()) + 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("G,N,Wt,table_std", [
    (1, 1960, 279, 0.01), (2, 49, 55, 0.01), (1, 10, 15, 1.0),
    (4, 1960, 279, 1.0)])
def test_lattice_bias_bwd_kernel_matches_plain(cuda_device, G, N, Wt,
                                               table_std):
    H = W = 28 if Wt != 15 else 8
    table, k_pos, *_ = _inputs(7, 2, G, 2, H, W, Wt, N, 4, cuda_device,
                               table_std)
    gen = torch.Generator(device="cuda").manual_seed(8)
    gout = torch.randn(2, G, 2, N, H * W, generator=gen,
                       device="cuda").bfloat16()
    t1, p1 = table.clone().requires_grad_(), k_pos.clone().requires_grad_()
    before = kernels.counts()["lattice_bias_bwd"]
    dt, dp = torch.autograd.grad(tda.lattice_bias(t1, p1, H, W), (t1, p1), gout)
    t2 = table.bfloat16().float().requires_grad_()
    p2 = k_pos.clone().requires_grad_()
    ref = tda.lattice_bias_plain(t2, p2, H, W, torch.float32)
    rdt, rdp = torch.autograd.grad(ref, (t2, p2), gout.float())
    torch.cuda.synchronize()
    assert kernels.counts()["lattice_bias_bwd"] == before + 1
    assert dt.dtype == torch.float32 and dt.shape == table.shape
    assert float(rdt.abs().max()) > 0 and float(rdp.abs().max()) > 0
    assert _close(dt, rdt, BWD_SUM_TOL)
    assert _close(dp, rdp, BWD_SUM_TOL)


def _site_kargs(table, k_pos, q, k, v, H, W):
    bf = torch.bfloat16
    return tda._kernel_args(table, k_pos, H, W) + (
        q.to(bf).contiguous(), k.to(bf).contiguous(), v.to(bf).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("ch,N,Wt,table_std", [
    (4, 1960, 279, 0.01), (8, 196, 55, 1.0), (4, 10, 15, 1.0)])
def test_fused_site_lse_kernel(cuda_device, ch, N, Wt, table_std):
    """The instance with the logsumexp: its output equals the plain
    instance's bit for bit, and the logsumexp matches the plain version's
    (1e-5: float32 sums in another order) and the online mirror's."""
    H = W = 28 if Wt != 15 else 8
    table, k_pos, q, k, v = _inputs(9, 2, 4, 2, H, W, Wt, N, ch, cuda_device,
                                    table_std)
    scale = ch ** -0.5
    kargs = _site_kargs(table, k_pos, q, k, v, H, W)
    before = kernels.counts()
    with torch.no_grad():
        out, lse = kernels.fused_site.fused_site_lse_cuda(*kargs, H, W, scale)
        base = kernels.fused_site.fused_site_cuda(*kargs, H, W, scale)
        tb = table.bfloat16().float()
        _, ref_lse = tda.site_plain_lse(q, k, v, k_pos, tb, H, W, scale,
                                        torch.float32)
        bias = tda.lattice_bias_plain(tb, k_pos, H, W, torch.float32)
        _, on_lse = tda.site_consumer_online(q, k, v, bias, scale,
                                             return_lse=True)
    torch.cuda.synchronize()
    after = kernels.counts()
    assert after["fused_site_lse"] == before["fused_site_lse"] + 1
    assert after["fused_site"] == before["fused_site"] + 1
    assert torch.equal(out, base)
    assert float((lse - ref_lse).abs().max()) <= 1e-5
    assert float((lse - on_lse).abs().max()) <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("ch,N,H,Wt,table_std", [
    (4, 1960, 28, 279, 0.01), (8, 196, 28, 55, 0.01), (4, 300, 8, 15, 0.01),
    (8, 1960, 28, 279, 1.0), (4, 784, 28, 55, 1.0),
    # the kernel's tile edges: N below one warp's 16 keys, N one key past a
    # block of 256 or not a multiple of 16, H * W below or not a multiple of
    # a strip of 32 queries (and H not dividing a thread's 8 rows)
    (8, 10, 8, 15, 0.01), (4, 10, 8, 15, 1.0), (8, 257, 5, 9, 1.0),
    (4, 257, 5, 9, 0.01), (8, 37, 6, 11, 0.01), (4, 37, 6, 11, 1.0),
    (8, 300, 8, 15, 1.0),
    # tables so wide that the dq buffers of only 4 warps (ch 8, Wt 390) or of
    # one (ch 4, Wt 399) fit beside them: fewer warps, more key blocks
    (8, 300, 28, 390, 0.01), (4, 300, 28, 399, 1.0)])
def test_fused_site_bwd_kernel_matches_plain(cuda_device, ch, N, H, Wt,
                                             table_std):
    """Gradients of the fused training site through the kernels against
    autograd through ``site_plain`` and against ``site_bwd_online``."""
    W = H
    inputs = _inputs(10, 2, 4, 2, H, W, Wt, N, ch, cuda_device, table_std)
    table, k_pos, q, k, v = inputs
    scale = ch ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(11)
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    before = kernels.counts()
    a = [t.clone().requires_grad_() for t in (q, k, v, k_pos, table)]
    out = tda.fused_site_train(*a, H, W, scale)
    got = torch.autograd.grad(out, a, dout)
    after = kernels.counts()
    assert after["fused_site_lse"] == before["fused_site_lse"] + 1
    assert after["fused_site_bwd"] == before["fused_site_bwd"] + 1
    b = [t.clone().requires_grad_() for t in (q, k, v, k_pos)]
    tb = table.bfloat16().float().requires_grad_()
    ref_out = tda.site_plain(*b, tb, H, W, scale, torch.float32)
    ref = torch.autograd.grad(ref_out, b + [tb], dout)
    with torch.no_grad():
        _, lse = kernels.fused_site.fused_site_lse_cuda(
            *_site_kargs(table, k_pos, q, k, v, H, W), H, W, scale)
        dsum = (dout * out.detach()).sum(-1)
    online = tda.site_bwd_online(q, k, v, k_pos, table, H, W, scale, dout,
                                 lse, dsum)
    online = online[:3] + (online[4], online[3])  # (dq, dk, dv, dk_pos, dtable)
    torch.cuda.synchronize()
    for name, x, r, o in zip(("dq", "dk", "dv", "dk_pos", "dtable"), got, ref,
                             online):
        assert x.shape == r.shape and bool(torch.isfinite(x).all()), name
        assert float(r.abs().max()) > 0, name
        assert _close(x, r, SITE_BWD_TOL), name
        assert _close(x, o, SITE_BWD_ONLINE_TOL), name


def test_wrappers_refuse_unsupported_shapes():
    """Checked before anything touches the card: the fused site has
    instances for head widths 4 and 8 only; the bias kernels take any
    H * W (a scalar tail where it is not a multiple of 8) but only CUDA
    tensors, and a table of 2H - 1 rows."""
    table, k_pos, q, k, v = _inputs(5, 1, 1, 2, 7, 7, 15, 10, 3, "cpu")
    args = tda._kernel_args(table, k_pos, 7, 7)
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="head widths"):
        kernels.fused_site.fused_site_cuda(*args, q.to(bf), k.to(bf), v.to(bf),
                                           7, 7, 0.5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.lattice_bias.lattice_bias_cuda(*args, 7, 7)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.lattice_bias.lattice_bias_wide_cuda(*args[:7], 7, 7)


@pytest.mark.parametrize("which", ["wide", "wide_bwd"])
def test_wide_wrappers_refuse_bad_inputs(which):
    """CPU tensors, a float32 table, a table whose height is not 2H - 1,
    int64 window starts and a float32 cotangent are refused before anything
    touches the card."""
    table, k_pos, *_ = _inputs(15, 1, 1, 2, 7, 7, 15, 10, 4, "cpu")
    table_b, ys, ms, wy, f, u0, g, Xp = tda._kernel_args(table, k_pos, 7, 7)
    gout = torch.zeros(1, 1, 2, 10, 49, dtype=torch.bfloat16)
    if which == "wide":
        def call(*a, H=7):
            return kernels.lattice_bias.lattice_bias_wide_cuda(*a, H, 7)
    else:
        def call(*a, H=7):
            return kernels.lattice_bias_bwd.lattice_bias_wide_bwd_cuda(
                *a, Xp, gout, H, 7)
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(table_b, ys, ms, wy, f, u0, g)
    meta = torch.device("meta")
    m = [t.to(meta) for t in (table_b, ys, ms, wy, f, u0, g)]
    with pytest.raises(TypeError, match="table"):
        call(m[0].float(), *m[1:])
    with pytest.raises(ValueError, match="table"):
        call(*m, H=8)
    with pytest.raises(TypeError, match="ys"):
        call(m[0], m[1].long(), *m[2:])
    if which == "wide_bwd":
        gout = gout.to(meta).float()
        with pytest.raises(TypeError, match="gout"):
            call(*m)


# (table shape, H) of every pyramid site (BEV 56-28-14-7, 2 heads per group,
# depth 5) and of the flagship's, with the bias kernels it takes: only SCA
# at BEV 56 outgrows the whole-table kernels' shared memory
ROUTES = [
    ((1, 2, 111, 111), 56, "whole"), ((1, 2, 111, 559), 56, "wide"),
    ((2, 2, 55, 55), 28, "whole"), ((2, 2, 55, 279), 28, "whole"),
    ((4, 2, 27, 27), 14, "whole"), ((4, 2, 27, 139), 14, "whole"),
    ((8, 2, 13, 13), 7, "whole"), ((8, 2, 13, 69), 7, "whole"),
    ((1, 1, 111, 559), 56, "wide"), ((1, 2, 55, 279), 28, "whole"),
]


@pytest.mark.parametrize("shape,H,route", ROUTES)
def test_bias_route_is_a_function_of_the_shapes(shape, H, route):
    assert tda.bias_route(shape, H, H) == route


# The bias kernels at the pyramid's shapes (chip_smoke.py holds them at the
# full batch): (H, G, N, Wt, table std). SCA at BEV 56 takes the wide
# kernels; BEV 14 and 7 give M = 196 and 49, not multiples of 8.
PYRAMID_BIAS = [
    (56, 1, 600, 559, 0.01), (56, 1, 49, 111, 1.0), (28, 2, 1960, 279, 1.0),
    (14, 4, 490, 139, 0.01), (14, 4, 49, 27, 1.0), (7, 8, 140, 69, 0.01),
    (7, 8, 49, 13, 1.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("H,G,N,Wt,table_std", PYRAMID_BIAS)
def test_bias_kernels_at_pyramid_shapes(cuda_device, H, G, N, Wt, table_std):
    """Forward within one bf16 ulp of the plain version, backward within
    BWD_SUM_TOL of autograd through it, each on the kernel of its route."""
    table, k_pos, *_ = _inputs(16, 2, G, 2, H, H, Wt, N, 4, cuda_device,
                               table_std)
    wide = tda.bias_route(table.shape, H, H) == "wide"
    fwd, bwd = (("lattice_bias_wide", "lattice_bias_wide_bwd") if wide
                else ("lattice_bias", "lattice_bias_bwd"))
    gen = torch.Generator(device="cuda").manual_seed(17)
    gout = torch.randn(2, G, 2, N, H * H, generator=gen,
                       device="cuda").bfloat16()
    before = kernels.counts()
    t1, p1 = table.clone().requires_grad_(), k_pos.clone().requires_grad_()
    out = tda.lattice_bias(t1, p1, H, H)
    dt, dp = torch.autograd.grad(out, (t1, p1), gout)
    t2 = table.bfloat16().float().requires_grad_()
    p2 = k_pos.clone().requires_grad_()
    ref = tda.lattice_bias_plain(t2, p2, H, H, torch.float32)
    rdt, rdp = torch.autograd.grad(ref, (t2, p2), gout.float())
    torch.cuda.synchronize()
    after = kernels.counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {fwd: 1, bwd: 1}
    rb = ref.detach().bfloat16().float()
    assert bool(((out.float() - rb).abs() <= rb.abs() * 2.0 ** -7).all())
    assert float(rdt.abs().max()) > 0 and float(rdp.abs().max()) > 0
    assert _close(dt, rdt, BWD_SUM_TOL)
    assert _close(dp, rdp, BWD_SUM_TOL)


# The wide-table route: the fused site that reads its table through L1, its
# logsumexp instance and its prefetch variant at the flagship's site shapes
# (SCA 279 columns, TSA 55) and a small one, at two table scales.
WIDE_SITES = [
    (4, 1960, 279, 0.01), (8, 1960, 279, 1.0), (8, 196, 55, 0.01),
    (4, 784, 55, 1.0), (4, 10, 15, 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("ch,N,Wt,table_std", WIDE_SITES)
def test_wide_site_kernels_equal_fused_site(cuda_device, ch, N, Wt,
                                            table_std):
    """``fused_site_wide`` and its logsumexp instance equal ``fused_site``
    bit for bit (same tiles, order and roundings), the prefetch variant
    equals ``fused_site_wide`` bit for bit, and all stand within the fused
    site's tolerances of the plain version and of the online mirror."""
    H = W = 28 if Wt != 15 else 8
    table, k_pos, q, k, v = _inputs(18, 2, 4, 2, H, W, Wt, N, ch, cuda_device,
                                    table_std)
    scale = ch ** -0.5
    kargs = _site_kargs(table, k_pos, q, k, v, H, W)
    geo, qkv = kargs[:7], kargs[8:]
    wide = kernels.fused_site_wide
    before = kernels.counts()
    with torch.no_grad():
        whole = kernels.fused_site.fused_site_cuda(*kargs, H, W, scale)
        whole_o, whole_lse = kernels.fused_site.fused_site_lse_cuda(
            *kargs, H, W, scale)
        out = wide.fused_site_wide_cuda(*geo, *qkv, H, W, scale)
        out_o, out_lse = wide.fused_site_wide_lse_cuda(*geo, *qkv, H, W, scale)
        pre = wide.fused_site_wide_prefetch_cuda(*geo, *qkv, H, W, scale)
        bias = tda.lattice_bias_plain(table.bfloat16().float(), k_pos, H, W,
                                      torch.float32)
        ref = tda.site_consumer(q, k, v, bias, scale)
        online = tda.site_consumer_online(q, k, v, bias, scale)
        wabs = tda.site_consumer(q, k, v.abs(), bias, scale)
    torch.cuda.synchronize()
    after = kernels.counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} \
        == {"fused_site": 1, "fused_site_lse": 1, "fused_site_wide": 1,
            "fused_site_wide_lse": 1, "fused_site_wide_prefetch": 1}
    assert torch.equal(out, whole) and torch.equal(out_o, whole_o)
    assert torch.equal(out_lse, whole_lse)
    assert torch.equal(pre, out)
    assert bool(((out - ref).abs() <= 2.0 ** -7 * wabs + 1e-5).all())
    assert bool(((out - online).abs() <= 2.0 ** -15 * wabs + 1e-7).all())


@pytest.mark.cuda
def test_narrow_site_over_shared_memory_takes_the_wide_kernel(cuda_device):
    """A narrow-head site whose table (BEV 64, depth 5: 127 x 639) does not
    fit ``fused_site``'s shared memory runs through ``fused_site`` on the
    wide kernel, within the fused site's tolerances of the online mirror."""
    H = W = 64
    table, k_pos, q, k, v = _inputs(19, 1, 1, 2, H, W, 639, 300, 4,
                                    cuda_device, 1.0)
    assert tda.site_route(table.shape, H, W, 4) == "wide"
    before = kernels.counts()
    with torch.no_grad():
        out = tda.fused_site(q, k, v, k_pos, table, H, W, 0.5)
        bias = tda.lattice_bias_plain(table.bfloat16().float(), k_pos, H, W,
                                      torch.float32)
        online = tda.site_consumer_online(q, k, v, bias, 0.5)
        wabs = tda.site_consumer(q, k, v.abs(), bias, 0.5)
    torch.cuda.synchronize()
    after = kernels.counts()
    assert after["fused_site_wide"] == before["fused_site_wide"] + 1
    assert after["fused_site"] == before["fused_site"]
    assert bool(((out - online).abs() <= 2.0 ** -15 * wabs + 1e-7).all())


# The folded fused sites, whose block serves both heads of a (b, g) cell
# (Hpg = 2, W = 28 at the flagship; W = 8 at the small shape).
@pytest.mark.cuda
@pytest.mark.parametrize("ch,N,Wt,table_std", WIDE_SITES)
def test_fold_site_kernels_equal_their_siblings(cuda_device, ch, N, Wt,
                                                table_std):
    """``fused_site_fold_rows`` equals ``fused_site``,
    ``fused_site_fold_heads`` equals ``fused_site_wide_prefetch`` and its
    logsumexp instance equals ``fused_site_lse`` (output and logsumexp),
    bit for bit; the folded outputs stand within the fused site's tolerance
    of the plain version."""
    H = W = 28 if Wt != 15 else 8
    table, k_pos, q, k, v = _inputs(21, 2, 4, 2, H, W, Wt, N, ch, cuda_device,
                                    table_std)
    scale = ch ** -0.5
    kargs = _site_kargs(table, k_pos, q, k, v, H, W)
    geo, qkv = kargs[:7], kargs[8:]
    fold = kernels.fused_site_fold
    before = kernels.counts()
    with torch.no_grad():
        whole = kernels.fused_site.fused_site_cuda(*kargs, H, W, scale)
        whole_o, whole_lse = kernels.fused_site.fused_site_lse_cuda(
            *kargs, H, W, scale)
        pre = kernels.fused_site_wide.fused_site_wide_prefetch_cuda(
            *geo, *qkv, H, W, scale)
        rows = fold.fused_site_fold_rows_cuda(*kargs, H, W, scale)
        heads = fold.fused_site_fold_heads_cuda(*geo, *qkv, H, W, scale)
        heads_o, heads_lse = fold.fused_site_fold_heads_lse_cuda(
            *geo, *qkv, H, W, scale)
        bias = tda.lattice_bias_plain(table.bfloat16().float(), k_pos, H, W,
                                      torch.float32)
        ref = tda.site_consumer(q, k, v, bias, scale)
        wabs = tda.site_consumer(q, k, v.abs(), bias, scale)
    torch.cuda.synchronize()
    after = kernels.counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} \
        == {"fused_site": 1, "fused_site_lse": 1,
            "fused_site_wide_prefetch": 1, "fused_site_fold_rows": 1,
            "fused_site_fold_heads": 1, "fused_site_fold_heads_lse": 1}
    assert torch.equal(rows, whole)
    assert torch.equal(heads, pre)
    assert torch.equal(heads_o, whole_o) and torch.equal(heads_lse, whole_lse)
    for out in (rows, heads):
        assert bool(((out - ref).abs() <= 2.0 ** -7 * wabs + 1e-5).all())


# (Hpg, H = W, table width, N, ch, path): the head-folded kernels' two
# paths at ragged shapes. Two heads of BEV 60 at depth 5 (127 x 459 padded,
# 233 KB) overflow one block and take the ring, 3600 queries in strips of
# 128 (16 left over); BEV 10 leaves 12 of 112 queries idle in the whole-table
# strip; one head per group takes strips of 224; N is no multiple of 32.
FOLD_PATHS = [
    (2, 60, 299, 70, 4, "ring"), (2, 60, 299, 45, 8, "ring"),
    (2, 10, 39, 45, 8, "whole"), (2, 10, 39, 70, 4, "whole"),
    (1, 28, 279, 100, 8, "whole"), (2, 28, 279, 1959, 8, "whole")]


@pytest.mark.cuda
@pytest.mark.parametrize("Hpg,H,Wt,N,ch,path", FOLD_PATHS)
def test_fold_heads_paths_equal_their_siblings(cuda_device, Hpg, H, Wt, N,
                                               ch, path):
    """Both paths of ``fused_site_fold_heads`` equal
    ``fused_site_wide_prefetch`` bit for bit and its logsumexp instance
    equals ``fused_site_lse`` in output and logsumexp, at the path
    ``heads_plan`` names; within the fused site's tolerance of the plain
    version. At the flagship's SCA two blocks of the whole-table path fit
    an SM."""
    fold = kernels.fused_site_fold
    assert fold.heads_plan(Hpg, Wt, H, H, ch)[0] == path
    table, k_pos, q, k, v = _inputs(25, 2, 1, Hpg, H, H, Wt, N, ch,
                                    cuda_device, 1.0)
    scale = ch ** -0.5
    kargs = _site_kargs(table, k_pos, q, k, v, H, H)
    geo, qkv = kargs[:7], kargs[8:]
    before = kernels.counts()
    with torch.no_grad():
        pre = kernels.fused_site_wide.fused_site_wide_prefetch_cuda(
            *geo, *qkv, H, H, scale)
        whole_o, whole_lse = kernels.fused_site.fused_site_lse_cuda(
            *kargs, H, H, scale)
        heads = fold.fused_site_fold_heads_cuda(*geo, *qkv, H, H, scale)
        heads_o, heads_lse = fold.fused_site_fold_heads_lse_cuda(
            *geo, *qkv, H, H, scale)
        bias = tda.lattice_bias_plain(table.bfloat16().float(), k_pos, H, H,
                                      torch.float32)
        ref = tda.site_consumer(q, k, v, bias, scale)
        wabs = tda.site_consumer(q, k, v.abs(), bias, scale)
    torch.cuda.synchronize()
    after = kernels.counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} \
        == {"fused_site_lse": 1, "fused_site_wide_prefetch": 1,
            "fused_site_fold_heads": 1, "fused_site_fold_heads_lse": 1}
    assert torch.equal(heads, pre) and torch.equal(heads_o, whole_o)
    assert torch.equal(heads_lse, whole_lse)
    assert bool(((heads - ref).abs() <= 2.0 ** -7 * wabs + 1e-5).all())
    if (Hpg, H, Wt) == (2, 28, 279):
        assert fold.heads_blocks_per_sm(Hpg, Wt, H, H, ch) >= 2


# (Hpg, H, W, table width, N, ch, path): the window-prefetch site's two
# paths at ragged shapes. One head of BEV 64 at depth 5 (135 x 969 padded,
# 264,702 bytes with the key stages) overflows a block and takes the ring;
# the others take the whole-table path: one head per group at the
# flagship's SCA width (784 queries in 5 strips of 160, 16 idle), a
# non-square 12 x 20 (240 queries: 2 strips of 128, 16 idle), BEV 10 (100
# queries in one strip of 128), and N no multiple of 32 everywhere.
PREFETCH_PATHS = [
    (1, 28, 28, 279, 100, 8, "whole"), (2, 28, 28, 279, 1959, 4, "whole"),
    (2, 12, 20, 119, 70, 8, "whole"), (2, 10, 10, 39, 45, 4, "whole"),
    (2, 64, 64, 639, 300, 8, "ring"), (1, 64, 64, 639, 45, 4, "ring")]


@pytest.mark.cuda
@pytest.mark.parametrize("Hpg,H,W,Wt,N,ch,path", PREFETCH_PATHS)
def test_prefetch_paths_equal_fused_site_wide(cuda_device, Hpg, H, W, Wt, N,
                                              ch, path):
    """Both paths of ``fused_site_wide_prefetch`` equal ``fused_site_wide``
    bit for bit at the path ``prefetch_plan`` names, within the fused
    site's tolerance of the plain version. At the flagship's SCA width
    three or more whole-table blocks fit an SM (one ring block did)."""
    wide = kernels.fused_site_wide
    assert wide.prefetch_plan(2 * H - 1, Wt, H, W, ch, 2 * 2 * Hpg,
                              132)[0] == path
    table, k_pos, q, k, v = _inputs(27, 2, 2, Hpg, H, W, Wt, N, ch,
                                    cuda_device, 1.0)
    scale = ch ** -0.5
    kargs = _site_kargs(table, k_pos, q, k, v, H, W)
    geo, qkv = kargs[:7], kargs[8:]
    before = kernels.counts()
    with torch.no_grad():
        out = wide.fused_site_wide_cuda(*geo, *qkv, H, W, scale)
        pre = wide.fused_site_wide_prefetch_cuda(*geo, *qkv, H, W, scale)
        bias = tda.lattice_bias_plain(table.bfloat16().float(), k_pos, H, W,
                                      torch.float32)
        ref = tda.site_consumer(q, k, v, bias, scale)
        wabs = tda.site_consumer(q, k, v.abs(), bias, scale)
    torch.cuda.synchronize()
    after = kernels.counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} \
        == {"fused_site_wide": 1, "fused_site_wide_prefetch": 1}
    assert torch.equal(pre, out)
    assert bool(((pre - ref).abs() <= 2.0 ** -7 * wabs + 1e-5).all())
    if (H, Wt) == (28, 279):
        assert wide.prefetch_blocks_per_sm(2 * H - 1, Wt, H, W, ch,
                                           2 * 2 * Hpg, 132) >= 3


# (Hpg, H, W, table width, N, ch): the wide and row-folded sites, instances
# of csrc/site_whole.cuh, at the flagship's SCA (784 queries in 5 strips of
# 160) and TSA widths, a non-square 12 x 20, BEV 10 (one strip) and one head
# per group, N no multiple of 32 but at the TSA.
TEMPLATE_SITES = [
    (2, 28, 28, 279, 1959, 8), (2, 28, 28, 55, 196, 4),
    (2, 12, 20, 119, 70, 8), (2, 10, 10, 39, 45, 4),
    (1, 28, 28, 279, 100, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["whole", "raw"])
@pytest.mark.parametrize("Hpg,H,W,Wt,N,ch", TEMPLATE_SITES)
def test_template_site_paths_equal_fused_site(cuda_device, Hpg, H, W, Wt, N,
                                              ch, path):
    """``fused_site_wide`` on each table source, "whole" (the head's padded
    table staged, which ``wide_plan`` takes at all of these) and "raw" (the
    raw table through L1), equals ``fused_site`` bit for bit, and its
    logsumexp instance ``fused_site_lse`` in output and logsumexp;
    ``fused_site_fold_rows`` (its heads' tables staged) equals
    ``fused_site``; one launch each, within the fused site's tolerance of
    the plain version."""
    wide, fold = kernels.fused_site_wide, kernels.fused_site_fold
    assert wide.wide_plan(2 * H - 1, Wt, H, W, ch, 2 * 2 * Hpg,
                          132).path == "whole"
    table, k_pos, q, k, v = _inputs(28, 2, 2, Hpg, H, W, Wt, N, ch,
                                    cuda_device, 1.0)
    scale = ch ** -0.5
    kargs = _site_kargs(table, k_pos, q, k, v, H, W)
    geo, qkv = kargs[:7], kargs[8:]
    before = kernels.counts()
    with torch.no_grad():
        whole = kernels.fused_site.fused_site_cuda(*kargs, H, W, scale)
        whole_o, whole_lse = kernels.fused_site.fused_site_lse_cuda(
            *kargs, H, W, scale)
        out = wide.fused_site_wide_cuda(*geo, *qkv, H, W, scale, path=path)
        out_o, out_lse = wide.fused_site_wide_lse_cuda(*geo, *qkv, H, W,
                                                       scale, path=path)
        rows = fold.fused_site_fold_rows_cuda(*kargs, H, W, scale)
        bias = tda.lattice_bias_plain(table.bfloat16().float(), k_pos, H, W,
                                      torch.float32)
        ref = tda.site_consumer(q, k, v, bias, scale)
        wabs = tda.site_consumer(q, k, v.abs(), bias, scale)
    torch.cuda.synchronize()
    after = kernels.counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} \
        == {"fused_site": 1, "fused_site_lse": 1, "fused_site_wide": 1,
            "fused_site_wide_lse": 1, "fused_site_fold_rows": 1}
    assert torch.equal(out, whole) and torch.equal(rows, whole)
    assert torch.equal(out_o, whole_o) and torch.equal(out_lse, whole_lse)
    assert bool(((out - ref).abs() <= 2.0 ** -7 * wabs + 1e-5).all())


@pytest.mark.cuda
@pytest.mark.parametrize("ch", [4, 8])
def test_wide_raw_path_takes_an_oversized_table(cuda_device, ch):
    """Where one head's padded table overflows a block (BEV 64 at depth 5:
    135 x 969, 264,702 bytes with the key stages) ``fused_site_wide`` and
    its logsumexp instance take path "raw" by the shapes alone, and stand
    within the fused site's tolerances of the plain version (output) and
    of ``site_plain_lse`` (logsumexp)."""
    H = W = 64
    wide = kernels.fused_site_wide
    plan = wide.wide_plan(2 * H - 1, 639, H, W, ch, 2 * 2, 132)
    assert plan.path == "raw" and plan.smem < 4096
    table, k_pos, q, k, v = _inputs(29, 1, 2, 2, H, W, 639, 300, ch,
                                    cuda_device, 1.0)
    scale = ch ** -0.5
    kargs = _site_kargs(table, k_pos, q, k, v, H, W)
    geo, qkv = kargs[:7], kargs[8:]
    with torch.no_grad():
        out = wide.fused_site_wide_cuda(*geo, *qkv, H, W, scale)
        out_o, out_lse = wide.fused_site_wide_lse_cuda(*geo, *qkv, H, W,
                                                       scale)
        tb = table.bfloat16().float()
        _, ref_lse = tda.site_plain_lse(q, k, v, k_pos, tb, H, W, scale,
                                        torch.float32)
        bias = tda.lattice_bias_plain(tb, k_pos, H, W, torch.float32)
        ref = tda.site_consumer(q, k, v, bias, scale)
        wabs = tda.site_consumer(q, k, v.abs(), bias, scale)
    torch.cuda.synchronize()
    assert torch.equal(out_o, out)
    assert bool(((out - ref).abs() <= 2.0 ** -7 * wabs + 1e-5).all())
    assert float((out_lse - ref_lse).abs().max()) <= 1e-5


# (batch, G, ch, N, table width) of chip_smoke's serving and training
# sites of the flagship (SITE_SITES, TRAIN_SITE_SITES; BEV 28, two heads a
# group)
FLAGSHIP_SITES = [(4, 4, 8, 196, 55), (4, 8, 4, 784, 55), (12, 4, 8, 1960, 279),
                  (12, 8, 4, 1960, 279), (2, 4, 8, 196, 55),
                  (2, 8, 4, 784, 55), (6, 4, 8, 1960, 279),
                  (6, 8, 4, 1960, 279)]


@pytest.mark.cuda
@pytest.mark.parametrize("table_std", [0.01, 1.0])
@pytest.mark.parametrize("B,G,ch,N,Wt", FLAGSHIP_SITES)
def test_fused_site_equals_the_template_instances(cuda_device, B, G, ch, N,
                                                  Wt, table_std):
    """``fused_site`` and its logsumexp instance, one launch each on
    ``site_plan``'s plan, equal ``fused_site_wide`` and
    ``fused_site_wide_lse`` on path "whole" (output and logsumexp) and
    ``fused_site_fold_rows`` bit for bit: every site of the flagship's main
    path, at both table scales."""
    H = W = 28
    wide, fold = kernels.fused_site_wide, kernels.fused_site_fold
    table, k_pos, q, k, v = _inputs(30, B, G, 2, H, W, Wt, N, ch,
                                    cuda_device, table_std)
    scale = ch ** -0.5
    kargs = _site_kargs(table, k_pos, q, k, v, H, W)
    geo, qkv = kargs[:7], kargs[8:]
    before = kernels.counts()
    with torch.no_grad():
        out = kernels.fused_site.fused_site_cuda(*kargs, H, W, scale)
        out_l, lse = kernels.fused_site.fused_site_lse_cuda(*kargs, H, W,
                                                            scale)
        sib = wide.fused_site_wide_cuda(*geo, *qkv, H, W, scale, path="whole")
        sib_l, sib_lse = wide.fused_site_wide_lse_cuda(*geo, *qkv, H, W,
                                                       scale, path="whole")
        rows = fold.fused_site_fold_rows_cuda(*kargs, H, W, scale)
    torch.cuda.synchronize()
    after = kernels.counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} \
        == {"fused_site": 1, "fused_site_lse": 1, "fused_site_wide": 1,
            "fused_site_wide_lse": 1, "fused_site_fold_rows": 1}
    assert torch.equal(out, sib) and torch.equal(out, rows)
    assert torch.equal(out_l, out) and torch.equal(out_l, sib_l)
    assert torch.equal(lse, sib_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("table_std", [0.01, 1.0])
@pytest.mark.parametrize("ch,N,Wt", [(4, 1960, 279), (8, 196, 55),
                                     (8, 45, 15)])
def test_fused_site_instances_match_online_mirror(cuda_device, ch, N, Wt,
                                                  table_std):
    """Both instances stand within chip_smoke's ONLINE_TOL (2^-15 of the
    p-weighted |v|) of ``site_consumer_online`` in output, the logsumexp
    within LSE_ONLINE_TOL of its, and within SITE_P_ROUND of the plain
    version; a table of std 1 makes the bias outweigh q . k."""
    H = W = 28 if Wt != 15 else 8
    table, k_pos, q, k, v = _inputs(31, 2, 4, 2, H, W, Wt, N, ch,
                                    cuda_device, table_std)
    scale = ch ** -0.5
    kargs = _site_kargs(table, k_pos, q, k, v, H, W)
    with torch.no_grad():
        out = kernels.fused_site.fused_site_cuda(*kargs, H, W, scale)
        out_l, lse = kernels.fused_site.fused_site_lse_cuda(*kargs, H, W,
                                                            scale)
        bias = tda.lattice_bias_plain(table.bfloat16().float(), k_pos, H, W,
                                      torch.float32)
        online, on_lse = tda.site_consumer_online(q, k, v, bias, scale,
                                                  return_lse=True)
        ref = tda.site_consumer(q, k, v, bias, scale)
        wabs = tda.site_consumer(q, k, v.abs(), bias, scale)
    torch.cuda.synchronize()
    for x in (out, out_l):
        assert bool(((x - online).abs() <= 2.0 ** -15 * wabs + 1e-7).all())
        assert bool(((x - ref).abs() <= 2.0 ** -7 * wabs + 1e-5).all())
    assert float((lse - on_lse).abs().max()) <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("ch", [4, 8])
def test_fused_site_occupancy_holds_the_plan(cuda_device, ch):
    """At the flagship's serving SCA (B*V=12, G=8 / 4) the card holds at
    least the blocks an SM ``site_plan`` counts on (four, by the launch
    bounds and the 57 KB a block)."""
    fs = kernels.fused_site
    G = 4 if ch == 8 else 8
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = fs.site_plan(12, G, 2, 55, tda.padded_width(279), 28, 28, ch, sms)
    assert plan.per_sm == 4
    assert fs.site_blocks_per_sm(plan, ch) >= plan.per_sm


@pytest.mark.cuda
def test_fused_site_refuses_misaligned_k_and_v(cuda_device):
    """The template copies each key's K and V row as one 2 ch-byte vector:
    both instances refuse a k or v that does not start on such a boundary
    before launching, and count no launch."""
    table, k_pos, q, k, v = _inputs(32, 1, 1, 2, 10, 10, 39, 40, 4,
                                    cuda_device)
    kargs = _site_kargs(table, k_pos, q, k, v, 10, 10)
    head, (q, k, v) = kargs[:8], kargs[8:]
    for i in (0, 1):
        x = (k, v)[i]
        off = torch.empty(x.numel() + 1, dtype=x.dtype,
                          device=x.device)[1:].view(x.shape)
        off.copy_(x)
        qkv = (q, off, v) if i == 0 else (q, k, off)
        for call in (kernels.fused_site.fused_site_cuda,
                     kernels.fused_site.fused_site_lse_cuda):
            before = kernels.counts()
            with pytest.raises(ValueError, match="8-byte boundary"):
                call(*head, *qkv, 10, 10, 0.5)
            assert kernels.counts() == before


@pytest.mark.cuda
def test_fold_options_reach_the_fold_kernels(cuda_device):
    """A flagship SCA site through ``streamed_deform_attention`` takes the
    folded kernels under the fold options and gives the per-head kernels'
    output; the folded training forward's gradients (the same backward
    kernel, float atomics) agree with the per-head forward's to
    SITE_BWD_ONLINE_TOL."""
    H = W = 28
    table, k_pos, q, k, v = _inputs(22, 2, 4, 2, H, W, 279, 700, 8,
                                    cuda_device, 1.0)

    def site(**options):
        with torch.no_grad():
            return tda.streamed_deform_attention(
                q, k, v, k_pos, table, H, W, scale=8 ** -0.5, fuse_site=True,
                **options)

    before = kernels.counts()
    rows = site(site_fold_rows=True)
    heads = site(lattice_route="wide", site_prefetch=True,
                 site_fold_heads=True)
    assert torch.equal(rows, site()) and torch.equal(heads, rows)
    grads = []
    for fold in (False, True):
        a = [t.clone().requires_grad_() for t in (q, k, v, k_pos, table)]
        out = tda.streamed_deform_attention(
            *a, H, W, scale=8 ** -0.5, fuse_site=False, fused_bwd=True,
            fused_fwd_fold=fold)
        grads.append((out.detach(), torch.autograd.grad(out.sum(), a)))
    torch.cuda.synchronize()
    after = kernels.counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} \
        == {"fused_site": 1, "fused_site_fold_rows": 1,
            "fused_site_fold_heads": 1, "fused_site_lse": 1,
            "fused_site_fold_heads_lse": 1, "fused_site_bwd": 2}
    assert torch.equal(grads[0][0], grads[1][0])
    for x, r in zip(grads[1][1], grads[0][1]):
        assert _close(x, r, SITE_BWD_ONLINE_TOL)


@pytest.mark.cuda
def test_fold_wrappers_refuse_sites_that_do_not_fold(cuda_device):
    """On the card the folded kernels refuse, before launching, a site whose
    tables or ring overflow shared memory (two heads of BEV 64 at depth 5;
    two heads of BEV 64 at depth 8), whose Hpg * W is over 128, or whose
    head count has no instance."""
    fold = kernels.fused_site_fold
    for Hpg, H, Wt, which, match in (
            (2, 64, 639, "rows", "shared memory"),
            (2, 64, 1023, "heads", "shared memory"),
            (2, 72, 719, "heads", "do not fold"),
            (4, 8, 79, "rows", "do not fold")):
        table, k_pos, q, k, v = _inputs(23, 1, 1, Hpg, H, H, Wt, 40, 4,
                                        cuda_device)
        kargs = _site_kargs(table, k_pos, q, k, v, H, H)
        with pytest.raises(ValueError, match=match):
            if which == "rows":
                fold.fused_site_fold_rows_cuda(*kargs, H, H, 0.5)
            else:
                fold.fused_site_fold_heads_cuda(*kargs[:7], *kargs[8:], H, H,
                                                0.5)


@pytest.mark.cuda
def test_fold_heads_refuses_misaligned_k_and_v(cuda_device):
    """The whole-table path copies each key's K and V row as one 2 ch-byte
    vector: a k or v that does not start on such a boundary is refused
    before launching, not copied."""
    fold = kernels.fused_site_fold
    table, k_pos, q, k, v = _inputs(26, 1, 1, 2, 10, 10, 39, 40, 4,
                                    cuda_device)
    kargs = _site_kargs(table, k_pos, q, k, v, 10, 10)
    geo, (q, k, v) = kargs[:7], kargs[8:]
    assert fold.heads_plan(2, 39, 10, 10, 4)[0] == "whole"
    for i in (0, 1):
        x = (k, v)[i]
        off = torch.empty(x.numel() + 1, dtype=x.dtype,
                          device=x.device)[1:].view(x.shape)
        off.copy_(x)
        qkv = (q, off, v) if i == 0 else (q, k, off)
        before = kernels.counts()
        with pytest.raises(ValueError, match="8-byte boundary"):
            fold.fused_site_fold_heads_cuda(*geo, *qkv, 10, 10, 0.5)
        assert kernels.counts() == before


def test_fold_wrappers_refuse_cpu_tensors_and_other_heads():
    """Checked before anything touches the card: CPU tensors. A site folds
    where the kernels have an instance for its head count and Hpg * W <=
    128."""
    fold = kernels.fused_site_fold
    table, k_pos, q, k, v = _inputs(24, 1, 1, 2, 8, 8, 15, 10, 4, "cpu")
    kargs = _site_kargs(table, k_pos, q, k, v, 8, 8)
    geo, qkv = kargs[:7], kargs[8:]
    with pytest.raises(ValueError, match="CUDA tensors"):
        fold.fused_site_fold_rows_cuda(*kargs, 8, 8, 0.5)
    for call in (fold.fused_site_fold_heads_cuda,
                 fold.fused_site_fold_heads_lse_cuda):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call(*geo, *qkv, 8, 8, 0.5)
    assert not fold.folds(4, 8) and not fold.folds(2, 65)
    assert fold.folds(2, 64) and fold.folds(1, 128) and fold.folds(2, 28)


def test_fold_sizes_follow_the_shapes():
    """At the flagship's SCA (55 x 279, W = 28, two heads) the row-folded
    site folds where both padded tables of 63 x 429 fit one block with the
    whole-table key stages, and stages one of them a block; the
    head-folded ring is two slots of 16 keys x 2 heads x 7 rows x 152
    columns, the per-head prefetch ring's 136 KB, though the head-folded
    site takes its whole-table path (113 KB); a shape whose ring overflows
    shared memory is refused with the numbers (two heads of BEV 64 at depth
    8)."""
    fold = kernels.fused_site_fold
    Xp = tda.padded_width(279)
    assert fold.whole_smem(2, 55, Xp, 8) == (2 * 63 * Xp * 2
                                             + 2 * (2 * 2 * 32 * 8 * 2
                                                    + 32 * 16))
    assert fold.rows_fit(2, 55, Xp, 28, 8)
    assert fold.rows_plan(12, 4, 2, 55, Xp, 28, 28, 8, 132).smem == (
        fold.whole_smem(1, 55, Xp, 8))
    assert not fold.rows_fit(2, 127, tda.padded_width(639), 64, 4)
    R, CW, _, smem = fold.fold_ring(2, 279, 28, 28, 8)
    assert (R, CW) == (7, 152)
    assert smem == 2 * 16 * 2 * 7 * 152 * 2 + 2 * 2 * 32 * 8 * 4 + 32 * 12
    assert fold.heads_fit(2, 279, 28, 28, 8)
    assert not fold.heads_fit(2, 1023, 64, 64, 4)
    # the whole-table path there: two stages of both heads' K and V tiles in
    # bf16 with four words of geometry a key, the two padded tables, and 7
    # strips of 112 queries a head
    assert fold.heads_plan(2, 279, 28, 28, 8) == (
        "whole", 112, 224, 2 * (2 * 2 * 32 * 8 * 2 + 32 * 16)
        + 2 * 63 * Xp * 2)
    with pytest.raises(ValueError, match="shared memory"):
        fold.fold_ring(2, 1023, 64, 64, 4)


# (H, G, N, Wt, table std): the flagship's bias sites (H = 28) and the
# pyramid's SCA at BEV 56 and its M = 196 and 49 sites
WIDE_BIAS = [
    (28, 1, 1960, 279, 0.01), (28, 2, 49, 55, 1.0), (56, 1, 600, 559, 1.0),
    (56, 1, 300, 559, 0.01), (14, 4, 490, 139, 1.0), (7, 8, 49, 13, 0.01)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,G,N,Wt,table_std", WIDE_BIAS)
def test_wide_bias_prefetch_equals_wide_bias(cuda_device, H, G, N, Wt,
                                             table_std):
    """``lattice_bias_wide_prefetch`` equals ``lattice_bias_wide`` bit for
    bit, and ``lattice_bias`` where that kernel's shared memory holds the
    table; all equal to the plain version rounded to bf16."""
    table, k_pos, *_ = _inputs(20, 2, G, 2, H, H, Wt, N, 4, cuda_device,
                               table_std)
    args = tda._kernel_args(table, k_pos, H, H)
    fwd = kernels.lattice_bias
    with torch.no_grad():
        wide = fwd.lattice_bias_wide_cuda(*args[:7], H, H)
        pre = fwd.lattice_bias_wide_prefetch_cuda(*args[:7], H, H)
        ref = tda.lattice_bias_plain(table.bfloat16().float(), k_pos, H, H,
                                     torch.float32).bfloat16().float()
        if tda.bias_route(table.shape, H, H) == "whole":
            assert torch.equal(fwd.lattice_bias_cuda(*args, H, H), wide)
    torch.cuda.synchronize()
    assert torch.equal(pre, wide)
    assert torch.equal(pre.float(), ref)


# The two wide bias forwards, one template (csrc/bias_fwd_rows.cuh): (H, G,
# N, Wt) at W = 7, 14, 28 and 56, the prefetch kernel on its whole-table
# path (also for a table of even width), and at W = 28 and 56 a table whose
# padded head overflows a block (63 x 1851 and 119 x 1127 bf16), where it
# takes path "l1"
WIDE_FWD = [(7, 8, 49, 13), (7, 8, 140, 69), (14, 4, 490, 139),
            (28, 1, 49, 55), (28, 2, 1960, 279), (56, 1, 600, 559),
            (28, 2, 200, 278), (28, 1, 300, 1843), (56, 1, 200, 1119)]


@pytest.mark.cuda
@pytest.mark.parametrize("table_std", [0.01, 1.0])
@pytest.mark.parametrize("H,G,N,Wt", WIDE_FWD)
def test_wide_bias_forwards_equal_each_other(cuda_device, H, G, N, Wt,
                                             table_std):
    """``lattice_bias_wide`` and ``lattice_bias_wide_prefetch`` equal each
    other and the plain version (float32 lerps on the bf16 table) rounded
    to bf16 bit for bit, on both of the prefetch kernel's paths, and
    ``lattice_bias`` where its shared memory holds the table; one launch
    each."""
    table, k_pos, *_ = _inputs(21, 2, G, 2, H, H, Wt, N, 4, cuda_device,
                               table_std)
    args = tda._kernel_args(table, k_pos, H, H)
    fwd = kernels.lattice_bias
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fwd.fwd_plan(2, G, 2, 2 * H - 1, Wt, N, H, H, sms,
                        "lattice_bias_wide_prefetch")
    assert plan.path == ("l1" if Wt in (1843, 1119) else "whole")
    whole = tda.bias_route(table.shape, H, H) == "whole"
    before = kernels.counts()
    with torch.no_grad():
        wide = fwd.lattice_bias_wide_cuda(*args[:7], H, H)
        pre = fwd.lattice_bias_wide_prefetch_cuda(*args[:7], H, H)
        ref = tda.lattice_bias_plain(table.bfloat16().float(), k_pos, H, H,
                                     torch.float32).bfloat16()
        if whole:
            assert torch.equal(fwd.lattice_bias_cuda(*args, H, H), wide)
    torch.cuda.synchronize()
    after = kernels.counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == dict(lattice_bias_wide=1, lattice_bias_wide_prefetch=1,
                **({"lattice_bias": 1} if whole else {}))
    assert torch.equal(pre, wide)
    assert torch.equal(wide, ref)


# lattice_bias at the shapes the models give it, (B, G, N, Wt, H): the
# flagship's serving TSA and SCA, its training TSA G=8 (staged), and the
# pyramid's TSA 56, BEV 14 and BEV 7 sites (M = 196 and 49); and a table of
# even width, which no model has but the staging takes
BIAS_LAYOUT_SHAPES = [(4, 1, 16, 55, 28), (4, 2, 49, 55, 28),
                      (4, 2, 1960, 279, 28), (2, 8, 784, 55, 28),
                      (2, 1, 49, 111, 56), (2, 4, 49, 27, 14),
                      (6, 4, 490, 139, 14), (2, 8, 49, 13, 7),
                      (6, 8, 140, 69, 7), (2, 2, 200, 278, 28)]


@pytest.mark.cuda
@pytest.mark.parametrize("table_std", [0.01, 1.0])
@pytest.mark.parametrize("B,G,N,Wt,H", BIAS_LAYOUT_SHAPES)
def test_lattice_bias_layouts_equal_plain(cuda_device, B, G, N, Wt, H,
                                          table_std):
    """``lattice_bias`` under its own plan and on both paths
    (``fwd_layout``: "whole" stages the head's table from the raw table,
    "l1" reads it through L1) equals the plain version rounded to bf16 bit
    for bit; one launch a call."""
    table, k_pos, *_ = _inputs(24, B, G, 2, H, H, Wt, N, 4, cuda_device,
                               table_std)
    fwd = kernels.lattice_bias
    args = tda._kernel_args(table, k_pos, H, H)
    with torch.no_grad():
        ref = tda.lattice_bias_plain(table.bfloat16().float(), k_pos, H, H,
                                     torch.float32).bfloat16()
        for path in (None, "l1", "whole"):
            before = fwd.launches
            out = fwd.lattice_bias_cuda(*args, H, H, path=path)
            torch.cuda.synchronize()
            assert fwd.launches == before + 1
            assert torch.equal(out, ref), path


# The window kernels of the windowed bias (bias_forward="windows"): (B, G,
# Hpg, H, Wt, N) with rows of W * Hpg = 56, 28, 14 and 7 bf16 (16-, 8-, 4-
# and 2-byte vectors), at the flagship's SCA and TSA and the pyramid's BEV 7
WINDOW_SHAPES = [(2, 2, 2, 28, 279, 1960), (2, 1, 1, 28, 55, 196),
                 (2, 8, 2, 7, 69, 140), (1, 2, 1, 7, 13, 49)]
# windowed bias against the bias kernel, as a share of the bf16 table's
# largest entry: nine bf16 roundings (chip_smoke.WINDOWED_TOL)
WINDOWED_TOL = 9 * 2.0 ** -8


def _windows_inputs(seed, B, G, Hpg, H, Wt, N, device):
    table, k_pos, *_ = _inputs(seed, B, G, Hpg, H, H, Wt, N, 4, device)
    ys, ms, _, _ = tda.lattice_geometry(table.shape, k_pos, H, H)
    t3 = tda.lattice_t3(table, H, torch.bfloat16)
    return table, k_pos, t3, ys.contiguous(), ms.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,Hpg,H,Wt,N", WINDOW_SHAPES)
def test_window_kernels_match_plain(cuda_device, B, G, Hpg, H, Wt, N):
    """``lattice_windows`` equals its plain version (both copy); the float32
    sums of ``lattice_windows_bwd`` stand within BWD_SUM_TOL of its plain
    version's (the same additions in another order), and its bf16 result,
    those sums rounded once, within one bf16 ulp of the plain one."""
    _, _, t3, ys, ms = _windows_inputs(22, B, G, Hpg, H, Wt, N, cuda_device)
    lw = kernels.lattice_windows
    before = kernels.counts()
    win = lw.lattice_windows_cuda(t3, ys, ms, H + 1)
    gen = torch.Generator(device="cuda").manual_seed(23)
    gout = torch.randn(win.shape, generator=gen, device="cuda").bfloat16()
    acc = lw.lattice_windows_bwd_cuda(gout, ys, ms, t3.shape, torch.float32)
    out = lw.lattice_windows_bwd_cuda(gout, ys, ms, t3.shape, torch.bfloat16)
    ref = lw.lattice_windows_bwd_plain(gout, ys, ms, t3.shape, torch.float32)
    torch.cuda.synchronize()
    after = kernels.counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"lattice_windows": 1, "lattice_windows_bwd": 2}
    assert win.shape == (B, G, N, 3, H + 1, H * Hpg)
    assert torch.equal(win, lw.lattice_windows_plain(t3, ys, ms, H + 1))
    assert float(ref.abs().max()) > 0
    assert _close(acc, ref, BWD_SUM_TOL)
    refb = ref.bfloat16().float()
    assert out.dtype == torch.bfloat16
    assert bool(((out.float() - refb).abs()
                 <= torch.maximum(out.float().abs(), refb.abs()) * 2.0 ** -7)
                .all())


# and #15's gather beyond them: rows of 112 (the pyramid's SCA 56, 16 lanes
# a row) and of 33 values (2-byte vectors, more than one warp's width), on
# both of its paths (groups of more than 256 keys bucketed first, B * N =
# 300; smaller ones sorted in each block, B * N = 100), and the training
# TSA G=1 (32 keys)
WINDOW_BWD_SHAPES = WINDOW_SHAPES + [(2, 1, 2, 56, 559, 300),
                                     (1, 1, 1, 33, 65, 300),
                                     (1, 1, 1, 33, 65, 100),
                                     (2, 1, 2, 28, 55, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,Hpg,H,Wt,N", WINDOW_BWD_SHAPES)
def test_window_bwd_kernel_equals_ordered_mirror(cuda_device, B, G, Hpg, H,
                                                 Wt, N):
    """``lattice_windows_bwd`` sums every row of the t3 gradient in a fixed
    order, with no float atomic: it equals ``lattice_windows_bwd_ordered``,
    which repeats that order in PyTorch, bit for bit in float32 and in
    bf16, and two calls give the same bits."""
    _, _, t3, ys, ms = _windows_inputs(28, B, G, Hpg, H, Wt, N, cuda_device)
    lw = kernels.lattice_windows
    gen = torch.Generator(device="cuda").manual_seed(29)
    gout = torch.randn((B, G, N, 3, H + 1, H * Hpg), generator=gen,
                       device="cuda").bfloat16()
    for dtype in (torch.float32, torch.bfloat16):
        first = lw.lattice_windows_bwd_cuda(gout, ys, ms, t3.shape, dtype)
        again = lw.lattice_windows_bwd_cuda(gout, ys, ms, t3.shape, dtype)
        ref = lw.lattice_windows_bwd_ordered(gout, ys, ms, t3.shape, dtype)
        torch.cuda.synchronize()
        assert first.dtype == dtype and float(ref.abs().max()) > 0
        assert torch.equal(first, again)
        assert torch.equal(first, ref)


# The bias backward kernels against their ordered mirror: (B, G, H, Wt, N).
# The flagship's SCA table (two bands of 32 rows, so a band boundary inside
# most keys' windows; 1960 keys in runs of 60, the last shorter), BEV 7 (M
# = 49), the pyramid's SCA 56 table at W = 56 (two rounds of lanes, six
# bands), W = 33 and a small TSA table with an odd key count.
BIAS_BWD_ORDER = [(2, 2, 28, 279, 1960), (1, 2, 7, 13, 49),
                  (2, 1, 56, 559, 300), (1, 1, 33, 65, 50), (2, 2, 8, 15, 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("B,G,H,Wt,N", BIAS_BWD_ORDER)
def test_bias_bwd_kernels_equal_ordered_mirror(cuda_device, wide, B, G, H,
                                               Wt, N):
    """``lattice_bias_bwd`` and ``lattice_bias_wide_bwd`` sum with no float
    atomic in a fixed order: dtable equals ``lattice_bias_bwd_ordered``
    under the wrapper's plan bit for bit, dwy and df are within
    BWD_SUM_TOL of its plain sums, and two calls give the same bits."""
    lbb = kernels.lattice_bias_bwd
    table, k_pos, *_ = _inputs(31, B, G, 2, H, H, Wt, N, 4, cuda_device, 0.5)
    gen = torch.Generator(device="cuda").manual_seed(32)
    gout = torch.randn(B, G, 2, N, H * H, generator=gen,
                       device="cuda").bfloat16()
    args = tda._kernel_args(table, k_pos, H, H)
    fn = lbb.lattice_bias_wide_bwd_cuda if wide else lbb.lattice_bias_bwd_cuda
    first = fn(*args, gout, H, H)
    again = fn(*args, gout, H, H)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = lbb.plan(B, G, 2, 2 * H - 1, Wt, N, H, H, sms)
    ref = lbb.lattice_bias_bwd_ordered(*args, gout, H, H, plan)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert float(ref[0].abs().max()) > 0
    assert torch.equal(first[0], ref[0])
    assert _close(first[1], ref[1], BWD_SUM_TOL)
    assert _close(first[2], ref[2], BWD_SUM_TOL)


@pytest.mark.cuda
def test_windowed_bias_runs_on_the_window_kernels(cuda_device, monkeypatch):
    """``lattice_bias_windowed`` on CUDA tensors launches one window kernel
    in its forward and one in its backward; its bias equals
    ``lattice_bias_plain`` in bf16 bit for bit and stands within
    WINDOWED_TOL of the bias kernel. Its gradients are those of the same
    function with the plain windows: dk_pos (which does not pass through
    the windows) exactly, dtable within 2^-6 of its largest entry (a t3
    gradient entry one bf16 ulp apart, 2^-7 of it, reaches the table
    entries it is added into, whose bf16 sums round again)."""
    H, W = 28, 28
    table, k_pos, *_ = _inputs(25, 2, 2, 2, H, W, 279, 500, 4, cuda_device)
    ct = torch.randn(2, 2, 2, 500, H * W, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(26))

    def run():
        t, p = table.clone().requires_grad_(), k_pos.clone().requires_grad_()
        out = tda.lattice_bias_windowed(t, p, H, W)
        return (out,) + torch.autograd.grad(out, (t, p), ct)

    before = kernels.counts()
    out, dt, dp = run()
    torch.cuda.synchronize()
    after = kernels.counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"lattice_windows": 1, "lattice_windows_bwd": 1}
    lw = kernels.lattice_windows
    monkeypatch.setattr(lw, "lattice_windows_cuda", lw.lattice_windows_plain)
    monkeypatch.setattr(lw, "lattice_windows_bwd_cuda",
                        lw.lattice_windows_bwd_plain)
    ref, rdt, rdp = run()
    with torch.no_grad():
        plain = tda.lattice_bias_plain(table, k_pos, H, W)
        kernel = tda.lattice_bias(table, k_pos, H, W).float()
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and torch.equal(out, plain)
    a = float(table.detach().bfloat16().abs().max())
    assert float((out.detach() - kernel).abs().max()) <= WINDOWED_TOL * a
    assert torch.equal(dp, rdp) and float(dp.abs().max()) > 0
    assert _close(dt, rdt, 2.0 ** -6) and float(dt.abs().max()) > 0


@pytest.mark.cuda
def test_retrieval_head_is_float32_with_tf32_enabled(cuda_device,
                                                      monkeypatch):
    """The retrieval head (no kernel of its own) on the card with TF32
    enabled globally, PyTorch's cuDNN default: within 1e-5 of its largest
    entry of the same head in float64 on the CPU, because the head pins
    IEEE float32 itself. Without that pin the same run departs by more, so
    TF32 really was on."""
    import contextlib
    import copy

    from bevrender_tpu_torch.models import retrieval
    from bevrender_tpu_torch.models.layers import init_params

    head = init_params(retrieval.RetrievalHead(256, (32, 64, 128, 256)), 0)
    x = torch.rand(4, 224, 224, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = copy.deepcopy(head).double()(x.double())
    card = head.to(cuda_device)
    xc = x.to(cuda_device)

    def rel():
        with torch.no_grad():
            got = card(xc)
        return float((got.double().cpu() - ref).abs().max()
                     / ref.abs().max())

    with retrieval.tf32(True):
        pinned = rel()
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        monkeypatch.setattr(retrieval, "tf32",
                            lambda enabled: contextlib.nullcontext())
        unpinned = rel()
    assert pinned <= 1e-5, pinned
    assert unpinned > 1e-5, unpinned


@pytest.mark.cuda
@pytest.mark.parametrize("ch", [1, 2, 6])
def test_narrow_head_site_takes_the_bias_route(cuda_device, ch):
    """A site whose head width has no fused-site instance (the flagship at
    width 32 has head width 2 at stage 3) runs through
    ``streamed_deform_attention`` on the bias kernel and the plain
    consumer, within the fused site's tolerance of ``site_plain``."""
    H = W = 28
    table, k_pos, q, k, v = _inputs(24, 2, 4, 2, H, W, 279, 1960, ch,
                                    cuda_device)
    scale = ch ** -0.5
    before = kernels.counts()
    with torch.no_grad():
        out = tda.streamed_deform_attention(q, k, v, k_pos, table, H, W,
                                            scale=scale, fuse_site=True)
        tb = table.bfloat16().float()
        ref = tda.site_plain(q, k, v, k_pos, tb, H, W, scale, torch.float32)
        bias = tda.lattice_bias_plain(tb, k_pos, H, W, torch.float32)
        wabs = tda.site_consumer(q, k, v.abs(), bias, scale)
    torch.cuda.synchronize()
    after = kernels.counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"lattice_bias": 1}
    assert bool(((out - ref).abs() <= 2.0 ** -7 * wabs + 1e-5).all())


def test_window_wrappers_refuse_bad_inputs():
    """Checked before anything touches the card: CPU tensors, a float32
    table, int64 starts, windows taller than the table, a float32
    cotangent and an output type the backward has no instance for."""
    _, _, t3, ys, ms = _windows_inputs(27, 1, 2, 2, 7, 13, 20, "cpu")
    lw = kernels.lattice_windows
    before = kernels.counts()
    gout = torch.zeros(1, 2, 20, 3, 8, 14, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lw.lattice_windows_cuda(t3, ys, ms, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lw.lattice_windows_bwd_cuda(gout, ys, ms, t3.shape, torch.bfloat16)
    meta = torch.device("meta")
    m3, mys, mms, mg = (x.to(meta) for x in (t3, ys, ms, gout))
    with pytest.raises(TypeError, match="t3"):
        lw.lattice_windows_cuda(m3.float(), mys, mms, 8)
    with pytest.raises(TypeError, match="ys"):
        lw.lattice_windows_cuda(m3, mys.long(), mms, 8)
    with pytest.raises(ValueError, match="do not fit"):
        lw.lattice_windows_cuda(m3, mys, mms, t3.shape[1] + 1)
    with pytest.raises(TypeError, match="gout"):
        lw.lattice_windows_bwd_cuda(mg.float(), mys, mms, t3.shape,
                                    torch.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        lw.lattice_windows_bwd_cuda(mg, mys, mms, t3.shape, torch.float16)
    assert kernels.counts() == before


@pytest.mark.parametrize("ch,N,table_std", [
    (4, 96, 0.01), (8, 70, 0.01), (4, 96, 1.0), (8, 45, 1.0)])
def test_online_consumer_matches_plain_consumer(ch, N, table_std):
    """``site_consumer_online`` (the fused kernel's roundings) computes the
    site of ``site_consumer``: p is rounded to bf16 in both, before
    normalising in one and after in the other, each off by at most 2^-8 of
    the p-weighted |v|. N = 70 and 45 end in a partial tile of keys."""
    H = W = 8
    table, k_pos, q, k, v = _inputs(6, 2, 2, 2, H, W, 15, N, ch, "cpu",
                                    table_std)
    bias = tda.lattice_bias_plain(table, k_pos, H, W, torch.float32)
    ref = tda.site_consumer(q, k, v, bias, ch ** -0.5)
    out = tda.site_consumer_online(q, k, v, bias, ch ** -0.5)
    wabs = tda.site_consumer(q, k, v.abs(), bias, ch ** -0.5)
    assert out.shape == ref.shape == (2, 2, 2, H * W, ch)
    assert bool(((out - ref).abs() <= 2.0 ** -7 * wabs + 1e-6).all())
    assert float((out - ref).abs().max()) > 0  # the roundings do differ


def test_cpu_tensors_take_the_plain_versions():
    table, k_pos, q, k, v = _inputs(4, 2, 1, 2, 8, 8, 15, 10, 4, "cpu")
    before = kernels.counts()
    bias = tda.lattice_bias(table, k_pos, 8, 8)
    out = tda.fused_site(q, k, v, k_pos, table, 8, 8, 0.5)
    assert kernels.counts() == before
    assert torch.equal(bias, tda.lattice_bias_plain(table, k_pos, 8, 8))
    assert torch.equal(out, tda.site_plain(q, k, v, k_pos, table, 8, 8, 0.5))


def test_cpu_gradients_take_the_plain_versions():
    """On CPU tensors the bias and the fused training site are their plain
    versions under autograd, and no kernel is launched."""
    table, k_pos, q, k, v = _inputs(12, 2, 1, 2, 8, 8, 15, 10, 4, "cpu")
    before = kernels.counts()
    a = [t.clone().requires_grad_() for t in (q, k, v, k_pos, table)]
    b = [t.clone().requires_grad_() for t in (q, k, v, k_pos, table)]
    got = torch.autograd.grad(tda.fused_site_train(*a, 8, 8, 0.5).sum(), a)
    ref = torch.autograd.grad(tda.site_plain(*b, 8, 8, 0.5).sum(), b)
    assert all(torch.equal(x, r) for x, r in zip(got, ref))
    t1, p1 = a[4], a[3]
    gb = torch.autograd.grad(tda.lattice_bias(t1, p1, 8, 8).sum(), (t1, p1))
    rb = torch.autograd.grad(tda.lattice_bias_plain(b[4], b[3], 8, 8).sum(),
                             (b[4], b[3]))
    assert all(torch.equal(x, r) for x, r in zip(gb, rb))
    assert float(gb[0].abs().max()) > 0 and float(gb[1].abs().max()) > 0
    assert kernels.counts() == before
    assert set(before) == {"lattice_bias", "fused_site", "lattice_bias_bwd",
                           "fused_site_lse", "fused_site_bwd",
                           "lattice_bias_wide", "lattice_bias_wide_bwd",
                           "fused_site_wide", "fused_site_wide_lse",
                           "fused_site_wide_prefetch",
                           "lattice_bias_wide_prefetch",
                           "fused_site_fold_rows", "fused_site_fold_heads",
                           "fused_site_fold_heads_lse", "lattice_windows",
                           "lattice_windows_bwd", "fused_site_mma"}


@pytest.mark.parametrize("which", ["bias_bwd", "site_bwd", "site_lse"])
def test_backward_wrappers_refuse_bad_inputs(which):
    """Checked before anything touches the card: CPU tensors, a wrong
    cotangent dtype, a head width the kernels have no instance for."""
    table, k_pos, q, k, v = _inputs(13, 1, 1, 2, 8, 8, 15, 10, 4, "cpu")
    args = tda._kernel_args(table, k_pos, 8, 8)
    bf = torch.bfloat16
    if which == "bias_bwd":
        gout = torch.zeros(1, 1, 2, 10, 64, dtype=bf)
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.lattice_bias_bwd.lattice_bias_bwd_cuda(*args, gout, 8, 8)
    elif which == "site_bwd":
        wide = [t.repeat(1, 1, 1, 1, 4).to(bf) for t in (q, k, v)]
        with pytest.raises(ValueError, match="head widths"):
            kernels.fused_site_bwd.fused_site_bwd_cuda(
                *args, *wide, torch.zeros(1, 1, 2, 64, 16),
                torch.zeros(1, 1, 2, 64), torch.zeros(1, 1, 2, 64), 8, 8, 0.5)
    else:
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.fused_site.fused_site_lse_cuda(
                *args, q.to(bf), k.to(bf), v.to(bf), 8, 8, 0.5)


@pytest.mark.parametrize("ch,N,table_std", [(4, 96, 0.01), (8, 45, 1.0)])
def test_site_bwd_online_matches_autograd(ch, N, table_std):
    """``site_bwd_online`` (the backward kernel's roundings) computes the
    gradients of ``site_plain``: both round to bf16, in different places,
    so they agree to SITE_BWD_TOL of the largest entry and not exactly. The
    lse of the online forward is the plain logsumexp."""
    H = W = 8
    table, k_pos, q, k, v = _inputs(14, 2, 2, 2, H, W, 15, N, ch, "cpu",
                                    table_std)
    scale = ch ** -0.5
    dout = torch.from_numpy(np.random.default_rng(15).standard_normal(
        q.shape)).float()
    b = [t.clone().requires_grad_() for t in (q, k, v, k_pos)]
    tb = table.bfloat16().float().requires_grad_()
    out, lse = tda.site_plain_lse(*b, tb, H, W, scale, torch.float32)
    ref = torch.autograd.grad(out, b + [tb], dout)
    bias = tda.lattice_bias_plain(tb.detach(), k_pos, H, W, torch.float32)
    on_out, on_lse = tda.site_consumer_online(q, k, v, bias, scale,
                                              return_lse=True)
    assert float((on_lse - lse.detach()).abs().max()) <= 1e-5
    dq, dk, dv, dtable, dkpos = tda.site_bwd_online(
        q, k, v, k_pos, table, H, W, scale, dout, on_lse,
        (dout * on_out).sum(-1))
    for name, x, r in zip(("dq", "dk", "dv", "dk_pos", "dtable"),
                          (dq, dk, dv, dkpos, dtable), ref):
        assert float(r.abs().max()) > 0, name
        assert _close(x, r, SITE_BWD_TOL), name
        assert float((x - r).abs().max()) > 0, name  # the roundings differ


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library("lattice_bias")
    assert not (tmp_path / "build").exists()


def test_library_path_follows_the_sources():
    a = build._lib_path("lattice_bias")
    b = build._lib_path("fused_site")
    assert a.parent != b.parent and a.name == "liblattice_bias.so"
    assert a.parent.parent == build.BUILD_ROOT


@pytest.mark.cuda
def test_preprocess_batch_on_card_equals_cpu(cuda_device):
    """The device-side data stage (plain PyTorch, float64 contractions) at
    the flagship's shape, 512 x 1920 -> 224 x 672, equal to its CPU run
    within 1e-5 on normalised values."""
    from bevrender_tpu_torch.data.preprocess import preprocess_batch

    rng = np.random.default_rng(0)
    cam = torch.from_numpy(rng.integers(0, 256, (2, 2, 512, 1920, 3),
                                        dtype=np.uint8))
    mp = torch.from_numpy(rng.integers(0, 256, (2, 224, 224, 3),
                                       dtype=np.uint8))
    kw = dict(num_views=3, resize_h=224, resize_w=672,
              cam_mean=(0.485, 0.456, 0.406), cam_std=(0.229, 0.224, 0.225))
    cpu = preprocess_batch(cam, mp, **kw)
    gpu = preprocess_batch(cam.to(cuda_device), mp.to(cuda_device), **kw)
    assert gpu["camera"].shape == (2, 2, 3, 224, 224, 3)
    assert gpu["camera"].is_cuda and gpu["camera"].dtype == torch.float32
    assert float((gpu["camera"].cpu() - cpu["camera"]).abs().max()) <= 1e-5
    assert torch.equal(gpu["map"].cpu(), cpu["map"])


def _graph_trainer(tmp_path, k=2, **model):
    from bevrender_tpu_torch.config import Config, tiny_model_config
    from bevrender_tpu_torch.data.synthetic import SyntheticDataset
    from bevrender_tpu_torch.training.trainer import Trainer

    cfg = Config()
    cfg.model = tiny_model_config(drop_path_rate=0.2, **model)
    cfg.train.work_dir = str(tmp_path)
    cfg.train.steps_per_dispatch = k
    cfg.train.learning_rate = 1e-3
    ds = SyntheticDataset(n_items=8, num_views=2, window_num_imgs=1,
                          img_height=32, img_width=32, map_tile=32)
    return Trainer(cfg, ds, device="cuda"), ds


def _snapshot(state):
    tensors = (list(state.net.parameters()) + list(state.net.buffers())
               + [v for st in state.optimizer.state.values()
                  for v in st.values() if torch.is_tensor(v)])
    return [(t, t.detach().clone()) for t in tensors], state.step


def _restore(state, saved):
    with torch.no_grad():
        for t, c in saved[0]:
            t.copy_(c)
    state.step = saved[1]


@pytest.mark.cuda
@pytest.mark.parametrize("fused_bwd", [False, True])
def test_graphed_sub_steps_equal_eager_steps(cuda_device, tmp_path,
                                             fused_bwd):
    """Each sub-step, eager and graphed from one state (drop path 0.2): the
    forward's loss is the same bits (the replay reseeds the registered
    generator and reads the copied batch); the step is captured once; the
    learning rate is read from its device tensor at every replay."""
    from bevrender_tpu_torch.data.prefetch import collate

    trainer, ds = _graph_trainer(tmp_path)
    trainer.tc.fused_bwd = fused_bwd
    assert trainer.graphed
    state = trainer.create_state(seed=0)
    assert state.optimizer.param_groups[0]["capturable"]
    batches = [collate([ds[2 * i], ds[2 * i + 1]]) for i in range(4)]
    graph = None
    for b in batches:
        saved = _snapshot(state)
        state, m_e, _ = trainer.train_step(state, b, rng=5)
        _restore(state, saved)
        state, m_g, render = trainer.train_step_multi(
            state, {k: v[None] for k, v in b.items()}, rng=5)
        assert graph is None or trainer.step_graph is graph
        graph = trainer.step_graph
        assert m_g["train_batch_loss"].shape == (1,)
        assert float(m_e["train_batch_loss"]) == float(
            m_g["train_batch_loss"][0])
    assert state.step == 4 and render.shape == (2, 32, 32, 3)
    # a group of 2 replays the same graph twice
    state, m, _ = trainer.train_step_multi(state, collate(batches[:2]), rng=5)
    assert trainer.step_graph is graph and state.step == 6
    assert bool(torch.isfinite(m["train_batch_loss"]).all())
    # with a rate of 0 (filled in place) AdamW leaves the weights as they are
    before = [p.detach().clone() for p in state.net.parameters()]
    trainer.set_epoch_lr(state, 0)
    state.optimizer.param_groups[0]["lr"].fill_(0.0)
    state, _, _ = trainer.train_step_multi(state, collate(batches[2:3]), rng=5)
    assert all(torch.equal(a, p) for a, p in zip(before,
                                                  state.net.parameters()))


@pytest.mark.cuda
def test_capturable_adamw_checkpoint_round_trip(cuda_device, tmp_path):
    """A graphed trainer's checkpoint (capturable AdamW: step counts and the
    learning rate on the device) restores into a graphed trainer, which
    captures anew and continues with the same forward as the saved state,
    and into an eager one (float rate, step counts on the CPU)."""
    from bevrender_tpu_torch.data.prefetch import collate

    trainer, ds = _graph_trainer(tmp_path / "a")
    state = trainer.create_state(seed=0)
    group = collate([collate([ds[0], ds[1]]), collate([ds[2], ds[3]])])
    state, _, _ = trainer.train_step_multi(state, group, rng=5)
    path = trainer.save_checkpoint(state, epoch=1)

    again, _ = _graph_trainer(tmp_path / "b")
    restored = again.restore_checkpoint(again.create_state(seed=1), path)
    assert restored.step == state.step == 2
    group0 = restored.optimizer.param_groups[0]
    assert group0["capturable"] and group0["lr"].is_cuda
    for p, q in zip(state.net.parameters(), restored.net.parameters()):
        a, b = state.optimizer.state[p], restored.optimizer.state[q]
        assert b["step"].is_cuda and float(b["step"]) == 2.0
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    nxt = collate([collate([ds[4], ds[5]])])
    state, m1, _ = trainer.train_step_multi(state, nxt, rng=5)
    restored, m2, _ = again.train_step_multi(restored, nxt, rng=5)
    assert float(m1["train_batch_loss"][0]) == float(m2["train_batch_loss"][0])

    eager, _ = _graph_trainer(tmp_path / "c", k=1)
    assert not eager.graphed
    plain = eager.restore_checkpoint(eager.create_state(seed=1), path)
    g = plain.optimizer.param_groups[0]
    assert not g["capturable"] and isinstance(g["lr"], float)
    assert all(not s["step"].is_cuda for s in plain.optimizer.state.values())
    plain, m3, _ = eager.train_step(plain, collate([ds[4], ds[5]]), rng=5)
    assert np.isfinite(float(m3["train_batch_loss"]))
