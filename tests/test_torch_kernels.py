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
    """At most one bf16 ulp from the plain version on the bf16 table with
    float32 lerps (the same arithmetic, rounded once at the end)."""
    H = W = 28 if Wt != 15 else 8
    table, k_pos, *_ = _inputs(1, 4, G, 2, H, W, Wt, N, 4, cuda_device)
    before = kernels.counts()["lattice_bias"]
    with torch.no_grad():
        out = tda.lattice_bias(table, k_pos, H, W)
        ref = tda.lattice_bias_plain(table.bfloat16().float(), k_pos, H, W,
                                     torch.float32).bfloat16()
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    err = (out.float() - ref.float()).abs()
    assert bool((err <= ref.float().abs() * 2.0 ** -7).all())
    assert kernels.counts()["lattice_bias"] == before + 1


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
    site stages two padded tables of 63 x 429 and the head-folded ring is
    two slots of 16 keys x 2 heads x 7 rows x 152 columns, the per-head
    prefetch ring's 136 KB; a shape whose ring overflows shared memory is
    refused with the numbers (two heads of BEV 64 at depth 8)."""
    fold = kernels.fused_site_fold
    Xp = tda.padded_width(279, 28)
    assert fold.rows_smem(2, 55, Xp, 8) == (2 * 63 * Xp * 2
                                            + 2 * 2 * 32 * 8 * 4 + 32 * 12)
    assert fold.rows_fit(2, 55, Xp, 28, 8)
    assert not fold.rows_fit(2, 127, tda.padded_width(639, 64), 64, 4)
    R, CW, _, smem = fold.fold_ring(2, 279, 28, 28, 8)
    assert (R, CW) == (7, 152)
    assert smem == 2 * 16 * 2 * 7 * 152 * 2 + 2 * 2 * 32 * 8 * 4 + 32 * 12
    assert fold.heads_fit(2, 279, 28, 28, 8)
    assert not fold.heads_fit(2, 1023, 64, 64, 4)
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
    table; all within one bf16 ulp of the plain version."""
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
    assert bool(((pre.float() - ref).abs() <= ref.abs() * 2.0 ** -7).all())


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
                           "lattice_windows_bwd"}


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
