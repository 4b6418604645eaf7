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
        tda.lattice_bias(table.requires_grad_(), k_pos, 8, 8)


def test_wrappers_refuse_unsupported_shapes():
    """Checked before anything touches the card: the fused site has
    instances for head widths 4 and 8 only, the bias kernel stores 8
    outputs at once."""
    table, k_pos, q, k, v = _inputs(5, 1, 1, 2, 7, 7, 15, 10, 3, "cpu")
    args = tda._kernel_args(table, k_pos, 7, 7)
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="head widths"):
        kernels.fused_site.fused_site_cuda(*args, q.to(bf), k.to(bf), v.to(bf),
                                           7, 7, 0.5)
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.lattice_bias.lattice_bias_cuda(*args, 7, 7)


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
