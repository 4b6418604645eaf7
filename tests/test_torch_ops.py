"""Ops of the PyTorch port held against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both. The port runs on
CPU tensors, so its kernel wrappers take their plain versions; the CUDA
kernels themselves are tested in test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevrender_tpu.geometry import ego_motion as jego
from bevrender_tpu.ops import deform_attn as jda
from bevrender_tpu.ops import grid_sample as jgs
from bevrender_tpu_torch.geometry import ego_motion as tego
from bevrender_tpu_torch.ops import deform_attn as tda
from bevrender_tpu_torch.ops import grid_sample as tgs
from bevrender_tpu_torch.ops import kernels

# float32 paths with no bf16 cast between them: the two frameworks differ
# only in summation order and in how a lerp is associated
F32_TOL = 1e-5
# sites round K, Q, p and V to bf16: an f32 difference in the last bit can
# flip one bf16 rounding of p (2^-8 relative), so the outputs are held to
# 2e-3 of their largest magnitude
SITE_REL = 2e-3


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _site_inputs(seed, B, G, Hpg, H, W, d, ch, pos_range=1.0):
    rng = np.random.default_rng(seed)
    N = (H // 2) * W * d
    table = (rng.standard_normal((G, Hpg, 2 * H - 1, 2 * W * d - 1)) * 0.01)
    k_pos = rng.uniform(-pos_range, pos_range, (B, G, N, 2))
    q = rng.standard_normal((B, G, Hpg, H * W, ch)) * 0.5
    k = rng.standard_normal((B, G, Hpg, N, ch)) * 0.5
    v = rng.standard_normal((B, G, Hpg, N, ch)) * 0.5
    return [a.astype(np.float32) for a in (q, k, v, k_pos, table)]


def test_grid_sample_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((3, 9, 11, 5)).astype(np.float32)
    # (x, y) in [-1.3, 1.3]: some corners fall outside and read zero
    grid = rng.uniform(-1.3, 1.3, (3, 7, 4, 2)).astype(np.float32)
    ref = np.asarray(jgs.grid_sample_2d_mm(jnp.asarray(img), jnp.asarray(grid)))
    out = tgs.grid_sample_2d(_t(img), _t(grid)).numpy()
    assert out.shape == ref.shape == (3, 7, 4, 5)
    np.testing.assert_allclose(out, ref, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("h,w", [(1, 5), (7, 7), (6, 13)])
def test_normalized_grid_matches_jax(h, w):
    ref = np.asarray(jgs.normalized_grid(h, w))
    np.testing.assert_array_equal(tgs.normalized_grid(h, w).numpy(), ref)


def test_ego_motion_warp_matches_jax():
    rng = np.random.default_rng(1)
    bev = rng.standard_normal((2, 12, 12, 6)).astype(np.float32)
    pose = np.stack([
        rng.uniform(90, 110, (2, 2)), rng.uniform(190, 210, (2, 2)),
        rng.uniform(-0.5, 0.5, (2, 2)),
    ], axis=-1).astype(np.float32)  # (B, 2, 3)
    ref = np.asarray(jego.project_history_bev(jnp.asarray(bev), jnp.asarray(pose)))
    out = tego.project_history_bev(_t(bev), _t(pose)).numpy()
    np.testing.assert_allclose(out, ref, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("pos_range", [1.0, 1.8])
def test_lattice_geometry_matches_jax(pos_range):
    *_, k_pos, table = _site_inputs(2, 2, 2, 2, 8, 8, 3, 4, pos_range)
    ys, ms, _, wy, f, *_ = jda._lattice_geometry(table.shape, jnp.asarray(k_pos), 8, 8)
    tys, tms, twy, tf = tda.lattice_geometry(table.shape, _t(k_pos), 8, 8)
    np.testing.assert_array_equal(tys.numpy(), np.asarray(ys))
    np.testing.assert_array_equal(tms.numpy(), np.asarray(ms))
    np.testing.assert_allclose(twy.numpy(), np.asarray(wy), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tf.numpy(), np.asarray(f), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos_range", [1.0, 1.8])
def test_lattice_bias_matches_jax(dtype, pos_range):
    """``pos_range`` 1.8 puts keys past the 4-pixel pad: their window
    starts are clipped, so the bias is read from a clamped window (not
    zeros, which ``F.grid_sample`` of the table would give)."""
    *_, k_pos, table = _site_inputs(3, 2, 2, 2, 8, 8, 3, 4, pos_range)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    ref = np.asarray(jnp.swapaxes(
        jda._lattice_bias(jnp.asarray(table), jnp.asarray(k_pos), 8, 8, jd), -1, -2))
    out = tda.lattice_bias_plain(_t(table), _t(k_pos), 8, 8, td).numpy()
    assert out.shape == ref.shape == (2, 2, 2, 4 * 8 * 3, 64)
    if dtype == "float32":
        # the table has std 0.01, so the bias is ~1e-2: hold it to 1e-7
        np.testing.assert_allclose(out, ref, atol=1e-7, rtol=0)
    else:
        # bf16 lerps: each rounding may land one bf16 ulp apart if XLA keeps
        # extra precision between ops; ulp(x) <= |x| * 2^-7
        np.testing.assert_array_less(np.abs(out - ref),
                                     np.abs(ref) * 2.0 ** -7 + 1e-9)


def _zero_padded_bias(table, k_pos, H, W):
    """Direct ``F.grid_sample`` (zeros outside) of the table at
    ``0.5 * (q_pos - k_pos)``: (B, G, Hpg, N, H*W)."""
    B, G, N, _ = k_pos.shape
    q_pos = tgs.normalized_grid(H, W).reshape(1, 1, H * W, 2)
    disp = 0.5 * (q_pos - k_pos[:, :, :, None])  # (B, G, N, M, 2) (y, x)
    out = []
    for g in range(G):
        grid = disp[:, g].reshape(1, B * N, H * W, 2).flip(-1)
        s = torch.nn.functional.grid_sample(table[g][None], grid,
                                            align_corners=True)
        out.append(s[0].reshape(-1, B, N, H * W).transpose(0, 1))
    return torch.stack(out, dim=1)


def test_lattice_bias_clips_windows():
    """Inside the table the lattice bias is the bilinear lookup; a key past
    the 4-pixel pad reads a clamped window instead of zeros."""
    *_, k_pos, table = _site_inputs(8, 2, 1, 2, 8, 8, 3, 4, 1.8)
    out = tda.lattice_bias_plain(_t(table), _t(k_pos), 8, 8, torch.float32)
    direct = _zero_padded_bias(_t(table), _t(k_pos), 8, 8)
    inside = torch.from_numpy(np.abs(k_pos).max(-1) <= 1.0)  # (B, G, N)
    diff = (out - direct).abs().amax(dim=(2, 4))  # (B, G, N)
    assert bool(inside.any()) and bool((~inside).any())
    assert float(diff[inside].max()) < 1e-6
    assert float(diff[~inside].max()) > 1e-3


@pytest.mark.parametrize("ch", [4, 8, 16])
def test_site_matches_site_xla(ch):
    """The port's plain site (the fused kernel's plain version) against
    ``_site_xla(use_kernel=False)`` at ch 4, 8 (fused sites) and 16 (bias
    kernel + plain consumer)."""
    q, k, v, k_pos, table = _site_inputs(4, 2, 2, 2, 8, 8, 3, ch, 1.2)
    ref = np.asarray(jda._site_xla(
        *map(jnp.asarray, (q, k, v, k_pos, table)), 8, 8,
        scale=ch ** -0.5, use_kernel=False))
    out = tda.site_plain(*map(_t, (q, k, v, k_pos, table)), 8, 8, ch ** -0.5).numpy()
    np.testing.assert_allclose(out, ref, atol=SITE_REL * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("fuse_site,ch", [(True, 4), (True, 8), (False, 4), (False, 16)])
def test_streamed_attention_matches_jax(fuse_site, ch):
    """The site dispatch, eval (fused) and train (bias + consumer), against
    ``streamed_deform_attention`` with the lattice branch on the CPU."""
    q, k, v, k_pos, table = _site_inputs(5, 2, 2, 2, 8, 8, 2, ch, 1.0)
    H = W = 8
    ref = np.asarray(jda.streamed_deform_attention(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(np.zeros((H * W, 2), np.float32)),
        jnp.asarray(k_pos), jnp.asarray(table), scale=ch ** -0.5,
        lattice_hw=(H, W), lattice_kernel=True, fuse_site=fuse_site))
    before = kernels.counts()
    out = tda.streamed_deform_attention(
        *map(_t, (q, k, v, k_pos, table)), H, W, scale=ch ** -0.5,
        fuse_site=fuse_site).numpy()
    np.testing.assert_allclose(out, ref, atol=SITE_REL * np.abs(ref).max(), rtol=0)
    assert kernels.counts() == before  # CPU tensors launch no kernel
