"""Gradients of the port's ops held against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both. The port runs on
CPU tensors, so its wrappers take their plain versions under autograd; the
JAX functions that reach a Pallas kernel run it in interpret mode, as the
JAX package's own tests do. The CUDA backward kernels themselves are held
against the same plain versions in test_torch_kernels.py on the card.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from bevrender_tpu.geometry import ego_motion as jego
from bevrender_tpu.ops import deform_attn as jda
from bevrender_tpu.ops import grid_sample as jgs
from bevrender_tpu_torch.geometry import ego_motion as tego
from bevrender_tpu_torch.ops import deform_attn as tda
from bevrender_tpu_torch.ops import grid_sample as tgs

# float32 paths with no bf16 cast between them, as a share of the largest
# entry of each gradient
F32_REL = 1e-5
# paths that round to bf16 (table, lerps, K, Q, p, V and the cotangents of
# those casts): the two frameworks round at slightly different places; the
# JAX package holds its own kernels to 8e-3 of the largest entry
BF16_REL = 8e-3
# gradients that flow through the bf16 XLA bias path (``use_kernel=False``
# in JAX, the CPU route of ``lattice_bias`` in the port): both sides run the
# lerps and their backward in bf16 and add hundreds of terms into each table
# entry in bf16, each in its own order, so they are held to 5e-2
BF16_PATH_REL = 5e-2
# table gradient against a Pallas backward kernel: the JAX package rounds
# the gradient of its staged table to bf16 (2^-9 per entry) before the
# un-staging sums up to W staged entries of mixed sign into one table entry;
# the port keeps float32
PALLAS_DTABLE_REL = 1.5e-2
# site output, plain bf16 path against a Pallas kernel that lerps in float32
# and rounds p before normalising (2^-8 each)
SITE_OUT_REL = 5e-3


def _t(x, grad=False):
    t = torch.from_numpy(np.array(x))
    return t.requires_grad_() if grad else t


def _inputs(seed, B, G, Hpg, H, W, d, ch, pos_range=0.95, table_std=0.05):
    rng = np.random.default_rng(seed)
    N = (H // 2) * W * d
    arrays = (
        rng.standard_normal((B, G, Hpg, H * W, ch)) * 0.5,
        rng.standard_normal((B, G, Hpg, N, ch)) * 0.5,
        rng.standard_normal((B, G, Hpg, N, ch)) * 0.5,
        rng.uniform(-pos_range, pos_range, (B, G, N, 2)),
        rng.standard_normal((G, Hpg, 2 * H - 1, 2 * W * d - 1)) * table_std,
    )
    return [a.astype(np.float32) for a in arrays]


def _assert_rel(got, ref, rel, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = np.abs(ref).max()
    assert scale > 0, name
    err = np.abs(got - ref).max()
    assert err <= rel * scale, f"{name}: {err / scale:.3g} > {rel}"


def _cotangent(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---- (a) the bias ---------------------------------------------------------

def _jax_bias_grads(table, k_pos, H, W, ct, **kw):
    def f(tb, kp):
        bias, n = jda._lattice_bias_nm(tb, kp, H, W, **kw)
        return bias[:, :, :, :n]
    out, vjp = jax.vjp(f, jnp.asarray(table), jnp.asarray(k_pos))
    grads = vjp(jnp.asarray(ct).astype(out.dtype))
    return np.asarray(out.astype(jnp.float32)), [np.asarray(g) for g in grads]


def test_bias_gradients_match_jax_f32():
    """float32 lerps in both: the XLA path (``use_kernel=False``)."""
    *_, k_pos, table = _inputs(0, 2, 2, 2, 8, 8, 2, 4, pos_range=1.5)
    ct = _cotangent(1, (2, 2, 2, 64, 64))
    ref, (jdt, jdp) = _jax_bias_grads(table, k_pos, 8, 8, ct,
                                      compute_dtype=jnp.float32,
                                      use_kernel=False)
    t, p = _t(table, True), _t(k_pos, True)
    out = tda.lattice_bias_plain(t, p, 8, 8, torch.float32)
    dt, dp = torch.autograd.grad(out, (t, p), _t(ct))
    _assert_rel(out.detach(), ref, F32_REL, "bias")
    _assert_rel(dt, jdt, F32_REL, "dtable")
    _assert_rel(dp, jdp, F32_REL, "dk_pos")


def test_bias_gradients_match_jax_bf16():
    """The CPU route of ``lattice_bias`` (bf16 lerps under autograd) against
    JAX autodiff through its bf16 XLA path."""
    *_, k_pos, table = _inputs(2, 2, 2, 2, 8, 8, 2, 4)
    ct = _cotangent(3, (2, 2, 2, 64, 64))
    _, (jdt, jdp) = _jax_bias_grads(table, k_pos, 8, 8, ct, use_kernel=False)
    t, p = _t(table, True), _t(k_pos, True)
    dt, dp = torch.autograd.grad(tda.lattice_bias(t, p, 8, 8), (t, p), _t(ct))
    _assert_rel(dt, jdt, BF16_PATH_REL, "dtable")
    _assert_rel(dp, jdp, BF16_PATH_REL, "dk_pos")


def test_bias_gradients_match_pallas_backward():
    """The Pallas forward and backward kernels in interpret mode (bf16
    staged table, float32 lerps, the staged gradient rounded to bf16 before
    un-staging) against the plain version the CUDA kernels are held to:
    autograd through float32 lerps on the bf16-rounded table."""
    *_, k_pos, table = _inputs(4, 1, 2, 2, 8, 8, 1, 4)
    N = 32
    # the kernel's output, and so its cotangent, is bf16
    ct = _t(_cotangent(5, (1, 2, 2, N, 64))).bfloat16().float().numpy()
    ref, (jdt, jdp) = _jax_bias_grads(table, k_pos, 8, 8, ct,
                                      use_kernel=True, interpret=True)
    t = _t(table).bfloat16().float().requires_grad_()
    p = _t(k_pos, True)
    out = tda.lattice_bias_plain(t, p, 8, 8, torch.float32)
    dt, dp = torch.autograd.grad(out, (t, p), _t(ct))
    _assert_rel(out.detach(), ref, BF16_REL, "bias")
    _assert_rel(dt, jdt, PALLAS_DTABLE_REL, "dtable")
    _assert_rel(dp, jdp, 1e-4, "dk_pos")      # float32 on both sides


def _odd_lattice_inputs(seed, H):
    """A pyramid-like site at BEV H (7 or 14: M = 49 or 196, not multiples
    of 8), G = 2 groups of 2 heads, an SCA key plane of ceil(H / 2) x H x 2
    keys, positions past the table edge (clipped windows)."""
    rng = np.random.default_rng(seed)
    N = ((H + 1) // 2) * H * 2
    table = rng.standard_normal((2, 2, 2 * H - 1, 4 * H - 1)) * 0.05
    k_pos = rng.uniform(-1.3, 1.3, (1, 2, N, 2))
    ct = _t(_cotangent(seed + 1, (1, 2, 2, N, H * H))).bfloat16().float()
    return table.astype(np.float32), k_pos.astype(np.float32), ct.numpy()


@pytest.mark.parametrize("H,staging", [(7, "1"), (7, "0"), (14, "1"),
                                       (14, "0")])
def test_odd_lattice_bias_matches_pallas(monkeypatch, H, staging):
    """The bias at BEV 7 and 14 against the Pallas kernels in interpret
    mode under both stagings: the shift-replicated one (``_fwd_call_sh`` /
    ``_bwd_call_sh``, rows 1 and 3 of the kernel table) and the resolve one
    that the JAX package takes at its wide sites (``_fwd_call`` /
    ``_bwd_call``, rows 4 and 6). The port's side is the plain version the
    CUDA kernels of both routes are held to; tolerances as
    test_bias_gradients_match_pallas_backward."""
    monkeypatch.setenv("BEVRENDER_SHIFT_REPLICA", staging)
    table, k_pos, ct = _odd_lattice_inputs(30 + H, H)
    assert jda.use_shift_replica(table.shape, H, H) == (staging == "1")
    ref, (jdt, jdp) = _jax_bias_grads(table, k_pos, H, H, ct,
                                      use_kernel=True, interpret=True)
    t = _t(table).bfloat16().float().requires_grad_()
    p = _t(k_pos, True)
    out = tda.lattice_bias_plain(t, p, H, H, torch.float32)
    dt, dp = torch.autograd.grad(out, (t, p), _t(ct))
    _assert_rel(out.detach(), ref, BF16_REL, "bias")
    _assert_rel(dt, jdt, PALLAS_DTABLE_REL, "dtable")
    _assert_rel(dp, jdp, 1e-4, "dk_pos")


@pytest.mark.parametrize("H", [7, 14])
def test_odd_lattice_bias_matches_jax_bf16(H):
    """The CPU route of ``lattice_bias`` at BEV 7 and 14 against JAX
    autodiff through its bf16 XLA path (``use_kernel=False``)."""
    table, k_pos, ct = _odd_lattice_inputs(40 + H, H)
    ref, (jdt, jdp) = _jax_bias_grads(table, k_pos, H, H, ct, use_kernel=False)
    t, p = _t(table, True), _t(k_pos, True)
    out = tda.lattice_bias(t, p, H, H)
    dt, dp = torch.autograd.grad(out, (t, p), _t(ct))
    _assert_rel(out.detach(), ref, BF16_REL, "bias")
    _assert_rel(dt, jdt, BF16_PATH_REL, "dtable")
    _assert_rel(dp, jdp, BF16_PATH_REL, "dk_pos")


# ---- (b) the non-fused site ----------------------------------------------

@pytest.mark.parametrize("ch", [4, 16])
def test_site_gradients_match_site_xla(ch):
    arrays = _inputs(6, 2, 2, 2, 8, 8, 2, ch)
    ct = _cotangent(7, arrays[0].shape)
    ref, vjp = jax.vjp(
        lambda *a: jda._site_xla(*a, 8, 8, scale=ch ** -0.5, use_kernel=False),
        *map(jnp.asarray, arrays))
    jgrads = vjp(jnp.asarray(ct))
    ts = [_t(a, True) for a in arrays]
    out = tda.streamed_deform_attention(*ts, 8, 8, scale=ch ** -0.5,
                                        fuse_site=False)
    grads = torch.autograd.grad(out, ts, _t(ct))
    _assert_rel(out.detach(), ref, 2e-3, "out")
    for name, g, jg in zip(("dq", "dk", "dv", "dk_pos", "dtable"), grads, jgrads):
        _assert_rel(g, jg, BF16_REL if name in ("dq", "dk", "dv")
                    else BF16_PATH_REL, name)


# ---- (c) the fused training site -------------------------------------------

@pytest.mark.parametrize("ch", [4, 8])
def test_fused_train_site_matches_pallas(ch):
    """The plain version that the CUDA training site is held to (autograd
    through ``site_plain`` with float32 lerps on the bf16-rounded table)
    against the Pallas forward with logsumexp and the Pallas flash
    backward, both in interpret mode. On CPU tensors ``fused_site_train``
    is ``site_plain`` itself (test_torch_kernels.py)."""
    arrays = _inputs(8, 1, 2, 2, 8, 8, 1, ch)
    scale = ch ** -0.5
    ct = _cotangent(9, arrays[0].shape)
    jargs = list(map(jnp.asarray, arrays))
    ref, vjp = jax.vjp(
        lambda *a: jda.fused_site_attention_train(*a, 8, 8, scale, True), *jargs)
    jgrads = vjp(jnp.asarray(ct))
    jlse = jda._fused_site_train_fwd_impl(*jargs, 8, 8, scale, True)[1][-1]
    ts = [_t(a, True) for a in arrays[:4]]
    ts.append(_t(arrays[4]).bfloat16().float().requires_grad_())
    out, lse = tda.site_plain_lse(*ts, 8, 8, scale, torch.float32)
    grads = torch.autograd.grad(out, ts, _t(ct))
    _assert_rel(out.detach(), ref, SITE_OUT_REL, "out")
    for name, g, jg in zip(("dq", "dk", "dv", "dk_pos", "dtable"), grads, jgrads):
        _assert_rel(g, jg, PALLAS_DTABLE_REL if name == "dtable" else BF16_REL,
                    name)
    lse = lse.detach()
    assert lse.shape == (1, 2, 2, 64)
    # logsumexp of scores of order 1: bf16-rounded q, k and table in both,
    # float32 after that
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-4, rtol=0)


# ---- (d) sampling ---------------------------------------------------------

def test_grid_sample_gradients_match_jax():
    rng = np.random.default_rng(10)
    img = rng.standard_normal((3, 9, 11, 5)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (3, 7, 4, 2)).astype(np.float32)
    ct = _cotangent(11, (3, 7, 4, 5))
    _, vjp = jax.vjp(jgs.grid_sample_2d_mm, jnp.asarray(img), jnp.asarray(grid))
    jdi, jdg = vjp(jnp.asarray(ct))
    ti, tg = _t(img, True), _t(grid, True)
    di, dg = torch.autograd.grad(tgs.grid_sample_2d(ti, tg), (ti, tg), _t(ct))
    _assert_rel(di, jdi, F32_REL, "dimg")
    _assert_rel(dg, jdg, 1e-4, "dgrid")  # divided differences of the image


def test_ego_warp_gradient_matches_jax():
    rng = np.random.default_rng(12)
    bev = rng.standard_normal((2, 12, 12, 6)).astype(np.float32)
    pose = np.stack([rng.uniform(90, 110, (2, 2)), rng.uniform(190, 210, (2, 2)),
                     rng.uniform(-0.5, 0.5, (2, 2))], axis=-1).astype(np.float32)
    ct = _cotangent(13, bev.shape)
    _, vjp = jax.vjp(lambda b: jego.project_history_bev(b, jnp.asarray(pose)),
                     jnp.asarray(bev))
    (jdb,) = vjp(jnp.asarray(ct))
    tb = _t(bev, True)
    (db,) = torch.autograd.grad(tego.project_history_bev(tb, _t(pose)), tb,
                                _t(ct))
    _assert_rel(db, jdb, F32_REL, "dbev")


# ---- (e) the backward kernel's mirror -------------------------------------

def test_site_bwd_online_within_rounding_bound():
    arrays = _inputs(14, 2, 1, 2, 8, 8, 1, 4, table_std=0.01)
    q, k, v, k_pos, table = map(_t, arrays)
    scale = 0.5
    dout = _t(_cotangent(15, q.shape))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, k_pos)]
    tb = table.bfloat16().float().requires_grad_()
    out, lse = tda.site_plain_lse(*leaves, tb, 8, 8, scale, torch.float32)
    ref = torch.autograd.grad(out, leaves + [tb], dout)
    dq, dk, dv, dt, dp = tda.site_bwd_online(
        q, k, v, k_pos, table, 8, 8, scale, dout, lse.detach(),
        (dout * out.detach()).sum(-1))
    for name, g, r in zip(("dq", "dk", "dv", "dk_pos", "dtable"),
                          (dq, dk, dv, dp, dt), ref):
        _assert_rel(g, r, BF16_REL, name)


# ---- (f) remat, and the dense oracle --------------------------------------

@pytest.mark.parametrize("fused_bwd", [False, True])
def test_remat_does_not_change_gradients(fused_bwd):
    """The site's output and gradients are the same bits under each
    ``site_remat`` mode ("dots" saves the products the other two recompute
    or keep); an unknown mode raises."""
    arrays = _inputs(16, 2, 2, 2, 8, 8, 2, 4)
    ct = _t(_cotangent(17, arrays[0].shape))
    got = {}
    for mode in tda.SITE_REMAT_MODES:
        ts = [_t(a, True) for a in arrays]
        out = tda.streamed_deform_attention(
            *ts, 8, 8, scale=0.5, fuse_site=False, fused_bwd=fused_bwd,
            site_remat=mode)
        got[mode] = [out.detach()] + list(torch.autograd.grad(out, ts, ct))
    assert tda.SITE_REMAT_MODES == ("nothing", "dots", "none")
    for mode in ("dots", "none"):
        for a, b in zip(got["nothing"], got[mode]):
            assert torch.equal(a, b), mode
    with pytest.raises(ValueError, match="site_remat"):
        tda.streamed_deform_attention(*map(_t, arrays), 8, 8, scale=0.5,
                                      fuse_site=False, site_remat="all")


def _kept_bytes(fn):
    """Bytes of the tensors that ``fn()`` makes and that outlive it, its
    output's storage aside: what a forward keeps for its backward.
    ``torch.utils.checkpoint`` packs what it saves under hooks of its own,
    where an outer ``saved_tensors_hooks`` does not see it, so the count
    follows every tensor the forward's operations return instead."""
    made = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            made.extend(weakref.ref(t) for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor))
            return out

    with Record():
        out = fn()
    gc.collect()
    own = out.untyped_storage().data_ptr()
    alive = {}
    for ref in made:
        t = ref()
        if t is not None and t.untyped_storage().data_ptr() != own:
            alive[t.untyped_storage().data_ptr()] = \
                t.untyped_storage().nbytes()
    return out, sum(alive.values())


def test_remat_modes_keep_more_in_order():
    """"nothing" keeps (almost) nothing of the site for the backward,
    "dots" the scores product (B G Hpg N M float32), "none" every residual
    autograd wants; the gradients agree bit for bit."""
    arrays = _inputs(24, 2, 2, 2, 8, 8, 2, 4)
    kept, grads = {}, {}
    for mode in tda.SITE_REMAT_MODES:
        ts = [_t(a, True) for a in arrays]
        out, kept[mode] = _kept_bytes(lambda: tda.streamed_deform_attention(
            *ts, 8, 8, scale=0.5, fuse_site=False, site_remat=mode))
        grads[mode] = torch.autograd.grad(out, ts, torch.ones_like(out))
    scores = 2 * 2 * 2 * 64 * 64 * 4
    assert kept["nothing"] < kept["dots"] < kept["none"], kept
    # on the card "dots" recomputes the bias kernel as "nothing" does
    q_shape, t_shape = arrays[0].shape, arrays[4].shape
    launches = {m: tda.site_kernels(q_shape, t_shape, 8, 8,
                                    tda.SiteOptions(site_remat=m), True)
                for m in tda.SITE_REMAT_MODES}
    assert launches == {
        "nothing": ("lattice_bias", "lattice_bias", "lattice_bias_bwd"),
        "dots": ("lattice_bias", "lattice_bias", "lattice_bias_bwd"),
        "none": ("lattice_bias", "lattice_bias_bwd")}
    assert kept["nothing"] < scores <= kept["dots"], kept
    for mode in ("dots", "none"):
        assert all(torch.equal(a, b)
                   for a, b in zip(grads["nothing"], grads[mode]))


def test_dots_remat_matches_jax_dots(monkeypatch):
    """The chunked (float32) path under "dots" against the JAX package's
    under BEVRENDER_SITE_REMAT=dots (read at trace time; each eager call
    traces afresh): output and every gradient to 1e-5."""
    monkeypatch.setenv("BEVRENDER_SITE_REMAT", "dots")
    arrays = _inputs(26, 2, 2, 2, 8, 8, 2, 4, pos_range=1.3)
    q_pos = _q_pos(8, 8).numpy()
    ct = _cotangent(27, arrays[0].shape)

    def jfn(q, k, v, kp, tb):
        return jda.streamed_deform_attention(
            q, k, v, jnp.asarray(q_pos), kp, tb, scale=0.5, chunk=24)
    ref, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    jgrads = vjp(jnp.asarray(ct))
    ts = [_t(a, True) for a in arrays]
    out = tda.chunked_deform_attention(ts[0], ts[1], ts[2], _t(q_pos), ts[3],
                                       ts[4], scale=0.5, chunk=24,
                                       site_remat="dots")
    grads = torch.autograd.grad(out, ts, _t(ct))
    _assert_rel(out.detach(), ref, F32_REL, "out")
    for name, g, jg in zip(("dq", "dk", "dv", "dk_pos", "dtable"), grads,
                           jgrads):
        _assert_rel(g, jg, F32_REL, name)


def test_attention_dropout_is_seeded_and_remat_safe():
    """Dropout takes the plain consumer; the mask is drawn once, outside the
    recomputed region, so remat on and off agree under one seed."""
    arrays = _inputs(18, 2, 1, 2, 8, 8, 1, 4)
    ct = _t(_cotangent(19, arrays[0].shape))
    got = []
    for mode, seed in (("nothing", 5), ("none", 5), ("none", 6)):
        ts = [_t(a, True) for a in arrays]
        out = tda.streamed_deform_attention(
            *ts, 8, 8, scale=0.5, fuse_site=False, fused_bwd=True,
            site_remat=mode, dropout_rate=0.3,
            generator=torch.Generator().manual_seed(seed))
        got.append([out.detach()] + list(torch.autograd.grad(out, ts, ct)))
    assert all(torch.equal(a, b) for a, b in zip(got[0], got[1]))
    assert not torch.equal(got[1][0], got[2][0])


def _q_pos(H, W):
    return tgs.normalized_grid(H, W).reshape(H * W, 2)


def test_dense_reference_and_chunked_path_match_jax():
    arrays = _inputs(20, 2, 2, 2, 8, 8, 2, 4, pos_range=1.3)
    q_pos = _q_pos(8, 8).numpy()
    ct = _cotangent(21, arrays[0].shape)
    q, k, v, k_pos, table = arrays

    def jfn(q, k, v, kp, tb):
        return jda.dense_deform_attention_reference(
            q, k, v, jnp.asarray(q_pos), kp, tb, scale=0.5)
    ref, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    jgrads = vjp(jnp.asarray(ct))
    for chunk in (None, 24):  # 24 does not divide M = 64
        ts = [_t(a, True) for a in arrays]
        if chunk is None:
            out = tda.dense_deform_attention_reference(
                ts[0], ts[1], ts[2], _t(q_pos), ts[3], ts[4], scale=0.5)
        else:
            out = tda.chunked_deform_attention(
                ts[0], ts[1], ts[2], _t(q_pos), ts[3], ts[4], scale=0.5,
                chunk=chunk)
        grads = torch.autograd.grad(out, ts, _t(ct))
        _assert_rel(out.detach(), ref, F32_REL, "out")
        for name, g, jg in zip(("dq", "dk", "dv", "dk_pos", "dtable"), grads,
                               jgrads):
            _assert_rel(g, jg, 5e-5, name)
    jl = jda._bilinear_table_lookup(
        jnp.asarray(table), jnp.asarray(
            0.5 * (q_pos[None, None, :, None] - k_pos[:, :, None])))
    tl = tda.bilinear_table_lookup(
        _t(table), 0.5 * (_t(q_pos)[None, None, :, None] - _t(k_pos)[:, :, None]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-7, rtol=0)


def test_lattice_bias_gradient_matches_dense_lookup():
    """Inside the table the lattice bias is the bilinear lookup, and so is
    its gradient (float32 lerps)."""
    *_, k_pos, table = _inputs(22, 2, 1, 2, 8, 8, 2, 4, pos_range=0.98)
    ct = _t(_cotangent(23, (2, 1, 2, 64, 64)))
    t1, p1 = _t(table, True), _t(k_pos, True)
    g1 = torch.autograd.grad(tda.lattice_bias_plain(t1, p1, 8, 8, torch.float32),
                             (t1, p1), ct)
    t2, p2 = _t(table, True), _t(k_pos, True)
    disp = 0.5 * (_q_pos(8, 8)[None, None, :, None] - p2[:, :, None])
    dense = tda.bilinear_table_lookup(t2, disp).transpose(-1, -2)
    g2 = torch.autograd.grad(dense, (t2, p2), ct)
    _assert_rel(g1[0], g2[0], 1e-4, "dtable")
    _assert_rel(g1[1], g2[1], 1e-3, "dk_pos")
