"""The windowed bias of the port (``ModelConfig.bias_forward="windows"``)
on the CPU: the plain versions of the window kernels against the JAX
package's Pallas kernels in interpret mode (``lattice_win.py``: the window
extraction and the scatter-add of its custom VJP), the windowed bias
against the JAX package's ``_lattice_bias`` (whose ``use_kernel=True`` it
is; on the CPU the JAX package takes its XLA slices, the same function),
the tiny slice on that route (a render and one training step, bridged
weights), and the kernel choice: the windows route and the head widths
without a fused site.

Inputs are made with numpy from a seed and fed to both frameworks. The CUDA
kernels themselves are held against the same plain versions in
test_torch_kernels.py on the card.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_windows.py -q
"""

import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevrender_tpu.config import Config as JConfig
from bevrender_tpu.config import tiny_model_config as j_tiny
from bevrender_tpu.inference.register import RegistrationPipeline as JPipeline
from bevrender_tpu.models.bevrender import BEVRenderModel
from bevrender_tpu.ops import deform_attn as jda
from bevrender_tpu.ops.pallas.lattice_win import lattice_windows
from bevrender_tpu.training.trainer import Trainer as JTrainer
from bevrender_tpu_torch import config as tcfg
from bevrender_tpu_torch.convert import flax_to_state_dict
from bevrender_tpu_torch.data import prefetch as tprefetch
from bevrender_tpu_torch.data.synthetic import SyntheticDataset
from bevrender_tpu_torch.inference.register import RegistrationPipeline
from bevrender_tpu_torch.models.attention import _Site
from bevrender_tpu_torch.ops import deform_attn as tda
from bevrender_tpu_torch.ops.kernels import lattice_windows as tlw
from bevrender_tpu_torch.training.trainer import Trainer

# as tests/test_torch_grads.py: the bias value through bf16 paths, as a
# share of its largest entry, and gradients that flow through the bf16 XLA
# bias path of the JAX package (bf16 lerps, bf16 sums in another order)
BF16_REL = 8e-3
BF16_PATH_REL = 5e-2
# as tests/test_torch_slice.py: renders in [0, 1], where a flipped bf16
# rounding at a site moves the render by up to ~2e-3
RENDER_TOL = 5e-3
# as tests/test_torch_trainer.py, step 1 from bridged weights: losses to
# 1e-5, the global gradient norm to 3e-3 (the sites' bf16 flips), every
# parameter to 1e-5 of its largest entry plus 0.2 of the learning rate
# (tensors near zero inherit the gradients' bf16 noise through Adam's
# division), BatchNorm statistics to 5e-4
GRAD_NORM_REL = 3e-3
LR = 1e-4
STAT_REL = 5e-4

BF16 = {"float32": (torch.float32, jnp.float32),
        "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _site_inputs(seed, H, B=2, G=2, Hpg=2, d=2, N=50):
    """A table (G, Hpg, 2H - 1, 2 W d - 1) and key positions reaching past
    the table's edge, so that some windows are clipped."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((G, Hpg, 2 * H - 1, 2 * H * d - 1)) * 0.05
    k_pos = rng.uniform(-2.2, 2.2, (B, G, N, 2))
    return table.astype(np.float32), k_pos.astype(np.float32)


def _jax_t3(table, W, dtype):
    """T3 as ``_lattice_bias`` builds it (deform_attn.py:131-145), in
    numpy: the padded head-minor table, per query column the m_max columns
    from its start, (G, Y, m_max, W * Hpg)."""
    G, Hpg, Ht, _ = table.shape
    u0, _, m_max, pad = jda._static_comb(table.shape, W)
    tp = np.pad(np.transpose(table.astype(dtype), (0, 2, 3, 1)),
                ((0, 0), (pad, pad), (pad, max(pad, m_max)), (0, 0)))
    t3 = np.stack([tp[:, :, u0[ix]:u0[ix] + m_max, :] for ix in range(W)],
                  axis=2)  # (G, Y, W, m_max, Hpg)
    return np.transpose(t3, (0, 1, 3, 2, 4)).reshape(G, Ht + 2 * pad, m_max,
                                                    W * Hpg)


def _windows_case(seed, H, dtype):
    """The port's t3 of a real table in ``dtype`` (checked against the JAX
    package's construction) and the clipped starts of real key positions
    (checked against the JAX package's geometry)."""
    table, k_pos = _site_inputs(seed, H)
    tdt, jdt = BF16[dtype]
    t3 = tda.lattice_t3(_t(table), H, tdt)
    ref = _jax_t3(np.asarray(jnp.asarray(table).astype(jdt)), H, jdt)
    np.testing.assert_array_equal(t3.float().numpy(),
                                  np.asarray(ref, np.float32))
    ys, ms, _, _ = tda.lattice_geometry(table.shape, _t(k_pos), H, H)
    jys, jms = jda._lattice_geometry(table.shape, jnp.asarray(k_pos), H, H)[:2]
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
    np.testing.assert_array_equal(ms.numpy(), np.asarray(jms))
    # windows clipped at both ends of both axes
    Y, m_max = t3.shape[1:3]
    assert int(ys.min()) == 0 and int(ys.max()) == Y - (H + 1)
    assert int(ms.min()) == 0 and int(ms.max()) == m_max - 3
    return t3, ys, ms, jnp.asarray(t3.float().numpy()).astype(jdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [8, 7])
def test_windows_plain_matches_pallas(H, dtype):
    """``lattice_windows_plain`` against the Pallas window extraction (#14,
    ``_lattice_windows_fwd_impl``) in interpret mode: the same copies,
    exactly, in the kernel's m-major layout."""
    t3, ys, ms, t3j = _windows_case(10 + H, H, dtype)
    got = tlw.lattice_windows_plain(t3, ys, ms, H + 1)
    ref = lattice_windows(t3j, jnp.asarray(ys.numpy()), jnp.asarray(ms.numpy()),
                          H + 1, True)
    assert got.shape == ref.shape == (2, 2, 50, 3, H + 1, 2 * H)
    assert got.dtype == t3.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [8, 7])
def test_windows_bwd_plain_matches_pallas_vjp(H, dtype):
    """``lattice_windows_bwd_plain`` against ``jax.vjp`` of the Pallas
    function (its backward is the scatter-add kernel #15,
    ``_lattice_windows_bwd``) in interpret mode. Both add every window's
    cotangent in float32, in another order, and cast to t3's dtype: in
    float32 within 1e-6 of the largest entry; in bf16 within one bf16 ulp
    of each entry (a last-bit difference of the float32 sum can flip its
    rounding)."""
    t3, ys, ms, t3j = _windows_case(20 + H, H, dtype)
    tdt, jdt = BF16[dtype]
    rng = np.random.default_rng(30 + H)
    gout = _t(rng.standard_normal((2, 2, 50, 3, H + 1, 2 * H))).to(tdt)
    _, vjp = jax.vjp(lambda t: lattice_windows(
        t, jnp.asarray(ys.numpy()), jnp.asarray(ms.numpy()), H + 1, True), t3j)
    (ref,) = vjp(jnp.asarray(gout.float().numpy()).astype(jdt))
    got = tlw.lattice_windows_bwd_plain(gout, ys, ms, t3.shape, tdt)
    assert got.dtype == tdt and got.shape == t3.shape
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    assert np.abs(ref).max() > 0
    if dtype == "float32":
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    else:
        np.testing.assert_array_less(
            np.abs(got - ref), np.maximum(np.abs(got), np.abs(ref)) * 2.0 ** -7
            + 1e-30)


@pytest.mark.parametrize("H", [8, 7])
def test_windowed_bias_matches_jax(H):
    """``lattice_bias_windowed`` (on CPU tensors: the plain windows in the
    autograd function that carries the kernels on the card) against the
    JAX package's ``_lattice_bias_nm(use_kernel=False)``, which on the CPU
    computes what ``use_kernel=True`` computes on a TPU: the bias, and the
    gradients with respect to the table and the key positions."""
    table, k_pos = _site_inputs(40 + H, H)
    ct = np.random.default_rng(41 + H).standard_normal(
        (2, 2, 2, 50, H * H)).astype(np.float32)

    def f(tb, kp):
        bias, n = jda._lattice_bias_nm(tb, kp, H, H, use_kernel=False)
        return bias[:, :, :, :n]

    ref, vjp = jax.vjp(f, jnp.asarray(table), jnp.asarray(k_pos))
    jdt, jdp = (np.asarray(g) for g in vjp(jnp.asarray(ct)))
    t, p = _t(table).requires_grad_(), _t(k_pos).requires_grad_()
    out = tda.lattice_bias_windowed(t, p, H, H)
    dt, dp = torch.autograd.grad(out, (t, p), _t(ct))
    for name, got, want, rel in (("bias", out.detach(), ref, BF16_REL),
                                 ("dtable", dt, jdt, BF16_PATH_REL),
                                 ("dk_pos", dp, jdp, BF16_PATH_REL)):
        got, want = got.numpy(), np.asarray(want, np.float32)
        assert got.shape == want.shape, name
        assert np.abs(want).max() > 0, name
        assert np.abs(got - want).max() <= rel * np.abs(want).max(), name
    # the windows are copies: the same bias as the plain bias, bit for bit
    assert torch.equal(out, tda.lattice_bias_plain(_t(table), _t(k_pos), H, H))
    # the plain bias adds the gradient of the t3 gather up in bf16 in the
    # two stages the JAX package's XLA path does (the windows into t3, t3's
    # columns into the padded table): its table gradient is JAX's exactly
    t2 = _t(table).requires_grad_()
    (dt2,) = torch.autograd.grad(
        tda.lattice_bias_plain(t2, _t(k_pos), H, H), t2, _t(ct))
    np.testing.assert_array_equal(dt2.numpy(), jdt)


# ---- the tiny slice with the field on --------------------------------------

def _count_windows(monkeypatch):
    """Count the calls of ``ops.deform_attn.lattice_windows`` (the windows of
    every windowed bias)."""
    calls = []
    real = tda.lattice_windows

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(tda, "lattice_windows", spy)
    return calls


@functools.lru_cache(maxsize=None)
def _render_setup():
    """JAX pipeline and the port's with ``bias_forward="windows"`` and
    without, on a
    tiny model whose stage 0 has head width 2 (no fused-site instance: the
    bias route) and stage 1 head width 4 (the fused site), one batch. (At
    width 32 with head width 16 the tiny model's render saturates and
    parts from JAX's by 0.1 with or without the field.)"""
    heads = dict(n_heads=(4, 2))
    jcfg, pcfg, plain = JConfig(), tcfg.Config(), tcfg.Config()
    jcfg.model = j_tiny(**heads)
    jcfg.data.window_num_imgs = 1
    pcfg.model = tcfg.tiny_model_config(bias_forward="windows", **heads)
    plain.model = tcfg.tiny_model_config(**heads)
    batch = SyntheticDataset(n_items=2, num_views=2, window_num_imgs=1,
                             img_height=32, img_width=32, map_tile=32).batch(2)
    variables = BEVRenderModel(jcfg).init(jax.random.PRNGKey(0), batch)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    state = flax_to_state_dict(variables)
    return (JPipeline(jcfg, variables),
            RegistrationPipeline(pcfg, state, device="cpu"),
            RegistrationPipeline(plain, state, device="cpu"), batch)


def test_windowed_render_matches_jax(monkeypatch):
    """The tiny pipeline with ``bias_forward="windows"`` renders what the
    JAX package
    renders, to RENDER_TOL, through the windowed bias at every bias site
    (stage 0: TSA and one SCA per view, in the history pass and the final
    one of the two frames) and the same render as without the field (on the
    CPU the windows are the plain copies)."""
    jpipe, tpipe, plain, batch = _render_setup()
    assert {s.site_options.bias_forward for s in tpipe.net.modules()
            if isinstance(s, _Site)} == {"windows"}
    calls = _count_windows(monkeypatch)
    render = tpipe.render(batch)
    assert len(calls) == 6
    np.testing.assert_allclose(render.numpy(), np.asarray(jpipe.render(batch)),
                               atol=RENDER_TOL, rtol=0)
    assert torch.equal(render, plain.render(batch))


def test_windowed_train_step_matches_jax(monkeypatch):
    """One ``Trainer`` step of the tiny model with ``bias_forward=
    "windows"`` (MSE +
    contrastive loss, AdamW's eps at 1e-3 where the update is smooth in the
    gradient) from bridged weights against the JAX trainer's step, at the
    step-1 tolerances of tests/test_torch_trainer.py. The final pass takes
    the bias at all 6 sites (head width 4 without ``fused_bwd``), each
    forward twice under ``site_remat="nothing"`` (the history pass takes the
    fused site); the table gradient comes back through the windows'
    scatter-add."""
    jcfg, pcfg = JConfig(), tcfg.Config()
    jcfg.model = j_tiny()
    pcfg.model = tcfg.tiny_model_config(bias_forward="windows")
    jcfg.data.window_num_imgs = 1
    work = tempfile.mkdtemp()
    for c in (jcfg.train, pcfg.train):
        c.batch_size, c.loss_type, c.eps, c.work_dir = (
            2, "MSE_CONTRASTIVE", 1e-3, work)
    ds = SyntheticDataset(n_items=8, num_views=2, window_num_imgs=1,
                          img_height=32, img_width=32, map_tile=32)
    jtrainer = JTrainer(BEVRenderModel(jcfg), jcfg, ds)
    jstate = jtrainer.create_state(jax.random.PRNGKey(0), ds.batch(2))
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    ttrainer = Trainer(pcfg, ds, device="cpu")
    tstate = ttrainer.create_state(state_dict=flax_to_state_dict(np_tree(
        {"params": jstate.params, "batch_stats": jstate.batch_stats})))
    batch = tprefetch.collate([ds[0], ds[1]])
    jstate, jm, jrender = jtrainer._train_step(
        jax.tree_util.tree_map(jnp.copy, jstate),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
    calls = _count_windows(monkeypatch)
    tstate, tm, trender = ttrainer.train_step(tstate, batch, rng=1)
    assert len(calls) == 12
    for key in ("train_batch_loss", "camera_encoder_grad_norm",
                "train_batch_render_loss", "train_batch_retrieval_loss"):
        rel = GRAD_NORM_REL if key == "camera_encoder_grad_norm" else 1e-5
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=rel,
                                   atol=0, err_msg=key)
    np.testing.assert_allclose(trender.numpy(), np.asarray(jrender),
                               atol=RENDER_TOL, rtol=0)
    ref = flax_to_state_dict(np_tree({"params": jstate.params,
                                      "batch_stats": jstate.batch_stats}))
    got = tstate.net.state_dict()
    assert got.keys() == ref.keys()
    for name, r in ref.items():
        if name.endswith("num_batches_tracked"):
            continue
        scale, err = float(r.abs().max()), float((got[name] - r).abs().max())
        if "running_" in name:
            assert err <= STAT_REL * max(scale, 1e-2), name
        else:
            assert err <= 1e-5 * scale + 0.2 * LR, name


# ---- the kernel choice -----------------------------------------------------

TABLE = (2, 2, 55, 279)  # the flagship's SCA table at G = 2


@pytest.mark.parametrize("ch", [1, 2, 3, 6])
def test_head_widths_without_a_fused_site_take_the_bias(ch):
    """The fused-site kernels have instances for head widths 4 and 8 only;
    a site of another width up to 8 takes the bias with the plain consumer,
    in eval and in training, with and without ``fused_bwd``, on both
    routes (a route of the shapes, which the launch counts show)."""
    q = (2, 2, 2, 784, ch)
    for route in tda.LATTICE_ROUTES:
        bias = "lattice_bias" if route == "auto" else "lattice_bias_wide"
        for fused_bwd in (False, True):
            opts = tda.SiteOptions(lattice_route=route, fused_bwd=fused_bwd)
            assert tda.site_kernels(q, TABLE, 28, 28, opts,
                                    training=False) == (bias,)
            assert tda.site_kernels(q, TABLE, 28, 28, opts, training=True) \
                == (bias, bias, f"{bias}_bwd")
        opts = tda.SiteOptions(lattice_route=route, bias_forward="windows")
        assert tda.site_kernels(q, TABLE, 28, 28, opts, training=False) == (
            "lattice_windows",)


def test_bias_windows_route_and_options():
    """``bias_forward="windows"`` names the window kernels at every site
    that takes
    the bias, on either route and whatever the table's size (they need no
    shared memory): the forward in eval; under ``site_remat`` "nothing"
    the forward twice and the backward, under "none" once each. Fused
    sites do not change. The field takes one of its three values; the
    config hands it to every site."""
    wide_table = (1, 2, 111, 559)  # the pyramid's SCA at BEV 56
    for route in tda.LATTICE_ROUTES:
        for table, H in ((TABLE, 28), (wide_table, 56)):
            q = (2, table[0], 2, H * H, 32)
            opts = tda.SiteOptions(lattice_route=route, bias_forward="windows")
            assert tda.site_kernels(q, table, H, H, opts, training=False) == (
                "lattice_windows",)
            assert tda.site_kernels(q, table, H, H, opts, training=True) == (
                "lattice_windows", "lattice_windows", "lattice_windows_bwd")
            none = tda.SiteOptions(lattice_route=route, bias_forward="windows",
                                   site_remat="none")
            assert tda.site_kernels(q, table, H, H, none, training=True) == (
                "lattice_windows", "lattice_windows_bwd")
        fused = tda.SiteOptions(lattice_route=route, bias_forward="windows",
                                fused_bwd=True)
        want = tda.site_kernels((2, 2, 2, 784, 8), TABLE, 28, 28,
                                tda.SiteOptions(lattice_route=route,
                                                fused_bwd=True), True)
        assert tda.site_kernels((2, 2, 2, 784, 8), TABLE, 28, 28, fused,
                                training=True) == want
        assert want[-1] == "fused_site_bwd"
    with pytest.raises(ValueError, match="bias_forward"):
        tda.SiteOptions(bias_forward="window")
    mc = tcfg.tiny_model_config(bias_forward="windows")
    assert mc.site_options()["bias_forward"] == "windows"
    assert tcfg.ModelConfig().bias_forward == "kernel"
    assert tda.SiteOptions().bias_forward == "kernel"
    with pytest.raises(ValueError, match="bias_forward"):
        tda.SiteOptions(**tcfg.tiny_model_config(
            bias_forward=True).site_options())
