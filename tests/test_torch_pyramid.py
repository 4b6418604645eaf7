"""The pyramid (the reference default, BEV 56 -> 7 -> 56 at widths 64-512)
in the port, held against the JAX package on the CPU.

A tiny pyramid defined here has every part the reference default adds to
the uniform flagship: a 3x3 stride-2 transition to an odd BEV (14 -> 7), an
odd-height SCA key plane (4 x 7 x d), a 2x2 transposed-conv transition back
up (7 -> 14), ``img_width_fix1`` on the image features, the history
``prev_bev`` at stages 0 and 2 only, and the decoder from BEV 14. Its images
are 64 x 64: ``PatchProjection`` takes patch sizes 4, 8 and 16 and
64 // 14 = 4 (32 x 32 images would ask for 2).

Tolerances. The attention sites round K, Q, p, V and (on the CPU) the bias
lerps to bf16 in both frameworks; a float32 difference in the last bit can
flip one of those roundings, and the tiny pyramid at random weights
amplifies a flip: the JAX render itself moves by 4e-3 when its input moves
by one part in 1e6. So the model's wiring is held to float32 sites
(``f32_sites`` swaps the site functions of both frameworks for float32
ones): there the JAX render moves by 1.2e-5 under the same input change,
and the port is held to 3e-5 of it. The shipped bf16 sites are held to
twice JAX's own distance under that input change.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevrender_tpu.config import Config as JConfig
from bevrender_tpu.config import tiny_model_config as j_tiny
from bevrender_tpu.geometry import projection as jproj
from bevrender_tpu.inference.register import RegistrationPipeline as JPipeline
from bevrender_tpu.models import encoder as jenc
from bevrender_tpu.models.bevrender import BEVRenderModel
from bevrender_tpu.ops import deform_attn as jda
from bevrender_tpu.training.trainer import Trainer as JTrainer
from bevrender_tpu_torch import config as tcfg
from bevrender_tpu_torch.convert import flax_to_state_dict
from bevrender_tpu_torch.data import prefetch as tprefetch
from bevrender_tpu_torch.data.synthetic import SyntheticDataset
from bevrender_tpu_torch.inference.register import RegistrationPipeline
from bevrender_tpu_torch.models import encoder as tenc
from bevrender_tpu_torch.models import layers as tlay
from bevrender_tpu_torch.models.bevrender import BEVRenderNet
from bevrender_tpu_torch.ops import deform_attn as tda
from bevrender_tpu_torch.training.trainer import Trainer

PYRAMID = dict(
    bev_shapes=(14, 7, 14, 14), embed_dims=(8, 16, 8, 8), n_stages=3,
    depths=(1, 1, 1), n_heads=(2, 2, 2), n_groups=(1, 2, 1),
    strides=(2, 1, 2), kernel_sizes=(3, 3, 3), bev_depth_dim=2,
    num_views=2, img_height=64, img_width=64, ori_img_height=64,
    ori_img_width=64, backbone="PatchProjection")
IMG = 64
# float32 sites: the JAX render's own distance under a 1e-6 input change is
# 1.2e-5 (values in [0, 1]); the port read 1.3e-5
F32_RENDER_TOL = 3e-5
# module outputs through float32 sites, as a share of the largest entry
F32_MODULE_REL = 1e-5


@pytest.fixture
def f32_sites(monkeypatch):
    """Both frameworks' attention sites in float32: the lattice bias with
    float32 lerps, scores, softmax and AV without bf16 casts."""

    def jsite(q, k, v, k_pos, rpe_table, H, W, *, scale, use_kernel,
              dropout_rate=0.0, dropout_key=None, bias_interpret=False):
        bias = jnp.swapaxes(jda._lattice_bias(rpe_table, k_pos, H, W,
                                              jnp.float32, False), -1, -2)
        s = jnp.einsum("bghnc,bghmc->bghnm", k, q,
                       precision="highest") * scale + bias
        p = jax.nn.softmax(s, axis=-2)
        return jnp.einsum("bghnm,bghnc->bghmc", p, v, precision="highest")

    def consumer(q, k, v, bias, scale, keep=None, dropout_rate=0.0):
        s = torch.matmul(k, q.transpose(-1, -2)) * scale + bias
        return torch.matmul(torch.softmax(s, dim=-2).transpose(-1, -2), v)

    def bias(t, p, H, W, kernel=None):
        return tda.lattice_bias_plain(t, p, H, W, torch.float32)

    monkeypatch.setattr(jda, "_site_xla", jsite)
    monkeypatch.setattr(tda, "site_consumer", consumer)
    monkeypatch.setattr(tda, "lattice_bias", bias)
    monkeypatch.setattr(tda, "fused_site",
                        lambda q, k, v, p, t, H, W, scale, kernel=None:
                        consumer(q, k, v, bias(t, p, H, W), scale))


def _configs():
    j, t = JConfig(), tcfg.Config()
    j.model, t.model = j_tiny(**PYRAMID), tcfg.tiny_model_config(**PYRAMID)
    j.data.window_num_imgs = 1
    return j, t


def _dataset(n=2, seed=0):
    return SyntheticDataset(n_items=n, num_views=2, window_num_imgs=1,
                            img_height=IMG, img_width=IMG, map_tile=224,
                            seed=seed)


@functools.lru_cache(maxsize=None)
def _variables():
    """The JAX tiny pyramid's variables (numpy), initialised from a seed."""
    jcfg = _configs()[0]
    v = BEVRenderModel(jcfg).init(jax.random.PRNGKey(0), _dataset().batch(2))
    return jax.tree_util.tree_map(np.asarray, dict(v))


def test_tiny_pyramid_tree_loads_strict():
    variables = _variables()
    net = BEVRenderNet(_configs()[1].model)
    res = net.load_state_dict(flax_to_state_dict(variables), strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    n_flax = sum(x.size for x in jax.tree_util.tree_leaves(variables["params"]))
    assert sum(p.numel() for p in net.parameters()) == n_flax
    enc = net.encoder
    # 14 -> 7: 3x3 stride-2 conv; 7 -> 14: transposed conv; 14 -> 14 at
    # equal width: none
    assert isinstance(enc.stage0.transition, tlay.Conv)
    assert enc.stage0.transition.stride == (2, 2)
    assert isinstance(enc.stage1.transition, tlay.ConvTranspose)
    assert enc.stage2.transition is None
    assert hasattr(enc, "img_width_fix1") and not hasattr(enc, "img_width_fix0")
    assert enc.with_history == [True, False, True]
    # the odd stage's SCA key plane: ceil(7 / 2) rows of 7 * d keys
    assert tuple(net.ref_points1.shape[1:]) == (2, 4, 14, 2)


def test_reference_default_tree_maps_one_to_one():
    """``Config()`` (BEV 56-28-14-7-14-28-56, widths 64-512, ResNet-18, 3
    views of 224 x 224): the names and shapes of the JAX package's variable
    tree, from ``jax.eval_shape`` (no weights made), are those of the port's
    state_dict (built on the meta device)."""
    jcfg = JConfig()
    batch = {k: v[None] for k, v in SyntheticDataset(
        n_items=1, num_views=3, window_num_imgs=1)[0].items()}
    shapes = jax.eval_shape(
        lambda: BEVRenderModel(jcfg).init(jax.random.PRNGKey(0), batch))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   dict(shapes))
    ref = {k: tuple(v.shape) for k, v in flax_to_state_dict(zeros).items()}
    with torch.device("meta"):
        net = BEVRenderNet(tcfg.Config().model)
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert got == ref
    assert got["encoder.stage3.transition.weight"] == (512, 256, 2, 2)
    assert got["encoder.stage0.transition.weight"] == (128, 64, 3, 3)
    assert got["encoder.stage6.layers.1.spatial_cross_attn.rpe_table"] == (
        2, 111, 559)
    assert {f"encoder.img_width_fix{s}.weight" for s in range(1, 6)} <= set(got)


def _stage_kw(dim, bev, n_groups):
    return dict(dim=dim, bev_depth_dim=2, n_heads=2, n_groups=n_groups,
                stride=1 if bev == 7 else 2, kernel_size=3, n_views=2,
                expansion=2, scale_offset_range=True)


@pytest.mark.parametrize("dim,bev,next_dim,next_bev,n_groups", [
    (8, 14, 16, 7, 1),    # down to an odd BEV: 3x3 stride-2 conv
    (16, 7, 8, 14, 2),    # at BEV 7 (key plane 4 x 7 x d), then up
])
def test_stage_with_transition_matches_flax(f32_sites, dim, bev, next_dim,
                                            next_bev, n_groups):
    """One encoder stage (a layer, then the transition) against the JAX
    package's ``BEVEncoderStage`` with bridged weights, float32 sites."""
    V, d = 2, 2
    rig = jproj.default_camera_rig(n_views=V, img_width=IMG, img_height=IMG)
    rp = jproj.reference_points_all_types(
        imu_to_rgb=rig[0], K=rig[1], vehicle_types=[0],
        bev_bound={"X": 25.2, "Y": 25.2, "Z": 2.5}, bev_feat_shape=bev,
        bev_depth_dim=d, z_shift=-1.0, img_width=IMG, img_height=IMG,
        ori_img_width=IMG, ori_img_height=IMG)[0]
    assert rp.shape == (V, (bev + 1) // 2, bev * d, 2)
    rng = np.random.default_rng(bev)
    q = rng.standard_normal((2, bev, bev, dim)).astype(np.float32)
    feat = rng.standard_normal((2, V, 16, 16, dim)).astype(np.float32)
    pose = np.zeros((2, 2, 3), np.float32)
    jmod = jenc.BEVEncoderStage(
        next_dim=next_dim, bev_feat_shape=bev, next_bev_feat_shape=next_bev,
        depth=1, drop_path_rate=0.0, **_stage_kw(dim, bev, n_groups))
    args = (jnp.asarray(q), jnp.asarray(feat), None, jnp.asarray(pose),
            jnp.asarray(rp))
    variables = jmod.init(jax.random.PRNGKey(bev), *args)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    # a non-zero rpe table and offset head, so the bias and the offsets count
    variables = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 * rng.standard_normal(x.shape)).astype(
            np.float32) if ("rpe_table" in jax.tree_util.keystr(p)
                            or "offset_proj" in jax.tree_util.keystr(p)) else x,
        variables)
    ref = np.asarray(jmod.apply(variables, *args, False, False))
    assert ref.shape == (2, next_bev, next_bev, next_dim)
    mod = tenc.BEVEncoderStage(1, next_dim, next_bev, bev=bev, cd=None,
                               **_stage_kw(dim, bev, n_groups))
    mod.load_state_dict(flax_to_state_dict(variables), strict=True)
    out = mod.eval()(torch.from_numpy(q), torch.from_numpy(feat), None,
                     torch.from_numpy(rp)).detach().numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=F32_MODULE_REL * np.abs(ref).max())


def _render_pair(batch):
    variables = _variables()
    jcfg, tcfg_ = _configs()
    jr = np.asarray(JPipeline(jcfg, variables).render(batch))
    tr = RegistrationPipeline(tcfg_, flax_to_state_dict(variables),
                              device="cpu").render(batch).numpy()
    return jr, tr


def test_tiny_pyramid_render_matches_jax_f32(f32_sites):
    """Eval render at T=2 (a history pass, then the final pass) with bridged
    weights and float32 sites."""
    batch = _dataset().batch(2)
    jr, tr = _render_pair(batch)
    assert tr.shape == jr.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(tr, jr, atol=F32_RENDER_TOL, rtol=0)


def test_tiny_pyramid_render_matches_jax_bf16():
    """The shipped sites (bf16 roundings): within twice the JAX render's own
    distance under a 1e-6 input change (4e-3 here)."""
    batch = _dataset().batch(2)
    jr, tr = _render_pair(batch)
    jcfg = _configs()[0]
    nudged = dict(batch, camera=batch["camera"] * np.float32(1 + 1e-6))
    self_dist = np.abs(
        np.asarray(JPipeline(jcfg, _variables()).render(nudged)) - jr).max()
    assert np.isfinite(tr).all()
    assert np.abs(tr - jr).max() <= 2 * self_dist + 1e-4


LR = 1e-4  # TrainConfig.learning_rate


def test_tiny_pyramid_train_step_matches_jax(f32_sites, tmp_path):
    """One ``Trainer`` step (MSE, AdamW with eps 1e-3, where the update is
    smooth in the gradient) from the bridged initial weights against the
    JAX package's ``_train_step``, float32 sites: the loss to 1e-5, every
    parameter to 1e-5 of its largest entry plus 0.2 of the learning rate
    (test_torch_trainer.py's slack for tensors near zero), BatchNorm
    statistics to 5e-4 (test_torch_trainer.py's). With the bf16 sites the
    two losses part by 2.3e-4 relative: bf16 flips, which the tiny model's
    own sensitivity amplifies (module docstring)."""
    jcfg, pcfg = _configs()
    for c in (jcfg.train, pcfg.train):
        c.batch_size, c.loss_type, c.eps = 2, "MSE", 1e-3
        c.work_dir = str(tmp_path)
    ds = _dataset(4)
    jtrainer = JTrainer(BEVRenderModel(jcfg), jcfg, ds)
    jstate = jtrainer.create_state(jax.random.PRNGKey(0), ds.batch(2))
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    ttrainer = Trainer(pcfg, ds, device="cpu")
    tstate = ttrainer.create_state(state_dict=flax_to_state_dict(variables))
    batch = tprefetch.collate([ds[0], ds[1]])
    # the JAX step donates its state: hand it a copy
    jstate, jm, _ = jtrainer._train_step(
        jax.tree_util.tree_map(jnp.copy, jstate),
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(1))
    tstate, tm, _ = ttrainer.train_step(tstate, batch, rng=1)
    np.testing.assert_allclose(float(tm["train_batch_loss"]),
                               float(jm["train_batch_loss"]), rtol=1e-5)
    ref = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params,
                     "batch_stats": jstate.batch_stats}))
    got = tstate.net.state_dict()
    assert got.keys() == ref.keys()
    for name, r in ref.items():
        if name.endswith("num_batches_tracked"):
            continue
        err = float((got[name] - r).abs().max())
        scale = float(r.abs().max())
        if "running_" in name:
            assert err <= 5e-4 * max(scale, 1e-2), name
        else:
            assert err <= 1e-5 * scale + 0.2 * LR, f"{name}: {err} of {scale}"
    for name in ("encoder.stage0.transition.weight",
                 "encoder.stage1.transition.weight",
                 "encoder.img_width_fix1.weight"):
        assert not torch.equal(got[name], flax_to_state_dict(variables)[name])


@pytest.mark.slow
def test_reference_default_pyramid_render_matches_jax():
    """``Config()``'s pyramid at 4x-down widths (as tests/test_pyramid_e2e.py
    cuts it for the CPU: 16-32-64-128-64-32-16, 64 x 64 images, ResNet-18)
    at float32, B=1, T=2, bridged weights: at random weights its render is
    chaotic, so the port is held to twice the JAX render's own distance
    under a 1e-6 input change."""
    jcfg, pcfg = JConfig(), tcfg.Config()
    for m in (jcfg.model, pcfg.model):
        m.embed_dims = (16, 32, 64, 128, 64, 32, 16, 16)
        m.img_height = m.img_width = m.ori_img_height = m.ori_img_width = 64
    jcfg.data.window_num_imgs = 1
    batch = SyntheticDataset(n_items=1, num_views=3, window_num_imgs=1,
                             img_height=64, img_width=64).batch(1)
    variables = BEVRenderModel(jcfg).init(jax.random.PRNGKey(0), batch)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    jpipe = JPipeline(jcfg, variables)
    ref = np.asarray(jpipe.render(batch))
    nudged = dict(batch, camera=batch["camera"] * np.float32(1 + 1e-6))
    self_dist = np.abs(np.asarray(jpipe.render(nudged)) - ref).mean()
    out = RegistrationPipeline(pcfg, flax_to_state_dict(variables),
                               device="cpu").render(batch).numpy()
    assert out.shape == ref.shape == (1, 224, 224, 3)
    assert np.isfinite(out).all()
    assert np.abs(out - ref).mean() <= 2 * self_dist + 1e-4
