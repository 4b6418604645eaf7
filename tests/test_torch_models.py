"""Modules of the PyTorch port with weights bridged from flax, held against
the JAX modules on the CPU (eval mode).

Every flax module is initialised from a seed, its norm parameters and
batch statistics are perturbed (so a mix-up of scale, bias, mean or var
shows), the tree is converted with ``convert.flax_to_state_dict`` and
loaded strictly into the port's module, and both run on the same numpy
inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevrender_tpu.geometry import projection as jproj
from bevrender_tpu.models import attention as jatt
from bevrender_tpu.models import backbone as jbb
from bevrender_tpu.models import decoder as jdec
from bevrender_tpu.models import encoder as jenc
from bevrender_tpu.models import layers as jlay
from bevrender_tpu_torch.convert import flax_to_state_dict
from bevrender_tpu_torch.geometry import projection as tproj
from bevrender_tpu_torch.models import attention as tatt
from bevrender_tpu_torch.models import backbone as tbb
from bevrender_tpu_torch.models import decoder as tdec
from bevrender_tpu_torch.models import encoder as tenc
from bevrender_tpu_torch.models import layers as tlay

# convolution stacks in float32: summation order differs, nothing else
F32_TOL = 1e-4
# modules with attention sites round K, Q, p and V to bf16: an f32
# difference in the last bit upstream can flip one bf16 rounding
SITE_REL = 2e-3


def _perturb(variables, seed):
    rng = np.random.default_rng(seed)

    def f(path, x):
        name = jax.tree_util.keystr(path[-1:])
        x = np.asarray(x)
        if "var" in name:
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if "mean" in name or "bias" in name:
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if "scale" in name:
            return (1 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(f, variables)


def _bridge(flax_mod, torch_mod, *args, seed=0, **kw):
    """Init ``flax_mod`` on ``args``, perturb, load into ``torch_mod``;
    returns the flax output and the variables."""
    arrays = [jnp.asarray(a) for a in args if isinstance(a, np.ndarray)]
    statics = [a for a in args if not isinstance(a, np.ndarray)]

    def call(fn, *head):  # arrays lead the call, static flags follow
        return lambda *xs: fn(*head, *xs, *statics, **kw)

    variables = jax.jit(lambda k, *xs: call(flax_mod.init, k)(*xs))(
        jax.random.PRNGKey(seed), *arrays)
    variables = _perturb(jax.tree_util.tree_map(np.asarray, dict(variables)), seed)
    torch_mod.load_state_dict(flax_to_state_dict(variables), strict=True)
    torch_mod.eval()
    return np.asarray(jax.jit(lambda v, *xs: call(flax_mod.apply, v)(*xs))(
        variables, *arrays))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(out, ref, rel=None):
    out = out.detach().numpy() if torch.is_tensor(out) else out
    assert out.shape == ref.shape
    atol = F32_TOL if rel is None else rel * np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=atol, rtol=0 if rel else F32_TOL)


def test_conv_mlp_matches_flax():
    x = _x(0, 2, 6, 6, 8)
    ref = _bridge(jlay.ConvMLP(8, 2), m := tlay.ConvMLP(8, 2), x)
    _close(m(_t(x)), ref)


def test_resnet18_backbone_matches_flax():
    x = _x(1, 2, 32, 32, 3)
    norm = jlay.make_norm("batch")
    ref = _bridge(jbb.ResNet18WoFPN(bev_dim=28, norm=norm),
                  m := tbb.ResNet18WoFPN(28, tlay.BatchNorm), x)
    assert ref.shape == (2, 4, 4, 64)
    _close(m(_t(x)), ref)


def test_patch_projection_matches_flax():
    x = _x(2, 2, 32, 32, 3)
    ref = _bridge(jbb.PatchProjection(embed_dim=8, patch_size=4),
                  m := tbb.PatchProjection(8, 4), x)
    _close(m(_t(x)), ref)


def test_decoder_matches_flax():
    x = _x(3, 2, 8, 8, 16)
    ref = _bridge(
        jdec.BEVImageRenderDecoder(bev_spatial_dim=8, model_dim=16, hid_dim=8,
                                   norm=jlay.make_norm("batch")),
        m := tdec.BEVImageRenderDecoder(8, 16, 8, tlay.BatchNorm), x)
    assert ref.shape == (2, 32, 32, 3)
    _close(m(_t(x)), ref)


@pytest.mark.parametrize("n_heads,n_groups", [(4, 2), (1, 1)])
def test_tsa_matches_flax(n_heads, n_groups):
    """ch 4 takes the fused site, ch 16 the bias + consumer route."""
    q, prev = _x(4, 2, 8, 8, 16), _x(5, 2, 8, 8, 16)
    ref = _bridge(
        jatt.TSADeformableAttention(16, n_heads, n_groups, stride=2, kernel_size=3),
        m := tatt.TSADeformableAttention(16, n_heads, n_groups, 2, 3, bev=8),
        q, prev, True)
    _close(m(_t(q), _t(prev)), ref, SITE_REL)


def _ref_points(bev, d, V, img):
    rig = jproj.default_camera_rig(n_views=V, img_width=img, img_height=img)
    kw = dict(imu_to_rgb=rig[0], K=rig[1], vehicle_types=[0],
              bev_bound={"X": 25.2, "Y": 25.2, "Z": 2.5}, bev_feat_shape=bev,
              bev_depth_dim=d, z_shift=-1.0, img_width=img, img_height=img,
              ori_img_width=img, ori_img_height=img)
    return jproj.reference_points_all_types(**kw), kw


def test_reference_points_match_jax():
    ref, kw = _ref_points(28, 5, 3, 224)
    rig = tproj.default_camera_rig(n_views=3, img_width=224, img_height=224)
    kw.update(imu_to_rgb=rig[0], K=rig[1])
    out = tproj.reference_points_all_types(**kw)
    assert out.shape == ref.shape == (1, 3, 14, 140, 2)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("n_heads,n_groups,bev", [
    (8, 4, 8), (4, 2, 8), (1, 1, 8), (4, 2, 7)])
def test_sca_matches_flax(n_heads, n_groups, bev):
    """G=4 folds the views into one site call; G<4 runs one call per view.
    An odd BEV height pads the stride-2 offset conv like flax's SAME."""
    V, d = 2, 2
    rp = _ref_points(bev, d, V, 32)[0][0]
    q, feat = _x(6, 2, bev, bev, 16), _x(7, 2, V, 8, 8, 16)
    ref = _bridge(
        jatt.SCADeformableAttention(16, n_heads, n_groups, bev_depth_dim=d,
                                    n_views=V),
        m := tatt.SCADeformableAttention(16, n_heads, n_groups, d, bev=bev,
                                         n_views=V),
        q, feat, rp, True)
    _close(m(_t(q), _t(feat), _t(rp)), ref, SITE_REL)


def test_encoder_layer_matches_flax():
    V, d = 2, 2
    rp = _ref_points(8, d, V, 32)[0][0]
    q, feat, prev = _x(8, 2, 8, 8, 16), _x(9, 2, V, 8, 8, 16), _x(10, 2, 8, 8, 16)
    pose = np.zeros((2, 2, 3), np.float32)
    kw = dict(dim=16, bev_feat_shape=8, bev_depth_dim=d, n_heads=4, n_groups=4,
              stride=2, kernel_size=3, n_views=V, expansion=2,
              scale_offset_range=True, drop_path_rate=0.0)
    ref = _bridge(jenc.EncoderLayer(**kw), m := tenc.EncoderLayer(
        dim=16, bev=8, bev_depth_dim=d, n_heads=4, n_groups=4, stride=2,
        kernel_size=3, n_views=V, expansion=2, scale_offset_range=True),
        q, feat, prev, pose, rp, False, False)
    _close(m(_t(q), _t(feat), _t(prev), _t(rp)), ref, SITE_REL)


def test_bf16_conv_and_dense_round_like_flax():
    """``compute_dtype=bf16`` casts input and weights, returns bf16."""
    x = _x(11, 2, 5, 5, 8)
    jl = jlay.Conv(6, (3, 3), padding=((1, 1), (1, 1)), dtype=jnp.bfloat16)
    tl = tlay.Conv(8, 6, 3, padding=1, compute_dtype=torch.bfloat16)
    ref = _bridge(jl, tl, x)
    out = tl(_t(x))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    # same bf16 inputs; sums in another order may round one ulp apart
    np.testing.assert_allclose(out.detach().float().numpy(), ref.astype(np.float32),
                               atol=np.abs(ref.astype(np.float32)).max() * 2 ** -7)
    jd = jlay.Dense(4, dtype=jnp.bfloat16)
    td = tlay.Dense(8, 4, compute_dtype=torch.bfloat16)
    ref = _bridge(jd, td, x)
    out = td(_t(x))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(), ref.astype(np.float32),
                               atol=np.abs(ref.astype(np.float32)).max() * 2 ** -7)
