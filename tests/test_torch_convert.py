"""The flax -> PyTorch weight bridge (``bevrender_tpu_torch.convert``).

Trees come from ``jax.eval_shape`` of the JAX model's init (no compile),
filled with seeded numpy values, and must load into the port's
``BEVRenderNet`` with ``strict=True``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevrender_tpu.config import Config as JConfig
from bevrender_tpu.config import flagship_config as j_flagship
from bevrender_tpu.config import tiny_model_config as j_tiny
from bevrender_tpu.data.dataset import SyntheticDataset
from bevrender_tpu.models.bevrender import BEVRenderModel
from bevrender_tpu_torch import config as tcfg
from bevrender_tpu_torch.convert import flax_to_state_dict
from bevrender_tpu_torch.models.bevrender import BEVRenderNet
from bevrender_tpu_torch.models.layers import ConvTranspose


def _configs(which):
    if which == "flagship":
        return j_flagship(), tcfg.flagship_config()
    j, t = JConfig(), tcfg.Config()
    j.model, t.model = j_tiny(), tcfg.tiny_model_config()
    return j, t


@functools.lru_cache(maxsize=None)
def _shapes(which):
    jcfg = _configs(which)[0]
    m = jcfg.model
    ds = SyntheticDataset(n_items=1, num_views=m.num_views, window_num_imgs=1,
                          img_height=m.img_height, img_width=m.img_width)
    batch = {k: v[None] for k, v in ds[0].items()}
    return jax.eval_shape(
        lambda: BEVRenderModel(jcfg).init(jax.random.PRNGKey(0), batch))


def _tree(which, seed=0):
    """The JAX model's variable tree with seeded values (var > 0)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32),
        dict(_shapes(which)))


@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_tree_loads_strict(which):
    tree = _tree(which)
    sd = flax_to_state_dict(tree)
    net = BEVRenderNet(_configs(which)[1].model)
    missing = net.load_state_dict(sd, strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    n_params = sum(p.numel() for p in net.parameters())
    n_flax = sum(x.size for x in jax.tree_util.tree_leaves(tree["params"]))
    assert n_params == n_flax


def test_layouts_are_mapped():
    tree = _tree("tiny", seed=1)
    sd = flax_to_state_dict(tree)
    p = tree["params"]["encoder"]["stage1"]["layers"]
    # depthwise conv (depth, kh, kw, in/groups, out) -> layer i (out, in/g, kh, kw)
    np.testing.assert_array_equal(
        sd["encoder.stage1.layers.0.tsa_lpu.weight"].numpy(),
        p["tsa_lpu"]["kernel"][0].transpose(3, 2, 0, 1))
    # dense (in, out) -> (out, in)
    np.testing.assert_array_equal(
        sd["encoder.stage1.layers.0.spatial_cross_attn.proj_out.weight"].numpy(),
        p["spatial_cross_attn"]["proj_out"]["kernel"][0].T)
    # per-view offset heads and the rpe table as they are
    np.testing.assert_array_equal(
        sd["encoder.stage1.layers.0.spatial_cross_attn.offset_proj_m1.weight"].numpy(),
        p["spatial_cross_attn"]["offset_proj_m1"]["kernel"][0].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["encoder.stage1.layers.0.temporal_self_attn.rpe_table"].numpy(),
        p["temporal_self_attn"]["rpe_table"][0])
    # layer norm scale -> weight; batch stats -> running stats
    np.testing.assert_array_equal(
        sd["encoder.stage1.layers.0.layer_norm.weight"].numpy(),
        p["layer_norm"]["scale"][0])
    bs = tree["batch_stats"]["decoder"]["stem_bn"]
    np.testing.assert_array_equal(sd["decoder.stem_bn.running_var"].numpy(), bs["var"])
    np.testing.assert_array_equal(sd["decoder.stem_bn.running_mean"].numpy(), bs["mean"])
    assert int(sd["decoder.stem_bn.num_batches_tracked"]) == 0
    np.testing.assert_array_equal(sd["bev_embedding"].numpy(),
                                  tree["params"]["bev_embedding"])


def test_unknown_leaf_is_refused():
    # ("gamma" is LayerScale's parameter since the reference API's layers
    # were ported; "beta" names no parameter of either package)
    with pytest.raises(ValueError, match="unknown flax parameter"):
        flax_to_state_dict({"params": {"x": {"beta": np.zeros(3, np.float32)}}})
    with pytest.raises(ValueError, match="rank 3"):
        flax_to_state_dict({"params": {"x": {"kernel": np.zeros((1, 2, 3))}}})


def test_state_dict_tensors_own_their_memory():
    tree = _tree("tiny", seed=2)
    sd = flax_to_state_dict(tree)
    sd["bev_embedding"].add_(1.0)
    assert not np.array_equal(sd["bev_embedding"].numpy(),
                              tree["params"]["bev_embedding"])
    assert all(t.dtype in (torch.float32, torch.int64) for t in sd.values())


def _conv_transpose_case():
    """flax's 2x2 stride-2 transposed conv (default SAME, as the pyramid's
    upsampling transition) on an asymmetric kernel, its output, and the
    kernel and input."""
    from flax import linen as nn

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    kernel = rng.standard_normal((2, 2, 5, 6)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    mod = nn.ConvTranspose(6, (2, 2), strides=(2, 2))
    ref = np.asarray(mod.apply({"params": {"kernel": kernel, "bias": bias}},
                               jnp.asarray(x)))
    assert ref.shape == (2, 6, 8, 6)
    return x, kernel, bias, ref


def test_conv_transpose_bridge_flips_the_kernel():
    """The bridge maps the kernel of a stage's ``transition`` that is 2x2
    to ``K[::-1, ::-1]`` as (in, out, kh, kw): the port's ``ConvTranspose``
    then gives flax's output (one product per output and input channel, so
    only the order of a 5-term sum differs). Mapped like a conv kernel,
    without the flip, the same weights give another output."""
    x, kernel, bias, ref = _conv_transpose_case()
    sd = flax_to_state_dict({"params": {"stage3": {"transition": {
        "kernel": kernel, "bias": bias}}}})
    w = sd["stage3.transition.weight"]
    assert tuple(w.shape) == (5, 6, 2, 2)
    np.testing.assert_array_equal(w.numpy(),
                                  kernel[::-1, ::-1].transpose(2, 3, 0, 1))
    mod = ConvTranspose(5, 6)
    mod.load_state_dict({"weight": w, "bias": sd["stage3.transition.bias"]})
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    # the same kernel unflipped (a conv's mapping reordered to (in, out)):
    # an asymmetric kernel gives a visibly different output
    mod.weight.data = torch.from_numpy(
        np.ascontiguousarray(kernel.transpose(2, 3, 0, 1)))
    with torch.no_grad():
        wrong = mod(torch.from_numpy(x)).numpy()
    assert np.abs(wrong - ref).max() > 0.1 * np.abs(ref).max()


def test_only_a_transition_kernel_of_2x2_is_flipped():
    """A 3x3 or 1x1 ``transition`` is a conv; a 2x2 kernel elsewhere too."""
    k3 = np.arange(2 * 3 * 3 * 4, dtype=np.float32).reshape(3, 3, 2, 4)
    k2 = np.arange(2 * 2 * 2 * 4, dtype=np.float32).reshape(2, 2, 2, 4)
    sd = flax_to_state_dict({"params": {
        "a": {"transition": {"kernel": k3}},
        "b": {"offset_proj": {"kernel": k2}}}})
    np.testing.assert_array_equal(sd["a.transition.weight"].numpy(),
                                  k3.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["b.offset_proj.weight"].numpy(),
                                  k2.transpose(3, 2, 0, 1))
