"""The port's retrieval head and embedding surface held against the JAX
package on the CPU: ``AdaptiveGroupNorm``, ``RetrievalHead`` with bridged
flax weights (flax's asymmetric SAME padding on stride 2 included), the
tiny model's ``embed`` and its registration through the head, the
``embed_fn`` / head / flatten choice, and the trainer's routing of the
retrieval losses through the head.

Tolerances: the head and the norm are float32 end to end in both
frameworks and are held to 1e-5 of their largest output entry (the limit
the JAX package's docstring asks of the head; summation order alone moves
them by ~1e-7). Registration through the tiny model runs the attention
sites, which round to bf16 in both frameworks: a flipped rounding moves a
render by up to ~4e-3 (tests/test_torch_slice.py holds 5e-3), and the head
carries that into the distances by up to ~5e-5, enough to swap two tiles
whose distances lie 2e-5 apart. So the registration is compared with both
frameworks' sites in float32 (``f32_sites``, as tests/test_torch_pyramid.py
does): renders to 1e-4, equal top-k indices, distances to 1e-5. The
trainer's step 1, with float32 sites too, is held to the limits of
tests/test_torch_trainer.py. The tiny model's weights are the port's
seeded ones carried into the flax tree (``_variables``), which spares a
JAX init.
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
from bevrender_tpu.models import layers as jlayers
from bevrender_tpu.models.bevrender import BEVRenderModel
from bevrender_tpu.models.retrieval import RetrievalHead as JHead
from bevrender_tpu.ops import deform_attn as jda
from bevrender_tpu.training.trainer import Trainer as JTrainer
from bevrender_tpu.training.trainer import TrainState as JTrainState
from bevrender_tpu_torch import config as tcfg
from bevrender_tpu_torch.convert import flax_to_state_dict
from bevrender_tpu_torch.data import prefetch as tprefetch
from bevrender_tpu_torch.data.synthetic import SyntheticDataset
from bevrender_tpu_torch.inference.register import RegistrationPipeline
from bevrender_tpu_torch.losses.metric import contrastive_loss_vs_db
from bevrender_tpu_torch.models import layers as tlayers
from bevrender_tpu_torch.models.bevrender import BEVRenderNet
from bevrender_tpu_torch.ops import deform_attn as tda
from bevrender_tpu_torch.models.retrieval import (
    RetrievalHead,
    same_pads,
    tf32,
)
from bevrender_tpu_torch.training.trainer import Trainer

REL = 1e-5
RENDER_TOL = 5e-3  # shipped bf16 sites (tests/test_torch_slice.py)
F32_RENDER_TOL = 1e-4  # float32 sites
DIST_TOL = 1e-5
HEAD = dict(retrieval_embed_dim=16, retrieval_head_widths=(8, 16))
LR = 1e-4  # TrainConfig.learning_rate


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture
def f32_sites(monkeypatch):
    """Both frameworks' attention sites in float32 (the fixture of
    tests/test_torch_pyramid.py): the lattice bias with float32 lerps,
    scores, softmax and AV without bf16 casts."""
    use_f32_sites(monkeypatch)


def use_f32_sites(monkeypatch):
    """``f32_sites`` on a ``pytest.MonkeyPatch`` of any scope."""

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


def _randomise_norms(params, rng):
    """Give every GroupNorm scale and bias random values, so that the
    bridge of both is exercised (their initial values are 1 and 0)."""
    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
            elif "GroupNorm" in "/".join(path) and k in ("scale", "bias"):
                base = 1.0 if k == "scale" else 0.0
                out[k] = (base + 0.3 * rng.standard_normal(v.shape)).astype(
                    np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(params)


# ---- the layers alone -------------------------------------------------------

@pytest.mark.parametrize("c", [4, 12, 64])
def test_adaptive_group_norm_matches_flax(c):
    """``AdaptiveGroupNorm`` at c // gcd(c, 8) groups, float32 and a bf16
    input (float32 out, as flax's), scale and bias random, to 1e-5 of the
    largest output."""
    rng = np.random.default_rng(c)
    x = (rng.standard_normal((2, 5, 6, c)) * 3 + 2).astype(np.float32)
    jnorm = jlayers.AdaptiveGroupNorm()
    params = _randomise_norms(
        _np_tree(jnorm.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    assert set(params["params"]) == {"GroupNorm_0"}
    tnorm = tlayers.make_norm("group")(c)
    assert isinstance(tnorm, tlayers.AdaptiveGroupNorm)
    assert tnorm.GroupNorm_0.num_groups == c // np.gcd(c, 8)
    tnorm.load_state_dict(flax_to_state_dict(params), strict=True)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        xt = torch.from_numpy(x).to(dt)
        ref = np.asarray(jnorm.apply(params, jnp.asarray(x).astype(jdt)))
        got = tnorm(xt)
        assert got.dtype == torch.float32 and ref.dtype == np.float32
        assert _rel(got.detach().numpy(), ref) <= REL


def test_make_norm_choices():
    assert tlayers.make_norm("batch") is tlayers.BatchNorm
    assert tlayers.make_norm("group") is tlayers.AdaptiveGroupNorm
    with pytest.raises(ValueError, match="unknown norm"):
        tlayers.make_norm("layer")


def test_same_pads_match_flax():
    """flax's SAME padding of a stride-2 conv, odd sizes included: for a 5
    x 5 kernel on 224 it pads 1 before and 2 after, for 3 x 3 on an even
    size 0 and 1."""
    assert same_pads(224, 5, 2) == (1, 2) and same_pads(112, 3, 2) == (0, 1)
    for n in range(1, 40):
        for k in (3, 5):
            ref = jax.lax.padtype_to_pads((n,), (k,), (2,), "SAME")[0]
            assert same_pads(n, k, 2) == tuple(ref), (n, k)


@pytest.mark.parametrize("widths,side,batch", [
    ((8, 16), 32, 3), ((8, 16), 30, 3), ((32, 64, 128, 256), 224, 2)])
def test_head_matches_flax(widths, side, batch):
    """``RetrievalHead`` with the flax weights bridged: the same unit
    vectors to 1e-5 of their largest entry, at an even and an odd size
    (flax's asymmetric padding) and at the shipped widths on 224 x 224."""
    rng = np.random.default_rng(side)
    x = rng.uniform(0, 1, (batch, side, side, 3)).astype(np.float32)
    jhead = JHead(embed_dim=16, widths=widths)
    params = _randomise_norms(
        _np_tree(jhead.init(jax.random.PRNGKey(1), jnp.asarray(x))), rng)
    ref = np.asarray(jhead.apply(params, jnp.asarray(x)))
    thead = RetrievalHead(16, widths)
    thead.load_state_dict(flax_to_state_dict(params), strict=True)
    got = thead(torch.from_numpy(x))
    assert got.shape == (batch, 16) and got.dtype == torch.float32
    assert _rel(got.detach().numpy(), ref) <= REL
    np.testing.assert_allclose(np.linalg.norm(got.detach().numpy(), axis=-1),
                               1.0, atol=1e-6)


def test_head_pins_full_float32_and_restores_the_flags():
    """The head's convolutions and projection run with TF32 off whatever
    the global settings say, and the settings come back as they were: a
    float32 matmul precision of "medium" stays "medium"."""
    cudnn = torch.backends.cudnn
    saved = torch.get_float32_matmul_precision(), cudnn.allow_tf32
    seen = []
    head = tlayers.init_params(RetrievalHead(8, (8, 16)), 0)
    hook = lambda *_: seen.append(  # noqa: E731
        (cudnn.allow_tf32, torch.get_float32_matmul_precision()))
    for name in ("Conv_0", "Conv_1", "Dense_0"):
        getattr(head, name).register_forward_pre_hook(hook)
    try:
        torch.set_float32_matmul_precision("medium")
        cudnn.allow_tf32 = True
        head(torch.rand(2, 16, 16, 3))
        assert (cudnn.allow_tf32, torch.get_float32_matmul_precision()) == \
            (True, "medium")
        assert seen == [(False, "highest")] * 3
        with tf32(True):
            assert cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
            with tf32(False):
                assert not cudnn.allow_tf32
                assert not torch.backends.cuda.matmul.allow_tf32
            assert cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
        assert (cudnn.allow_tf32, torch.get_float32_matmul_precision()) == \
            (True, "medium")
    finally:
        torch.set_float32_matmul_precision(saved[0])
        cudnn.allow_tf32 = saved[1]


@torch.no_grad()
def test_head_runs_in_float32_from_bf16_and_in_float64_when_its_weights_are():
    head = tlayers.init_params(RetrievalHead(8, (8, 16)), 3)
    x = torch.rand(2, 16, 16, 3).to(torch.bfloat16)
    got = head(x)
    assert got.dtype == torch.float32
    assert torch.equal(got, head(x.float()))
    wide = head.double()(x.double())
    assert wide.dtype == torch.float64
    assert float((wide - got.double()).abs().max()) <= REL


# ---- the tiny model with a head ---------------------------------------------

def _configs(**model):
    j, t = JConfig(), tcfg.Config()
    j.model, t.model = j_tiny(**model), tcfg.tiny_model_config(**model)
    j.data.window_num_imgs = 1
    return j, t


def _dataset(n=8, seed=0):
    return SyntheticDataset(n_items=n, num_views=2, window_num_imgs=1,
                            img_height=32, img_width=32, map_tile=32,
                            seed=seed)


@functools.lru_cache(maxsize=None)
def _variables(**model):
    """Flax variables of the tiny model as numpy, holding the port's seeded
    weights (``init_params``, the JAX initialisers' distributions): the
    tree's names and shapes come from ``jax.eval_shape`` of the JAX init
    (``_call_and_embed`` when a head is configured), so no JAX init is
    compiled. Each flax leaf is filled with the ids of its entries and sent
    through ``flax_to_state_dict``: where an id lands in the port's tensors
    says which port entry fills it."""
    jcfg, pcfg = _configs(**model)
    shapes = jax.eval_shape(lambda: BEVRenderModel(jcfg).init(
        jax.random.PRNGKey(0), _dataset().batch(2)))
    leaves, treedef = jax.tree_util.tree_flatten(dict(shapes))
    sizes = [int(np.prod(leaf.shape)) for leaf in leaves]
    starts = np.cumsum([0] + sizes)
    assert starts[-1] < 2 ** 24  # ids exact in float32
    ids = jax.tree_util.tree_unflatten(treedef, [
        (np.arange(n) + s0).reshape(leaf.shape).astype(np.float32)
        for leaf, n, s0 in zip(leaves, sizes, starts)])
    placed = flax_to_state_dict(ids)
    weights = tlayers.init_params(BEVRenderNet(pcfg.model), 0).state_dict()
    flat = np.full(starts[-1], np.nan, np.float32)
    for name, where in placed.items():
        if not name.endswith("num_batches_tracked"):
            flat[where.numpy().astype(np.int64).ravel()] = \
                weights[name].numpy().ravel()
    assert not np.isnan(flat).any()
    return jax.tree_util.tree_unflatten(treedef, [
        flat[s0:s0 + n].reshape(leaf.shape)
        for leaf, n, s0 in zip(leaves, sizes, starts)])


@functools.lru_cache(maxsize=None)
def _head_setup():
    jcfg, pcfg = _configs(**HEAD)
    variables = _variables(**HEAD)
    jpipe = JPipeline(jcfg, variables)
    tpipe = RegistrationPipeline(pcfg, flax_to_state_dict(variables),
                                 device="cpu")
    tiles = np.random.default_rng(3).uniform(0, 1, (20, 32, 32, 3)).astype(
        np.float32)
    return jcfg, pcfg, variables, jpipe, tpipe, tiles


def test_tree_with_head_loads_strictly():
    *_, variables, _, tpipe, _ = _head_setup()
    assert "retrieval_head" in variables["params"]
    names = {n for n in tpipe.net.state_dict() if n.startswith("retrieval_head.")}
    assert names == {f"retrieval_head.{n}" for n in (
        "Conv_0.weight", "GroupNorm_0.weight", "GroupNorm_0.bias",
        "Conv_1.weight", "GroupNorm_1.weight", "GroupNorm_1.bias",
        "Dense_0.weight", "Dense_0.bias")}


def test_tiny_embed_matches_jax():
    jcfg, _, variables, _, tpipe, tiles = _head_setup()
    ref = np.asarray(BEVRenderModel(jcfg).embed(variables, jnp.asarray(tiles)))
    got = tpipe.net.embed(torch.from_numpy(tiles)).detach().numpy()
    assert got.shape == (20, 16)
    assert _rel(got, ref) <= REL


def test_tiny_register_through_the_head_matches_jax(f32_sites):
    jcfg, _, variables, _, tpipe, tiles = _head_setup()
    jpipe = JPipeline(jcfg, variables)  # traced under the float32 sites
    batch = _dataset().batch(4)
    jdb = np.asarray(jpipe.build_tile_database(list(tiles), batch_size=6))
    tdb = tpipe.build_tile_database(list(tiles), batch_size=6)
    assert tdb.shape == (20, 16) and tdb.dtype == torch.float32
    assert _rel(tdb.numpy(), jdb) <= REL
    jr, jidx, jdist = (np.asarray(x) for x in jpipe.register(batch, top_k=5))
    tr, tidx, tdist = tpipe.register(batch, top_k=5)
    assert float(np.abs(tr.numpy() - jr).max()) <= F32_RENDER_TOL
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_allclose(tdist.numpy(), jdist, atol=DIST_TOL, rtol=0)


def test_a_tile_retrieves_itself_through_the_head():
    *_, tpipe, tiles = _head_setup()
    db = tpipe.build_tile_database(list(tiles), batch_size=7)
    q = tpipe.embed(torch.from_numpy(tiles))
    assert torch.equal(torch.argmax(q @ db.T, dim=-1), torch.arange(20))


def test_embed_fn_takes_precedence_over_the_head():
    """An explicit ``embed_fn`` wins over the head, L2-normalised, as in
    the JAX pipeline."""
    jcfg, pcfg, variables, _, _, tiles = _head_setup()
    jpipe = JPipeline(jcfg, variables,
                      embed_fn=lambda x: jnp.mean(x, axis=(1, 2)))
    tpipe = RegistrationPipeline(pcfg, flax_to_state_dict(variables),
                                 device="cpu",
                                 embed_fn=lambda x: x.mean(dim=(1, 2)))
    jdb = np.asarray(jpipe.build_tile_database(list(tiles)))
    tdb = tpipe.build_tile_database(list(tiles))
    assert tdb.shape == (20, 3)
    assert _rel(tdb.numpy(), jdb) <= REL


def test_flatten_without_a_head():
    """``retrieval_embed_dim=0``: no head parameters, the embedding is the
    flatten (normalised by the pipeline), the database as wide as a tile."""
    _, pcfg = _configs()
    pipe = RegistrationPipeline(pcfg, device="cpu", seed=0)
    assert not hasattr(pipe.net, "retrieval_head")
    assert not [n for n in pipe.net.state_dict() if "retrieval" in n]
    tiles = np.random.default_rng(4).uniform(0, 1, (5, 32, 32, 3)).astype(
        np.float32)
    x = torch.from_numpy(tiles)
    assert torch.equal(pipe.net.embed(x), x.reshape(5, -1))
    db = pipe.build_tile_database(list(tiles))
    assert db.shape == (5, 32 * 32 * 3)
    assert torch.equal(db, x.reshape(5, -1) / x.reshape(5, -1).norm(
        dim=-1, keepdim=True))


def test_seed_gives_the_trunk_the_same_numbers_with_or_without_a_head():
    _, plain = _configs()
    _, head = _configs(**HEAD)
    a = tlayers.init_params(BEVRenderNet(plain.model), 5).state_dict()
    b = tlayers.init_params(BEVRenderNet(head.model), 5).state_dict()
    c = tlayers.init_params(BEVRenderNet(head.model), 6).state_dict()
    assert set(b) - set(a) and all(n.startswith("retrieval_head.")
                                   for n in set(b) - set(a))
    assert all(torch.equal(a[n], b[n]) for n in a)
    again = tlayers.init_params(BEVRenderNet(head.model), 5).state_dict()
    assert all(torch.equal(b[n], again[n]) for n in b)
    assert not torch.equal(b["retrieval_head.Conv_0.weight"],
                           c["retrieval_head.Conv_0.weight"])
    assert torch.equal(b["retrieval_head.GroupNorm_0.weight"],
                       torch.ones(8))


def _as_group_norm(variables):
    """The tiny tree with every BatchNorm's {scale, bias} (a node with
    statistics in ``batch_stats``) moved under ``GroupNorm_0`` and the
    statistics dropped: the tree of the same model at ``norm="group"``
    (``AdaptiveGroupNorm`` names its inner module so)."""
    def walk(params, stats):
        if set(stats) == {"mean", "var"}:
            return {"GroupNorm_0": dict(params)}
        return {k: walk(v, stats[k]) if k in stats else v
                for k, v in params.items()}
    return {"params": walk(variables["params"], variables["batch_stats"])}


def test_group_norm_model_loads_strictly_and_renders_as_jax(f32_sites):
    """``norm="group"`` (the tiny model's decoder norms) with a head: the
    flax tree loads strictly and the render matches JAX's to 1e-4 with
    float32 sites (measured 5e-6)."""
    jcfg, pcfg = _configs(norm="group", **HEAD)
    variables = _as_group_norm(_variables(**HEAD))
    variables["params"] = _randomise_norms(variables["params"],
                                           np.random.default_rng(0))
    tpipe = RegistrationPipeline(pcfg, flax_to_state_dict(variables),
                                 device="cpu")
    norms = [m for m in tpipe.net.modules()
             if isinstance(m, tlayers.AdaptiveGroupNorm)]
    batch_norms = [m for m in _head_setup()[4].net.modules()
                   if isinstance(m, tlayers.BatchNorm)]
    assert len(norms) == len(batch_norms) > 0 and not any(
        isinstance(m, tlayers.BatchNorm) for m in tpipe.net.modules())
    batch = _dataset().batch(2)
    ref = np.asarray(JPipeline(jcfg, variables).render(batch))
    got = tpipe.render(batch).numpy()
    assert float(np.abs(got - ref).max()) <= F32_RENDER_TOL


def test_resnet_tree_with_head_and_group_norm_maps_one_to_one():
    """A model with ResNet-18, ``norm="group"`` (the backbone's norms and
    the decoder's) and the shipped head (256-D, widths 32-256): the names
    and shapes of the JAX package's variable tree (``jax.eval_shape`` of
    the ``_call_and_embed`` init, no weights made) are those of the port's
    state_dict, and the tree loads strictly."""
    jcfg, pcfg = _configs(norm="group", backbone="ResNet18",
                          embed_dims=(64, 64, 64), img_height=64,
                          img_width=64, ori_img_height=64, ori_img_width=64,
                          retrieval_embed_dim=256)
    batch = SyntheticDataset(n_items=1, num_views=2, window_num_imgs=1,
                             img_height=64, img_width=64).batch(1)
    shapes = jax.eval_shape(
        lambda: BEVRenderModel(jcfg).init(jax.random.PRNGKey(0), batch))
    assert "batch_stats" not in shapes
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   dict(shapes))
    state_dict = flax_to_state_dict(zeros)
    with torch.device("meta"):
        net = BEVRenderNet(pcfg.model)
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in state_dict.items()}
    assert tuple(state_dict["retrieval_head.Conv_0.weight"].shape) == (
        32, 3, 5, 5)
    assert tuple(state_dict["retrieval_head.Dense_0.weight"].shape) == (
        256, 256)
    assert "encoder.img_backbone.resnet.stem_bn.GroupNorm_0.weight" in \
        state_dict
    BEVRenderNet(pcfg.model).load_state_dict(state_dict, strict=True)


# ---- the trainer through the head -------------------------------------------

@functools.lru_cache(maxsize=None)
def _train_setup():
    """The JAX trainer and its state at the tiny head model's variables
    (``_variables``), the port's trainer, and the bridged weights."""
    jcfg, pcfg = _configs(**HEAD)
    for c in (jcfg.train, pcfg.train):
        c.batch_size, c.loss_type, c.eps = 2, "MSE_CONTRASTIVE", 1e-3
        c.work_dir = tempfile.mkdtemp()
    ds = _dataset()
    jtrainer = JTrainer(BEVRenderModel(jcfg), jcfg, ds)
    variables = _variables(**HEAD)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JTrainState(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=jtrainer.tx.init(params), step=jnp.zeros((), jnp.int32))
    ttrainer = Trainer(pcfg, ds, device="cpu")
    return jtrainer, jstate, ttrainer, flax_to_state_dict(variables), ds


def test_trainer_uses_the_head():
    _, _, ttrainer, state_dict, ds = _train_setup()
    assert ttrainer.use_embed_head
    state = ttrainer.create_state(state_dict=state_dict)
    tiles = torch.as_tensor(ds.batch(4)["map"])
    emb = ttrainer._embed(state.net, tiles)
    assert emb.shape == (4, 16)
    assert torch.equal(emb, state.net.embed(tiles))
    _, pcfg = _configs(**HEAD)
    pcfg.train.work_dir = tempfile.mkdtemp()
    own = Trainer(pcfg, ds, device="cpu", embed_fn=lambda x: x[:, 0, 0])
    assert not own.use_embed_head


def test_trainer_step_through_the_head_matches_jax(f32_sites):
    """Step 1 from the bridged state, MSE + contrastive loss through the
    head, AdamW eps 1e-3, float32 sites (as
    tests/test_torch_pyramid.py's step: with the bf16 sites a flipped
    rounding parts the two losses by 3.9e-4 at these weights): the losses
    to 1e-5, the gradient norm to 3e-3 (tests/test_torch_trainer.py's
    GRAD_NORM_REL), every parameter, the head's among them, to 1e-5 of its
    largest entry plus 0.2 of the learning rate (``_compare_states``
    there), and the head's updates to 0.2 of their largest entry. The head
    moved."""
    jtrainer, jstate0, ttrainer, state_dict, ds = _train_setup()
    batch = tprefetch.collate([ds[0], ds[1]])
    jstate, jm, _ = jtrainer._train_step(
        jax.tree_util.tree_map(jnp.copy, jstate0),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
    tstate = ttrainer.create_state(state_dict=state_dict)
    before = {k: v.clone() for k, v in tstate.net.state_dict().items()}
    tstate, tm, _ = ttrainer.train_step(tstate, batch, rng=1)
    for key in ("train_batch_loss", "train_batch_render_loss",
                "train_batch_retrieval_loss", "camera_encoder_grad_norm"):
        rel = 3e-3 if key == "camera_encoder_grad_norm" else 1e-5
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=rel,
                                   atol=0, err_msg=key)
    ref = flax_to_state_dict(_np_tree({"params": jstate.params,
                                       "batch_stats": jstate.batch_stats}))
    got = tstate.net.state_dict()
    assert got.keys() == ref.keys()
    for name, r in ref.items():
        if name.endswith("num_batches_tracked") or "running_" in name:
            continue
        err = float((got[name] - r).abs().max())
        assert err <= 1e-5 * float(r.abs().max()) + 0.2 * LR, name
        if name.startswith("retrieval_head."):
            dj, dt = r - before[name], got[name] - before[name]
            assert float(dj.abs().max()) > 0, name
            assert float((dt - dj).abs().max()) <= \
                0.2 * float(dj.abs().max()), name


def test_head_moves_under_a_database_loss_through_step_with():
    """The recall demo's path (tests/test_retrieval_head.py:96-120):
    ``_step_with`` with ``contrastive_loss_vs_db`` against the batch's own
    tiles, both sides through the head. The loss is finite and every head
    parameter moves."""
    _, _, ttrainer, state_dict, ds = _train_setup()
    batch = {k: torch.as_tensor(v) for k, v in ds.batch(4).items()}
    labels = torch.arange(4)
    tiles = batch["map"]

    def losses(net, out, b):
        loss = contrastive_loss_vs_db(ttrainer._embed(net, out),
                                      ttrainer._embed(net, tiles), labels)
        return loss, {"retrieval": loss}

    tstate = ttrainer.create_state(state_dict=state_dict)
    before = {n: p.detach().clone() for n, p in tstate.net.named_parameters()
              if n.startswith("retrieval_head.")}
    tstate, tm, _ = ttrainer._step_with(tstate, batch, 2, losses)
    assert np.isfinite(float(tm["train_batch_loss"]))
    assert float(tm["train_batch_retrieval_loss"]) > 0
    assert len(before) == 8
    for name, p in tstate.net.named_parameters():
        if name in before:
            assert float((p.detach() - before[name]).abs().max()) > 0, name
