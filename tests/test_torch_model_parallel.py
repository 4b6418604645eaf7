"""The port's model axis (``parallel.dist.init_model_parallel``) on the CPU:
the attention heads and ``ConvMLP``'s hidden channels split over M model
ranks, beside D data ranks, in ranks forked over gloo by the harness of
tests/test_torch_parallel.py. What D x M ranks compute is held against the
JAX package's unsharded step (its own dp+tp test, tests/test_parallel.py:
222-278), against one process of the port gradient by gradient, and the
split modules against whole ones.
"""

import numpy as np
import pytest
import torch

from bevrender_tpu_torch import config as tcfg
from bevrender_tpu_torch.convert import flax_to_state_dict
from bevrender_tpu_torch.data.synthetic import SyntheticDataset
from bevrender_tpu_torch.inference.register import RegistrationPipeline
from bevrender_tpu_torch.models import attention as tattn
from bevrender_tpu_torch.models import layers as tlayers
from bevrender_tpu_torch.ops import deform_attn as tda
from bevrender_tpu_torch.parallel import dist as pdist
from bevrender_tpu_torch.training import trainer as ttrainer
from bevrender_tpu_torch.training.trainer import Trainer
from test_torch_parallel import (NOISE_ONLY, _check_params, _cpu_state,
                                 _dataset, _dp_configs, _jax_step, _rows,
                                 run_ranks)
from test_torch_retrieval import f32_sites, use_f32_sites  # noqa: F401
from test_torch_wide_site import FLAGSHIP, PYRAMID, _site_calls, chip_smoke

# (data ranks, model ranks)
LAYOUTS = {"1x2": (1, 2), "2x2": (2, 2)}
# a split module's outputs and gradients against the whole module's, in
# float32: its partial sums in another order, ~1e-7 of each tensor's
# largest value; a gradient counted M times is off by 1
GRAD_REL = 1e-5
# a training step's gradients on D x M ranks against one process's. In
# float32, to 1e-5 of the gradient's global norm (what the clip reads): the
# tiny model at random weights amplifies the rounding of sums in another
# order, so that data ranks alone (M = 1) read up to 1.7e-5, and model
# ranks up to 6e-5, of the largest gradient element. In float64 the same
# runs agree to 3e-14 of it: each tensor is held to 1e-10 of its own
# largest element, which an error of any size in any part would break
STEP_REL = {"float32": 1e-5, "float64": 1e-10}


@pytest.fixture
def f32_sites_dropout(monkeypatch):
    """``f32_sites`` (every site in float32, no bf16 rounding that a sum in
    another order could flip) with the attention-dropout mask applied as
    ``site_consumer`` applies it."""
    use_f32_sites(monkeypatch)

    def consumer(q, k, v, bias, scale, keep=None, dropout_rate=0.0):
        p = torch.softmax(torch.matmul(k, q.transpose(-1, -2)) * scale
                          + bias, dim=-2)
        if keep is not None:
            p = torch.where(keep, p / (1.0 - dropout_rate),
                            torch.zeros_like(p))
        return torch.matmul(p.transpose(-1, -2), v)

    monkeypatch.setattr(tda, "site_consumer", consumer)


@pytest.fixture
def float64_everywhere(f32_sites_dropout, monkeypatch):
    """Every tensor of a training step in float64: new tensors by default,
    and every cast to float32 (the norms' ``.float()``, the sites' float32
    bias) made to float64 instead, so that no sum rounds to float32."""
    f64 = torch.float64
    to = torch.Tensor.to

    def to64(self, *args, **kw):
        args = tuple(f64 if a is torch.float32 else a for a in args)
        if kw.get("dtype") is torch.float32:
            kw["dtype"] = f64
        return to(self, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "float", lambda self: to(self, f64))
    monkeypatch.setattr(torch.Tensor, "to", to64)
    monkeypatch.setattr(tda, "lattice_bias", lambda t, p, H, W, kernel=None:
                        tda.lattice_bias_plain(t, p, H, W, f64))
    default = torch.get_default_dtype()
    torch.set_default_dtype(f64)
    yield
    torch.set_default_dtype(default)


def _split(world_model):
    D, M = world_model
    pdist.init_model_parallel(M)
    assert (pdist.data_world_size(), pdist.model_parallel()) == (D, M)
    return pdist.data_rank(), D


# ---- the JAX package's dp+tp test -------------------------------------

_JAX_STEP = {}


def _jax_step_once():
    """``_jax_step`` of tests/test_torch_parallel.py (the JAX trainer's
    unsharded step on the 8-row batch), compiled once for this module."""
    if not _JAX_STEP:
        _JAX_STEP["step"] = _jax_step()
    return _JAX_STEP["step"]


def _jax_setup_rank(rank, world, layout, variables, work_dir):
    d, D = _split(layout)
    _, cfg = _dp_configs(work_dir)
    trainer = Trainer(cfg, _dataset(), device="cpu")
    state = trainer.create_state(state_dict=flax_to_state_dict(variables))
    state, m, _ = trainer.train_step(state, _rows(_dataset().batch(8), d, D),
                                     rng=3)
    return {k: float(v) for k, v in m.items()}, _cpu_state(state)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_model_ranks_match_the_jax_unsharded_step(tmp_path, f32_sites,
                                                  layout):
    """The JAX package's own dp+tp setup (``tiny_model_config()``, batch 8,
    MSE_CONTRASTIVE, one frame a window) on 1 x 2 and 2 x 2 ranks from the
    bridged JAX weights, against the JAX ``Trainer._train_step`` on the 8
    rows, at that test's limits: loss rtol 5e-4, every parameter after the
    step rtol 5e-3 / atol 2e-4 (``proj_k.bias`` aside, whose gradient is
    zero in exact arithmetic: tests/test_torch_parallel.py). Every rank's
    state equals every other's bit for bit. Both frameworks' sites run in
    float32 (``f32_sites``), as in the data-parallel test."""
    variables, after, jm = _jax_step_once()
    D, M = LAYOUTS[layout]
    ranks = run_ranks(_jax_setup_rank, D * M, LAYOUTS[layout], variables,
                      str(tmp_path))
    m0, s0 = ranks[0]
    for m, s in ranks[1:]:
        assert m == m0
        assert all(torch.equal(s0[k], s[k]) for k in s0)
    np.testing.assert_allclose(m0["train_batch_loss"], jm["train_batch_loss"],
                               rtol=5e-4)
    ref = flax_to_state_dict(after)
    assert ref.keys() == s0.keys()
    _check_params(s0, ref, rtol=5e-3, atol=2e-4)


# ---- every parameter's gradient, with and without random masks ---------

# the tiny model with every random mask (drop path, dropout, attention
# dropout) at both SCA branches: stage 0 one group (views one by one),
# stage 1 four (views folded into the batch), two heads a group each
MASKS = dict(drop_path_rate=0.2, drop_rate=0.1, attn_drop_rate=0.1,
             embed_dims=(16, 16, 16), n_heads=(2, 8), n_groups=(1, 4))
# (precision, layout) of the gradient test: float64 on data and model
# ranks together holds the split exact; float32 on each layout holds it
# at the precision the model trains in
GRAD_CASES = [("float32", "1x2"), ("float32", "2x2"), ("float64", "2x2")]


def _grad_step(rank, world, layout, work_dir):
    """One training step of the tiny model with ``MASKS`` from seed 0 on
    this rank's rows: (metrics, every parameter's gradient as the clip
    receives it, after the trainer's mean over the ranks)."""
    d, D = _split(layout) if layout else (0, 1)
    cfg = tcfg.Config()
    cfg.model = tcfg.tiny_model_config(**MASKS)
    cfg.train.loss_type, cfg.train.batch_size = "MSE_CONTRASTIVE", 8
    cfg.train.work_dir = work_dir
    trainer = Trainer(cfg, _dataset(), device="cpu")
    state = trainer.create_state(seed=0)
    grads = []
    clip = ttrainer.clip_by_global_norm_
    ttrainer.clip_by_global_norm_ = lambda g, n: (
        grads.append([t.clone() for t in g]), clip(g, n))[1]
    try:
        _, m, _ = trainer.train_step(state, _rows(_dataset().batch(8), d, D),
                                     rng=11)
    finally:
        ttrainer.clip_by_global_norm_ = clip
    names = [n for n, _ in state.net.named_parameters()]
    return {k: float(v) for k, v in m.items()}, dict(zip(names, grads[0]))


def _check_grads(got, ref, rel=GRAD_REL, norm=False):
    """Each gradient within ``rel`` of its largest value, or with ``norm``
    of the global norm of all; the key bias's, zero in exact arithmetic
    (``NOISE_ONLY``), rounding noise in both: within ``rel`` of the
    largest gradient of all."""
    assert got.keys() == ref.keys()
    top = max(float(r.abs().max()) for r in ref.values())
    total = float(torch.linalg.vector_norm(torch.cat([
        r.reshape(-1) for r in ref.values()])))
    for name, r in ref.items():
        if name.endswith(NOISE_ONLY):
            assert float(got[name].abs().max()) <= rel * top, name
            assert float(r.abs().max()) <= rel * top, name
            continue
        scale = total if norm else max(float(r.abs().max()), 1e-30)
        err = float((got[name] - r).abs().max())
        assert err <= rel * scale, (name, err, scale)


@pytest.mark.parametrize("precision,layout", GRAD_CASES)
def test_every_gradient_equals_one_process(tmp_path, request, precision,
                                           layout):
    """Every parameter's gradient after the backward and the ranks' mean
    (what the global-norm clip receives), on D x M ranks, against one
    process of the port on the global batch: a split parameter's slices
    summed over the model group, a gradient that every model rank computes
    alike counted once, the masks of drop path, dropout (``ConvMLP``'s
    hidden one drawn whole and sliced) and attention dropout (drawn for
    every head), on views one by one and folded, the one process's. In
    float32 (float32 sites, ``f32_sites_dropout``) to 1e-5 of the
    gradient's global norm and the losses to 1e-5; in float64
    (``float64_everywhere``) each gradient to 1e-10 of its largest
    element. Every rank holds the same gradients bit for bit."""
    request.getfixturevalue("f32_sites_dropout" if precision == "float32"
                            else "float64_everywhere")
    one_m, one_g = _grad_step(0, 1, None, str(tmp_path))
    D, M = LAYOUTS[layout]
    ranks = run_ranks(_grad_step, D * M, LAYOUTS[layout], str(tmp_path))
    m0, g0 = ranks[0]
    for m, g in ranks[1:]:
        assert m == m0
        assert all(torch.equal(g0[k], g[k]) for k in g0)
    assert all(g.dtype == getattr(torch, precision) for g in g0.values())
    for key, v in one_m.items():
        if key != "camera_encoder_grad_norm":
            np.testing.assert_allclose(m0[key], v, rtol=1e-5, err_msg=key)
    _check_grads(g0, one_g, STEP_REL[precision],
                 norm=precision == "float32")


# ---- the split modules alone ------------------------------------------

def _module(kind):
    """A module of the tiny model's widths with random weights (a non-zero
    table), and its inputs."""
    torch.manual_seed(0)
    if kind == "conv_mlp":
        mod = tlayers.ConvMLP(8, 2)
        inputs = (torch.randn(2, 6, 6, 8),)
    elif kind == "tsa":
        mod = tattn.TSADeformableAttention(8, 2, 1, 2, 3, 8)
        inputs = (torch.randn(2, 8, 8, 8), torch.randn(2, 8, 8, 8))
    else:
        G, heads, dim = (4, 8, 16) if kind == "sca_folded" else (1, 2, 8)
        mod = tattn.SCADeformableAttention(dim, heads, G, 2, 8, n_views=2)
        inputs = (torch.randn(2, 8, 8, dim), torch.randn(2, 2, 8, 8, dim),
                  torch.rand(2, 4, 16, 2) * 2 - 1)
    tlayers.init_params(mod, 0)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            if name.endswith("bias") or name == "rpe_table":
                p.copy_(torch.randn(p.shape) * 0.1)
    return mod.train(), inputs


def _module_run(rank, world, kind):
    if world > 1:
        pdist.init_model_parallel(world)
    mod, inputs = _module(kind)
    inputs = tuple(x.requires_grad_(True) for x in inputs)
    out = mod(*inputs)
    ct = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
    (out * ct).sum().backward()
    return (out.detach(), [x.grad for x in inputs],
            {n: p.grad for n, p in mod.named_parameters()})


@pytest.mark.parametrize("kind", ["tsa", "sca_views", "sca_folded",
                                  "conv_mlp"])
def test_split_modules_equal_whole_ones(f32_sites_dropout, kind):
    """TSA, SCA (views one by one; views folded, G = 4) and ``ConvMLP`` on
    2 model ranks against the whole module in one process: the output, the
    inputs' gradients and every parameter's gradient to 1e-5 of the
    tensor's largest value (float32 sites, ``f32_sites_dropout``: the
    partial sums of a split reorder them, and one process's bf16 site may
    round a score otherwise at Hpg = 1 than at Hpg = 2), and the two
    ranks' bit for bit."""
    ref = _module_run(0, 1, kind)
    ranks = run_ranks(_module_run, 2, kind)
    for out, gin, gpar in ranks:
        for got, want in [(out, ref[0])] + list(zip(gin, ref[1])):
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= GRAD_REL * scale
        _check_grads(gpar, ref[2])
    assert torch.equal(ranks[0][0], ranks[1][0])
    assert all(torch.equal(a, b) for a, b in zip(ranks[0][1], ranks[1][1]))


# ---- serving: register and the sharded matcher --------------------------

def _pipeline():
    cfg = tcfg.Config()
    cfg.model = tcfg.tiny_model_config(retrieval_embed_dim=16,
                                       retrieval_head_widths=(8, 16))
    pipe = RegistrationPipeline(cfg, device="cpu", seed=0)
    tiles = SyntheticDataset(n_items=13, num_views=2, window_num_imgs=1,
                             img_height=32, img_width=32, map_tile=32,
                             seed=4).batch(13)["map"]
    return pipe, list(tiles), _dataset(3).batch(3)


def _register_rank(rank, world, layout):
    _split(layout) if world > 1 else None
    pipe, tiles, batch = _pipeline()
    db = pipe.build_tile_database(tiles)
    render, idx, dist_ = pipe.register(batch, top_k=5)
    with torch.no_grad():
        q = pipe.embed(render)
    padded, n = RegistrationPipeline.pad_tile_db(db, pdist.data_world_size())
    nl = padded.shape[0] // pdist.data_world_size()
    r = pdist.data_rank()
    sharded = RegistrationPipeline.make_sharded_matcher(5)(
        q, padded[r * nl:(r + 1) * nl], n)
    return render, idx, dist_, sharded


def test_register_and_matcher_on_model_ranks(float64_everywhere):
    """``register`` on 2 x 2 ranks (the tiny model with its 16-D head, 13
    tiles), two model ranks a data rank, against one process: the render
    and the distances to 1e-10
    (float64 throughout, ``float64_everywhere``: in float32 the tiny
    model's two frames amplify the model ranks' sums in another order to
    2.5e-5 of the render), the top-5 the same tiles; the sharded matcher
    over the data ranks (the 13 tiles padded to D shards, model ranks on
    the same shard) returns that top-5 on every rank; every rank's results
    equal bit for bit."""
    ref = _register_rank(0, 1, None)
    ranks = run_ranks(_register_rank, 4, LAYOUTS["2x2"])
    for render, idx, dist_, (sidx, sdist) in ranks:
        assert render.dtype == torch.float64
        assert float((render - ref[0]).abs().max()) <= 1e-10
        assert idx.tolist() == ref[1].tolist() == sidx.tolist()
        np.testing.assert_allclose(dist_.numpy(), ref[2].numpy(), atol=1e-10)
        np.testing.assert_allclose(sdist.numpy(), dist_.numpy(), atol=1e-10)
    assert all(torch.equal(ranks[0][0], r[0]) for r in ranks[1:])


# ---- refusals ------------------------------------------------------------

def _refusals(rank, world):
    msgs = []
    with pytest.raises(ValueError, match="3 ranks not divisible by "
                                         "model_parallel=2") as e:
        pdist.init_model_parallel(2)
    msgs.append(str(e.value))
    return msgs


def _hpg_refusal(rank, world):
    pdist.init_model_parallel(2)
    mod = tattn.TSADeformableAttention(8, 2, 2, 2, 3, 8)  # Hpg = 1
    with pytest.raises(ValueError, match="1 heads a group do not split "
                                         "over 2 model ranks"):
        mod(torch.randn(1, 8, 8, 8), None)
    sca = tattn.SCADeformableAttention(8, 4, 4, 2, 8, n_views=2)
    with pytest.raises(ValueError, match="1 heads a group"):
        sca(torch.randn(1, 8, 8, 8), torch.randn(1, 2, 8, 8, 8),
            torch.rand(2, 4, 16, 2) * 2 - 1)
    return True


def test_refusals_of_a_split_that_does_not_divide(monkeypatch):
    """W % M != 0 raises with the meaning of the JAX package's
    ``make_mesh`` message ("devices not divisible by"), on 3 ranks and
    without a group (one rank); a site whose heads a group do not split
    over the model ranks (Hpg = 1 on M = 2) raises at its forward."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="1 ranks not divisible by "
                                         "model_parallel=2"):
        pdist.initialize_distributed("cpu", model_parallel=2)
    assert run_ranks(_refusals, 3) == [[
        "3 ranks not divisible by model_parallel=2"]] * 3
    assert run_ranks(_hpg_refusal, 2) == [True, True]


def _layout(rank, world):
    pdist.init_model_parallel(2)
    out = (pdist.data_rank(), pdist.model_rank(), pdist.data_world_size(),
           pdist.model_parallel(), pdist.is_main())
    x = torch.tensor([float(rank)])
    mean = [x.clone()]
    pdist.all_reduce_mean_(mean)
    y = pdist.sum_model(torch.tensor([float(rank)]))
    g = pdist.gather_model(torch.tensor([[float(rank)]]), 1)
    rows = pdist.all_gather_rows(torch.tensor([float(rank)]))
    return out + (float(mean[0]), float(y), g.tolist(), rows.tolist())


def test_rank_layout_is_the_mesh_layout():
    """On 4 ranks with M = 2: global rank d * M + m is model rank m of
    data rank d (``make_mesh``'s reshape to (n // M, M)); the model sum
    and gather join the ranks of one data rank in model-rank order, the
    row gather the ranks of one model rank in data-rank order; the
    trainer's mean is over every rank; rank 0 alone is main."""
    assert run_ranks(_layout, 4) == [
        (0, 0, 2, 2, True, 1.5, 1.0, [[0.0, 1.0]], [0.0, 2.0]),
        (0, 1, 2, 2, False, 1.5, 1.0, [[0.0, 1.0]], [1.0, 3.0]),
        (1, 0, 2, 2, False, 1.5, 5.0, [[2.0, 3.0]], [0.0, 2.0]),
        (1, 1, 2, 2, False, 1.5, 5.0, [[2.0, 3.0]], [1.0, 3.0])]


# ---- the kernels a model rank launches ------------------------------------

def _rank_launches(mc, B, options, training, M):
    """The launches of a T=2 window on one of M model ranks, from
    ``site_kernels`` at Hpg / M (tests/test_torch_wide_site.py's sum)."""
    counts = {}
    for q, t, H, W, n in _site_calls(mc, B):
        q = q[:2] + (q[2] // M,) + q[3:]
        t = (t[0], t[1] // M) + t[2:]
        for final in (False, training):
            for name in tda.site_kernels(q, t, H, W, options, training=final):
                counts[name] = counts.get(name, 0) + n
    return counts


@pytest.mark.parametrize("options", [
    dict(), dict(fused_bwd=True), dict(lattice_route="wide"),
    dict(lattice_route="wide", site_prefetch=True, bias_forward="prefetch"),
    dict(lattice_route="wide", site_prefetch=True, site_fold_heads=True),
    dict(site_prefetch=True, site_fold_heads=True, fused_bwd=True),
    dict(site_fold_rows=True), dict(bias_forward="windows")])
def test_one_head_a_group_takes_the_kernels_of_two(options):
    """Every flagship and pyramid site at Hpg = 1 (two model ranks) takes
    the kernels it takes at Hpg = 2, serving and training, on every route
    and option: the tables halve, and no fit of ``site_route``,
    ``bias_route``, ``heads_fit``, ``rows_fit`` or ``_site_bwd_fits``
    changes. chip_smoke's phase 31 holds the flagship's counts a rank
    (``MP_SERVE_COUNTS``, ``MP_TRAIN_COUNTS``) on the card."""
    opts = tda.SiteOptions(**options)
    for mc, B in ((FLAGSHIP, 2), (FLAGSHIP, 4), (PYRAMID, 2)):
        for training in (False, True):
            assert _rank_launches(mc, B, opts, training, 2) == \
                _rank_launches(mc, B, opts, training, 1)
    assert _rank_launches(FLAGSHIP, chip_smoke.MP_B, tda.SiteOptions(),
                          False, 2) == chip_smoke.MP_SERVE_COUNTS
    assert _rank_launches(FLAGSHIP, chip_smoke.MP_B, tda.SiteOptions(),
                          True, 2) == chip_smoke.MP_TRAIN_COUNTS


# ---- the reference API's classes and functions (item 10) -----------------

LOSS_CLASSES = ["MSELoss", "L1Loss", "CrossEntropyLoss", "ContrastiveLoss",
                "TripletLossMetricLearning", "LiftedStructureLoss"]


@pytest.mark.parametrize("name", LOSS_CLASSES)
def test_loss_classes_match_jax(name):
    """Each loss class's ``get_loss`` against the JAX package's on the same
    seeded inputs, to 1e-6: renders and targets (2, 3, 8, 8) for the
    rendering losses (probability targets over axis 1 for the cross
    entropy), camera and map embeddings (6, 16) for the metric ones."""
    import jax.numpy as jnp

    import bevrender_tpu.losses as jlosses
    import bevrender_tpu_torch.losses as tlosses

    rng = np.random.default_rng(7)
    if name in LOSS_CLASSES[:3]:
        a = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
        b = rng.uniform(0, 1, (2, 3, 8, 8)).astype(np.float32)
        if name == "CrossEntropyLoss":
            b = b / b.sum(axis=1, keepdims=True)
    else:
        a = rng.standard_normal((6, 16)).astype(np.float32)
        b = (a + 0.5 * rng.standard_normal((6, 16))).astype(np.float32)
    got = float(getattr(tlosses, name)().get_loss(torch.from_numpy(a),
                                                  torch.from_numpy(b)))
    ref = float(getattr(jlosses, name)().get_loss(jnp.asarray(a),
                                                  jnp.asarray(b)))
    assert ref != 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_losses_package_exports_the_jax_names():
    import bevrender_tpu.losses as jlosses
    import bevrender_tpu_torch.losses as tlosses

    def names(mod):
        return {n for n, v in vars(mod).items() if not n.startswith("_")
                and not isinstance(v, type(mod))}

    assert names(tlosses) == names(jlosses)
    assert set(LOSS_CLASSES) < names(tlosses)


def test_get_config_and_window_key_shape_equal_jax(capsys):
    """``get_config()`` is the JAX package's reference dict (but for the
    checkpoint directory, whose default here is the system's temporary
    directory: tests/test_torch_train_cli.py), printed with
    ``print_or_not``; ``window_key_shape`` equals JAX's for ``Config()``
    and ``flagship_config()``."""
    from bevrender_tpu import config as jconfig

    ours, theirs = tcfg.get_config(), jconfig.get_config()
    assert list(ours) == list(theirs)
    assert {k for k in ours if ours[k] != theirs[k]} == {"CKPT_DIR"}
    assert capsys.readouterr().out == ""
    assert tcfg.get_config(print_or_not=True, save_or_not=True) == ours
    assert "Configuration:" in capsys.readouterr().out
    for make in ("Config", "flagship_config"):
        mt, mj = getattr(tcfg, make)().model, getattr(jconfig, make)().model
        assert mt.window_key_shape == mj.window_key_shape
    assert tcfg.flagship_config().model.window_key_shape == (14, 28 * 5)


def test_bev2camera_projector_equals_jax(tmp_path):
    """``BEV2CameraProjector.bev_grid_to_camera`` on ``default_camera_rig``
    (3 views, capture 640 x 512 resized to 224) equals the JAX package's
    bit for bit, its rescaled intrinsics too. With ``remove_ref_in_gray``
    on calibration PNGs (written by the port's encoder) it equals the JAX
    class, which reads them through PIL, and the port's function form
    (``reference_points_all_types``), and drops points."""
    from bevrender_tpu.geometry import projection as jproj
    from bevrender_tpu_torch.data.png import encode_png
    from bevrender_tpu_torch.geometry import projection as tproj

    rig = tproj.default_camera_rig(img_width=640, img_height=512)
    pts = tproj.sample_3d_points({"X": 25.2, "Y": 25.2, "Z": 2.5}, 28, 5,
                                 -1.0)
    kw = dict(imu_to_rgb=rig[0], K=rig[1], vehicle_type_code=0,
              img_width=224, img_height=224, ori_img_width=640,
              ori_img_height=512)
    ours = tproj.BEV2CameraProjector(**kw)
    theirs = jproj.BEV2CameraProjector(**kw)
    for a, b in zip(ours.K[0], theirs.K[0]):
        np.testing.assert_array_equal(a, b)
    got, ref = ours.bev_grid_to_camera(pts), theirs.bev_grid_to_camera(pts)
    assert list(got) == list(ref) == [0]
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_array_equal(a, b)

    rng = np.random.default_rng(3)
    paths = []
    for v in range(3):
        img = rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
        img[40 + 30 * v:150, 20:200] = 128
        encode_png(tmp_path / f"calib{v}.png", img)
        paths.append(str(tmp_path / f"calib{v}.png"))
    gray = dict(kw, remove_ref_in_gray=True, bound_check_img_paths=paths)
    masked = tproj.BEV2CameraProjector(**gray).bev_grid_to_camera(pts)[0]
    for a, b in zip(masked, jproj.BEV2CameraProjector(
            **gray).bev_grid_to_camera(pts)[0]):
        np.testing.assert_array_equal(a, b)
    fn = tproj.reference_points_all_types(
        rig[0], rig[1], [0], {"X": 25.2, "Y": 25.2, "Z": 2.5}, 28, 5, -1.0,
        224, 224, 640, 512, remove_ref_in_gray=True,
        bound_check_img_paths=paths)[0]
    np.testing.assert_array_equal(
        np.stack([v.transpose(1, 2, 3, 0).reshape(v.shape[1], -1, 2)
                  for v in masked]), fn)
    dropped = sum(int((m == -1).all(0).sum() - (p == -1).all(0).sum())
                  for m, p in zip(masked, got[0]))
    assert dropped > 0


@pytest.mark.parametrize("name", ["LayerNorm2d", "LayerScale",
                                  "FeedForwardLayer"])
def test_reference_layers_match_flax(monkeypatch, name):
    """``LayerNorm2d``, ``LayerScale`` and ``FeedForwardLayer`` with the
    flax module's parameters (randomised, through
    ``convert.flax_to_state_dict``, strict) give flax's output on a seeded
    NHWC input to 1e-5, in float32."""
    import jax
    import jax.numpy as jnp

    from bevrender_tpu.models import layers as jlayers

    monkeypatch.setattr(jlayers, "_COMPUTE_DTYPE", [None])  # float32 dense
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    jmod, tmod = {
        "LayerNorm2d": (jlayers.LayerNorm2d(), tlayers.LayerNorm2d(8)),
        "LayerScale": (jlayers.LayerScale(8), tlayers.LayerScale(8)),
        "FeedForwardLayer": (jlayers.FeedForwardLayer(8, 12),
                             tlayers.FeedForwardLayer(8, 12))}[name]
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.standard_normal(p.shape).astype(
            np.float32) * 0.5, params)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod.load_state_dict(flax_to_state_dict({"params": params}), strict=True)
    got = tmod(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
