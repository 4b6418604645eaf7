"""The port's trainer held against the JAX package's on the CPU: loss
selection, schedule, K-fold split, BatchNorm statistics, optimizer steps
from bridged weights, the optimizer-state bridge, and the parts that have
no JAX counterpart to compare with (checkpoints, device default, dropout
masks), on the tiny config with ``device="cpu"``.
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
from bevrender_tpu.data import prefetch as jprefetch
from bevrender_tpu.models.bevrender import BEVRenderModel
from bevrender_tpu.training.schedule import warmup_cosine_lambda as j_lambda
from bevrender_tpu.training.trainer import Trainer as JTrainer
from bevrender_tpu.training.trainer import select_losses as j_select
from bevrender_tpu_torch import config as tcfg
from bevrender_tpu_torch.convert import (
    flax_to_state_dict,
    load_adamw_state,
    train_state_to_torch,
)
from bevrender_tpu_torch.data import prefetch as tprefetch
from bevrender_tpu_torch.data.synthetic import SyntheticDataset
from bevrender_tpu_torch.inference.register import RegistrationPipeline
from bevrender_tpu_torch.losses.recall import recall_at_k
from bevrender_tpu_torch.models import layers as tlayers
from bevrender_tpu_torch.models.bevrender import BEVRenderNet
from bevrender_tpu_torch.training import checkpoint as tckpt
from bevrender_tpu_torch.training.schedule import warmup_cosine_lambda
from bevrender_tpu_torch.training.trainer import (
    Trainer,
    clip_by_global_norm_,
    kfold_indices,
    select_losses,
)


def _dataset(n=8):
    return SyntheticDataset(n_items=n, num_views=2, window_num_imgs=1,
                            img_height=32, img_width=32, map_tile=32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- loss selection, schedule, K-fold --------------------------------------

@pytest.mark.parametrize("loss_type", [
    "MSE", "L1", "CROSS_ENTROPY_RENDER", "LIFT", "TRIPLET", "CONTRASTIVE",
    "CROSS_ENTROPY_RTRVL", "MSE_CONTRASTIVE", "L1_TRIPLET", "MSE_LIFT",
    "CROSS_ENTROPY_RENDER_CROSS_ENTROPY_RTRVL", "NONE"])
def test_select_losses_matches_jax(loss_type):
    jr, jq, jrf, jqf = j_select(loss_type)
    tr, tq, trf, tqf = select_losses(loss_type)
    assert (tr, tq) == (jr, jq)
    assert (trf is None) == (jrf is None) and (tqf is None) == (jqf is None)
    for tf, jf in ((trf, jrf), (tqf, jqf)):
        if tf is not None and jf.__name__ != "<lambda>":
            assert tf.__name__ == jf.__name__
    if "CROSS_ENTROPY_RENDER" in loss_type:  # the class axis is the last
        rng = np.random.default_rng(0)
        p = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
        t = rng.uniform(0, 1, (2, 4, 4, 3)).astype(np.float32)
        assert abs(float(trf(torch.from_numpy(p), torch.from_numpy(t)))
                   - float(jrf(jnp.asarray(p), jnp.asarray(t)))) < 1e-6


def test_trainer_refuses_a_loss_type_without_a_loss(tmp_path):
    cfg = tcfg.Config()
    cfg.model = tcfg.tiny_model_config()
    cfg.train.loss_type = "NONE"
    cfg.train.work_dir = str(tmp_path)
    with pytest.raises(ValueError, match="selects no loss"):
        Trainer(cfg, _dataset(), device="cpu")


@pytest.mark.parametrize("warmup,total", [(5, 100), (0, 10), (3, 3)])
def test_schedule_matches_jax(warmup, total):
    for epoch in range(total + 2):
        assert warmup_cosine_lambda(epoch, warmup, total) == \
            j_lambda(epoch, warmup, total)


@pytest.mark.parametrize("n,k,seed", [(8, 2, 15213), (23, 5, 0), (10, 10, 7),
                                      (100, 3, 42)])
def test_kfold_matches_sklearn(n, k, seed):
    from sklearn.model_selection import KFold

    ref = list(KFold(n_splits=k, shuffle=True, random_state=seed).split(
        np.arange(n)))
    got = list(kfold_indices(n, k, seed))
    assert len(got) == len(ref) == k
    for (gt, gv), (rt, rv) in zip(got, ref):
        np.testing.assert_array_equal(gt, rt)
        np.testing.assert_array_equal(gv, rv)


def test_kfold_refuses_more_folds_than_samples():
    with pytest.raises(ValueError, match="k_fold"):
        list(kfold_indices(3, 5, 0))


# ---- data loading ----------------------------------------------------------

@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_dataloader_matches_jax(shuffle, drop_last):
    ds = _dataset(7)
    sampler = np.array([6, 0, 3, 5, 1])
    kw = dict(shuffle=shuffle, num_workers=2, drop_last=drop_last, seed=3,
              sampler=sampler)
    jl, tl = jprefetch.DataLoader(ds, 2, **kw), tprefetch.DataLoader(ds, 2, **kw)
    for epoch in (0, 4):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == len(tl) == len(jl)
        for a, b in zip(jb, tb):
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
    grouped = list(tprefetch.group_batches(iter(tl), 2))
    ref = list(jprefetch.group_batches(iter(jl), 2))
    assert [g["map"].shape for g in grouped] == [g["map"].shape for g in ref]


def test_device_prefetch_yields_tensors_and_surfaces_errors():
    ds = _dataset(4)
    out = list(tprefetch.device_prefetch(
        iter(tprefetch.DataLoader(ds, 2, drop_last=True)), "cpu"))
    assert len(out) == 2 and torch.is_tensor(out[0]["camera"])
    assert out[0]["camera"].shape == (2, 2, 2, 32, 32, 3)
    np.testing.assert_array_equal(out[1]["map"].numpy(),
                                  np.stack([ds[2]["map"], ds[3]["map"]]))

    def broken():
        yield {"x": np.zeros(2)}
        raise RuntimeError("bad sample")

    with pytest.raises(RuntimeError, match="bad sample"):
        list(tprefetch.device_prefetch(broken(), "cpu"))


# ---- stochastic layers -----------------------------------------------------

def test_drop_path_masks_whole_samples_and_rescales():
    layer = tlayers.DropPath(0.25).train()
    layer.generator = torch.Generator().manual_seed(0)
    x = torch.ones(4000, 3, 2)
    y = layer(x)
    kept = y[:, 0, 0] != 0
    assert bool(((y == 0) | (y == 1 / 0.75)).all())
    assert bool((y == y[:, :1, :1]).all())  # one draw per sample
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    layer.generator.manual_seed(0)
    assert torch.equal(layer(x), y)          # the generator decides the mask
    assert torch.equal(layer.eval()(x), x)   # identity at eval
    assert torch.equal(tlayers.DropPath(0.0).train()(x), x)


def test_dropout_is_elementwise_and_seeded():
    layer = tlayers.Dropout(0.4).train()
    gen = torch.Generator().manual_seed(1)
    tlayers.set_generator(layer, gen)
    x = torch.ones(200, 50)
    y = layer(x)
    assert bool(((y == 0) | ((y - 1 / 0.6).abs() < 1e-6)).all())
    assert abs(float((y != 0).float().mean()) - 0.6) < 0.02
    assert abs(float(y.mean()) - 1.0) < 0.05
    gen.manual_seed(1)
    assert torch.equal(layer(x), y)
    assert torch.equal(layer.eval()(x), x)


def test_model_dropout_follows_the_step_seed(tmp_path):
    """Two trainers with one seed draw the same masks step for step; the
    masks change from step to step."""
    cfg = tcfg.Config()
    cfg.model = tcfg.tiny_model_config(drop_path_rate=0.3, drop_rate=0.1,
                                       attn_drop_rate=0.1)
    cfg.train.work_dir = str(tmp_path)
    batch = _dataset().batch(2)
    runs = []
    for _ in range(2):
        trainer = Trainer(cfg, _dataset(), device="cpu")
        state = trainer.create_state(seed=0)
        losses = []
        for _ in range(2):
            state, m, _ = trainer.train_step(state, batch, rng=11)
            losses.append(float(m["train_batch_loss"]))
        runs.append(losses)
    assert runs[0] == runs[1]
    net = state.net.train()
    args = [torch.as_tensor(batch[k]) for k in ("camera", "vehicle_pose",
                                                "vehicle_type")]
    outs = []
    for seed in (1, 1, 2):
        trainer._gen.manual_seed(seed)
        with torch.no_grad():
            outs.append(net(*args))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


# ---- the JAX trainer and the port's, from the same weights -----------------

def _configs(loss_type, eps, work_dir):
    j, t = JConfig(), tcfg.Config()
    j.model, t.model = j_tiny(), tcfg.tiny_model_config()
    j.data.window_num_imgs = 1
    for c in (j.train, t.train):
        c.batch_size, c.loss_type, c.eps = 2, loss_type, eps
        c.work_dir = work_dir
    return j, t


@functools.lru_cache(maxsize=None)
def _setup(loss_type, eps):
    """JAX trainer and state, the port's trainer, and the bridged weights."""
    jcfg, pcfg = _configs(loss_type, eps, tempfile.mkdtemp())
    ds = _dataset()
    jtrainer = JTrainer(BEVRenderModel(jcfg), jcfg, ds)
    sample = ds.batch(2)
    jstate = jtrainer.create_state(jax.random.PRNGKey(0), sample)
    variables = _np_tree({"params": jstate.params,
                          "batch_stats": jstate.batch_stats})
    return jtrainer, jstate, Trainer(pcfg, ds, device="cpu"), variables


LR = 1e-4  # TrainConfig.learning_rate


def _compare_states(tstate, jstate, rel, what):
    """Every parameter and BatchNorm buffer of the port against the JAX
    state after one step from equal state: ``rel`` of the tensor's largest
    entry, plus 0.2 of what AdamW can have moved an entry in that step (the
    learning rate). The second term is for tensors still near their zero
    initial value, which hold nothing but their updates: those inherit,
    through Adam's division, the gradients' bf16 noise, which is largest for
    the offset heads (their gradient comes through the bias path, bf16 end
    to end on the CPU: 5e-2 in test_torch_grads.py). The optimizer's own
    arithmetic is held to 1e-6 in test_clip_and_adamw_match_optax."""
    ref = flax_to_state_dict(_np_tree({"params": jstate.params,
                                       "batch_stats": jstate.batch_stats}))
    got = tstate.net.state_dict()
    assert got.keys() == ref.keys()
    worst = 0.0
    for name, r in ref.items():
        if name.endswith("num_batches_tracked"):
            continue
        scale = float(r.abs().max())
        err = float((got[name] - r).abs().max())
        if "running_" in name:
            # BatchNorm statistics see the sites' bf16 flips in full
            assert err <= 5e-4 * max(scale, 1e-2), f"{what} {name}: {err}"
            continue
        tol = rel * scale + 0.2 * LR
        assert err <= tol, f"{what} {name}: {err} of {scale}"
        worst = max(worst, err / tol)
    return worst


# The attention sites round K, Q, p, V and (on the CPU) the bias lerps to
# bf16 in both frameworks; a float32 difference in the last bit flips one of
# those roundings now and then (2^-9 of an entry). Measured on the tiny
# config at the bridged initial weights that moves the global gradient norm
# by up to 1e-3 relative, so the norm is held to 3e-3 and the loss, which
# the flips barely move, to 1e-5.
GRAD_NORM_REL = 3e-3


def _check_metrics(tm, jm, keys):
    """Step 1, from the bridged initial weights: the losses to 1e-5, the
    norm to GRAD_NORM_REL."""
    for key in keys:
        rel = GRAD_NORM_REL if key == "camera_encoder_grad_norm" else 1e-5
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=rel,
                                   atol=0, err_msg=key)


# Steps 2 and 3 each start, in both frameworks, from the JAX state before
# them. After a step the offset heads are no longer zero and the sampling
# points leave the lattice; from there on this tiny model at random weights
# is ill-conditioned in JAX itself: one JAX step from weights perturbed by
# 1e-6 relative (each parameter times 1 + 1e-6 * a standard normal draw)
# parts from the unperturbed JAX step by up to 1.7e-3 in a loss, 0.36 in the
# gradient norm, 8.3e-2 in the render, 1.7e-2 in a running statistic, and
# by 0.10 to 0.49 in the median over the tensors of an update's relative L2
# error (over the three steps under both loss settings below). The port
# stays inside that: it read at most 4.2e-4, 4.6e-2, 1.2e-2, 2.1e-3 and
# 0.077 (largest tensor 0.43). The limits are about twice the port's
# readings. A port that took no step reads 1.0 in every tensor's update
# error.
LATER_LOSS_REL = 1e-3
LATER_NORM_REL = 1e-1
LATER_RENDER_ABS = 3e-2
LATER_STAT_REL = 5e-3
LATER_UPDATE_MEDIAN = 0.15
LATER_UPDATE_MAX = 0.6


def _check_later_step(what, jstate, tstate, jm, tm, jrender, trender,
                      before, keys):
    """One step from a bridged JAX state at generic weights, held to the
    LATER_* limits: metrics, render, BatchNorm statistics, and each
    tensor's update (its change in this step) by its relative L2 error."""
    for key in keys:
        rel = (LATER_NORM_REL if key == "camera_encoder_grad_norm"
               else LATER_LOSS_REL)
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=rel,
                                   atol=0, err_msg=f"{what} {key}")
    np.testing.assert_allclose(trender.numpy(), np.asarray(jrender),
                               atol=LATER_RENDER_ABS, rtol=0, err_msg=what)
    ref = flax_to_state_dict(_np_tree({"params": jstate.params,
                                       "batch_stats": jstate.batch_stats}))
    got = tstate.net.state_dict()
    assert got.keys() == ref.keys()
    errs = {}
    for name, r in ref.items():
        if name.endswith("num_batches_tracked"):
            continue
        if "running_" in name:
            err = float((got[name] - r).abs().max())
            assert err <= LATER_STAT_REL * max(float(r.abs().max()), 1e-2), \
                f"{what} {name}: {err}"
            continue
        if name.endswith("proj_k.bias"):
            continue  # its gradient is zero in exact arithmetic: noise
        dj, dt = r - before[name], got[name] - before[name]
        assert float(dj.norm()) > 0, f"{what} {name}"
        errs[name] = float((dt - dj).norm() / dj.norm())
    worst = max(errs, key=errs.get)
    assert errs[worst] <= LATER_UPDATE_MAX, f"{what} {worst}: {errs[worst]}"
    median = float(np.median(list(errs.values())))
    assert median <= LATER_UPDATE_MEDIAN, f"{what}: median {median}"


def _adam_state(opt_state):
    """The ``scale_by_adam`` state inside the JAX trainer's optimizer state."""
    found = []

    def walk(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            found.append(node)
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)
        elif hasattr(node, "inner_state"):
            walk(node.inner_state)

    walk(opt_state)
    assert len(found) == 1
    return found[0]


def _bridged(ttrainer, jstate):
    """The whole JAX state (weights, BatchNorm statistics, AdamW moments and
    count) as a state of the port's trainer."""
    adam = _adam_state(jstate.opt_state)
    state_dict, adamw = train_state_to_torch(
        _np_tree(jstate.params), _np_tree(jstate.batch_stats),
        {"mu": _np_tree(adam.mu), "nu": _np_tree(adam.nu),
         "count": int(adam.count)})
    assert adamw["step"] == int(jstate.step)
    tstate = ttrainer.create_state(state_dict=state_dict)
    load_adamw_state(tstate.optimizer, tstate.net, adamw)
    tstate.step = adamw["step"]
    return tstate


def _three_steps(loss_type, eps):
    """Three JAX steps in a row. The port takes step 1 from the bridged
    weights and each later step from the whole JAX state before it (AdamW's
    moments and count included): left to run on its own it parts from JAX by
    more than an update's size within two steps (see the LATER_* limits),
    and a comparison that loose would pass a port that took no step at all.
    Yields, per step, both states and metrics after it, both renders, and
    the port's tensors before it."""
    jtrainer, jstate0, ttrainer, variables = _setup(loss_type, eps)
    jstate = jstate0
    ds = _dataset()
    rng = jax.random.PRNGKey(1)
    for step in range(3):
        batch = tprefetch.collate([ds[2 * step], ds[2 * step + 1]])
        if step == 0:
            tstate = ttrainer.create_state(
                state_dict=flax_to_state_dict(variables))
        else:
            tstate = _bridged(ttrainer, jstate)
        before = {k: v.clone() for k, v in tstate.net.state_dict().items()}
        # the JAX step donates its state: hand it a copy, keep ours alive
        jstate, jm, jrender = jtrainer._train_step(
            jax.tree_util.tree_map(jnp.copy, jstate),
            {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        tstate, tm, trender = ttrainer.train_step(tstate, batch, rng=1)
        yield step, jstate, tstate, jm, tm, jrender, trender, before


def test_batchnorm_layer_matches_flax():
    """The layer alone on one numpy input, train mode: output, gradient of
    the input, and the running statistics after two updates (flax's biased
    variance E[x^2] - E[x]^2, momentum 0.9), to 1e-6; then eval mode on
    those statistics."""
    import flax.linen as fnn

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 4, 6)) * 2 + 1.5).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(6), "var": jnp.ones(6)}}
    tbn = tlayers.BatchNorm(6).train()
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
    for _ in range(2):
        def f(xx, variables=variables):
            return jbn.apply(variables, xx, mutable=["batch_stats"])
        jy, upd = f(jnp.asarray(x))
        jdx = jax.grad(lambda xx: jnp.sum(f(xx)[0] * ct))(jnp.asarray(x))
        variables = {"params": variables["params"],
                     "batch_stats": upd["batch_stats"]}
        tx = torch.from_numpy(x.copy()).requires_grad_()
        ty = tbn(tx)
        (tdx,) = torch.autograd.grad(ty, tx, torch.from_numpy(ct))
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                                   atol=2e-6, rtol=0)
        np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), atol=2e-6,
                                   rtol=0)
    stats = variables["batch_stats"]
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-6, rtol=0)
    # torch's own layer would have stored the unbiased variance
    unbiased = torch.nn.BatchNorm2d(6, momentum=0.1).train()
    for _ in range(2):
        unbiased(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert float((unbiased.running_var - tbn.running_var).abs().max()) > 1e-3
    jeval = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                          epsilon=1e-5).apply(variables, jnp.asarray(x))
    before = tbn.running_var.clone()
    np.testing.assert_allclose(tbn.eval()(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jeval), atol=2e-6, rtol=0)
    assert torch.equal(tbn.running_var, before)  # eval updates nothing


def test_batchnorm_running_statistics_match_flax():
    """The model after one train-mode step: the decoder's statistics
    follow flax's (one update, from the final pass: the history pass runs in
    eval mode). They sit downstream of the attention sites, whose bf16
    roundings flip now and then between the frameworks, so they are held to
    5e-4 of their largest entry and not to the layer's own 1e-6."""
    step, jstate, tstate, *_ = next(_three_steps("MSE", 1e-8))
    ref = flax_to_state_dict(_np_tree({"params": {},
                                       "batch_stats": jstate.batch_stats}))
    got = tstate.net.state_dict()
    stats = [n for n in ref if "running_" in n]
    assert len(stats) >= 4
    for name in stats:
        scale = float(ref[name].abs().max())
        assert float((got[name] - ref[name]).abs().max()) <= 5e-4 * scale, name
    moved = [n for n in stats if n.endswith("running_var")
             and float((got[n] - 1.0).abs().max()) > 1e-3]
    assert moved  # the statistics did move away from their initial 1


def test_three_steps_match_jax_default_eps():
    """MSE loss, AdamW at its default eps 1e-8, three steps (``_three_steps``).
    Step 1: loss 1e-5 relative, global gradient norm GRAD_NORM_REL, render
    5e-3. Parameters: with eps this small Adam's first step moves every
    entry by about the learning rate in the direction of its gradient's
    sign, so an entry whose gradient is rounding noise (the bias of proj_k,
    which the softmax ignores) may go the other way: entries are held to
    Adam's own bound 2.2 * lr, and 95% of each tensor's entries to the
    tolerance of the smooth case below. Steps 2 and 3: the LATER_* limits."""
    lr = LR
    keys = ("train_batch_loss", "camera_encoder_grad_norm",
            "train_batch_render_loss")
    for step, jstate, tstate, jm, tm, jrender, trender, before in \
            _three_steps("MSE", 1e-8):
        assert tstate.step == step + 1 == int(jstate.step)
        if step > 0:
            _check_later_step(f"step {step + 1}", jstate, tstate, jm, tm,
                              jrender, trender, before, keys)
            continue
        _check_metrics(tm, jm, keys)
        # renders are sigmoid outputs; the sites' bf16 flips move them by
        # up to ~2e-3 at equal weights (test_torch_slice.py holds 5e-3)
        np.testing.assert_allclose(trender.numpy(), np.asarray(jrender),
                                   atol=5e-3, rtol=0)
        ref = flax_to_state_dict(_np_tree({"params": jstate.params}))
        got = tstate.net.state_dict()
        for name, r in ref.items():
            d = (got[name] - r).abs()
            assert float(d.max()) <= 2.2 * lr, name
            if name.endswith("proj_k.bias"):
                continue  # a gradient that is zero in exact arithmetic
            tol = 1e-5 * float(r.abs().max()) + 0.2 * lr
            assert float((d <= tol).float().mean()) >= 0.95, name


def test_three_steps_match_jax_parameter_for_parameter():
    """MSE + contrastive loss with AdamW's eps at 1e-3, where the update is
    smooth in the gradient, three steps (``_three_steps``). Step 1: loss,
    gradient norm, every parameter and every BatchNorm buffer agree to 1e-5
    relative (plus the slack of ``_compare_states`` for tensors near zero),
    and each tensor's update to 0.2 of its largest entry. Steps 2 and 3:
    the LATER_* limits, which hold every tensor's update too. Step 3 is
    tighter than they say: test_train_state_bridge_takes_the_next_step_equally
    holds it to 1e-5 as well."""
    keys = ("train_batch_loss", "camera_encoder_grad_norm",
            "train_batch_render_loss", "train_batch_retrieval_loss")
    for step, jstate, tstate, jm, tm, jrender, trender, before in \
            _three_steps("MSE_CONTRASTIVE", 1e-3):
        assert tstate.step == step + 1 == int(jstate.step)
        if step > 0:
            _check_later_step(f"step {step + 1}", jstate, tstate, jm, tm,
                              jrender, trender, before, keys)
            continue
        _check_metrics(tm, jm, keys)
        _compare_states(tstate, jstate, 1e-5, "step 1")
        # the updates themselves (a parameter moves by at most the learning
        # rate per step, so the check above is loose about them): each
        # tensor's change since the start, held to 0.2 of its largest entry
        # (the gradients' bf16 noise, through Adam's division)
        ref = flax_to_state_dict(_np_tree({"params": jstate.params}))
        got = tstate.net.state_dict()
        for name, r in ref.items():
            if name.endswith("proj_k.bias"):
                continue  # its gradient is zero in exact arithmetic: noise
            dj, dt = r - before[name], got[name] - before[name]
            assert float((dt - dj).abs().max()) <= \
                0.2 * float(dj.abs().max()) + 1e-9, name
            assert float(dj.abs().max()) > 0, name


def test_train_state_bridge_takes_the_next_step_equally():
    """Two JAX steps, then the whole state (weights, BatchNorm statistics,
    AdamW moments and count) crosses to the port and both take step 3."""
    steps = list(_three_steps("MSE_CONTRASTIVE", 1e-3))
    _, _, ttrainer, _ = _setup("MSE_CONTRASTIVE", 1e-3)
    _, jstate2, *_ = steps[1]
    _, jstate3, _, jm3, *_ = steps[2]
    tstate = _bridged(ttrainer, jstate2)
    assert tstate.step == 2
    # the moments did cross: AdamW's state is that of two steps taken
    moments = tstate.optimizer.state_dict()["state"]
    assert moments and all(int(m["step"]) == 2 for m in moments.values())
    assert any(float(m["exp_avg_sq"].max()) > 0 for m in moments.values())
    ds = _dataset()
    tstate, tm, _ = ttrainer.train_step(
        tstate, tprefetch.collate([ds[4], ds[5]]), rng=1)
    np.testing.assert_allclose(float(tm["train_batch_loss"]),
                               float(jm3["train_batch_loss"]), rtol=1e-5)
    _compare_states(tstate, jstate3, 1e-5, "step 3 from the bridged state")
    assert tstate.step == 3


def test_clip_and_adamw_match_optax():
    """The optimizer alone, on gradients made with numpy: three steps of
    ``optax.chain(clip_by_global_norm(1.0), adamw(...))`` against the port's
    clip and ``torch.optim.AdamW`` over all parameters, to 1e-6."""
    import optax

    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(1e-2, weight_decay=1e-2, eps=1e-8))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(v.copy()))
          for v in params.values()]
    opt = torch.optim.AdamW(tp, lr=1e-2, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-2)
    for scale in (10.0, 0.01, 1.0):  # clipped, not clipped, clipped
        grads = {k: (scale * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        updates, opt_state = tx.update(
            {k: jnp.asarray(g) for k, g in grads.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads.values()):
            p.grad = torch.from_numpy(g.copy())
        norm = clip_by_global_norm_([p.grad for p in tp], 1.0)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            {k: jnp.asarray(g) for k, g in grads.items()})), rtol=1e-6)
        opt.step()
        for p, k in zip(tp, shapes):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=0)


def test_clip_follows_optax():
    """``max_norm / max(norm, max_norm)``: no epsilon in the denominator,
    and no scaling below the threshold."""
    g = [torch.full((4,), 3.0), torch.full((9,), -2.0)]
    norm = float(np.sqrt(4 * 9 + 9 * 4))
    out = [t.clone() for t in g]
    got = clip_by_global_norm_(out, 1.0)
    assert abs(float(got) - norm) < 1e-5
    np.testing.assert_allclose(out[0].numpy(), g[0].numpy() / norm, rtol=1e-6)
    small = [torch.full((4,), 0.1)]
    clip_by_global_norm_(small, 1.0)
    assert torch.equal(small[0], torch.full((4,), 0.1))


# ---- the port's own machinery ----------------------------------------------

def _tiny_trainer(tmp_path, **train):
    cfg = tcfg.Config()
    cfg.model = tcfg.tiny_model_config()
    cfg.train.work_dir = str(tmp_path)
    cfg.train.num_workers = 1
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return Trainer(cfg, _dataset(), device="cpu")


def test_trainer_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = tcfg.Config()
    cfg.model = tcfg.tiny_model_config()
    cfg.train.work_dir = str(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, _dataset())


def test_checkpoint_restore_resumes_the_step_counter(tmp_path):
    trainer = _tiny_trainer(tmp_path)
    state = trainer.create_state(seed=0)
    batch = _dataset().batch(2)
    for _ in range(3):
        state, _, _ = trainer.train_step(state, batch, rng=5)
    path = trainer.save_checkpoint(state, epoch=4, best=True)
    assert path.endswith("best_epoch_4.pt")
    last = trainer.save_checkpoint(state, epoch=5)
    assert last.endswith("last_epoch.pt")
    tckpt.save_model(str(tmp_path), {"model": {}}, 11, best=True)
    assert tckpt.latest_best(str(tmp_path)).endswith("best_epoch_11.pt")
    assert tckpt.restore_model(path)["epoch"] == 4

    fresh = trainer.create_state(seed=1)
    assert fresh.step == 0
    fresh = trainer.restore_checkpoint(fresh, path)
    assert fresh.step == 3
    for (n, a), (_, b) in zip(fresh.net.state_dict().items(),
                              state.net.state_dict().items()):
        assert torch.equal(a, b), n
    # both continue alike: same weights, moments, step and dropout stream
    s1, m1, _ = trainer.train_step(state, batch, rng=5)
    s2, m2, _ = trainer.train_step(fresh, batch, rng=5)
    assert float(m1["train_batch_loss"]) == float(m2["train_batch_loss"])
    assert s1.step == s2.step == 4


def test_one_kfold_epoch_with_validation_and_recall(tmp_path):
    trainer = _tiny_trainer(tmp_path, loss_type="MSE_CONTRASTIVE", k_fold=2,
                            epoch_per_fold=1, total_epochs=2,
                            validation_metric="RECALL", save_val_results=True,
                            steps_per_dispatch=2)
    state = trainer.create_state(seed=0)
    before = {n: p.clone() for n, p in state.net.named_parameters()}
    folds = list(kfold_indices(8, 2, trainer.tc.seed))
    loaders = [tprefetch.DataLoader(trainer.dataset, 2, shuffle=s, sampler=i,
                                    num_workers=1, seed=trainer.tc.seed)
               for s, i in ((True, folds[0][0]), (False, folds[0][1]))]
    state, metrics = trainer._run_epoch(state, 1, 0, *loaders, True, rng=3)
    assert state.step == 2
    for key in ("train_epoch_loss", "val_epoch_loss", "val_R@1", "val_R@5",
                "val_R@10"):
        assert np.isfinite(metrics[key]), key
    assert 0 <= metrics["val_R@1"] <= metrics["val_R@5"] <= 100
    assert any(not torch.equal(p, before[n])
               for n, p in state.net.named_parameters())
    # epoch 1 of 5 warm-up epochs: a fifth of the base rate
    assert abs(state.optimizer.param_groups[0]["lr"] - 1e-4 * 0.2) < 1e-12
    assert trainer.best_epoch == 1 and trainer.best_epoch_recall > 0
    assert (tmp_path / "best_epoch_1.pt").exists()
    assert len(list((tmp_path / "best_epoch_val").glob("*.png"))) == 4
    state = trainer.train(state, max_epochs=2)  # the outer loop: one epoch
    assert state.step == 4


def test_log_image_layout():
    rng = np.random.default_rng(0)
    img = Trainer.get_log_image(rng.uniform(0, 1, (32, 32, 3)),
                                rng.uniform(0, 1, (32, 32, 3)),
                                rng.standard_normal((2, 16, 16, 3)))
    assert img.shape == (64, 96, 3) and 0 <= img.min() and img.max() <= 1
    assert float(np.abs(img[32:, 32:64]).max()) == 0.0  # the blank middle


def test_history_pass_leaves_batchnorm_alone():
    """Train mode, T = 2: the history pass runs in eval mode on the running
    statistics and updates none; only the final pass on the last frame
    does. So the buffers after a T = 2 forward equal those after a T = 1
    forward on the last frame alone, for every BatchNorm fed by the images
    only (the decoder's also see the history through the BEV)."""
    net = tlayers.init_params(BEVRenderNet(tcfg.tiny_model_config(
        backbone="ResNet18", embed_dims=(64, 64, 64), img_height=64,
        img_width=64, ori_img_height=64, ori_img_width=64)), 0).train()
    ds = SyntheticDataset(n_items=2, num_views=2, window_num_imgs=1,
                          img_height=64, img_width=64, map_tile=64)
    b = {k: torch.as_tensor(v) for k, v in ds.batch(2).items()}
    start = {n: t.clone() for n, t in net.state_dict().items()}
    with torch.no_grad():
        net(b["camera"], b["vehicle_pose"], b["vehicle_type"])
    two = {n: t.clone() for n, t in net.state_dict().items() if "running" in n}
    net.load_state_dict(start)
    with torch.no_grad():
        net(b["camera"][:, 1:], b["vehicle_pose"][:, 1:], b["vehicle_type"])
    one = {n: t for n, t in net.state_dict().items() if "running" in n}
    backbone = [n for n in two if "img_backbone" in n]
    assert len(backbone) >= 10
    for n in backbone:
        assert torch.equal(two[n], one[n]), n
        assert not torch.equal(two[n], start[n]), n
    assert net.training  # the mode is restored after the history pass


def test_evaluate_recall_matches_its_parts():
    cfg = tcfg.Config()
    cfg.model = tcfg.tiny_model_config()
    pipe = RegistrationPipeline(cfg, device="cpu", seed=0)
    ds = _dataset(6)
    got = pipe.evaluate_recall(ds, batch_size=4)
    batch = ds.batch(6)
    render = pipe.render(batch)
    unit = lambda x: x / x.norm(dim=-1, keepdim=True)  # noqa: E731
    ref = recall_at_k(unit(render.reshape(6, -1)),
                      unit(torch.as_tensor(batch["map"]).reshape(6, -1)))
    assert set(got) == {"R@1", "R@5", "R@10"}
    for key, r in zip(("R@1", "R@5", "R@10"), ref):
        assert abs(got[key] - float(r)) < 1e-4
