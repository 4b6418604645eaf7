"""Grouped steps (``TrainConfig.steps_per_dispatch``) of the port's trainer
against the JAX package's ``_train_step_multi`` and epoch loop on the CPU,
on the tiny config (``device="cpu"``: each sub-step is a plain step; on
the card each is a CUDA graph replay, chip_smoke phase 29).

One JAX trainer serves every test (a module-scoped fixture): its grouped
step compiles once for a group of 2 and once for a group of 1, the shapes
the epoch loop of the JAX-loop test reuses. Both frameworks' attention
sites run in float32 (``f32_sites`` of tests/test_torch_retrieval.py): at
the shipped bf16 sites a rounding flip moves a step's loss from the same
weights by up to 6.9e-5 relative (measured here, first sub-step of the
group of 2), and the steps' bf16 parity is tests/test_torch_trainer.py's.
A step from the bridged JAX state agrees to 1e-5 in its losses; a later
step, taken by each framework from its own state, to the LATER_* limits
stated there. The port held against itself (grouped steps against
sequential ones, bit for bit) keeps the shipped bf16 sites: the float32
sites' table gradient is not the same bits from run to run on the CPU (a
parallel scatter-add).
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevrender_tpu.models.bevrender import BEVRenderModel
from bevrender_tpu.training.trainer import Trainer as JTrainer
from bevrender_tpu.training.trainer import TrainState as JState
from bevrender_tpu_torch.convert import flax_to_state_dict
from bevrender_tpu_torch.data import prefetch as tprefetch
from bevrender_tpu_torch.training.trainer import Trainer
from test_torch_retrieval import _variables
from test_torch_retrieval import f32_sites  # noqa: F401 (a fixture)
from test_torch_trainer import (
    GRAD_NORM_REL,
    LATER_LOSS_REL,
    LATER_NORM_REL,
    LATER_RENDER_ABS,
    _compare_states,
    _configs,
    _dataset,
)

LOSS = "MSE_CONTRASTIVE"
EPS = 1e-3  # AdamW's eps where its update is smooth in the gradient
KEYS = ("train_batch_loss", "camera_encoder_grad_norm",
        "train_batch_render_loss", "train_batch_retrieval_loss")


@pytest.fixture(scope="module")
def jax_setup():
    """(JAX trainer, its state at the port's seeded weights, the port's
    trainer, the flax variables), both logging every dispatch, two steps a
    dispatch. The weights are ``test_torch_retrieval._variables``: the
    tree's names and shapes come from ``jax.eval_shape`` of the JAX init,
    so no init is run."""
    jcfg, pcfg = _configs(LOSS, EPS, tempfile.mkdtemp())
    for tc in (jcfg.train, pcfg.train):
        tc.log_every_steps, tc.steps_per_dispatch = 1, 2
    ds = _dataset()
    jtrainer = JTrainer(BEVRenderModel(jcfg), jcfg, ds)
    variables = _variables()
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JState(params=params,
                    batch_stats=jax.tree_util.tree_map(
                        jnp.asarray, variables["batch_stats"]),
                    opt_state=jtrainer.tx.init(params),
                    step=jnp.zeros((), jnp.int32))
    return jtrainer, jstate, Trainer(pcfg, ds, device="cpu"), variables


def _groups():
    """Three batches of two, as a group of 2 and a trailing group of 1."""
    ds = _dataset()
    batches = [tprefetch.collate([ds[2 * i], ds[2 * i + 1]])
               for i in range(3)]
    return [tprefetch.collate(batches[:2]), tprefetch.collate(batches[2:])]


def _jax_multi(jtrainer, jstate, group):
    # the JAX step donates its state: hand it a copy
    return jtrainer._train_step_multi(
        jax.tree_util.tree_map(jnp.copy, jstate),
        {k: jnp.asarray(v) for k, v in group.items()}, jax.random.PRNGKey(1))


def test_grouped_steps_match_jax(jax_setup, f32_sites):
    """A group of 2 and a group of 1, each from the initial JAX state and,
    in the port, from that state bridged: the metrics come stacked to (k,),
    the render is the last sub-step's. A group's first sub-step is a step
    from the bridged initial weights: its losses agree with JAX's to 1e-5
    (GRAD_NORM_REL in the norm), and after the group of 1 every parameter
    and BatchNorm statistic to 1e-5, as step 1 in tests/test_torch_trainer.py.
    The second sub-step of the group of 2 starts from each framework's own
    state: the LATER_* limits."""
    jtrainer, jstate0, ttrainer, variables = jax_setup
    got = {}
    for group in _groups():
        k = len(group["map"])
        jstate, jm, jr = _jax_multi(jtrainer, jstate0, group)
        tstate = ttrainer.create_state(
            state_dict=flax_to_state_dict(variables))
        tstate, tm, tr = ttrainer.train_step_multi(tstate, group, rng=1)
        assert tstate.step == int(jstate.step) == k
        got[k] = (jstate, tstate, jr, tr)
        assert set(tm) == set(jm) == set(KEYS)
        for key in KEYS:
            t, j = tm[key].numpy(), np.asarray(jm[key])
            assert t.shape == j.shape == (k,)
            first = GRAD_NORM_REL if key == KEYS[1] else 1e-5
            later = LATER_NORM_REL if key == KEYS[1] else LATER_LOSS_REL
            np.testing.assert_allclose(t[0], j[0], rtol=first, atol=0,
                                       err_msg=f"group of {k}: {key}")
            np.testing.assert_allclose(t[1:], j[1:], rtol=later, atol=0,
                                       err_msg=f"group of {k}: {key}")
    jstate, tstate, jr, tr = got[1]
    # renders are sigmoid outputs; the sites' bf16 flips move them by up to
    # ~2e-3 at equal weights (tests/test_torch_trainer.py)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=5e-3, rtol=0)
    _compare_states(tstate, jstate, 1e-5, "after the group of 1")
    _, _, jr, tr = got[2]
    assert tuple(tr.shape) == tuple(jr.shape) == (2, 32, 32, 3)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr),
                               atol=LATER_RENDER_ABS, rtol=0)


def test_grouped_steps_equal_sequential_steps(jax_setup):
    """On the CPU a group of k is k plain steps: the same bits as
    ``train_step`` called k times, metrics, renders and state."""
    _, _, ttrainer, _ = jax_setup
    group2, group1 = _groups()
    grouped = ttrainer.create_state(seed=3)
    single = ttrainer.create_state(seed=3)
    got, want = [], []
    for group in (group2, group1):
        grouped, m, render = ttrainer.train_step_multi(grouped, group, rng=5)
        got.append(m["train_batch_loss"])
        k = len(group["map"])
        for i in range(k):
            single, ms, rs = ttrainer.train_step(
                single, {key: v[i] for key, v in group.items()}, rng=5)
            want.append(ms["train_batch_loss"])
        assert torch.equal(render, rs)
    assert torch.equal(torch.cat(got), torch.stack(want))
    assert grouped.step == single.step == 3
    for (n, a), (_, b) in zip(grouped.net.state_dict().items(),
                              single.net.state_dict().items()):
        assert torch.equal(a, b), n
    for a, b in zip(grouped.optimizer.state.values(),
                    single.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)


def _logged(trainer):
    calls = []
    trainer.metrics.log_batch = lambda idx, n, *a: calls.append((idx, n))
    return calls


def _loader(mod, dataset):
    return mod.DataLoader(dataset, 2, shuffle=True, num_workers=1, seed=11,
                          sampler=np.array([0, 3, 4, 7, 1, 6]))


def test_epoch_loop_groups_and_logs_like_jax(jax_setup, f32_sites):
    """``_run_epoch`` at k=2 over three batches (a group of 2 and one of 1,
    the shapes above: no new JAX compile) against the JAX loop: it logs on
    the same dispatch indices, takes three steps, and its epoch loss is
    within LATER_LOSS_REL of the JAX loop's."""
    from bevrender_tpu.data import prefetch as jprefetch

    jtrainer, jstate0, ttrainer, variables = jax_setup
    jcalls = _logged(jtrainer)
    jstate, jmetrics = jtrainer._run_epoch(
        jax.tree_util.tree_map(jnp.copy, jstate0), 0, 0,
        _loader(jprefetch, ttrainer.dataset),
        _loader(jprefetch, ttrainer.dataset), False, jax.random.PRNGKey(2))
    assert int(jstate.step) == 3
    tcalls = _logged(ttrainer)
    tstate, tmetrics = ttrainer._run_epoch(
        ttrainer.create_state(state_dict=flax_to_state_dict(variables)), 0,
        0, _loader(tprefetch, ttrainer.dataset),
        _loader(tprefetch, ttrainer.dataset), False, rng=2)
    assert tstate.step == 3
    assert tcalls == jcalls == [(0, 3), (1, 3)]
    np.testing.assert_allclose(tmetrics["train_epoch_loss"],
                               jmetrics["train_epoch_loss"],
                               rtol=LATER_LOSS_REL, atol=0)


def test_grouped_epoch_equals_sequential_epoch(jax_setup):
    """The port's epoch at k=2 and at k=1 from one state: the same steps
    (the same state, bit for bit), a log line a dispatch, and the same
    epoch loss (the same losses; at k=2 the sum runs per group first, so
    to 1e-6)."""
    _, _, ttrainer, _ = jax_setup
    runs = {}
    for k in (2, 1):
        ttrainer.tc.steps_per_dispatch = k
        try:
            calls = _logged(ttrainer)
            state, metrics = ttrainer._run_epoch(
                ttrainer.create_state(seed=4), 0, 0,
                _loader(tprefetch, ttrainer.dataset),
                _loader(tprefetch, ttrainer.dataset), False, rng=2)
        finally:
            ttrainer.tc.steps_per_dispatch = 2
        runs[k] = (calls, state, metrics["train_epoch_loss"])
    assert runs[2][0] == [(0, 3), (1, 3)]
    assert runs[1][0] == [(0, 3), (1, 3), (2, 3)]
    assert runs[2][1].step == runs[1][1].step == 3
    np.testing.assert_allclose(runs[2][2], runs[1][2], rtol=1e-6, atol=0)
    for (n, a), (_, b) in zip(runs[2][1].net.state_dict().items(),
                              runs[1][1].net.state_dict().items()):
        assert torch.equal(a, b), n
