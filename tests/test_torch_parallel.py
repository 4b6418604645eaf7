"""The port's data-parallel layer (``bevrender_tpu_torch.parallel``) on the
CPU: W ranks forked from the test, joined over gloo through a rendezvous
file in the test's temporary directory, each rank under one time limit so
that a hung collective fails the test. What W ranks compute is held
against one process on the global batch, against the JAX package's
one-batch step and its sharded matcher, and the ranks against each other.
"""

import os
import socket
import tempfile
import time
import traceback
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from bevrender_tpu.config import Config as JConfig
from bevrender_tpu.config import tiny_model_config as j_tiny
from bevrender_tpu.data import prefetch as jprefetch
from bevrender_tpu.inference.register import RegistrationPipeline as JPipeline
from bevrender_tpu.models.bevrender import BEVRenderModel
from bevrender_tpu.parallel.mesh import make_mesh
from bevrender_tpu.training.trainer import Trainer as JTrainer
from bevrender_tpu_torch import config as tcfg
from bevrender_tpu_torch import train as ttrain
from bevrender_tpu_torch.convert import flax_to_state_dict
from bevrender_tpu_torch.data import prefetch as tprefetch
from bevrender_tpu_torch.data.synthetic import SyntheticDataset
from bevrender_tpu_torch.inference.register import RegistrationPipeline
from bevrender_tpu_torch.models import layers as tlayers
from bevrender_tpu_torch.parallel import dist as pdist
from bevrender_tpu_torch.training import graph_step
from bevrender_tpu_torch.training.trainer import Trainer
from test_torch_retrieval import f32_sites  # noqa: F401 (a fixture)

# every forked group of ranks finishes within this many seconds or fails
RANKS_TIMEOUT_S = 120

_FORK = mp.get_context("fork")


def _rank_main(fn, rank, world, tmp, args, init):
    code = 0
    try:
        torch.set_num_threads(1)
        if init:
            dist.init_process_group(
                "gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                world_size=world)
        out = fn(rank, world, *args)
        torch.save(out, f"{tmp}/out{rank}.pt")
    except BaseException:  # reported by the parent, which fails the test
        Path(f"{tmp}/err{rank}.txt").write_text(traceback.format_exc())
        code = 1
    finally:
        if pdist.is_initialized():
            dist.destroy_process_group()
    os._exit(code)


def run_ranks(fn, world, *args, init=True, timeout=RANKS_TIMEOUT_S):
    """``fn(rank, world, *args)`` in ``world`` forked ranks joined over gloo
    (``init``); their results in rank order. A rank that raises, or a group
    that outlives ``timeout``, fails the calling test."""
    tmp = tempfile.mkdtemp(prefix="ranks_")
    procs = [_FORK.Process(target=_rank_main,
                           args=(fn, r, world, tmp, args, init))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join(10)
    errors = {r: Path(f"{tmp}/err{r}.txt").read_text() for r in range(world)
              if Path(f"{tmp}/err{r}.txt").exists()}
    assert not hung, f"ranks {hung} still running after {timeout} s: {errors}"
    assert all(p.exitcode == 0 for p in procs) and not errors, errors
    return [torch.load(f"{tmp}/out{r}.pt", weights_only=False)
            for r in range(world)]


def _dataset(n=8, window=1):
    return SyntheticDataset(n_items=n, num_views=2, window_num_imgs=window,
                            img_height=32, img_width=32, map_tile=32)


def _rows(batch, rank, world):
    return {k: np.ascontiguousarray(v[rank::world]) for k, v in batch.items()}


def _cpu_state(state):
    return {k: v.detach().clone() for k, v in state.net.state_dict().items()}


# the key projection's bias: its gradient is zero in exact arithmetic (the
# softmax over keys does not see a shift common to every key), so Adam's
# first step moves it by +-lr in the direction of rounding noise, in either
# framework and on any split of the batch (tests/test_torch_trainer.py
# leaves it out for the same reason)
NOISE_ONLY = "proj_k.bias"


def _check_params(got, ref, rtol, atol):
    for name, r in ref.items():
        if name.endswith(NOISE_ONLY) or not r.is_floating_point():
            continue
        np.testing.assert_allclose(got[name].numpy(), r.numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


# ---- the loader's rank shard -------------------------------------------

class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i)}


@pytest.mark.parametrize("n,world,batch", [(8, 2, 2), (10, 4, 2), (7, 3, 2),
                                           (5, 2, 1), (9, 2, 4)])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_shard_matches_jax(n, world, batch, shuffle, drop_last):
    """Every rank's batches and length equal the JAX DataLoader's with the
    same ``process_shard``, padding (n not a multiple of W) among them."""
    for rank in range(world):
        kw = dict(batch_size=batch, shuffle=shuffle, drop_last=drop_last,
                  seed=3, process_shard=(rank, world),
                  sampler=np.arange(n)[::-1].copy())
        ours, theirs = (mod.DataLoader(_Indexed(n), **kw)
                        for mod in (tprefetch, jprefetch))
        ours.set_epoch(2), theirs.set_epoch(2)
        assert len(ours) == len(theirs)
        got = [b["i"].tolist() for b in ours]
        assert got == [b["i"].tolist() for b in theirs]
        assert len(got) == len(ours)


def test_rank_rows_are_the_loader_shard():
    """A global batch of the unsharded loader, split by ``rank_rows``, is
    the ranks' batches of the sharded one."""
    full = [b["i"] for b in tprefetch.DataLoader(_Indexed(12), 6,
                                                 shuffle=True, seed=1)]
    for rank in range(3):
        shard = [b["i"] for b in tprefetch.DataLoader(
            _Indexed(12), 2, shuffle=True, seed=1, process_shard=(rank, 3))]
        assert [f[pdist.rank_rows(6, 3, rank).numpy()].tolist()
                for f in full] == [s.tolist() for s in shard]
    with pytest.raises(ValueError, match="does not split"):
        pdist.rank_rows(5, 2, 0)


def test_no_group_is_one_process():
    assert not pdist.is_initialized()
    assert (pdist.world_size(), pdist.rank(), pdist.is_main()) == (1, 0, True)
    x = torch.randn(3, 2)
    assert pdist.all_gather_rows(x) is x and pdist.all_reduce_sum(x) is x
    gen = torch.Generator().manual_seed(4)
    a = pdist.local_rand((4, 3), gen, "cpu")
    gen.manual_seed(4)
    assert torch.equal(a, torch.rand((4, 3), generator=gen))


# ---- collectives: BatchNorm, the row gather, the masks -----------------

def _bn_inputs():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((8, 5, 4, 6)) * 2 + 1.5).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    return x, ct, scale, bias


def _bn_run(x, ct, scale, bias, steps=2):
    """Output and input gradient of the first of ``steps`` train-mode
    calls, and the running statistics after them."""
    bn = tlayers.BatchNorm(6).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    out = None
    for _ in range(steps):
        xt = torch.from_numpy(x).requires_grad_(True)
        y = bn(xt)
        (y * torch.from_numpy(ct)).sum().backward()
        if out is None:
            out = (y.detach(), xt.grad)
    return out[0], out[1], bn.running_mean.clone(), bn.running_var.clone()


def _bn_rank(rank, world):
    x, ct, scale, bias = _bn_inputs()
    return _bn_run(x[rank::world], ct[rank::world], scale, bias)


def test_batchnorm_two_ranks_match_one_process_and_flax():
    """BatchNorm on 2 ranks x 4 rows against one process on the 8 rows and
    against flax's on them: output, input gradient of sum(y * ct), running
    statistics after two updates, to 1e-6 (absolute against one process;
    against flax relative, as the outputs reach 2.5)."""
    import flax.linen as fnn

    x, ct, scale, bias = _bn_inputs()
    one = _bn_run(x, ct, scale, bias)
    ranks = run_ranks(_bn_rank, 2)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(6), "var": jnp.ones(6)}}

    def f(xj, v):
        return jbn.apply(v, xj, mutable=["batch_stats"])

    y_j, upd = f(jnp.asarray(x), variables)
    g_j = jax.grad(lambda xj: jnp.sum(f(xj, variables)[0] * ct))(
        jnp.asarray(x))
    _, upd = f(jnp.asarray(x), {**variables, **upd})
    flax = (np.asarray(y_j), np.asarray(g_j),
            np.asarray(upd["batch_stats"]["mean"]),
            np.asarray(upd["batch_stats"]["var"]))
    for r, (y, g, rm, rv) in enumerate(ranks):
        for got, ref, ref_j, name in ((y, one[0], flax[0], "output"),
                                      (g, one[1], flax[1], "input grad")):
            np.testing.assert_allclose(got.numpy(), ref[r::2].numpy(),
                                       atol=1e-6, rtol=0, err_msg=name)
            # flax's own sums: 1e-6 of the value (outputs reach 2.5, where
            # 1e-6 absolute is 4 ulps), 1e-6 absolute near zero
            np.testing.assert_allclose(got.numpy(), ref_j[r::2], atol=1e-6,
                                       rtol=1e-6, err_msg=name)
        for got, ref, ref_j in ((rm, one[2], flax[2]), (rv, one[3], flax[3])):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6,
                                       rtol=0)
            np.testing.assert_allclose(got.numpy(), ref_j, atol=1e-6, rtol=0)
    assert torch.equal(ranks[0][2], ranks[1][2])
    assert torch.equal(ranks[0][3], ranks[1][3])


def _gather_rank(rank, world):
    g = torch.arange(6 * world * 2, dtype=torch.float32).reshape(
        6 * world, 2) / 7
    c = torch.linspace(-1, 1, g.numel()).reshape(g.shape)
    x = g[rank::world].clone().requires_grad_(True)
    y = pdist.all_gather_rows(x)
    (y * c).sum().backward()
    gen = torch.Generator().manual_seed(5)
    mask = pdist.local_rand((2 * 3, 4), gen, "cpu", rows_per_sample=3)
    return y.detach(), x.grad, g, c, mask


@pytest.mark.parametrize("world", [2, 3])
def test_all_gather_rows_and_local_rand(world):
    """Forward: the global batch in its order. Backward: W times the
    shared loss's gradient on the rank's rows (the trainer divides the
    all-reduced gradient by W). ``local_rand``: each rank's rows of one
    process's draw for the global batch, two rows a sample."""
    ranks = run_ranks(_gather_rank, world)
    gen = torch.Generator().manual_seed(5)
    full = torch.rand((world * 6, 4), generator=gen).reshape(world * 2, 3, 4)
    for r, (y, grad, g, c, mask) in enumerate(ranks):
        assert torch.equal(y, g)
        assert torch.equal(grad, world * c[r::world])
        assert torch.equal(mask, full[r::world].reshape(6, 4))


# ---- the training slice ------------------------------------------------

def _dp_configs(work_dir, loss_type="MSE_CONTRASTIVE", batch=8):
    """The setup of the JAX package's data-parallel test
    (tests/test_parallel.py:111-160) for both frameworks."""
    j, t = JConfig(), tcfg.Config()
    j.model, t.model = j_tiny(), tcfg.tiny_model_config()
    j.data.window_num_imgs = t.data.window_num_imgs = 1
    for c in (j.train, t.train):
        c.batch_size, c.loss_type = batch, loss_type
        c.work_dir = work_dir
    return j, t


def _jax_step():
    """The JAX trainer's one step on the 8-row batch, from its seeded
    state: (initial variables, state after, metrics)."""
    jcfg, _ = _dp_configs(tempfile.mkdtemp())
    ds = _dataset()
    batch = ds.batch(8)
    jtrainer = JTrainer(BEVRenderModel(jcfg), jcfg, ds)
    jstate = jtrainer.create_state(jax.random.PRNGKey(0), batch)
    variables = jax.tree_util.tree_map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats})
    s1, m1, _ = jtrainer._train_step(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(3))
    after = jax.tree_util.tree_map(np.asarray, {
        "params": s1.params, "batch_stats": s1.batch_stats})
    return variables, after, {k: float(v) for k, v in m1.items()}


def _step_rank(rank, world, variables, work_dir):
    _, cfg = _dp_configs(work_dir)
    trainer = Trainer(cfg, _dataset(), device="cpu")
    state = trainer.create_state(state_dict=flax_to_state_dict(variables))
    batch = _rows(_dataset().batch(8), rank, world)
    state, m, _ = trainer.train_step(state, batch, rng=3)
    return {k: float(v) for k, v in m.items()}, _cpu_state(state)


def test_two_ranks_match_the_jax_one_batch_step(tmp_path, f32_sites):
    """The tiny model, MSE_CONTRASTIVE, 2 views of 32 x 32, batch 8 on 2
    ranks x 4 rows, from the bridged JAX weights, against the JAX
    ``Trainer._train_step`` on the 8 rows: losses to 1e-5, gradient norm
    to 5e-3, every parameter after one AdamW step to rtol 5e-3 / atol 2e-4
    (the tolerances of the JAX package's own sharded-vs-unsharded test);
    the ranks' parameters and statistics equal bit for bit. Both
    frameworks run their attention sites in float32 (``f32_sites``): with
    the shipped bf16 roundings one process of the port already reads the
    8-row loss 1.2e-5 and the render loss 5.6e-5 off JAX's, as the 2 ranks
    do."""
    variables, after, jm = _jax_step()
    ranks = run_ranks(_step_rank, 2, variables, str(tmp_path))
    (m0, s0), (m1, s1) = ranks
    assert m0 == m1
    assert s0.keys() == s1.keys()
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    for key in ("train_batch_loss", "train_batch_render_loss",
                "train_batch_retrieval_loss"):
        np.testing.assert_allclose(m0[key], jm[key], rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(m0["camera_encoder_grad_norm"],
                               jm["camera_encoder_grad_norm"], rtol=5e-3)
    ref = flax_to_state_dict(after)
    assert ref.keys() == s0.keys()
    _check_params(s0, ref, rtol=5e-3, atol=2e-4)


# drop path alone; and dropout with attention dropout on sites whose views
# are folded into the batch (4 groups: SCA folds its 2 views)
DROP_CONFIGS = {
    "drop_path": dict(drop_path_rate=0.2),
    "dropout": dict(drop_rate=0.1, attn_drop_rate=0.1, n_heads=(4, 4),
                    n_groups=(4, 4)),
}


def _drop_trainer(work_dir, drop, steps_per_dispatch=1):
    cfg = tcfg.Config()
    cfg.model = tcfg.tiny_model_config(**DROP_CONFIGS[drop])
    cfg.train.loss_type, cfg.train.batch_size = "MSE_CONTRASTIVE", 8
    cfg.train.work_dir = work_dir
    cfg.train.steps_per_dispatch = steps_per_dispatch
    trainer = Trainer(cfg, _dataset(16), device="cpu")
    return trainer, trainer.create_state(seed=0)


def _drop_step(rank, world, drop, work_dir):
    trainer, state = _drop_trainer(work_dir, drop)
    batch = _rows(_dataset().batch(8), rank, world)
    state, m, _ = trainer.train_step(state, batch, rng=11)
    return {k: float(v) for k, v in m.items()}, _cpu_state(state)


@pytest.mark.parametrize("drop", sorted(DROP_CONFIGS))
def test_two_ranks_match_one_process_with_random_masks(tmp_path, drop):
    """A step with drop path 0.2 (and, second case, dropout and attention
    dropout on folded views) from one seeded state: 2 ranks x 4 rows draw
    the one process's masks of the 8 rows, so the losses agree to 1e-5 and
    the parameters to the one-step test's tolerance; the ranks agree bit
    for bit."""
    one_m, one_state = _drop_step(0, 1, drop, str(tmp_path))
    ranks = run_ranks(_drop_step, 2, drop, str(tmp_path))
    assert ranks[0][0] == ranks[1][0]
    assert all(torch.equal(ranks[0][1][k], ranks[1][1][k])
               for k in one_state)
    for key in ("train_batch_loss", "train_batch_render_loss",
                "train_batch_retrieval_loss"):
        np.testing.assert_allclose(ranks[0][0][key], one_m[key], rtol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(ranks[0][0]["camera_encoder_grad_norm"],
                               one_m["camera_encoder_grad_norm"], rtol=5e-3)
    _check_params(ranks[0][1], one_state, rtol=5e-3, atol=2e-4)


def _grouped(rank, world, work_dir):
    cfg = tcfg.Config()
    cfg.model = tcfg.tiny_model_config()
    cfg.train.loss_type, cfg.train.batch_size = "MSE", 8
    cfg.train.work_dir, cfg.train.steps_per_dispatch = work_dir, 2
    ds = _dataset(16)
    trainer = Trainer(cfg, ds, device="cpu")
    state = trainer.create_state(seed=0)
    b = [_rows(tprefetch.collate([ds[8 * i + j] for j in range(8)]), rank,
               world) for i in range(2)]
    group = {k: np.stack([b[0][k], b[1][k]]) for k in b[0]}
    state, m, _ = trainer.train_step_multi(state, group, rng=3)
    return m["train_batch_loss"].tolist(), state.step, _cpu_state(state)


def test_grouped_steps_on_two_ranks_match_one_process(tmp_path):
    """``train_step_multi`` with k=2 (two batches of 8) on 2 ranks x 4 rows
    against one process, held as the JAX package holds its grouped
    dispatch on a mesh against one device (tests/test_parallel.py:162-220):
    step 1, from the same state, to 1e-5; step 2 runs on step 1's state,
    whose rounding differences (the key bias's +-lr among them) the tiny
    batch's BatchNorm amplifies, to 2.5e-2, and the parameters after it to
    rtol 5e-2 / atol 1e-2. The ranks agree bit for bit."""
    one_losses, one_step, one_state = _grouped(0, 1, str(tmp_path))
    ranks = run_ranks(_grouped, 2, str(tmp_path))
    assert ranks[0][:2] == ranks[1][:2] and ranks[0][1] == one_step == 2
    assert all(torch.equal(ranks[0][2][k], ranks[1][2][k]) for k in one_state)
    np.testing.assert_allclose(ranks[0][0][0], one_losses[0], rtol=1e-5)
    np.testing.assert_allclose(ranks[0][0], one_losses, rtol=2.5e-2)
    _check_params(ranks[0][2], one_state, rtol=5e-2, atol=1e-2)


def _world_one(rank, world, work_dir):
    """The same step without a group and in a group of one."""
    trainer, state0 = _drop_trainer(work_dir, "drop_path")
    snap = _cpu_state(state0)
    batch = _dataset().batch(4)
    out = []
    for with_group in (False, True):
        if with_group:
            dist.init_process_group(
                "gloo", init_method=f"file://{work_dir}/rendezvous1",
                rank=0, world_size=1)
        trainer, state = _drop_trainer(work_dir, "drop_path")
        state.net.load_state_dict(snap)
        state, m, render = trainer.train_step(state, batch, rng=2)
        out.append(({k: float(v) for k, v in m.items()}, render,
                    _cpu_state(state)))
    return out


def test_a_group_of_one_changes_no_bit(tmp_path):
    """A train step (drop path 0.2) in a gloo group of one gives the bits
    of the step without a group: metrics, render and state."""
    (alone, grouped), = run_ranks(_world_one, 1, str(tmp_path), init=False)
    assert alone[0] == grouped[0]
    assert torch.equal(alone[1], grouped[1])
    assert all(torch.equal(alone[2][k], grouped[2][k]) for k in alone[2])


def _rank_zeros_state(rank, world, work_dir):
    trainer, _ = _drop_trainer(work_dir, "drop_path")
    created = _cpu_state(trainer.create_state(seed=rank))
    other, _ = _drop_trainer(work_dir, "drop_path")
    state = other.create_state(seed=10 + rank)
    state, _, _ = other.train_step(state, _rows(_dataset().batch(8), rank,
                                                world), rng=1)
    path = other.save_checkpoint(state, epoch=rank) if rank == 0 else None
    path = pdist.broadcast_object(path)
    if rank == 1:  # rank 1 reads a checkpoint of other weights
        with torch.no_grad():
            for p in state.net.parameters():
                p.add_(1.0)
        path = other.save_checkpoint(state, epoch=rank)
    restored = trainer.restore_checkpoint(trainer.create_state(seed=rank),
                                          path)
    moments = [v.clone() for st in restored.optimizer.state.values()
               for v in st.values()]
    return created, _cpu_state(restored), moments


def test_state_is_rank_zeros(tmp_path):
    """``create_state`` from per-rank seeds and ``restore_checkpoint`` of
    per-rank files both leave every rank with rank 0's model (and AdamW
    moments after the restore)."""
    (c0, r0, m0), (c1, r1, m1) = run_ranks(_rank_zeros_state, 2,
                                           str(tmp_path))
    assert all(torch.equal(c0[k], c1[k]) for k in c0)
    assert all(torch.equal(r0[k], r1[k]) for k in r0)
    assert len(m0) == len(m1) > 0
    assert all(torch.equal(a, b) for a, b in zip(m0, m1))
    assert not all(torch.equal(c0[k], r0[k]) for k in c0)


def _graphed_on_gloo(rank, world, work_dir):
    trainer, state = _drop_trainer(work_dir, "drop_path",
                                   steps_per_dispatch=2)
    trainer.graphed = True  # as on the card
    msgs = []
    try:
        graph_step.check_capturable()
    except ValueError as e:
        msgs.append(str(e))
    try:
        trainer._graph_step(state, trainer._to_device(
            _rows(_dataset().batch(8), rank, world)), 0)
    except ValueError as e:
        msgs.append(str(e))
    return msgs, state.step


def test_a_graphed_step_on_gloo_raises(tmp_path):
    """A graphed step cannot capture gloo's collectives: it raises a
    ValueError naming the backend before anything runs, and no step is
    taken."""
    for msgs, step in run_ranks(_graphed_on_gloo, 2, str(tmp_path)):
        assert len(msgs) == 2 and all("'gloo'" in m for m in msgs), msgs
        assert step == 0


# ---- the sharded matcher -----------------------------------------------

def _matcher_inputs(n_tiles):
    """Queries (a tiny pipeline's renders, embedded by its 16-D retrieval
    head) and a database of ``n_tiles`` embedded tiles; the pipeline's
    unsharded ``register``."""
    cfg = tcfg.Config()
    cfg.model = tcfg.tiny_model_config(retrieval_embed_dim=16,
                                       retrieval_head_widths=(8, 16))
    pipe = RegistrationPipeline(cfg, device="cpu", seed=0)
    tiles = SyntheticDataset(n_items=n_tiles, num_views=2, window_num_imgs=1,
                             img_height=32, img_width=32, map_tile=32,
                             seed=4).batch(n_tiles)["map"]
    db = pipe.build_tile_database(list(tiles))
    batch = _dataset(3).batch(3)
    with torch.no_grad():
        q = pipe.embed(pipe.render(batch))
    return pipe, q, db, batch


def _match_rank(rank, world, q, db, top_k):
    padded, n = RegistrationPipeline.pad_tile_db(db, world)
    nl = padded.shape[0] // world
    match = RegistrationPipeline.make_sharded_matcher(top_k)
    return match(q, padded[rank * nl:(rank + 1) * nl], n)


@pytest.mark.parametrize("top_k", [3, 10])
def test_sharded_matcher_matches_jax_and_register(top_k):
    """13 tiles (not a multiple of 2) on 2 ranks, top 3 and top 10 (more
    than a rank's 7 rows): the indices equal JAX's ``make_sharded_matcher``
    on the 8-device CPU mesh and the port's unsharded ``register``, the
    distances within 1e-6 of both, on both ranks."""
    pipe, q, db, batch = _matcher_inputs(13)
    _, idx_ref, dist_ref = pipe.register(batch, top_k=top_k)
    # no two distances of a query within twice the 1e-6 that the
    # frameworks may differ by: the order is defined
    full = torch.sort(2.0 - 2.0 * (q @ db.T), dim=1).values
    assert float((full[:, 1:] - full[:, :-1]).min()) > 2e-6
    mesh = make_mesh(8)
    jdb, n = JPipeline.pad_tile_db(jnp.asarray(db.numpy()), 8)
    assert n == 13 and jdb.shape[0] == 16
    jmatch = JPipeline.make_sharded_matcher(object.__new__(JPipeline), mesh,
                                            top_k=top_k)
    jidx, jdist = (np.asarray(a) for a in jmatch(jnp.asarray(q.numpy()), jdb,
                                                 jnp.int32(n)))
    for idx, dist_ in run_ranks(_match_rank, 2, q, db, top_k):
        assert idx.tolist() == jidx.tolist() == idx_ref.tolist()
        np.testing.assert_allclose(dist_.numpy(), jdist, atol=1e-6, rtol=0)
        np.testing.assert_allclose(dist_.numpy(), dist_ref.numpy(),
                                   atol=1e-6, rtol=0)


def test_pad_tile_db_matches_jax():
    db = torch.randn(5, 3)
    for shards in (1, 2, 4, 5):
        padded, n = RegistrationPipeline.pad_tile_db(db, shards)
        jpadded, jn = JPipeline.pad_tile_db(jnp.asarray(db.numpy()), shards)
        assert n == jn == 5
        np.testing.assert_array_equal(padded.numpy(), np.asarray(jpadded))


# ---- the epoch loop and the CLI ----------------------------------------

def _epoch(rank, world, work_dir):
    cfg = tcfg.Config()
    cfg.model = tcfg.tiny_model_config()
    tc = cfg.train
    tc.loss_type, tc.batch_size, tc.work_dir = "MSE_CONTRASTIVE", 4, work_dir
    tc.k_fold, tc.epoch_per_fold, tc.total_epochs = 3, 1, 2
    tc.save_ckpt, tc.save_val_results, tc.num_workers = True, True, 1
    trainer = Trainer(cfg, _dataset(12), device="cpu")
    calls, epochs = [], []
    for name in ("save_checkpoint", "save_val_images"):
        fn = getattr(trainer, name)
        setattr(trainer, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    run_epoch = trainer._run_epoch
    trainer._run_epoch = lambda *a: (lambda r: (epochs.append(r[1]), r)[1])(
        run_epoch(*a))
    state = trainer.train(trainer.create_state(seed=0))
    return epochs, calls, state.step


def _files(work_dir):
    return sorted(p.relative_to(work_dir).as_posix()
                  for p in Path(work_dir).rglob("*") if p.is_file())


def test_kfold_epoch_on_two_ranks_equals_one_process(tmp_path):
    """One K-fold epoch of ``Trainer.train`` (12 samples, 3 folds, global
    batch 4: two steps, one validation batch): on 2 ranks the validation
    loss equals one process's to 1e-5 and the recalls exactly, on both
    ranks; rank 0 alone saves the checkpoint and the validation images,
    the same files one process writes."""
    (one_metrics,), one_calls, one_step = _epoch(0, 1, str(tmp_path / "one"))
    ranks = run_ranks(_epoch, 2, str(tmp_path / "two"))
    assert one_calls == ["save_checkpoint", "save_val_images"]
    assert one_step == 2 and "val_R@5" in one_metrics
    assert _files(tmp_path / "two") == _files(tmp_path / "one") != []
    for rank, ((metrics,), calls, step) in enumerate(ranks):
        assert calls == (one_calls if rank == 0 else [])
        assert step == one_step
        assert metrics.keys() == one_metrics.keys()
        for key, v in one_metrics.items():
            rel = 0 if key.startswith("val_R@") else 1e-5
            np.testing.assert_allclose(metrics[key], v, rtol=rel, err_msg=key)


def test_batch_size_must_split_over_the_ranks(tmp_path):
    def refused(rank, world, work_dir):
        cfg = tcfg.Config()
        cfg.model = tcfg.tiny_model_config()
        cfg.train.batch_size, cfg.train.work_dir = 3, work_dir
        trainer = Trainer(cfg, _dataset(12), device="cpu")
        with pytest.raises(ValueError, match="positive multiple of "
                                             "world_size=2"):
            trainer.train(trainer.create_state(seed=0))
        return True

    assert run_ranks(refused, 2, str(tmp_path)) == [True, True]


def test_cli_distributed_without_torchrun_is_one_process(tmp_path,
                                                        monkeypatch, caplog):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with caplog.at_level("INFO", logger="bevrender_tpu_torch"):
        state = ttrain.main(["--tiny", "--epochs", "2", "--device", "cpu",
                             "--distributed"])
    assert "WORLD_SIZE is not set" in caplog.text
    assert not pdist.is_initialized()
    assert state.step == 6  # as test_cli_synthetic_tiny
    assert len(list((tmp_path / "bevrender_ckpt").iterdir())) == 1


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cli_rank(rank, world, tmp, port):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    tempfile.tempdir = tmp
    state = ttrain.main(["--tiny", "--epochs", "2", "--device", "cpu",
                         "--distributed"])
    assert pdist.world_size() == world and pdist.rank() == rank
    return state.step, _cpu_state(state), state.net.training


def test_cli_distributed_trains_on_two_cpu_ranks(tmp_path):
    """``--distributed --device cpu`` under torchrun's environment: two
    gloo ranks train the tiny model for one epoch (global batch 2, one row
    a rank), end with equal states, and rank 0 alone made the work
    directory with its config."""
    ranks = run_ranks(_cli_rank, 2, str(tmp_path), _free_port(), init=False)
    (step0, s0, _), (step1, s1, _) = ranks
    assert step0 == step1 == 6
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    (work,) = list((tmp_path / "bevrender_ckpt").iterdir())
    assert (work / "config.yaml").exists()


def test_initialize_distributed_joins_and_refuses_twice(tmp_path):
    def join(rank, world, tmp):
        dev = pdist.initialize_distributed(
            "cpu", init_method=f"file://{tmp}/rendezvous2", rank=rank,
            world_size=world)
        with pytest.raises(RuntimeError, match="already initialised"):
            pdist.initialize_distributed("cpu")
        return (str(dev), pdist.world_size(), pdist.rank(), pdist.is_main(),
                dist.get_backend())

    assert run_ranks(join, 2, str(tmp_path), init=False) == [
        ("cpu", 2, 0, True, "gloo"), ("cpu", 2, 1, False, "gloo")]
