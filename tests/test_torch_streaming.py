"""The port's streaming serving on the tiny config with a retrieval head,
on the CPU: ``encode_step`` / ``decode`` (and the pipeline's streaming step
built on them) against the JAX package's, the carried chain against the
port's own full-window render, the replay against the chain, and the
``from_checkpoint`` round trip.

Tolerances: against JAX both frameworks' attention sites run in float32
(``f32_sites``, tests/test_torch_retrieval.py): the shipped sites round to
bf16, where a flipped rounding moves a render by up to ~4e-3. There the BEV
is held to 1e-4 of its largest entry and the render to 1e-4, also when
the port's decoder alone renders JAX's BEV (float32 summation order
through the decoder: 2.4e-5 measured); the argmin tiles must be equal. The chain, the
replay and the full window run the same operations on the same inputs in
the port, so they are held equal bit for bit.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bevrender_tpu.inference.register import RegistrationPipeline as JPipeline
from bevrender_tpu_torch.convert import flax_to_state_dict
from bevrender_tpu_torch.data.synthetic import SyntheticDataset
from bevrender_tpu_torch.inference.register import RegistrationPipeline
from bevrender_tpu_torch.training.trainer import Trainer
from test_torch_retrieval import (  # noqa: F401 (f32_sites is a fixture)
    F32_RENDER_TOL,
    HEAD,
    _configs,
    _variables,
    f32_sites,
)

BEV_REL = 1e-4
T = 3  # two history frames and the current one


def _pairs(pose: torch.Tensor):
    """Each frame's pose pair under the JAX package's rule
    (tests/test_inference.py:87-114): frame t of a T-frame window warps
    with ``pose[:, lo:lo + 2]``, ``lo = min(t, T - 2)``."""
    n = pose.shape[1]
    return [pose[:, min(t, n - 2):min(t, n - 2) + 2] for t in range(n)]


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, pcfg = _configs(**HEAD)
    ds = SyntheticDataset(n_items=2, num_views=2, window_num_imgs=T - 1,
                          img_height=32, img_width=32, map_tile=32)
    batch = ds.batch(2)
    variables = _variables(**HEAD)
    tpipe = RegistrationPipeline(pcfg, flax_to_state_dict(variables),
                                 device="cpu")
    tiles = np.random.default_rng(5).uniform(0, 1, (12, 32, 32, 3)).astype(
        np.float32)
    db = tpipe.build_tile_database(list(tiles))
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    return jcfg, pcfg, variables, tpipe, b, db


def _chain(tpipe, b, db):
    """The streaming step over the window: (per-frame BEVs, renders and
    tile indices)."""
    step = tpipe.make_streaming_step()
    bev, bevs, outs, idx = None, [], [], []
    for t, pair in enumerate(_pairs(b["vehicle_pose"])):
        bev, out, i = step(b["camera"][:, t], bev, pair, b["vehicle_type"], db)
        bevs.append(bev)
        outs.append(out)
        idx.append(i)
    return bevs, outs, idx


def test_streaming_step_matches_jax(f32_sites):
    """Two frames of the streaming step, the first without a carried BEV,
    against the JAX pipeline's ``make_streaming_step`` on the same tile
    embeddings; then the port's ``decode`` of JAX's BEV against JAX's
    render."""
    jcfg, _, variables, tpipe, b, db = _setup()
    jstep = JPipeline(jcfg, variables).make_streaming_step()
    tstep = tpipe.make_streaming_step()
    pose, vt, cam = b["vehicle_pose"], b["vehicle_type"], b["camera"]
    jbev, tbev = None, None
    for t in range(2):
        pair = pose[:, t:t + 2]
        jbev, jout, jidx = jstep(variables, jnp.asarray(cam[:, t].numpy()),
                                 jbev, jnp.asarray(pair.numpy()),
                                 jnp.asarray(vt.numpy()),
                                 jnp.asarray(db.numpy()))
        tbev, tout, tidx = tstep(cam[:, t], tbev, pair, vt, db)
        ref = np.asarray(jbev)
        assert tbev.shape == ref.shape == (2, 8, 8, 8)
        assert float(np.abs(tbev.numpy() - ref).max()) <= \
            BEV_REL * float(np.abs(ref).max()), t
        assert float(np.abs(tout.numpy() - np.asarray(jout)).max()) <= \
            F32_RENDER_TOL, t
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    with torch.no_grad():
        got = tpipe.net.decode(torch.from_numpy(np.array(jbev)))
    assert float(np.abs(got.numpy() - np.asarray(jout)).max()) <= \
        F32_RENDER_TOL


def test_streaming_chain_equals_the_full_window_render():
    """One encoder pass a frame with the BEV carried gives the window's
    render, bit for bit."""
    _, _, _, tpipe, b, db = _setup()
    _, outs, _ = _chain(tpipe, b, db)
    full = tpipe.render(b)
    assert torch.equal(outs[-1], full)
    two = {k: (v[:, :2] if k in ("camera", "vehicle_pose") else v)
           for k, v in b.items()}
    step = tpipe.make_streaming_step()
    pair = b["vehicle_pose"][:, 0:2]
    bev, _, _ = step(b["camera"][:, 0], None, pair, b["vehicle_type"], db)
    _, out, _ = step(b["camera"][:, 1], bev, pair, b["vehicle_type"], db)
    assert torch.equal(out, tpipe.render(two))


def test_replay_equals_the_chain():
    """The replay over the window returns the chain's tile indices and its
    final BEV, bit for bit, and each frame's distance to its tile."""
    _, _, _, tpipe, b, db = _setup()
    bevs, outs, idx = _chain(tpipe, b, db)
    frames = b["camera"].transpose(0, 1)
    pairs = torch.stack(_pairs(b["vehicle_pose"]))
    bev, ridx, rdist = tpipe.make_replay_scan()(frames, pairs,
                                                b["vehicle_type"], db)
    assert ridx.shape == rdist.shape == (T, 2)
    assert torch.equal(ridx, torch.stack(idx))
    assert torch.equal(bev, bevs[-1])
    for t in range(T):
        d = 2.0 - 2.0 * tpipe.embed(outs[t]) @ db.T
        assert torch.equal(rdist[t], d.amin(dim=-1))


def test_carrying_history_changes_the_bev():
    _, _, _, tpipe, b, db = _setup()
    step = tpipe.make_streaming_step()
    frame, pair = b["camera"][:, -1], b["vehicle_pose"][:, -2:]
    bev1, out1, _ = step(frame, None, pair, b["vehicle_type"], db)
    bev2, out2, _ = step(frame, bev1, pair, b["vehicle_type"], db)
    assert bev1.shape == bev2.shape and out1.shape == out2.shape
    assert float((bev1 - bev2).abs().max()) > 1e-6


def test_encode_step_keeps_the_training_mode():
    """``encode_step`` runs in eval semantics and hands the mode back."""
    _, _, _, tpipe, b, _ = _setup()
    net = tpipe.net.train()
    try:
        with torch.no_grad():
            bev = net.encode_step(b["camera"][:, 0], None,
                                  b["vehicle_pose"][:, 0:2],
                                  b["vehicle_type"])
        assert net.training
        net.eval()
        with torch.no_grad():
            again = net.encode_step(b["camera"][:, 0], None,
                                    b["vehicle_pose"][:, 0:2],
                                    b["vehicle_type"])
        assert torch.equal(bev, again)
    finally:
        net.eval()


def test_from_checkpoint_round_trip(tmp_path):
    """``Trainer.save_checkpoint`` then ``from_checkpoint``: the same
    render and the same database, bit for bit."""
    _, pcfg, _, tpipe, b, _ = _setup()
    pcfg = copy.deepcopy(pcfg)
    pcfg.train.work_dir = str(tmp_path)
    trainer = Trainer(pcfg, None, device="cpu")
    state = trainer.create_state(state_dict=tpipe.net.state_dict())
    path = trainer.save_checkpoint(state, epoch=3, best=True)
    loaded = RegistrationPipeline.from_checkpoint(pcfg, path, device="cpu")
    assert torch.equal(loaded.render(b), tpipe.render(b))
    tiles = list(b["map"].numpy())
    assert torch.equal(loaded.build_tile_database(tiles),
                       tpipe.embed(b["map"]))
