"""``scripts/orbax_to_torch.py``: an Orbax checkpoint of the JAX package,
written by its ``training.checkpoint.save_model``, carried into the
port's format, then served by ``RegistrationPipeline.from_checkpoint`` and
resumed by ``Trainer.restore_checkpoint`` on the CPU (tiny config).

The JAX state holds the port's seeded weights in the flax tree
(``test_torch_retrieval._variables``: no JAX init compiled) and AdamW
moments drawn from a seed with a count of 3, so that every entry that
crosses is distinguishable. Renders are compared with both frameworks'
sites in float32 (``f32_sites``): the file's render equals the render of
the same weights bridged in memory bit for bit, and the JAX render to
F32_RENDER_TOL (float32 summation order through the decoder: 1.6e-5
measured here, 2.4e-5 in tests/test_torch_streaming.py, so 1e-5 does not
hold).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevrender_tpu.inference.register import RegistrationPipeline as JPipeline
from bevrender_tpu.models.bevrender import BEVRenderModel
from bevrender_tpu.training import checkpoint as jckpt
from bevrender_tpu.training.trainer import Trainer as JTrainer
from bevrender_tpu_torch.convert import (
    flax_to_state_dict,
    load_adamw_state,
    train_state_to_torch,
)
from bevrender_tpu_torch.inference.register import RegistrationPipeline
from bevrender_tpu_torch.training import checkpoint as tckpt
from bevrender_tpu_torch.training.trainer import Trainer
from test_torch_retrieval import (  # noqa: F401 (f32_sites is a fixture)
    F32_RENDER_TOL,
    _configs,
    _dataset,
    _variables,
    f32_sites,
)

ROOT = Path(__file__).resolve().parents[1]
COUNT = 3
EPOCH = 4


def _script():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", ROOT / "scripts" / "orbax_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _opt_state(jtrainer, params):
    """optax's state for ``params`` with seeded moments and count COUNT."""
    rng = np.random.default_rng(7)
    state = jtrainer.tx.init(params)

    def fill(path, x):
        keys = [getattr(p, "name", None) for p in path]
        if "mu" in keys or "nu" in keys:
            scale = 1e-3 if "mu" in keys else 1e-6
            return jnp.asarray(np.abs(rng.standard_normal(x.shape)) * scale,
                               x.dtype)
        if keys[-1] == "count":
            return jnp.asarray(COUNT, x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(fill, state)


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """(JAX config, port config, flax variables, optax state, the Orbax
    directory, the port's file written by the script's ``main``)."""
    tmp = tmp_path_factory.mktemp("bridge")
    jcfg, pcfg = _configs()
    pcfg.train.work_dir = str(tmp / "work")
    variables = _variables()
    jtrainer = JTrainer(BEVRenderModel(jcfg), jcfg, _dataset())
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    opt_state = _opt_state(jtrainer, params)
    orbax_dir = jckpt.save_model(
        str(tmp / "orbax"), {"params": params,
                             "batch_stats": variables["batch_stats"],
                             "opt_state": opt_state}, EPOCH, best=True)
    cfg_json = tmp / "cfg.json"
    cfg_json.write_text(pcfg.to_json())
    out = tmp / "from_orbax.pt"
    assert _script().main([orbax_dir, str(out), "--config",
                           str(cfg_json)]) == str(out)
    return jcfg, pcfg, variables, opt_state, orbax_dir, out


def test_bridged_checkpoint_renders_as_jax(bridged, f32_sites):
    jcfg, pcfg, variables, _, _, out = bridged
    saved = tckpt.restore_model(str(out))
    assert saved["epoch"] == EPOCH and saved["step"] == COUNT
    batch = _dataset().batch(2)
    pipe = RegistrationPipeline.from_checkpoint(pcfg, str(out), device="cpu")
    render = pipe.render(batch)
    memory = RegistrationPipeline(pcfg, flax_to_state_dict(variables),
                                  device="cpu").render(batch)
    assert torch.equal(render, memory)
    ref = np.asarray(JPipeline(jcfg, variables).render(
        {k: jnp.asarray(v) for k, v in batch.items()}))
    assert render.shape == ref.shape
    np.testing.assert_allclose(render.numpy(), ref, atol=F32_RENDER_TOL,
                               rtol=0)


def test_trainer_resumes_from_the_bridged_checkpoint(bridged):
    """The weights, BatchNorm statistics, AdamW moments and count cross
    exactly; the resumed trainer continues at step COUNT + 1 and takes the
    same step, bit for bit, as a state bridged in memory
    (``train_state_to_torch``, ``load_adamw_state``)."""
    _, pcfg, variables, opt_state, _, out = bridged
    trainer = Trainer(pcfg, _dataset(), device="cpu")
    state = trainer.restore_checkpoint(trainer.create_state(seed=1),
                                       str(out))
    assert state.step == COUNT
    ref = flax_to_state_dict(variables)
    for name, t in state.net.state_dict().items():
        assert torch.equal(t, ref[name]), name
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")][0]
    mu = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray,
                                                              adam.mu)})
    nu = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray,
                                                              adam.nu)})
    for name, p in state.net.named_parameters():
        st = state.optimizer.state[p]
        assert int(st["step"]) == COUNT
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name

    memory = trainer.create_state(state_dict=ref)
    _, moments = train_state_to_torch(
        variables["params"], variables["batch_stats"],
        {"mu": jax.tree_util.tree_map(np.asarray, adam.mu),
         "nu": jax.tree_util.tree_map(np.asarray, adam.nu), "count": COUNT})
    load_adamw_state(memory.optimizer, memory.net, moments)
    memory.step = COUNT
    batch = _dataset().batch(2)
    state, m1, _ = trainer.train_step(state, batch, rng=3)
    memory, m2, _ = trainer.train_step(memory, batch, rng=3)
    assert state.step == memory.step == COUNT + 1
    assert np.isfinite(float(m1["train_batch_loss"]))
    assert float(m1["train_batch_loss"]) == float(m2["train_batch_loss"])
    for (n, a), (_, b) in zip(state.net.state_dict().items(),
                              memory.net.state_dict().items()):
        assert torch.equal(a, b), n


def test_weights_only_checkpoint_starts_adamw_afresh(bridged, tmp_path):
    """A checkpoint without an optimizer state crosses as weights, with an
    empty AdamW state at step 0."""
    _, pcfg, variables, _, _, _ = bridged
    orbax_dir = jckpt.save_model(
        str(tmp_path / "orbax"),
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}, 1)
    out = _script().convert(orbax_dir, str(tmp_path / "w.pt"), pcfg)
    saved = tckpt.restore_model(out)
    assert saved["step"] == 0 and saved["epoch"] == 1
    assert not saved["optimizer"]["state"]
    ref = flax_to_state_dict(variables)
    for name, t in saved["model"].items():
        assert torch.equal(t, ref[name]), name
