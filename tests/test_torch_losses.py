"""Losses and recall of the PyTorch port held against the JAX package on
the CPU: the same numpy inputs go through both, values and gradients.

Tolerance: float32 in both, a few dozen operations deep: 1e-6 absolute on
values of order 1 and on their gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevrender_tpu.losses import metric as jmetric
from bevrender_tpu.losses import recall as jrecall
from bevrender_tpu.losses import rendering as jrender
from bevrender_tpu_torch.losses import metric as tmetric
from bevrender_tpu_torch.losses import recall as trecall
from bevrender_tpu_torch.losses import rendering as trender

TOL = 1e-6


def _pair(seed, B=6, D=24, spread=0.3, common=1.0):
    """Camera and map embeddings that are close pairwise around a shared
    direction, so every loss has active positives, negatives and semihard
    triplets (negatives barely farther than the positives)."""
    rng = np.random.default_rng(seed)
    base = (common * rng.standard_normal((1, D))
            + 0.5 * rng.standard_normal((B, D))).astype(np.float32)
    cam = base + spread * rng.standard_normal((B, D)).astype(np.float32)
    map_ = base + spread * rng.standard_normal((B, D)).astype(np.float32)
    return cam, map_


def _both(jfn, tfn, arrays, n_grad):
    """Values and gradients (with respect to the first ``n_grad`` arrays) of
    the JAX function and the port's on the same inputs."""
    jargs = [jnp.asarray(a) for a in arrays]
    jval, jgrads = jax.value_and_grad(jfn, argnums=tuple(range(n_grad)))(*jargs)
    targs = [torch.from_numpy(np.array(a)) for a in arrays]
    for t in targs[:n_grad]:
        t.requires_grad_()
    tval = tfn(*targs)
    tgrads = torch.autograd.grad(tval, targs[:n_grad])
    return (float(jval), [np.asarray(g) for g in jgrads],
            float(tval.detach()), [g.numpy() for g in tgrads])


def _check(jval, jgrads, tval, tgrads):
    assert abs(jval - tval) <= TOL, (jval, tval)
    for jg, tg in zip(jgrads, tgrads):
        assert np.abs(jg).max() > 0
        np.testing.assert_allclose(tg, jg, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["mse_loss", "l1_loss", "cross_entropy_loss"])
def test_rendering_losses_match_jax(name):
    rng = np.random.default_rng(0)
    pred = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    _check(*_both(getattr(jrender, name), getattr(trender, name),
                  [pred, target], 1))


def test_cross_entropy_class_axis_matches_jax():
    rng = np.random.default_rng(1)
    pred = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    _check(*_both(lambda p, t: jrender.cross_entropy_loss(p, t, class_axis=-1),
                  lambda p, t: trender.cross_entropy_loss(p, t, class_axis=-1),
                  [pred, target], 1))


@pytest.mark.parametrize("name", ["contrastive_loss", "triplet_loss",
                                  "lifted_structure_loss"])
@pytest.mark.parametrize("seed", [2, 3])
def test_pair_losses_match_jax(name, seed):
    cam, map_ = _pair(seed)
    jval, jgrads, tval, tgrads = _both(getattr(jmetric, name),
                                       getattr(tmetric, name), [cam, map_], 2)
    assert jval > 0
    _check(jval, jgrads, tval, tgrads)


def test_triplet_loss_has_mined_triplets():
    """The inputs of the parity test do reach the mined branch: the loss
    exceeds its regulariser (the mean norm of the raw embeddings)."""
    cam, map_ = _pair(2)
    reg = float(np.linalg.norm(np.concatenate([cam, map_]), axis=-1).mean())
    val = float(tmetric.triplet_loss(torch.from_numpy(cam),
                                     torch.from_numpy(map_)))
    assert val > reg + 1e-4


@pytest.mark.parametrize("name", ["contrastive_loss_vs_db",
                                  "infonce_loss_vs_db"])
def test_db_losses_match_jax(name):
    cam, _ = _pair(4, B=5)
    rng = np.random.default_rng(5)
    db = rng.standard_normal((17, cam.shape[1])).astype(np.float32)
    labels = rng.choice(17, size=5, replace=False).astype(np.int32)
    db[labels] = cam + 0.2 * rng.standard_normal(cam.shape).astype(np.float32)
    jfn, tfn = getattr(jmetric, name), getattr(tmetric, name)
    jl, tl = jnp.asarray(labels), torch.from_numpy(labels)
    _check(*_both(lambda c, d: jfn(c, d, jl), lambda c, d: tfn(c, d, tl),
                  [cam, db], 2))


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_recall_matches_jax():
    cam, map_ = _pair(6, B=40, D=16, spread=0.9, common=0.0)
    cam, map_ = _unit(cam), _unit(map_)
    ref = [float(r) for r in jrecall.recall_at_k(jnp.asarray(cam),
                                                 jnp.asarray(map_), (1, 5, 10))]
    out = [float(r) for r in trecall.recall_at_k(
        torch.from_numpy(cam), torch.from_numpy(map_), (1, 5, 10))]
    assert 0 < ref[0] < ref[2] <= 100
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    curve = trecall.recall_curve(torch.from_numpy(cam), torch.from_numpy(map_))
    ref_curve = np.asarray(jrecall.recall_curve(jnp.asarray(cam),
                                                jnp.asarray(map_)))
    assert curve.shape == (11,) and float(curve[0]) == 0.0
    np.testing.assert_allclose(curve.numpy(), ref_curve, atol=TOL, rtol=0)
