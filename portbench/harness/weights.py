"""Seeded weights and BatchNorm buffers, made on the device in one draw.

The benchmark makes the state that both the program and the reference
read. One uniform draw from a generator on the device covers every
floating tensor, and each tensor takes its slice through the model's own
initial distribution (normal by the inverse error function, or uniform):

* convolutions: normal, std sqrt(2 / fan_out), fan_out = output channels
  x kernel area (Kaiming, fan-out mode); a 2 x 2 transposed convolution:
  normal, std 1 / sqrt(input channels x 4) / 0.8796 (LeCun, truncated);
* dense layers: uniform, +-sqrt(6 / (fan_in + fan_out)) (Xavier);
* biases 0, norm weights 1; rpe tables normal, std ``RPE_STD`` (the
  model's initialiser draws 0.01: 0.25 makes the bias move the scores by a
  fraction of their spread, so that the check sees the bias kernels'
  work); the BEV query uniform in [0, 1);
* the last projection of every residual branch of the encoder (the
  attention sites' ``proj_out``, the conv MLPs' ``linear2``) scaled by
  1 / sqrt(the number of residual branches), GPT-2's scheme, so that the
  BEV stream stays of order one over the 56 branches (unscaled it grows
  to a std of about 45, and the history keys then drive the temporal
  attention's softmax to one key); the render head scaled by 1/4, so that
  the render lies inside the sigmoid's range, not at its ends;
* BatchNorm's running statistics are then set to the batch statistics of
  a calibration batch (``calibrate_norms``: the reference, float32, eval
  semantics otherwise), as a trained model's are: without that, an eval
  pass leaves its activations unnormalised and the render saturates.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RPE_STD = 0.25
BRANCH_ENDS = ("proj_out.weight", "linear2.weight")
HEAD = ("decoder.head.conv1.weight", 0.25)


def mix(*ints: int) -> int:
    """A 63-bit seed from several integers (numpy's SeedSequence)."""
    return int(np.random.SeedSequence([int(i) for i in ints]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def _kind(name: str, shape) -> tuple:
    """(distribution, scale) of one tensor: ("normal", std), ("truncated",
    std) (at two std), ("uniform", half-width), ("unit", 0) for [0, 1), or
    ("const", value)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bev_embedding":
        return "unit", 0.0
    if leaf == "rpe_table":
        return "normal", RPE_STD
    if leaf in ("running_mean", "bias"):
        return "const", 0.0
    if leaf == "running_var" or len(shape) == 1:
        return "const", 1.0
    if len(shape) == 4:
        if "transition" in name and tuple(shape[2:]) == (2, 2):
            return "truncated", (shape[0] * 4) ** -0.5 / 0.87962566103423978
        return "normal", math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    return "uniform", math.sqrt(6.0 / (shape[0] + shape[1]))


def make_state(shapes: dict, seed: int, device, branches: int) -> dict:
    """name -> tensor on ``device`` for every entry of ``shapes`` (name ->
    (shape, dtype)), from ``seed``; ``branches`` residual branches."""
    floats = [(n, s) for n, (s, dt) in shapes.items() if dt.is_floating_point]
    total = sum(math.prod(s) for _, s in floats)
    gen = torch.Generator(device=device)
    gen.manual_seed(mix(seed, 7001))
    u = torch.rand(total, generator=gen, device=device)
    z = math.sqrt(2.0) * torch.erfinv(torch.clamp(2.0 * u - 1.0, -0.9999994,
                                                  0.9999994))
    out, off = {}, 0
    for name, shape in floats:
        n = math.prod(shape)
        ui, zi = u[off:off + n].view(shape), z[off:off + n].view(shape)
        off += n
        kind, a = _kind(name, shape)
        if name.startswith("encoder.stage") and name.endswith(BRANCH_ENDS):
            a /= math.sqrt(branches)
        elif name == HEAD[0]:
            a *= HEAD[1]
        if kind == "normal":
            t = a * zi
        elif kind == "truncated":
            t = a * torch.clamp(zi, -2.0, 2.0)
        elif kind == "uniform":
            t = a * (2.0 * ui - 1.0)
        elif kind == "unit":
            t = ui
        else:
            t = torch.full(shape, a, device=device)
        out[name] = t.clone()
    for name, (shape, dt) in shapes.items():
        if not dt.is_floating_point:
            out[name] = torch.zeros(shape, dtype=dt, device=device)
    return {n: out[n] for n in shapes}


def residual_branches(model: dict) -> int:
    """Four residual branches an encoder layer (TSA, MLP, SCA, MLP)."""
    return 4 * sum(model["depths"][:model["n_stages"]])


def seeded_state(model: dict, shapes: dict, seed: int, device,
                 calibration: dict) -> dict:
    """The state both sides read: ``make_state`` with its BatchNorm
    statistics calibrated on ``calibration`` windows."""
    state = make_state(shapes, seed, device, residual_branches(model))
    calibrate_norms(model, state, calibration)
    return state


@torch.no_grad()
def calibrate_norms(model: dict, state: dict, batch: dict) -> None:
    """Set every BatchNorm's running mean and variance (in ``state``, in
    place) to the statistics of its input over ``batch`` (a few seeded
    windows), layer after layer, through the float32 reference."""
    from portbench.reference.model import Reference, tf32_off

    with tf32_off():
        ref = Reference(model, state)
        ref.calibrating = True
        ref.render(batch["camera"], batch["vehicle_pose"])
