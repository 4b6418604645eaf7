"""flax variable tree -> the port's ``state_dict``.

``flax_to_state_dict`` takes ``{"params": ..., "batch_stats": ...}`` as
nested dicts of numpy arrays (the JAX package's ``BEVRenderModel.init``
output, moved to numpy) and returns tensors under the port's module names,
which follow the flax names:

* conv kernels (kh, kw, in/groups, out) -> weight (out, in/groups, kh, kw);
* the kernel of a stage's ``transition`` that is a 2 x 2 transposed conv
  (an upsampling stage of a pyramid config; its other transitions are 1 x 1
  or 3 x 3 convs) -> weight ``K[::-1, ::-1]`` as (in, out, kh, kw): flax's
  transposed conv reads the kernel flipped against PyTorch's
  (``models.layers.ConvTranspose``);
* dense kernels (in, out) -> weight (out, in);
* LayerNorm / BatchNorm / GroupNorm ``scale`` -> ``weight`` (the
  retrieval head's and ``AdaptiveGroupNorm``'s modules carry flax's names,
  ``Conv_0``, ``GroupNorm_0``, ``Dense_0``, so they map as they are);
* ``batch_stats`` mean / var -> ``running_mean`` / ``running_var``, with a
  zero ``num_batches_tracked``;
* the leading depth axis of ``stage{s}/layers/*`` (the flax scan stack)
  -> ``stage{s}.layers.{i}.*``;
* ``bev_embedding``, ``rpe_table`` and ``LayerScale``'s ``gamma`` as they
  are; so do the module names
  of ``ResnetFPN`` (a bottleneck's ``conv3`` / ``bn3``, an FPN level's
  ``lateral``, ``top_proj`` and ``out_conv`` with their biases) and of
  ``SimpleDecoder``.

``train_state_to_torch`` does the same for a whole training state: the
optax AdamW moments have the shapes of the parameters and map as they do.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, np.asarray(tree)


def _unstack(path: tuple, arr: np.ndarray):
    """Split the scan depth axis of ``.../stage{s}/layers/...`` leaves."""
    if "layers" not in path:
        return [(path, arr)]
    i = path.index("layers")
    return [(path[: i + 1] + (str(d),) + path[i + 1:], arr[d])
            for d in range(arr.shape[0])]


def _is_conv_transpose(path: tuple, arr: np.ndarray) -> bool:
    return (len(path) >= 2 and path[-2] == "transition" and arr.ndim == 4
            and arr.shape[:2] == (2, 2))


def _param(path: tuple, arr: np.ndarray):
    name = path[-1]
    if name == "kernel":
        if _is_conv_transpose(path, arr):
            return "weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:
            return "weight", arr.T
        raise ValueError(f"kernel of rank {arr.ndim} has no mapping")
    if name == "scale":
        return "weight", arr
    if name in ("bias", "rpe_table", "bev_embedding", "gamma"):
        return name, arr
    raise ValueError(f"unknown flax parameter {name!r}")


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a, dtype=np.float32))  # a copy


def flax_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(variables["params"]):
        for p, a in _unstack(path, arr):
            name, a = _param(p, a)
            out[".".join(p[:-1] + (name,))] = _tensor(a)
    for path, arr in _leaves(variables.get("batch_stats", {})):
        for p, a in _unstack(path, arr):
            stat = {"mean": "running_mean", "var": "running_var"}[p[-1]]
            prefix = ".".join(p[:-1])
            out[f"{prefix}.{stat}"] = _tensor(a)
            out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return out


def train_state_to_torch(params, batch_stats, opt_state):
    """The JAX package's ``TrainState`` -> the port's.

    ``params`` and ``batch_stats`` as for ``flax_to_state_dict``;
    ``opt_state`` is ``{"mu": tree, "nu": tree, "count": int}``, the first
    and second moments and the update count of optax's ``scale_by_adam``
    state as numpy. Returns ``(state_dict, adamw)`` where ``adamw`` is
    ``{"step": count, "exp_avg": {name: tensor}, "exp_avg_sq": {...}}``
    under the port's parameter names; ``load_adamw_state`` puts it into a
    ``torch.optim.AdamW`` over the same model."""
    state_dict = flax_to_state_dict({"params": params,
                                     "batch_stats": batch_stats or {}})
    adamw = {"step": int(np.asarray(opt_state["count"])),
             "exp_avg": flax_to_state_dict({"params": opt_state["mu"]}),
             "exp_avg_sq": flax_to_state_dict({"params": opt_state["nu"]})}
    return state_dict, adamw


def load_adamw_state(optimizer: torch.optim.Optimizer, net: torch.nn.Module,
                     adamw) -> None:
    """Fill ``optimizer`` (AdamW over ``net.parameters()``) with the moments
    and step count from ``train_state_to_torch``. The step count lies where
    ``torch.optim`` keeps it: on the parameter's device for a capturable
    (or fused) AdamW, on the CPU otherwise."""
    group = optimizer.param_groups[0]
    on_device = group.get("capturable", False) or group.get("fused", False)
    for name, p in net.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(adamw["step"]),
                                 device=p.device if on_device else "cpu"),
            "exp_avg": adamw["exp_avg"][name].to(p.device, p.dtype),
            "exp_avg_sq": adamw["exp_avg_sq"][name].to(p.device, p.dtype),
        }
