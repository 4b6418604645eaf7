"""Warmup-cosine learning-rate factor (counterpart of
bevrender_tpu/training/schedule.py::warmup_cosine_lambda): linear 0 -> 1
over ``warmup_steps``, then cosine 1 -> 0 over the rest. The trainer steps
it per epoch."""

from __future__ import annotations

import math


def warmup_cosine_lambda(step: float, warmup_steps: int, t_total: int,
                         cycles: float = 0.5) -> float:
    if step < warmup_steps:
        return float(step) / float(max(1.0, warmup_steps))
    progress = float(step - warmup_steps) / float(max(1, t_total - warmup_steps))
    return max(0.0, 0.5 * (1.0 + math.cos(math.pi * cycles * 2.0 * progress)))
