"""Timing of a call on the device (counterpart of
bevrender_tpu/utils/timing.py).

``device_bench`` keeps the JAX function's two remedies:

* **min-of-differences bias**: taking ``min`` over repetitions of
  ``(t(n2) - t(n1)) / (n2 - n1)`` selects the most negative noise
  excursion and can read negative for short calls. Here each count's
  time is min-reduced separately, then differenced once.
* **fixed iteration counts**: a count that suits a 40 ms call drowns in
  noise for a 0.2 ms one, so ``n`` is calibrated until the calls take
  ``target_s`` seconds.

The JAX function also perturbs its input by the loop index, to defeat
XLA's caching of a repeated identical computation; an eager PyTorch call
is never elided, so the port calls ``fn`` on its arguments as they are.
"""

from __future__ import annotations

import time

import torch

__all__ = ["device_bench"]


def _timer():
    """Seconds taken by ``n`` back-to-back calls of a function: by CUDA
    events around the queued calls where a card is present (the events
    wait for the device's work; the launches queue without a host wait
    between them), else by the host clock."""
    if not torch.cuda.is_available():
        def timed(call, n: int) -> float:
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            return time.perf_counter() - t0
        return timed

    def timed(call, n: int) -> float:
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            call()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3

    return timed


def device_bench(fn, *args, target_s: float = 1.5, reps: int = 3,
                 max_n: int = 1 << 20) -> float:
    """Milliseconds per call of ``fn(*args)``: ``n`` calibrated so that
    ``n`` calls take about ``target_s`` seconds, then the least of
    ``reps`` timings of ``n`` calls and of ``n // 8`` calls, differenced
    once (which also removes the fixed cost of a timing)."""
    timed = _timer()

    def call():
        fn(*args)

    timed(call, 1)  # first call: builds, allocations, autotuning
    # calibrate; growth per round is bounded x8 so that one noisy reading
    # cannot send n past max_n
    n = 4
    for _ in range(16):
        t = timed(call, n)
        if t >= target_s or n >= max_n:
            break
        want = int(n * target_s / max(t, 1e-4)) + 1
        n = min(max_n, max(n * 2, min(want, n * 8)))

    n2, n1 = n, max(1, n // 8)
    t1 = min(timed(call, n1) for _ in range(reps))
    t2 = min(timed(call, n2) for _ in range(reps))
    return (t2 - t1) / (n2 - n1) * 1e3
