"""Tracing and profiling hooks (counterpart of
bevrender_tpu/utils/profiling.py): a ``torch.profiler`` trace, named
ranges (the port's spans), a per-step timer that waits for the device,
and the device's memory counters."""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a
    card is present) and write a Chrome trace, viewable in Perfetto or
    ``chrome://tracing``, to ``<log_dir>/trace_<pid>_<n>.json``. Yields
    the profiler, whose ``key_averages()`` sum the block by name."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    n = len(list(out.glob("trace_*.json")))
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{n}.json"))


# what ``annotation`` gives while no profiler runs: one shared, stateless
# context, so that a span then costs one attribute read
_NO_SPAN = contextlib.nullcontext()


def annotation(name: str):
    """The port's span: a named range in a ``trace``
    (``torch.profiler.record_function``), which the profiler writes into
    the same Chrome trace, on the same clock, as the device's activity.
    Its start, end and enclosing spans (by nesting on its thread) are the
    trace's. While no profiler runs it enters nothing: a shared null
    context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


def _synchronize(result) -> None:
    """Wait for the devices of the CUDA tensors in ``result`` (a tensor or
    a nest of dicts, lists and tuples of them)."""
    if torch.is_tensor(result):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _synchronize(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _synchronize(v)


class StepTimer:
    """Per-step wall-clock timer that waits for the device, with simple
    stats."""

    def __init__(self):
        self.times: list = []

    @contextlib.contextmanager
    def step(self, result_to_block_on=None) -> Iterator[None]:
        """Time the block; with ``result_to_block_on`` (tensors, or a
        nest of them) the clock stops only after their CUDA devices have
        finished their queued work."""
        t0 = time.perf_counter()
        yield
        if result_to_block_on is not None:
            _synchronize(result_to_block_on)
        self.times.append(time.perf_counter() - t0)

    def stats(self, skip_first: int = 1) -> Dict[str, float]:
        """Mean, min and max seconds over the steps after the first
        ``skip_first`` (all of them where that leaves none), and their
        count; empty when no step was timed."""
        t = self.times[skip_first:] or self.times
        if not t:
            return {}
        return {
            "mean_s": sum(t) / len(t),
            "min_s": min(t),
            "max_s": max(t),
            "steps": len(t),
        }


def device_memory_stats(device="cuda") -> Optional[Dict[str, int]]:
    """Memory of a CUDA ``device`` in bytes: in use and at its peak (since
    the last ``torch.cuda.reset_peak_memory_stats``) by PyTorch's
    allocator, and the card's total; ``None`` for a device without such
    counters (the CPU), as the JAX function returns ``None`` where the
    device reports none."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": total,
    }
