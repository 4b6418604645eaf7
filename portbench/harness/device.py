"""What the harness asks of the device, so that its CPU tests can drive a
whole run (the benchmark itself refuses to run without a card)."""

from __future__ import annotations

import torch


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int:
    if torch.device(dev).type == "cuda":
        return int(torch.cuda.max_memory_allocated(dev))
    return 0


def free(dev) -> None:
    import gc

    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
