"""Utilities of the port (counterpart of bevrender_tpu/utils/):
``profiling`` (traces, annotations, a step timer, device memory) and
``timing`` (``device_bench``)."""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def enable_compilation_cache(cache_dir: Optional[str] = None) -> None:
    """The port's counterpart of the JAX package's persistent compilation
    cache: with ``cache_dir`` the CUDA kernel libraries are built into and
    loaded from there (``ops.kernels.build.BUILD_ROOT``). Without one
    nothing changes: the libraries are already cached on disk, keyed by a
    hash of their sources and flags. Libraries already loaded stay
    loaded."""
    if cache_dir is None:
        return
    from bevrender_tpu_torch.ops.kernels import build

    build.BUILD_ROOT = Path(cache_dir)
