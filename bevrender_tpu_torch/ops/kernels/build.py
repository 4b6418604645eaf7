"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries go to
``build/bevrender_tpu_torch/<hash>/`` at the repository root, keyed by a
hash of the sources and flags, and are built at first use. ``build_all``
starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "bevrender_tpu_torch"
SOURCES = ("lattice_bias", "fused_site", "lattice_bias_bwd", "fused_site_bwd",
           "lattice_bias_wide", "lattice_bias_wide_bwd", "fused_site_wide",
           "fused_site_wide_prefetch", "lattice_bias_wide_prefetch",
           "fused_site_fold_rows", "fused_site_fold_heads", "lattice_windows")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str):
    """Start one nvcc for ``name``; returns (process or None, target,
    temporary output). None when the library is already built."""
    target = _lib_path(name)
    if target.exists():
        return None, target, None
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, target, tmp


def _finish(name: str, proc, target: Path, tmp) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    return log


def build_all() -> dict:
    """Build every kernel library in parallel. Returns {name: nvcc log}
    (the ``-Xptxas -v`` register and shared-memory report; empty when the
    library was already built)."""
    with _lock:
        started = {n: _start(n) for n in SOURCES}
        return {n: _finish(n, *started[n]) for n in SOURCES}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            proc, target, tmp = _start(name)
            _finish(name, proc, target, tmp)
            lib = ctypes.CDLL(str(target))
            _libs[name] = lib
    return lib
