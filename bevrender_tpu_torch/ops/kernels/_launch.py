"""Argument checks and the ctypes call shared by the kernel wrappers."""

from __future__ import annotations

import ctypes

import torch

from bevrender_tpu_torch.ops.kernels.build import load_library


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


_fns: dict = {}


def _fn(lib_name: str, fn_name: str, args):
    """The C function with its ctypes signature, set once."""
    key = (lib_name, fn_name)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(load_library(lib_name), fn_name)
        types = [ctypes.c_void_p if isinstance(a, torch.Tensor)
                 else ctypes.c_float if isinstance(a, float) else ctypes.c_int
                 for a in args]
        fn.argtypes = types + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def call(lib_name: str, fn_name: str, args) -> None:
    """Call ``fn_name`` of the kernel library on PyTorch's current stream.
    Tensors pass as pointers, Python floats as C floats and ints as C ints;
    the stream goes last. Raises on a non-zero ``cudaGetLastError``."""
    fn = _fn(lib_name, fn_name, args)
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = fn(*c_args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} at launch")
