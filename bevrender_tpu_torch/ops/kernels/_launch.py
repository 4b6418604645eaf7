"""Argument checks and the ctypes call shared by the kernel wrappers."""

from __future__ import annotations

import ctypes

import torch

from bevrender_tpu_torch.ops.kernels.build import load_library

# shared memory one block may use on an H100 (227 KB, opted in above 48 KB)
SMEM_PER_BLOCK = 232448
# rows (above and below) and columns (on the left) of zero padding around an
# rpe table in the kernels (PAD in csrc/lattice_common.cuh)
PAD = 4


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_geometry(fn: str, table, ys, ms, wy, f, u0, g, H: int, W: int,
                   gout=None):
    """The bias kernels' common arguments: table (G, Hpg, 2H-1, Wt) bf16 on
    a CUDA device; ys, ms (B, G, N) int32; wy, f (B, G, N) float32; u0 (W,)
    int32, g (W,) float32; and, for the backward kernels, the cotangent of
    the bias ``gout`` (B, G, Hpg, N, H*W) bf16."""
    dev = table.device
    if table.dim() != 4 or ys.dim() != 3:
        raise ValueError(f"{fn}: table must be 4-d and ys 3-d")
    G, Hpg, _, Wt = table.shape
    B, _, N = ys.shape
    check("table", table, torch.bfloat16, (G, Hpg, 2 * H - 1, Wt), dev)
    for name, t, dt in (("ys", ys, torch.int32), ("ms", ms, torch.int32),
                        ("wy", wy, torch.float32), ("f", f, torch.float32)):
        check(name, t, dt, (B, G, N), dev)
    check("u0", u0, torch.int32, (W,), dev)
    check("g", g, torch.float32, (W,), dev)
    if gout is not None:
        check("gout", gout, torch.bfloat16, (B, G, Hpg, N, H * W), dev)
    if dev.type != "cuda":
        raise ValueError(f"{fn} takes CUDA tensors")


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
