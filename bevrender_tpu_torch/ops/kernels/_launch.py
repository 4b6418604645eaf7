"""Argument checks and the ctypes call shared by the kernel wrappers."""

from __future__ import annotations

import ctypes

import torch

from bevrender_tpu_torch.ops.kernels.build import load_library

# shared memory one block may use on an H100 (227 KB, opted in above 48 KB)
SMEM_PER_BLOCK = 232448
# shared memory of one H100 SM (228 KB), of which each resident block also
# takes 1 KB
SMEM_PER_SM = 233472
SMEM_PER_BLOCK_RESERVED = 1024
# rows (above and below) and columns (on the left) of zero padding around an
# rpe table in the kernels (PAD in csrc/lattice_common.cuh)
PAD = 4
# head widths the fused-site kernels have instances for
HEAD_WIDTHS = (4, 8)
KEY_TILE = 32  # keys per online-softmax step, KT in csrc/site_common.cuh


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


def check_site_args(table, ys, ms, wy, f, u0, g, q, k, v, H: int, W: int):
    """Shape, dtype, device and layout checks shared by the site kernels'
    wrappers; returns (B, G, Hpg, Ht, Wt, N, ch)."""
    ch = q.shape[-1]
    if ch not in HEAD_WIDTHS:
        raise ValueError(f"fused site takes head widths {HEAD_WIDTHS}, got {ch}")
    check_geometry("the fused site kernels", table, ys, ms, wy, f, u0, g, H, W)
    G, Hpg, Ht, Wt = table.shape
    B, _, N = ys.shape
    dev = table.device
    check("q", q, torch.bfloat16, (B, G, Hpg, H * W, ch), dev)
    check("k", k, torch.bfloat16, (B, G, Hpg, N, ch), dev)
    check("v", v, torch.bfloat16, (B, G, Hpg, N, ch), dev)
    return B, G, Hpg, Ht, Wt, N, ch


def window_width(Wt: int) -> int:
    """m_max of the lattice lookup (``ops.deform_attn.static_comb``): the
    columns of the padded table that one query column's window spans."""
    return -(-(Wt - 1) // 2) + 3 + PAD


def padded_width(Wt: int) -> int:
    """Row pitch of the zero-padded table that the window reads come from
    and the whole-table kernels stage: PAD columns on the left, max(PAD,
    m_max) on the right."""
    return Wt + PAD + max(PAD, window_width(Wt))


def window_columns(Wt: int) -> tuple:
    """(CW, Xs) of a key's window in the prefetch kernels: its queries read
    the columns ms .. ms + max(u0) + 2 of the padded table, CW is the width
    of the whole 16-byte chunks that hold them wherever ms falls, and Xs the
    row pitch (a multiple of 8) of the pitched zero-padded table
    (csrc/lattice_ring.cuh) that every such chunk lies in."""
    u_max = (Wt - 1) // 2  # u0 of the last query column
    m_max = window_width(Wt)
    CW = -(-(u_max + 3 + 7) // 8) * 8
    return CW, -(-max(padded_width(Wt), m_max - 3 + CW) // 8) * 8


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


def sm_count(device) -> int:
    """SMs of the card that holds ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def blocks_per_sm(lib_name: str, fn_name: str, *args: int) -> int:
    """Blocks one SM of the card holds at once, from a library's occupancy
    query ``fn_name(*args)`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    in C; a negative CUDA error code where it fails, which raises)."""
    fn = getattr(load_library(lib_name), fn_name)
    fn.argtypes = [ctypes.c_int] * len(args)
    fn.restype = ctypes.c_int
    n = fn(*args)
    if n <= 0:
        raise RuntimeError(f"{fn_name}: CUDA error {-n}")
    return n


def call(lib_name: str, fn_name: str, args) -> None:
    """Call ``fn_name`` of the kernel library on PyTorch's current stream.
    Tensors pass as pointers, Python floats as C floats and ints as C ints;
    the stream goes last. Raises on a non-zero ``cudaGetLastError``."""
    fn = _fn(lib_name, fn_name, args)
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = fn(*c_args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} at launch")
