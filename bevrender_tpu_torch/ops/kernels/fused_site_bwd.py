"""Wrapper of the ``fused_site_bwd`` CUDA kernel (csrc/fused_site_bwd.cu),
the counterpart of bevrender_tpu/ops/pallas/fused_attn.py::site_bwd_call.
Its plain version is autograd through ``ops.deform_attn.site_plain``;
``ops.deform_attn.site_bwd_online`` repeats its roundings in PyTorch.

``tiling`` chooses the kernel's blocks from the shapes alone."""

from __future__ import annotations

import torch

from bevrender_tpu_torch.ops.kernels._launch import (
    PAD,
    SMEM_PER_BLOCK,
    call,
    check,
)
from bevrender_tpu_torch.ops.kernels.fused_site import check_site_args

launches = 0  # kernel launches since the last reset (ops.kernels.reset_counts)

SLOTS = 32          # queries a block takes at a time (a strip)
KEYS_PER_WARP = 16  # the rows of the kernel's mma tiles
MAX_WARPS = 16      # 512 threads a block
SMS = 132           # streaming multiprocessors of an H100
MIN_BLOCKS = 2 * SMS


def smem_bytes(Ht: int, Xp: int, ch: int, warps: int = 1) -> int:
    """Shared memory of one block: the zero-padded table in bf16 and its
    gradient in float32, a strip's q and dO in float32 with four words a
    query, and one float32 (SLOTS, ch) dq buffer for each of ``warps``
    warps."""
    return (Ht + 2 * PAD) * Xp * 6 + SLOTS * (2 * ch + 4 + warps * ch) * 4


def tiling(B: int, G: int, Hpg: int, Ht: int, Xp: int, N: int, M: int,
           ch: int) -> tuple:
    """(warps, nkb, qsplit) of a launch: a head's N keys in as few key
    blocks (``nkb``) as hold them at the most warps whose dq buffers fit
    beside the table (at most MAX_WARPS), spread evenly over the warps, 16
    keys a warp; the query walk split into ``qsplit`` chunks of strips where
    the key blocks of the B * G * Hpg heads alone would launch fewer than
    MIN_BLOCKS blocks. The kernel takes nkb and qsplit as given: block x of
    a head has key block x % nkb and strips [c S // qsplit, (c + 1) S //
    qsplit) of the S strips, c = x // nkb."""
    fit = (SMEM_PER_BLOCK - smem_bytes(Ht, Xp, ch, 0)) // (SLOTS * ch * 4)
    cap = min(MAX_WARPS, fit)
    if cap < 1:
        raise ValueError(f"fused_site_bwd: a table of {Ht} x {Xp} padded "
                         f"entries needs {smem_bytes(Ht, Xp, ch)} B of shared "
                         f"memory, over {SMEM_PER_BLOCK}")
    nkb = -(-N // (KEYS_PER_WARP * cap))
    warps = -(-(-(-N // nkb)) // KEYS_PER_WARP)
    strips = -(-M // SLOTS)
    qsplit = min(strips, max(1, -(-MIN_BLOCKS // (B * G * Hpg * nkb))))
    return warps, nkb, qsplit


def fused_site_bwd_cuda(table, ys, ms, wy, f, u0, g, Xp: int, q, k, v, dout,
                        lse, dsum, H: int, W: int, scale: float):
    """table, geometry, q, k, v as ``fused_site_cuda``; dout (B, G, Hpg,
    H*W, ch) float32, the cotangent of the site's output; lse and dsum
    (B, G, Hpg, H*W) float32, the forward's logsumexp and rowsum(dO * O)
    -> (dq, dk, dv, dtable, dwy, df), all float32. dq, dtable, dwy and df
    (and dk, dv where the query walk is split) are summed through float
    atomics: their last bits vary from run to run."""
    global launches
    B, G, Hpg, Ht, Wt, N, ch = check_site_args(table, ys, ms, wy, f, u0, g,
                                               q, k, v, H, W)
    dev = table.device
    M = H * W
    check("dout", dout, torch.float32, (B, G, Hpg, M, ch), dev)
    check("lse", lse, torch.float32, (B, G, Hpg, M), dev)
    check("dsum", dsum, torch.float32, (B, G, Hpg, M), dev)
    tiles = tiling(B, G, Hpg, Ht, Xp, N, M, ch)
    f32 = dict(dtype=torch.float32, device=dev)
    dq = torch.zeros((B, G, Hpg, M, ch), **f32)
    dk = torch.zeros((B, G, Hpg, N, ch), **f32)
    dv = torch.zeros((B, G, Hpg, N, ch), **f32)
    dtable = torch.zeros((G, Hpg, Ht, Wt), **f32)
    dwy = torch.zeros((B, G, N), **f32)
    df = torch.zeros((B, G, N), **f32)
    call("fused_site_bwd", "fused_site_bwd_launch",
         (table, ys, ms, wy, f, u0, g, q, k, v, dout, lse, dsum, dq, dk, dv,
          dtable, dwy, df, B, G, Hpg, Ht, Wt, Xp, N, H, W, ch,
          *tiles, float(scale)))
    launches += 1
    return dq, dk, dv, dtable, dwy, df
