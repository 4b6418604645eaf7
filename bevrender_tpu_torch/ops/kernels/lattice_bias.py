"""Wrappers of the bias forward kernels: ``lattice_bias`` (csrc/
lattice_bias.cu), the counterpart of bevrender_tpu/ops/pallas/
lattice_bias.py::_fwd_call_sh, ``lattice_bias_wide`` (csrc/
lattice_bias_wide.cu), the counterpart of ``_fwd_call`` there, for sites
whose table does not fit ``lattice_bias``'s shared memory
(``ops.deform_attn.bias_route``) or under ``ModelConfig.lattice_route=
"wide"``, and ``lattice_bias_wide_prefetch`` (csrc/
lattice_bias_wide_prefetch.cu), the counterpart of ``_fwd_call(dma=True)``,
which stages a head's table in shared memory by asynchronous copies
(``ModelConfig.bias_forward="prefetch"``). The two wide kernels are
instances of one row-walking template (csrc/bias_fwd_rows.cuh), launched by
``fwd_plan``. All three compute the same function; its plain version is
``ops.deform_attn.lattice_bias_plain``."""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from bevrender_tpu_torch.ops.kernels._launch import (
    PAD,
    SMEM_PER_BLOCK,
    call,
    check_geometry,
)
from bevrender_tpu_torch.ops.kernels.lattice_bias_bwd import pitch

# kernel launches since the last reset (ops.kernels.reset_counts)
launches = 0  # lattice_bias
launches_wide = 0  # lattice_bias_wide
launches_wide_prefetch = 0  # lattice_bias_wide_prefetch
# csrc/bias_fwd_rows.cuh: threads a block (one block holds an SM)
FWD_THREADS = 1024
FWD_WARPS = FWD_THREADS // 32
# what a warp task costs beyond its rows (its key's geometry and columns),
# in row steps, for ``fwd_plan``'s choice of strips
TASK_ROWS = 2


def _output(table, ys, H: int, W: int) -> torch.Tensor:
    G, Hpg = table.shape[:2]
    B, _, N = ys.shape
    return torch.empty((B, G, Hpg, N, H * W), dtype=torch.bfloat16,
                       device=table.device)


def lattice_bias_cuda(table, ys, ms, wy, f, u0, g, Xp: int, H: int,
                      W: int) -> torch.Tensor:
    """table (G, Hpg, 2H-1, Wt) bf16; ys, ms (B, G, N) int32 window starts
    in the zero-padded table of width ``Xp``; wy, f (B, G, N) float32;
    u0 (W,) int32, g (W,) float32 -> (B, G, Hpg, N, H*W) bf16. The
    geometry comes from ``ops.deform_attn.lattice_geometry``. A group's
    padded table must fit in shared memory (the launch fails otherwise)."""
    global launches
    check_geometry("lattice_bias_cuda", table, ys, ms, wy, f, u0, g, H, W)
    G, Hpg, Ht, Wt = table.shape
    B, _, N = ys.shape
    out = _output(table, ys, H, W)
    # about two blocks per SM over the whole launch, each loading its
    # group's table into shared memory once
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    keys_per_block = max(1, min(64, -(-B * G * N // (2 * sms))))
    call("lattice_bias", "lattice_bias_launch",
         (table, ys, ms, wy, f, u0, g, out, B, G, Hpg, Ht, Wt, Xp, N, H, W,
          keys_per_block))
    launches += 1
    return out


def lanes(W: int) -> tuple:
    """(P, K) of bias_fwd_rows.cuh's instance for W query columns: segments
    of P = 8, 16 or 32 lanes, the fewest that hold W columns at K = 2
    adjacent columns a lane (one where W <= 8). A warp walks 32 / P row
    strips at once."""
    return (8, 1) if W <= 8 else (8, 2) if W <= 16 else (
        (16, 2) if W <= 32 else (32, 2))


class FwdPlan(NamedTuple):
    """How one launch of a wide bias forward cuts the work (``fwd_plan``)."""

    path: str     # "whole": one head's padded table in shared memory;
                  # "l1": the raw table read through L1
    runs: int     # key runs of ``keys`` (b, n) keys (the last may hold fewer)
    keys: int
    strips: int   # row strips a key of ``rows`` rows (the last may hold fewer)
    rows: int
    pitch: int    # row pitch Xs of the staged table on "whole", else 0
    smem: int     # shared memory a block of FWD_THREADS, bytes
    blocks: int


@functools.lru_cache(maxsize=None)
def fwd_plan(B: int, G: int, Hpg: int, Ht: int, Wt: int, N: int, H: int,
             W: int, sms: int, prefetch: bool) -> FwdPlan:
    """The launch of ``lattice_bias_wide`` (``prefetch`` False) or
    ``lattice_bias_wide_prefetch`` (True) on a card of ``sms`` SMs. The
    prefetch kernel takes path "whole" where one head's zero-padded table,
    (Ht + 2 PAD) rows at a pitch Xs of ``pitch`` rounded up to whole 16-byte
    chunks, fits the shared memory of a block; otherwise, and always for
    ``lattice_bias_wide``, path "l1". A block holds one head and a run of
    keys; runs give at most one block an SM (a block of FWD_THREADS holds
    one), so that the grid is one wave. Of the strip counts, the one whose
    slowest warp walks the fewest row steps, a task costing its rows, one
    more x-lerped row and TASK_ROWS. Raises ValueError for W outside 1-64."""
    if not 1 <= W <= 64:
        raise ValueError(f"wide bias forward: W = {W} query columns, the "
                         f"kernels take 1 to 64")
    Xs = -(-pitch(Wt) // 8) * 8
    smem = (Ht + 2 * PAD) * Xs * 2
    whole = prefetch and smem <= SMEM_PER_BLOCK
    runs = max(1, min(B * N, sms // (G * Hpg)))
    keys = -(-B * N // runs)
    runs = -(-B * N // keys)
    seg = 32 // lanes(W)[0]

    def cost(s: int) -> tuple:  # (row steps of the slowest warp, strips, rows)
        rows = -(-H // s)
        strips = -(-H // rows)
        tasks = keys * -(-strips // seg)
        return -(-tasks // FWD_WARPS) * (rows + 1 + TASK_ROWS), strips, rows

    _, strips, rows = min(cost(s) for s in range(1, H + 1))
    return FwdPlan("whole" if whole else "l1", runs, keys, strips, rows,
                   Xs if whole else 0, smem if whole else 0, G * Hpg * runs)


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def lattice_bias_wide_cuda(table, ys, ms, wy, f, u0, g, H: int,
                           W: int) -> torch.Tensor:
    """``lattice_bias_cuda`` for a table of any size: the kernel reads the
    raw table through L1, so it takes no padded width."""
    global launches_wide
    check_geometry("lattice_bias_wide_cuda", table, ys, ms, wy, f, u0, g,
                   H, W)
    G, Hpg, Ht, Wt = table.shape
    B, _, N = ys.shape
    p = fwd_plan(B, G, Hpg, Ht, Wt, N, H, W, _sms(table.device), False)
    out = _output(table, ys, H, W)
    call("lattice_bias_wide", "lattice_bias_wide_launch",
         (table, ys, ms, wy, f, u0, g, out, B, G, Hpg, Ht, Wt, N, H, W,
          p.runs, p.keys, p.strips, p.rows))
    launches_wide += 1
    return out


def lattice_bias_wide_prefetch_cuda(table, ys, ms, wy, f, u0, g, H: int,
                                    W: int) -> torch.Tensor:
    """``lattice_bias_wide_cuda`` through the prefetch kernel. On path
    "whole" the launch first copies the table into scratch as a pitched
    zero-padded table (G * Hpg * (Ht + 2 PAD) * Xs bf16), which its time
    includes."""
    global launches_wide_prefetch
    check_geometry("lattice_bias_wide_prefetch_cuda", table, ys, ms, wy, f,
                   u0, g, H, W)
    G, Hpg, Ht, Wt = table.shape
    B, _, N = ys.shape
    p = fwd_plan(B, G, Hpg, Ht, Wt, N, H, W, _sms(table.device), True)
    out = _output(table, ys, H, W)
    whole = p.path == "whole"
    pitched = (torch.empty((G * Hpg * (Ht + 2 * PAD) * p.pitch,),
                           dtype=torch.bfloat16, device=table.device)
               if whole else table)
    call("lattice_bias_wide_prefetch", "lattice_bias_wide_prefetch_launch",
         (table, pitched, ys, ms, wy, f, u0, g, out, B, G, Hpg, Ht, Wt,
          p.pitch, N, H, W, int(whole), p.runs, p.keys, p.strips, p.rows))
    launches_wide_prefetch += 1
    return out

