"""Wrappers of the bias forward kernels: ``lattice_bias`` (csrc/
lattice_bias.cu), the counterpart of bevrender_tpu/ops/pallas/
lattice_bias.py::_fwd_call_sh, ``lattice_bias_wide`` (csrc/
lattice_bias_wide.cu), the counterpart of ``_fwd_call`` there, for sites
whose table does not fit ``lattice_bias``'s shared memory
(``ops.deform_attn.bias_route``) or under ``ModelConfig.lattice_route=
"wide"``, and ``lattice_bias_wide_prefetch`` (csrc/
lattice_bias_wide_prefetch.cu), the counterpart of ``_fwd_call(dma=True)``,
which stages a head's table in shared memory by asynchronous copies
(``ModelConfig.bias_forward="prefetch"``). The three kernels are instances
of one row-walking template (csrc/bias_fwd_rows.cuh), launched by
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
    padded_width,
)

# kernel launches since the last reset (ops.kernels.reset_counts)
launches = 0  # lattice_bias
launches_wide = 0  # lattice_bias_wide
launches_wide_prefetch = 0  # lattice_bias_wide_prefetch
# the kernels of csrc/bias_fwd_rows.cuh, by the name ``fwd_plan`` takes
FWD_KERNELS = ("lattice_bias", "lattice_bias_wide",
               "lattice_bias_wide_prefetch")
# csrc/bias_fwd_rows.cuh: threads a block (one block holds an SM)
FWD_THREADS = 1024
FWD_WARPS = FWD_THREADS // 32
# what a unit costs beyond its rows (its key's geometry and columns), in
# row steps, for ``fwd_layout``'s choice of strips
TASK_ROWS = 2
# lattice_bias stages a head's table where a block's run of keys writes at
# least STAGE_OUTPUTS outputs for each entry of the padded table it stages,
# and STAGE_MIN_OUTPUTS in all: a staging costs a round trip and two
# barriers before any output, which a short run does not repay (PERF.md §6)
STAGE_OUTPUTS = 2
STAGE_MIN_OUTPUTS = 8192


def _output(table, ys, H: int, W: int) -> torch.Tensor:
    G, Hpg = table.shape[:2]
    B, _, N = ys.shape
    return torch.empty((B, G, Hpg, N, H * W), dtype=torch.bfloat16,
                       device=table.device)


def lanes(W: int) -> tuple:
    """(P, K) of bias_fwd_rows.cuh's instance for W query columns: segments
    of P = 8, 16 or 32 lanes, the fewest that hold W columns at K = 2
    adjacent columns a lane (one where W <= 8). A warp task is 32 / P
    units, a unit a (key, strip of rows) that P lanes walk."""
    return (8, 1) if W <= 8 else (8, 2) if W <= 16 else (
        (16, 2) if W <= 32 else (32, 2))


class FwdPlan(NamedTuple):
    """How one launch of a bias forward cuts the work (``fwd_plan``)."""

    path: str     # "whole": one head's padded table in shared memory;
                  # "l1": the raw table read through L1
    runs: int     # key runs of ``keys`` (b, n) keys (the last may hold fewer)
    keys: int
    strips: int   # row strips a key of ``rows`` rows (the last may hold fewer)
    rows: int
    pitch: int    # row pitch Xs of the staged table on "whole", else 0
    smem: int     # shared memory a block of FWD_THREADS, bytes
    blocks: int


def staged_pitch(Wt: int) -> int:
    """Row pitch Xs of a staged padded head table, Wt + 8: the least that
    holds every column a window reaches (``pitch``, Wt + 6) and equals Wt
    modulo 8, so that every staged row lies at its raw row's 16-byte phase
    (bias_fwd_rows.cuh::stage_raw)."""
    return Wt + 8


def table_bytes(Ht: int, Wt: int) -> int:
    """Shared memory of a staged padded head table
    (bias_fwd_rows.cuh::smem_bytes): it may start up to 7 entries in, and
    is rounded up to 16 bytes."""
    return -(-((Ht + 2 * PAD) * staged_pitch(Wt) * 2 + 14) // 16) * 16


@functools.lru_cache(maxsize=None)
def fwd_layout(B: int, G: int, Hpg: int, Ht: int, Wt: int, N: int, H: int,
               W: int, sms: int, path: str) -> FwdPlan:
    """The launch of a bias forward on a path on a card of ``sms`` SMs
    (every kernel of FWD_KERNELS that takes the path launches alike). A block
    holds one head and a run of keys; runs give at most one block an SM (a
    block of FWD_THREADS holds one), so that the grid is one wave. A warp
    task is 32 / P units (``lanes``), a unit a (key, strip of rows) walked by
    P lanes. Of the strip counts, the one whose slowest warp walks the
    fewest row steps, a unit costing its rows, one more x-lerped row and
    TASK_ROWS. Raises ValueError for W outside 1-64, for a path other than
    "whole" and "l1", and for path "whole" where the staged table overflows
    a block."""
    if not 1 <= W <= 64:
        raise ValueError(f"bias forward: W = {W} query columns, the kernels "
                         f"take 1 to 64")
    if path not in ("whole", "l1"):
        raise ValueError(f"bias forward: no path {path!r}")
    whole = path == "whole"
    smem = table_bytes(Ht, Wt) if whole else 0
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"bias forward: a staged head table of {smem} B "
                         f"overflows a block")
    runs = max(1, min(B * N, sms // (G * Hpg)))
    keys = -(-B * N // runs)
    runs = -(-B * N // keys)
    seg = 32 // lanes(W)[0]

    def cost(s: int) -> tuple:  # (row steps of the slowest warp, strips, rows)
        rows = -(-H // s)
        strips = -(-H // rows)
        tasks = -(-keys * strips // seg)
        return -(-tasks // FWD_WARPS) * (rows + 1 + TASK_ROWS), strips, rows

    _, strips, rows = min(cost(s) for s in range(1, H + 1))
    return FwdPlan(path, runs, keys, strips, rows,
                   staged_pitch(Wt) if whole else 0, smem,
                   G * Hpg * runs)


@functools.lru_cache(maxsize=None)
def fwd_plan(B: int, G: int, Hpg: int, Ht: int, Wt: int, N: int, H: int,
             W: int, sms: int, kernel: str) -> FwdPlan:
    """The launch of ``kernel`` (one of FWD_KERNELS) on a card of ``sms``
    SMs (``fwd_layout`` of the path chosen here). A table can be staged
    where one head's zero-padded table, (Ht + 2 PAD) rows at the
    ``staged_pitch``, fits the shared memory of a block.
    ``lattice_bias_wide`` takes path "l1", ``lattice_bias_wide_prefetch``
    "whole" where the table can be staged. ``lattice_bias`` stages
    ("whole") where also a block's run of keys writes STAGE_OUTPUTS outputs
    or more for each staged entry and STAGE_MIN_OUTPUTS in all, else reads
    through L1."""
    if kernel not in FWD_KERNELS:
        raise ValueError(f"no bias forward kernel {kernel!r}")
    stageable = table_bytes(Ht, Wt) <= SMEM_PER_BLOCK
    if kernel != "lattice_bias_wide" and stageable:
        p = fwd_layout(B, G, Hpg, Ht, Wt, N, H, W, sms, "whole")
        if kernel == "lattice_bias_wide_prefetch" or p.keys * H * W >= max(
                STAGE_OUTPUTS * (Ht + 2 * PAD) * p.pitch, STAGE_MIN_OUTPUTS):
            return p
    return fwd_layout(B, G, Hpg, Ht, Wt, N, H, W, sms, "l1")


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def lattice_bias_cuda(table, ys, ms, wy, f, u0, g, Xp: int, H: int, W: int,
                      path: str | None = None) -> torch.Tensor:
    """table (G, Hpg, 2H-1, Wt) bf16; ys, ms (B, G, N) int32 window starts
    in the zero-padded table of width ``Xp`` (``padded_width(Wt)``, to
    which the starts are clipped); wy, f (B, G, N) float32; u0 (W,) int32,
    g (W,) float32 -> (B, G, Hpg, N, H*W) bf16. The geometry comes from
    ``ops.deform_attn.lattice_geometry``. One launch of ``fwd_plan``'s
    plan, or, where ``path`` is given ("whole" or "l1", for measuring the
    path the plan does not take), of ``fwd_layout``'s on that path."""
    global launches
    check_geometry("lattice_bias_cuda", table, ys, ms, wy, f, u0, g, H, W)
    G, Hpg, Ht, Wt = table.shape
    B, _, N = ys.shape
    if Xp != padded_width(Wt):
        raise ValueError(f"lattice_bias_cuda: Xp = {Xp}, the starts are "
                         f"clipped to a padded width of {padded_width(Wt)}")
    sms = _sms(table.device)
    p = (fwd_layout(B, G, Hpg, Ht, Wt, N, H, W, sms, path) if path else
         fwd_plan(B, G, Hpg, Ht, Wt, N, H, W, sms, "lattice_bias"))
    out = _output(table, ys, H, W)
    call("lattice_bias", "lattice_bias_launch",
         (table, ys, ms, wy, f, u0, g, out, B, G, Hpg, Ht, Wt, p.pitch, N, H,
          W, int(p.path == "whole"), p.runs, p.keys, p.strips, p.rows))
    launches += 1
    return out


def lattice_bias_wide_cuda(table, ys, ms, wy, f, u0, g, H: int,
                           W: int) -> torch.Tensor:
    """``lattice_bias_cuda`` for a table of any size: the kernel reads the
    raw table through L1, so it takes no padded width."""
    global launches_wide
    check_geometry("lattice_bias_wide_cuda", table, ys, ms, wy, f, u0, g,
                   H, W)
    G, Hpg, Ht, Wt = table.shape
    B, _, N = ys.shape
    p = fwd_plan(B, G, Hpg, Ht, Wt, N, H, W, _sms(table.device),
                 "lattice_bias_wide")
    out = _output(table, ys, H, W)
    call("lattice_bias_wide", "lattice_bias_wide_launch",
         (table, ys, ms, wy, f, u0, g, out, B, G, Hpg, Ht, Wt, N, H, W,
          p.runs, p.keys, p.strips, p.rows))
    launches_wide += 1
    return out


def lattice_bias_wide_prefetch_cuda(table, ys, ms, wy, f, u0, g, H: int,
                                    W: int) -> torch.Tensor:
    """``lattice_bias_wide_cuda`` through the prefetch kernel, which stages
    a head's table in shared memory on path "whole"."""
    global launches_wide_prefetch
    check_geometry("lattice_bias_wide_prefetch_cuda", table, ys, ms, wy, f,
                   u0, g, H, W)
    G, Hpg, Ht, Wt = table.shape
    B, _, N = ys.shape
    p = fwd_plan(B, G, Hpg, Ht, Wt, N, H, W, _sms(table.device),
                 "lattice_bias_wide_prefetch")
    out = _output(table, ys, H, W)
    call("lattice_bias_wide_prefetch", "lattice_bias_wide_prefetch_launch",
         (table, ys, ms, wy, f, u0, g, out, B, G, Hpg, Ht, Wt, p.pitch, N, H,
          W, int(p.path == "whole"), p.runs, p.keys, p.strips, p.rows))
    launches_wide_prefetch += 1
    return out

