"""Wrappers of the folded fused-site kernels, whose block serves all Hpg
heads of a (b, g) cell (``ops.deform_attn.site_kernels``):

- ``fused_site_fold_rows_cuda`` (csrc/fused_site_fold_rows.cu), the
  counterpart of bevrender_tpu/ops/pallas/experimental.py::
  fused_site_call_sh2 (``ModelConfig.site_fold_rows``): ``fused_site`` with
  the heads folded;
- ``fused_site_fold_heads_cuda`` (csrc/fused_site_fold_heads.cu), the
  counterpart of ``fused_site_call_v2`` there (``ModelConfig.
  site_fold_heads``): ``fused_site_wide_prefetch`` with the heads folded;
- ``fused_site_fold_heads_lse_cuda``, its instance that also returns the
  logsumexp, the counterpart of ``fused_site_call_v2_lse`` (the forward of a
  ``fused_bwd`` training site under ``TrainConfig.fused_fwd_fold``).

They compute the function of ``fused_site`` and equal it bit for bit; the
plain versions are ``ops.deform_attn.site_plain`` and ``site_plain_lse``.
A site folds where Hpg * W <= FOLD_WIDTH (the JAX package's condition: one
query row of every head in one 128-lane block) and the kernels have an
instance for Hpg (``folds``); its shared memory must fit as well
(``rows_fit``, ``heads_fit``). The wrappers refuse any other site. The
head-folded kernels take one of two paths, by the shapes alone
(``heads_plan``): every head's whole padded table in shared memory where
they fit one block, the window ring where they do not. The row-folded
kernel is an instance of the same whole-table template
(csrc/site_whole.cuh) at ROWS_HEADS heads a block, in strips that fill
whole waves of the card (``rows_plan``, ``wave_strip``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from bevrender_tpu_torch.ops.kernels._launch import (
    KEY_TILE,
    PAD,
    SMEM_PER_BLOCK,
    SMEM_PER_BLOCK_RESERVED,
    SMEM_PER_SM,
    blocks_per_sm,
    call,
    check_site_args,
    padded_width,
    sm_count,
    window_columns,
)

# kernel launches since the last reset (ops.kernels.reset_counts)
launches_rows = 0  # fused_site_fold_rows
launches_heads = 0  # fused_site_fold_heads
launches_heads_lse = 0  # fused_site_fold_heads_lse
THREADS = 128  # queries of a ring block, THREADS in fused_site_fold_heads.cu
KEY_HALF = KEY_TILE // 2  # keys per ring slot, KH in fused_site_fold_heads.cu
# threads of a whole-table block of fused_site_fold_heads at most (Hpg x its
# strip of queries; MAX_THREADS in csrc/fused_site_fold_heads.cu)
MAX_THREADS = 256
# heads per group the kernels have instances for (every supported model has
# two)
HEADS = (1, 2)
FOLD_WIDTH = 128  # Hpg * W at most
# fused_site_fold_rows (csrc/fused_site_fold_rows.cu): heads a block, threads
# a block at most, and the blocks an SM its launch bounds ask for. One head a
# block: four blocks of the flagship's SCA share an SM, where both heads a
# block (the fold of fused_site_fold_heads) fit two (PERF.md §6)
ROWS_HEADS = 1
ROWS_THREADS = 160
ROWS_MIN_BLOCKS = 4


def folds(Hpg: int, W: int) -> bool:
    """Whether a site of ``Hpg`` heads per group on query rows of ``W``
    folds (shared memory aside)."""
    return Hpg in HEADS and Hpg * W <= FOLD_WIDTH


def rows_fit(Hpg: int, Ht: int, Xp: int, W: int, ch: int) -> bool:
    """Whether ``fused_site_fold_rows`` takes a site: it folds, and every
    head's padded table fits one block with the key stages of the
    whole-table template (``whole_smem`` at Hpg heads), as the JAX
    package's row fold holds every head's table at once. The kernel stages
    ROWS_HEADS of them a block; the fit stays the fold's. Before the
    template the kernel's own layout (the tables, every head's K and V tile
    in float32, three words a key) was the fit: ``whole_smem`` is 640 bytes
    more at two heads and either head width, so only a site within 640
    bytes of SMEM_PER_BLOCK could drop, and no site of either supported
    model is (the flagship's largest, its SCA, needs 113,228 bytes; the
    pyramid has no fused site)."""
    return folds(Hpg, W) and whole_smem(Hpg, Ht, Xp, ch) <= SMEM_PER_BLOCK


def _ring(Hpg: int, Wt: int, H: int, W: int, ch: int) -> tuple:
    CW, Xs = window_columns(Wt)
    R = min(-(-(THREADS - 1) // W), H - 1) + 2
    smem = (2 * KEY_HALF * Hpg * R * CW * 2 + 2 * Hpg * KEY_TILE * ch * 4
            + KEY_TILE * 3 * 4)
    return R, CW, Xs, smem


def heads_fit(Hpg: int, Wt: int, H: int, W: int, ch: int) -> bool:
    return folds(Hpg, W) and _ring(Hpg, Wt, H, W, ch)[3] <= SMEM_PER_BLOCK


def fold_ring(Hpg: int, Wt: int, H: int, W: int, ch: int) -> tuple:
    """(R, CW, Xs, shared-memory bytes) of ``fused_site_fold_heads``'s ring:
    two slots of KEY_HALF keys x Hpg heads x R rows x CW columns in bf16
    (a KEY_TILE tile staged in two halves), plus every head's K and V of
    the key tile and its geometry, as the kernel lays them out. Raises
    where that exceeds SMEM_PER_BLOCK."""
    R, CW, Xs, smem = _ring(Hpg, Wt, H, W, ch)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"fused_site_fold_heads: a ring of 2 x {KEY_HALF} keys x {Hpg} "
            f"heads x {R} rows x {CW} columns needs {smem} bytes of shared "
            f"memory, over {SMEM_PER_BLOCK}; take fused_site_wide_prefetch "
            f"(site_fold_heads=False)")
    return R, CW, Xs, smem


def stages_smem(Hpg: int, ch: int) -> int:
    """Shared memory of the key stages of a whole-table block
    (csrc/site_whole.cuh) of Hpg heads: two stages of every head's K and V
    rows of a key tile in bf16 with four words of geometry a key. A block
    that reads the raw table (path "raw") has no other."""
    return 2 * (2 * Hpg * KEY_TILE * ch * 2 + 4 * KEY_TILE * 4)


def whole_smem(Hpg: int, Ht: int, Xp: int, ch: int) -> int:
    """Shared memory of a whole-table block (csrc/site_whole.cuh) of Hpg
    heads: the key stages (``stages_smem``) and the Hpg zero-padded tables
    ((Ht + 2 PAD) x Xp bf16 each), as the kernel lays them out."""
    return stages_smem(Hpg, ch) + Hpg * (Ht + 2 * PAD) * Xp * 2


def strip(Hpg: int, M: int, most: int = MAX_THREADS) -> int:
    """Queries per head of a whole-table block of at most ``most`` threads:
    the fewest strips of at most most / Hpg queries that cover the M
    queries, as even as steps that keep Hpg x the strip a multiple of 32
    allow (112 for M = 784 and two heads in 256 threads: 7 strips, no idle
    thread)."""
    step = 32 // Hpg
    per = -(-M // -(-M // (most // Hpg)))
    return -(-per // step) * step


class SitePlan(NamedTuple):
    """How one launch of a whole-table site kernel cuts the work."""

    path: str     # "whole": the heads' padded tables in shared memory;
                  # "raw": the raw table read through L1
    heads: int    # heads a block
    strip: int    # queries a head of a block
    threads: int  # heads x strip
    smem: int     # shared memory a block, bytes
    blocks: int   # blocks of the grid
    per_sm: int   # blocks an SM the plan counts on (``blocks_an_sm``)
    waves: int    # rounds of per_sm blocks on every SM the grid takes


def blocks_an_sm(smem: int, min_blocks: int) -> int:
    """Blocks an SM holds at once, as the plans count them from the shapes:
    what its shared memory holds at ``smem`` bytes a block, at most the
    ``min_blocks`` that the kernel's launch bounds ask the compiler to fit
    (so its registers hold them; the card may hold more of smaller ones)."""
    return min(min_blocks, SMEM_PER_SM // (smem + SMEM_PER_BLOCK_RESERVED))


def wave_strip(heads: int, M: int, rows: int, per_sm: int, sms: int,
               most: int) -> int:
    """Queries a head of a block of ``heads`` heads and at most ``most``
    threads, for a grid of ``rows`` block rows over M queries on ``sms``
    SMs that hold ``per_sm`` blocks each: of the strips whose threads are a
    multiple of 32, evenly cut, those whose grid takes the fewest waves
    (rounds of per_sm x sms blocks), then the one whose busiest SM runs the
    fewest warps summed over the waves (a wave spreads its blocks evenly),
    then the fewest blocks. At one head a block and the flagship's SCA
    (M = 784, 96 block rows, 4 blocks an SM on 132 SMs) that is 160: 5
    strips, 480 blocks, one wave; at two heads and 24 rows, 2 blocks an SM,
    80 where ``strip`` gives 112 (240 blocks in one wave against 168, the
    busiest SM 10 warps against 14)."""
    step = 32 // heads
    slots = per_sm * sms

    def cost(S: int) -> tuple:
        blocks = -(-M // S) * rows
        load, left = 0, blocks
        while left > 0:
            wave = min(left, slots)
            load += -(-wave // sms) * (heads * S // 32)
            left -= wave
        return -(-blocks // slots), load, blocks

    fewest = -(-M // (most // heads))
    cands = {-(-(-(-M // k)) // step) * step  # ceil(M / k) up to a step
             for k in range(fewest, -(-M // step) + 1)}
    return min((S for S in cands if S * heads <= most),
               key=lambda S: (cost(S), S))


def whole_plan(path: str, heads: int, smem: int, rows: int, M: int,
               sms: int, most: int, min_blocks: int) -> SitePlan:
    """The launch of a whole-table site kernel (csrc/site_whole.cuh) of
    ``heads`` heads a block, at most ``most`` threads and ``min_blocks``
    blocks an SM asked of the compiler, with ``smem`` bytes a block, over
    ``rows`` block rows of M queries on ``sms`` SMs: strips of
    ``wave_strip`` queries."""
    per_sm = blocks_an_sm(smem, min_blocks)
    S = wave_strip(heads, M, rows, per_sm, sms, most)
    blocks = -(-M // S) * rows
    return SitePlan(path, heads, S, heads * S, smem, blocks, per_sm,
                    -(-blocks // (per_sm * sms)))


@functools.lru_cache(maxsize=None)
def rows_plan(B: int, G: int, Hpg: int, Ht: int, Xp: int, H: int, W: int,
              ch: int, sms: int) -> SitePlan:
    """The launch of ``fused_site_fold_rows`` at a site that it takes
    (``rows_fit``) on a card of ``sms`` SMs: ROWS_HEADS heads a block, the
    heads' padded tables staged ("whole"), in strips of ``wave_strip``
    queries."""
    return whole_plan("whole", ROWS_HEADS, whole_smem(ROWS_HEADS, Ht, Xp, ch),
                      B * G * Hpg // ROWS_HEADS, H * W, sms, ROWS_THREADS,
                      ROWS_MIN_BLOCKS)


def rows_blocks_per_sm(plan: SitePlan, ch: int) -> int:
    """Blocks of ``fused_site_fold_rows`` at ``plan`` that one SM of the
    card holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    return blocks_per_sm("fused_site_fold_rows",
                         "fused_site_fold_rows_occupancy", ch, plan.threads,
                         plan.smem)


def heads_plan(Hpg: int, Wt: int, H: int, W: int, ch: int) -> tuple:
    """(path, queries per head of a block, threads of a block, shared-memory
    bytes) of ``fused_site_fold_heads`` at a site that folds
    (``heads_fit``): "whole" where every head's padded table fits one block
    with the key stages (``whole_smem``), "ring" (``fold_ring``) where not.
    A route of the shapes, never of a failure: every site of the supported
    models takes "whole"."""
    smem = whole_smem(Hpg, 2 * H - 1, padded_width(Wt), ch)
    if smem <= SMEM_PER_BLOCK:
        S = strip(Hpg, H * W)
        return "whole", S, Hpg * S, smem
    return "ring", THREADS, THREADS, _ring(Hpg, Wt, H, W, ch)[3]


def heads_blocks_per_sm(Hpg: int, Wt: int, H: int, W: int, ch: int) -> int:
    """Blocks of ``fused_site_fold_heads`` that one SM of the card holds at
    once at this site, on the path ``heads_plan`` takes
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    path, _, threads, smem = heads_plan(Hpg, Wt, H, W, ch)
    return blocks_per_sm("fused_site_fold_heads",
                         "fused_site_fold_heads_occupancy",
                         int(path == "whole"), ch, Hpg, threads, smem)


def check_rows_aligned(name: str, k, v, ch: int) -> None:
    """A whole-table kernel copies a key's K and V row as one 2 ch-byte
    vector: refuse a k or v that does not start on such a boundary."""
    for arg, x in (("k", k), ("v", v)):
        if x.data_ptr() % (2 * ch):
            raise ValueError(
                f"{name}: {arg} must start on a {2 * ch}-byte boundary")


def _check_fold(name: str, Hpg: int, W: int) -> None:
    if not folds(Hpg, W):
        raise ValueError(
            f"{name}: {Hpg} heads per group on rows of {W} queries do not "
            f"fold (heads per group {HEADS}, Hpg * W <= {FOLD_WIDTH})")


def fused_site_fold_rows_cuda(table, ys, ms, wy, f, u0, g, Xp: int, q, k, v,
                              H: int, W: int, scale: float) -> torch.Tensor:
    """Arguments as ``fused_site_cuda`` -> (B, G, Hpg, H*W, ch) float32."""
    global launches_rows
    B, G, Hpg, Ht, Wt, N, ch = check_site_args(table, ys, ms, wy, f, u0, g,
                                               q, k, v, H, W)
    _check_fold("fused_site_fold_rows", Hpg, W)
    if not rows_fit(Hpg, Ht, Xp, W, ch):
        raise ValueError(
            f"fused_site_fold_rows: {Hpg} padded tables of {Ht + 2 * PAD} x "
            f"{Xp} and the key stages need {whole_smem(Hpg, Ht, Xp, ch)} "
            f"bytes of shared memory, over {SMEM_PER_BLOCK}; take fused_site "
            f"(site_fold_rows=False)")
    check_rows_aligned("fused_site_fold_rows", k, v, ch)
    plan = rows_plan(B, G, Hpg, Ht, Xp, H, W, ch, sm_count(table.device))
    out = torch.empty((B, G, Hpg, H * W, ch), dtype=torch.float32,
                      device=table.device)
    call("fused_site_fold_rows", "fused_site_fold_rows_launch",
         (table, ys, ms, wy, f, u0, g, q, k, v, out, B, G, Hpg, Ht, Wt, Xp, N,
          H, W, plan.strip, ch, float(scale)))
    launches_rows += 1
    return out


def _launch_heads(table, ys, ms, wy, f, u0, g, q, k, v, H, W, scale,
                  with_lse: bool):
    B, G, Hpg, Ht, Wt, N, ch = check_site_args(table, ys, ms, wy, f, u0, g,
                                               q, k, v, H, W)
    _check_fold("fused_site_fold_heads", Hpg, W)
    R, CW, Xs, _ = fold_ring(Hpg, Wt, H, W, ch)  # refuses what does not fit
    path, S, _, _ = heads_plan(Hpg, Wt, H, W, ch)
    dev = table.device
    out = torch.empty((B, G, Hpg, H * W, ch), dtype=torch.float32, device=dev)
    lse = (torch.empty((B, G, Hpg, H * W), dtype=torch.float32, device=dev)
           if with_lse else None)
    fn = "fused_site_fold_heads" + ("_ring" if path == "ring" else "") + (
        "_lse_launch" if with_lse else "_launch")
    if path == "whole":
        check_rows_aligned("fused_site_fold_heads", k, v, ch)
        call("fused_site_fold_heads", fn,
             (table, ys, ms, wy, f, u0, g, q, k, v, out)
             + ((lse,) if with_lse else ())
             + (B, G, Hpg, Ht, Wt, padded_width(Wt), N, H, W, S, ch,
                float(scale)))
    else:
        pitched = torch.empty((G * Hpg * (Ht + 2 * PAD) * Xs,),
                              dtype=torch.bfloat16, device=dev)
        call("fused_site_fold_heads", fn,
             (table, pitched, ys, ms, wy, f, u0, g, q, k, v, out)
             + ((lse,) if with_lse else ())
             + (B, G, Hpg, Ht, Wt, Xs, N, H, W, R, CW, ch, float(scale)))
    return out, lse


def fused_site_fold_heads_cuda(table, ys, ms, wy, f, u0, g, q, k, v, H: int,
                               W: int, scale: float) -> torch.Tensor:
    """Arguments as ``fused_site_wide_prefetch_cuda`` -> (B, G, Hpg, H*W,
    ch) float32. On the ring path (``heads_plan``) the launch first copies
    the table into scratch as a pitched zero-padded table (G * Hpg * (Ht +
    2 PAD) * Xs bf16), which its time includes."""
    global launches_heads
    out, _ = _launch_heads(table, ys, ms, wy, f, u0, g, q, k, v, H, W, scale,
                           False)
    launches_heads += 1
    return out


def fused_site_fold_heads_lse_cuda(table, ys, ms, wy, f, u0, g, q, k, v,
                                   H: int, W: int, scale: float):
    """``fused_site_fold_heads_cuda`` that also returns the logsumexp over
    the keys, (B, G, Hpg, H*W) float32 in natural-log units."""
    global launches_heads_lse
    out = _launch_heads(table, ys, ms, wy, f, u0, g, q, k, v, H, W, scale,
                        True)
    launches_heads_lse += 1
    return out
