"""Wrappers of the wide fused-site kernels, for narrow-head sites whose
table ``fused_site`` cannot stage in shared memory, or every site under
``ModelConfig.lattice_route="wide"`` (``ops.deform_attn.site_kernels``):

- ``fused_site_wide_cuda`` (csrc/fused_site_wide.cu), the counterpart of
  bevrender_tpu/ops/pallas/fused_attn.py::fused_site_call (the
  ``pallas_call`` of ``_fused_site_pallas_call``, plain staging): an
  instance of the whole-table template (csrc/site_whole.cuh), one head a
  block, on one of two table sources chosen by the shapes alone
  (``wide_plan``): the head's padded table staged in shared memory where it
  fits one block, the raw table read through L1 where it does not;
- ``fused_site_wide_lse_cuda``, its instance that also returns the
  logsumexp, the counterpart of ``fused_site_call_lse`` there;
- ``fused_site_wide_prefetch_cuda`` (csrc/fused_site_wide_prefetch.cu), the
  counterpart of bevrender_tpu/ops/pallas/experimental.py::
  fused_site_call_dma (``ModelConfig.site_prefetch``): the same site with
  the key tiles prefetched into shared memory by asynchronous copies. It
  takes one of two paths, by the shapes alone (``prefetch_plan``): the
  head's whole padded table in shared memory (csrc/site_whole.cuh) where it
  fits one block, each key tile's table windows in a ring where it does
  not.

They compute the function of ``fused_site`` and equal it bit for bit; the
plain versions are ``ops.deform_attn.site_plain`` and ``site_plain_lse``.
"""

from __future__ import annotations

import torch

from bevrender_tpu_torch.ops.kernels._launch import (
    KEY_TILE,
    PAD,
    SMEM_PER_BLOCK,
    blocks_per_sm,
    call,
    check_site_args,
    padded_width,
    sm_count,
    window_columns,
)
from bevrender_tpu_torch.ops.kernels.fused_site_fold import (
    SitePlan,
    check_rows_aligned,
    stages_smem,
    whole_plan,
    whole_smem,
)

# kernel launches since the last reset (ops.kernels.reset_counts)
launches = 0  # fused_site_wide
launches_lse = 0  # fused_site_wide_lse
launches_prefetch = 0  # fused_site_wide_prefetch
# queries of a ring block, THREADS in csrc/fused_site_wide_prefetch.cu
THREADS = 128
# queries of a whole-table block at most (WHOLE_THREADS there: with its
# launch bounds, four such blocks of the flagship's SCA share an SM)
WHOLE_THREADS = 160
# fused_site_wide (csrc/fused_site_wide.cu, one head a block on either table
# source): threads a block at most and the blocks an SM its launch bounds
# ask for, those of fused_site_wide_prefetch's whole-table path, whose plan
# is this kernel's (``prefetch_plan``)
WIDE_THREADS = WHOLE_THREADS
WIDE_MIN_BLOCKS = 4
WIDE_PATHS = ("whole", "raw")


def prefetch_ring(Ht: int, Wt: int, H: int, W: int, ch: int) -> tuple:
    """(R, CW, Xs, shared-memory bytes) of ``fused_site_wide_prefetch``'s
    ring: two stages of KEY_TILE keys x R rows x CW columns in bf16, plus
    the key tile's K, V and geometry, as the kernel lays them out. Raises
    where that exceeds SMEM_PER_BLOCK."""
    CW, Xs = window_columns(Wt)
    R = min(-(-(THREADS - 1) // W), H - 1) + 2
    smem = 2 * KEY_TILE * R * CW * 2 + KEY_TILE * (2 * ch + 3) * 4
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"fused_site_wide_prefetch: a ring of 2 x {KEY_TILE} keys x {R} "
            f"rows x {CW} columns needs {smem} bytes of shared memory, over "
            f"{SMEM_PER_BLOCK}; take fused_site_wide (site_prefetch=False)")
    return R, CW, Xs, smem


def prefetch_plan(Ht: int, Wt: int, H: int, W: int, ch: int, heads: int,
                  sms: int) -> tuple:
    """(path, queries a block, threads a block, shared-memory bytes) of
    ``fused_site_wide_prefetch`` at a site of ``heads`` = B * G * Hpg heads
    on a card of ``sms`` SMs, one head a block: "whole" where the head's
    zero-padded table fits one block with the two key stages, as
    ``fused_site_wide``'s plan of that path (``wide_plan``: the same
    template instance, in strips of ``wave_strip`` queries); else "ring"
    (``prefetch_ring``, which refuses a site that fits neither). A route of
    the shapes, never of a failure: every site of the supported models
    takes "whole"."""
    p = wide_plan(Ht, Wt, H, W, ch, heads, sms)
    if p.path == "whole":
        return "whole", p.strip, p.threads, p.smem
    return "ring", THREADS, THREADS, prefetch_ring(Ht, Wt, H, W, ch)[3]


def prefetch_blocks_per_sm(Ht: int, Wt: int, H: int, W: int, ch: int,
                           heads: int, sms: int) -> int:
    """Blocks of ``fused_site_wide_prefetch`` that one SM of the card holds
    at once at this site, on the path ``prefetch_plan`` takes
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    path, _, threads, smem = prefetch_plan(Ht, Wt, H, W, ch, heads, sms)
    return blocks_per_sm("fused_site_wide_prefetch",
                         "fused_site_wide_prefetch_occupancy",
                         int(path == "whole"), ch, threads, smem)


def wide_plan(Ht: int, Wt: int, H: int, W: int, ch: int, heads: int,
              sms: int, path: str | None = None) -> SitePlan:
    """The launch of ``fused_site_wide`` (and its logsumexp instance) at a
    site of ``heads`` = B * G * Hpg heads on a card of ``sms`` SMs, one head
    a block: path "whole" (the head's zero-padded table staged in shared
    memory) where it fits one block with the key stages
    (``fused_site_fold.whole_smem`` at one head: every site of the
    supported models), else "raw" (the raw table read through L1; shared
    memory the key stages alone), in strips of ``wave_strip`` queries. A
    route of the shapes, never of a failure; ``path`` names one for
    measurements."""
    whole = whole_smem(1, Ht, padded_width(Wt), ch)
    if path is None:
        path = "whole" if whole <= SMEM_PER_BLOCK else "raw"
    if path not in WIDE_PATHS:
        raise ValueError(f"fused_site_wide: no path {path!r}")
    smem = whole if path == "whole" else stages_smem(1, ch)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"fused_site_wide: a staged head table of {smem} B "
                         f"overflows a block")
    return whole_plan(path, 1, smem, heads, H * W, sms, WIDE_THREADS,
                      WIDE_MIN_BLOCKS)


def wide_blocks_per_sm(plan: SitePlan, ch: int) -> int:
    """Blocks of ``fused_site_wide`` at ``plan`` that one SM of the card
    holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    return blocks_per_sm("fused_site_wide", "fused_site_wide_occupancy",
                         int(plan.path == "raw"), ch, plan.threads, plan.smem)


def _launch(fn_name: str, table, ys, ms, wy, f, u0, g, q, k, v, H, W, scale,
            with_lse: bool, path: str | None):
    B, G, Hpg, Ht, Wt, N, ch = check_site_args(table, ys, ms, wy, f, u0, g,
                                               q, k, v, H, W)
    check_rows_aligned("fused_site_wide", k, v, ch)
    dev = table.device
    plan = wide_plan(Ht, Wt, H, W, ch, B * G * Hpg, sm_count(dev), path)
    out = torch.empty((B, G, Hpg, H * W, ch), dtype=torch.float32, device=dev)
    lse = (torch.empty((B, G, Hpg, H * W), dtype=torch.float32, device=dev)
           if with_lse else None)
    call("fused_site_wide", fn_name,
         (table, ys, ms, wy, f, u0, g, q, k, v, out)
         + ((lse,) if with_lse else ())
         + (B, G, Hpg, Ht, Wt, padded_width(Wt), N, H, W, plan.strip,
            int(plan.path == "raw"), ch, float(scale)))
    return out, lse


def fused_site_wide_cuda(table, ys, ms, wy, f, u0, g, q, k, v, H: int,
                         W: int, scale: float,
                         path: str | None = None) -> torch.Tensor:
    """Arguments as ``fused_site_cuda`` without the padded width (the
    kernel takes it from the table) -> (B, G, Hpg, H*W, ch) float32, on the
    path ``wide_plan`` names (``path`` forces one, for measurements)."""
    global launches
    out, _ = _launch("fused_site_wide_launch", table, ys, ms, wy, f, u0, g, q,
                     k, v, H, W, scale, False, path)
    launches += 1
    return out


def fused_site_wide_lse_cuda(table, ys, ms, wy, f, u0, g, q, k, v, H: int,
                             W: int, scale: float, path: str | None = None):
    """``fused_site_wide_cuda`` that also returns the logsumexp over the
    keys, (B, G, Hpg, H*W) float32 in natural-log units."""
    global launches_lse
    out = _launch("fused_site_wide_lse_launch", table, ys, ms, wy, f, u0, g,
                  q, k, v, H, W, scale, True, path)
    launches_lse += 1
    return out


def fused_site_wide_prefetch_cuda(table, ys, ms, wy, f, u0, g, q, k, v,
                                  H: int, W: int, scale: float) -> torch.Tensor:
    """``fused_site_wide_cuda`` through the prefetch kernel, on the path
    ``prefetch_plan`` names. On the ring path the launch first copies the
    table into scratch as a pitched zero-padded table (G * Hpg * (Ht + 2
    PAD) * Xs bf16), which its time includes."""
    global launches_prefetch
    B, G, Hpg, Ht, Wt, N, ch = check_site_args(table, ys, ms, wy, f, u0, g,
                                               q, k, v, H, W)
    dev = table.device
    path, S, _, _ = prefetch_plan(Ht, Wt, H, W, ch, B * G * Hpg,
                                  sm_count(dev))
    out = torch.empty((B, G, Hpg, H * W, ch), dtype=torch.float32, device=dev)
    if path == "whole":
        check_rows_aligned("fused_site_wide_prefetch", k, v, ch)
        call("fused_site_wide_prefetch",
             "fused_site_wide_prefetch_whole_launch",
             (table, ys, ms, wy, f, u0, g, q, k, v, out, B, G, Hpg, Ht, Wt,
              padded_width(Wt), N, H, W, S, ch, float(scale)))
    else:
        R, CW, Xs, _ = prefetch_ring(Ht, Wt, H, W, ch)
        pitched = torch.empty((G * Hpg * (Ht + 2 * PAD) * Xs,),
                              dtype=torch.bfloat16, device=dev)
        call("fused_site_wide_prefetch", "fused_site_wide_prefetch_launch",
             (table, pitched, ys, ms, wy, f, u0, g, q, k, v, out, B, G, Hpg,
              Ht, Wt, Xs, N, H, W, R, CW, ch, float(scale)))
    launches_prefetch += 1
    return out
