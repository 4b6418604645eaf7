"""Wrappers of the ``fused_site`` CUDA kernel (csrc/fused_site.cu):
``fused_site_cuda``, the counterpart of bevrender_tpu/ops/pallas/
fused_attn.py::fused_site_call_sh (plain version
``ops.deform_attn.site_plain``), and ``fused_site_lse_cuda``, the instance
that also returns the logsumexp, the counterpart of ``fused_site_call_lse``
there (plain version ``ops.deform_attn.site_plain_lse``).

The kernel is an instance of the whole-table template (csrc/site_whole.cuh)
at one head a block with the head's padded table staged, launched on the
plan ``site_plan`` makes from the shapes: strips of
``fused_site_fold.wave_strip`` queries that fill whole waves of the card.
A site whose table does not fit one block takes ``fused_site_wide``
(``ops.deform_attn.site_route``); this wrapper refuses it."""

from __future__ import annotations

import functools

import torch

# HEAD_WIDTHS (4, 8) and KEY_TILE are the kernel's, read here by
# ops.deform_attn
from bevrender_tpu_torch.ops.kernels._launch import (  # noqa: F401
    HEAD_WIDTHS,
    KEY_TILE,
    PAD,
    SMEM_PER_BLOCK,
    blocks_per_sm,
    call,
    check_site_args,
    padded_width,
    sm_count,
)
from bevrender_tpu_torch.ops.kernels.fused_site_fold import (
    SitePlan,
    check_rows_aligned,
    whole_plan,
    whole_smem,
)

launches = 0  # kernel launches since the last reset (ops.kernels.reset_counts)
launches_lse = 0  # launches of the instance that writes the logsumexp
# threads of a block at most and the blocks an SM its launch bounds ask for
# (THREADS, MIN_BLOCKS in csrc/fused_site.cu): four blocks of the flagship's
# SCA share an SM
SITE_THREADS = 160
SITE_MIN_BLOCKS = 4


@functools.lru_cache(maxsize=None)
def site_plan(B: int, G: int, Hpg: int, Ht: int, Xp: int, H: int, W: int,
              ch: int, sms: int) -> SitePlan:
    """The launch of ``fused_site`` (and its logsumexp instance) at a site of
    B * G * Hpg heads on a card of ``sms`` SMs: one head a block with its
    padded table of row pitch Xp staged ("whole", ``whole_smem`` at one
    head), in strips of ``wave_strip`` queries. Raises where the table and
    the key stages overflow a block: ``site_route`` sends such a site to
    ``fused_site_wide``."""
    smem = whole_smem(1, Ht, Xp, ch)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"fused_site: a padded table of {Ht + 2 * PAD} x {Xp} and the key "
            f"stages need {smem} bytes of shared memory, over "
            f"{SMEM_PER_BLOCK}; such a site takes fused_site_wide "
            f"(ops.deform_attn.site_route)")
    return whole_plan("whole", 1, smem, B * G * Hpg, H * W, sms, SITE_THREADS,
                      SITE_MIN_BLOCKS)


def site_blocks_per_sm(plan: SitePlan, ch: int) -> int:
    """Blocks of ``fused_site`` at ``plan`` that one SM of the card holds at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    return blocks_per_sm("fused_site", "fused_site_occupancy", ch,
                         plan.threads, plan.smem)


def _launch(fn_name: str, table, ys, ms, wy, f, u0, g, Xp, q, k, v, H, W,
            scale, with_lse: bool):
    B, G, Hpg, Ht, Wt, N, ch = check_site_args(table, ys, ms, wy, f, u0, g,
                                               q, k, v, H, W)
    if Xp != padded_width(Wt):
        raise ValueError(f"fused_site: Xp = {Xp}, the starts are clipped to "
                         f"a padded width of {padded_width(Wt)}")
    check_rows_aligned("fused_site", k, v, ch)
    dev = table.device
    plan = site_plan(B, G, Hpg, Ht, Xp, H, W, ch, sm_count(dev))
    out = torch.empty((B, G, Hpg, H * W, ch), dtype=torch.float32, device=dev)
    lse = (torch.empty((B, G, Hpg, H * W), dtype=torch.float32, device=dev)
           if with_lse else None)
    call("fused_site", fn_name,
         (table, ys, ms, wy, f, u0, g, q, k, v, out)
         + ((lse,) if with_lse else ())
         + (B, G, Hpg, Ht, Wt, Xp, N, H, W, plan.strip, ch, float(scale)))
    return out, lse


def fused_site_cuda(table, ys, ms, wy, f, u0, g, Xp: int, q, k, v, H: int,
                    W: int, scale: float) -> torch.Tensor:
    """table (G, Hpg, 2H-1, Wt) bf16; geometry as ``lattice_bias_cuda``;
    q (B, G, Hpg, H*W, ch), k and v (B, G, Hpg, N, ch) bf16 with ch in
    ``HEAD_WIDTHS``, k and v on a 2 ch-byte boundary -> (B, G, Hpg, H*W,
    ch) float32."""
    global launches
    out, _ = _launch("fused_site_launch", table, ys, ms, wy, f, u0, g, Xp, q,
                     k, v, H, W, scale, False)
    launches += 1
    return out


def fused_site_lse_cuda(table, ys, ms, wy, f, u0, g, Xp: int, q, k, v,
                        H: int, W: int, scale: float):
    """``fused_site_cuda`` that also returns the softmax's logsumexp over
    the keys, (B, G, Hpg, H*W) float32 in natural-log units."""
    global launches_lse
    out = _launch("fused_site_lse_launch", table, ys, ms, wy, f, u0, g, Xp,
                  q, k, v, H, W, scale, True)
    launches_lse += 1
    return out
