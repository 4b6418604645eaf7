"""Wrapper of the ``fused_site_mma`` CUDA kernel (csrc/fused_site_mma.cu):
the whole eval site at head widths 16 and 32 (bias, scores, online softmax
and AV in one pass) on the tensor cores. Plain version
``ops.deform_attn.site_plain``; ``ops.deform_attn.fused_site`` takes it for
CPU tensors, this wrapper only launches.

The kernel replaces no TPU kernel: the JAX package fuses head widths up to 8
and runs wider heads through ``_site_xla``. A block owns one head with its
zero-padded table staged in shared memory and two stages of 64 keys; a site
whose table and stages overflow a block (``fits``) keeps the bias route
(``ops.deform_attn.site_kernels``), and this wrapper refuses it."""

from __future__ import annotations

import functools

import torch

from bevrender_tpu_torch.ops.kernels._launch import (
    PAD,
    SMEM_PER_BLOCK,
    blocks_per_sm,
    call,
    check,
    check_geometry,
    padded_width,
    sm_count,
)

launches = 0  # kernel launches since the last reset (ops.kernels.reset_counts)
HEAD_WIDTHS = (16, 32)
KEY_TILE = 64  # keys a stage (KT in csrc/fused_site_mma.cu)
MAX_WARPS = 8  # warps a block at most; each owns 16 queries
ALIGN = 16  # q, k and v start on a 16-byte boundary (cp.async, 32-bit loads)


def smem_bytes(Ht: int, Xp: int, ch: int) -> int:
    """Shared memory of a block, as csrc/fused_site_mma.cu lays it out: two
    stages of ``KEY_TILE`` keys (K and V rows of ch bf16, four words of
    geometry a key), then the head's padded table ((Ht + 2 PAD) x Xp
    bf16). At the flagship's SCA that is 72,486 bytes at ch 32, so three
    blocks share an SM."""
    stage = 2 * KEY_TILE * ch * 2 + 4 * KEY_TILE * 4
    return 2 * stage + (Ht + 2 * PAD) * Xp * 2


def fits(Ht: int, Xp: int, ch: int) -> bool:
    """Whether a site's table and key stages fit one block: the route's test
    (``ops.deform_attn.site_kernels``). Every supported site fits: the
    largest, the pyramid's SCA at BEV 56 (a 111 x 559 table, Xp 849), needs
    220,494 bytes of 232,448."""
    return smem_bytes(Ht, Xp, ch) <= SMEM_PER_BLOCK


def pairs(H: int, W: int) -> int:
    """Vertical query pairs of an H x W lattice, 8 to a warp: rows 2r and
    2r + 1 of each column (the lower one masked on an odd H's last row)."""
    return (H + 1) // 2 * W


@functools.lru_cache(maxsize=None)
def plan(heads: int, H: int, W: int, sms: int) -> int:
    """Warps a block at a site of ``heads`` heads: of 4 to ``MAX_WARPS``,
    the one whose busiest SM gets the fewest warps of work if the blocks
    are spread evenly (ceil(blocks / sms) x warps; the larger on a tie). A
    warp takes 16 queries over every key, so that is the SM's work; a block
    of warps with no query left idles beside the others."""
    tasks = -(-pairs(H, W) // 8)
    best = None
    for warps in range(4, MAX_WARPS + 1):
        blocks = heads * -(-tasks // warps)
        cost = -(-blocks // sms) * warps
        if best is None or cost <= best[0]:
            best = (cost, warps)
    return best[1]


def occupancy(ch: int, warps: int, smem: int) -> int:
    """Blocks of ``warps`` warps with ``smem`` bytes of shared memory that one
    SM of the card holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    return blocks_per_sm("fused_site_mma", "fused_site_mma_occupancy", ch,
                         warps, smem)


def fused_site_mma_cuda(table, ys, ms, wy, f, u0, g, Xp: int, q, k, v,
                        H: int, W: int, scale: float,
                        warps: int | None = None) -> torch.Tensor:
    """table (G, Hpg, 2H-1, Wt) bf16; geometry as ``lattice_bias_cuda``;
    q (B, G, Hpg, H*W, ch), k and v (B, G, Hpg, N, ch) bf16 with ch in
    ``HEAD_WIDTHS``, each on a 16-byte boundary -> (B, G, Hpg, H*W, ch)
    float32. ``warps`` overrides the plan's warps a block (for
    measurements)."""
    global launches
    ch = q.shape[-1]
    if ch not in HEAD_WIDTHS:
        raise ValueError(f"fused_site_mma takes head widths {HEAD_WIDTHS}, "
                         f"got {ch}")
    if table.dim() != 4:
        raise ValueError("fused_site_mma: table must be 4-d")
    _, _, Ht, Wt = table.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % ALIGN:
            raise ValueError(f"fused_site_mma: {name} must start on a "
                             f"{ALIGN}-byte boundary")
    if Xp != padded_width(Wt):
        raise ValueError(f"fused_site_mma: Xp = {Xp}, the starts are clipped "
                         f"to a padded width of {padded_width(Wt)}")
    smem = smem_bytes(Ht, Xp, ch)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"fused_site_mma: a padded table of {Ht + 2 * PAD} x {Xp} and "
            f"the key stages need {smem} bytes of shared memory, over "
            f"{SMEM_PER_BLOCK}; such a site takes the bias route "
            f"(ops.deform_attn.site_kernels)")
    # shapes and dtypes, then the device: CUDA tensors only
    check_geometry("fused_site_mma", table, ys, ms, wy, f, u0, g, H, W)
    G, Hpg = table.shape[:2]
    B, _, N = ys.shape
    dev = table.device
    check("q", q, torch.bfloat16, (B, G, Hpg, H * W, ch), dev)
    check("k", k, torch.bfloat16, (B, G, Hpg, N, ch), dev)
    check("v", v, torch.bfloat16, (B, G, Hpg, N, ch), dev)
    if warps is None:
        warps = plan(B * G * Hpg, H, W, sm_count(dev))
    out = torch.empty((B, G, Hpg, H * W, ch), dtype=torch.float32, device=dev)
    call("fused_site_mma", "fused_site_mma_launch",
         (table, ys, ms, wy, f, u0, g, q, k, v, out, B, G, Hpg, Ht, Wt, Xp, N,
          H, W, warps, ch, float(scale)))
    launches += 1
    return out
