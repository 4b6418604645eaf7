"""Wrappers of the bias forward kernels: ``lattice_bias`` (csrc/
lattice_bias.cu), the counterpart of bevrender_tpu/ops/pallas/
lattice_bias.py::_fwd_call_sh, ``lattice_bias_wide`` (csrc/
lattice_bias_wide.cu), the counterpart of ``_fwd_call`` there, for sites
whose table does not fit ``lattice_bias``'s shared memory
(``ops.deform_attn.bias_route``) or under ``ModelConfig.lattice_route=
"wide"``, and ``lattice_bias_wide_prefetch`` (csrc/
lattice_bias_wide_prefetch.cu), the counterpart of ``_fwd_call(dma=True)``,
which stages each key's window in shared memory by asynchronous copies
(``ModelConfig.bias_prefetch``). All three compute the same function; its
plain version is ``ops.deform_attn.lattice_bias_plain``."""

from __future__ import annotations

import torch

from bevrender_tpu_torch.ops.kernels._launch import (
    PAD,
    SMEM_PER_BLOCK,
    call,
    check_geometry,
    window_columns,
)

# kernel launches since the last reset (ops.kernels.reset_counts)
launches = 0  # lattice_bias
launches_wide = 0  # lattice_bias_wide
launches_wide_prefetch = 0  # lattice_bias_wide_prefetch
PREFETCH_THREADS = 256  # THREADS in csrc/lattice_bias_wide_prefetch.cu


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


def lattice_bias_wide_cuda(table, ys, ms, wy, f, u0, g, H: int,
                           W: int) -> torch.Tensor:
    """``lattice_bias_cuda`` for a table of any size: the kernel reads the
    raw table from device memory, so it takes no padded width."""
    global launches_wide
    check_geometry("lattice_bias_wide_cuda", table, ys, ms, wy, f, u0, g,
                   H, W)
    G, Hpg, Ht, Wt = table.shape
    B, _, N = ys.shape
    out = _output(table, ys, H, W)
    # 8 keys per block: a block's reads stay within a few keys' windows
    call("lattice_bias_wide", "lattice_bias_wide_launch",
         (table, ys, ms, wy, f, u0, g, out, B, G, Hpg, Ht, Wt, N, H, W, 8))
    launches_wide += 1
    return out


def bias_ring(Wt: int, H: int, W: int) -> tuple:
    """(KS, CW, Xs, shared-memory bytes) of ``lattice_bias_wide_prefetch``'s
    ring: two stages of KS keys' windows of (H + 1) rows x CW columns in
    bf16, KS the fewest keys whose outputs give each thread a vector (8
    outputs, or 1 where H * W % 8 != 0) or more, as many as fit. Raises where
    one key's window in each stage exceeds SMEM_PER_BLOCK."""
    CW, Xs = window_columns(Wt)
    key_bytes = 2 * (H + 1) * CW * 2
    if key_bytes > SMEM_PER_BLOCK:
        raise ValueError(
            f"lattice_bias_wide_prefetch: two stages of one key's window of "
            f"{H + 1} rows x {CW} columns need {key_bytes} bytes of shared "
            f"memory, over {SMEM_PER_BLOCK}; take lattice_bias_wide "
            f"(bias_prefetch=False)")
    vectors = H * W // (8 if H * W % 8 == 0 else 1)
    KS = min(-(-PREFETCH_THREADS // vectors), SMEM_PER_BLOCK // key_bytes)
    return KS, CW, Xs, KS * key_bytes


def lattice_bias_wide_prefetch_cuda(table, ys, ms, wy, f, u0, g, H: int,
                                    W: int) -> torch.Tensor:
    """``lattice_bias_wide_cuda`` through the prefetch kernel. The launch
    first copies the table into scratch as a pitched zero-padded table
    (G * Hpg * (Ht + 2 PAD) * Xs bf16), which its time includes."""
    global launches_wide_prefetch
    check_geometry("lattice_bias_wide_prefetch_cuda", table, ys, ms, wy, f,
                   u0, g, H, W)
    G, Hpg, Ht, Wt = table.shape
    B, _, N = ys.shape
    KS, CW, Xs, _ = bias_ring(Wt, H, W)
    out = _output(table, ys, H, W)
    pitched = torch.empty((G * Hpg * (Ht + 2 * PAD) * Xs,),
                          dtype=torch.bfloat16, device=table.device)
    # runs of keys for about eight blocks per SM over the whole launch, in
    # whole stages
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    stages = max(2, -(-B * G * Hpg * N // (KS * 8 * sms)))
    call("lattice_bias_wide_prefetch", "lattice_bias_wide_prefetch_launch",
         (table, pitched, ys, ms, wy, f, u0, g, out, B, G, Hpg, Ht, Wt, Xs, N,
          H, W, CW, KS, KS * stages))
    launches_wide_prefetch += 1
    return out
