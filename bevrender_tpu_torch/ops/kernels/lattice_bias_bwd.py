"""Wrappers of the bias backward kernels: ``lattice_bias_bwd`` (csrc/
lattice_bias_bwd.cu), the counterpart of bevrender_tpu/ops/pallas/
lattice_bias.py::_bwd_call_sh, and ``lattice_bias_wide_bwd`` (csrc/
lattice_bias_wide_bwd.cu), the counterpart of ``_bwd_call`` there, for sites
whose table does not fit ``lattice_bias_bwd``'s shared memory
(``ops.deform_attn.bias_route``). Their plain version is autograd through
``ops.deform_attn.lattice_bias_plain``."""

from __future__ import annotations

import torch

from bevrender_tpu_torch.ops.kernels._launch import (
    PAD,
    SMEM_PER_BLOCK,
    call,
    check_geometry,
)

# kernel launches since the last reset (ops.kernels.reset_counts)
launches = 0  # lattice_bias_bwd
launches_wide = 0  # lattice_bias_wide_bwd


def _outputs(table, ys):
    B, G, N = ys.shape
    dev = table.device
    return (torch.zeros(table.shape, dtype=torch.float32, device=dev),
            torch.zeros((B, G, N), dtype=torch.float32, device=dev),
            torch.zeros((B, G, N), dtype=torch.float32, device=dev))


def _chunks(blocks_per_chunk: int, N: int, sms: int) -> int:
    """Key runs per (b, g, h[, band]): about two blocks per SM over the
    whole launch; each block flushes its shared-memory gradient once, so
    fewer, longer blocks are cheaper."""
    return max(1, min(-(-N // 8), -(-2 * sms // blocks_per_chunk)))


def lattice_bias_bwd_cuda(table, ys, ms, wy, f, u0, g, Xp: int, gout, H: int,
                          W: int):
    """table and geometry as ``lattice_bias_cuda``; gout (B, G, Hpg, N, H*W)
    bf16, the cotangent of its output -> (dtable (G, Hpg, 2H-1, Wt), dwy
    (B, G, N), df (B, G, N)), all float32. Sums run through float atomics:
    their last bits vary from run to run. One head's padded table and its
    gradient must fit in shared memory (the launch fails otherwise)."""
    global launches
    check_geometry("lattice_bias_bwd_cuda", table, ys, ms, wy, f, u0, g, H, W,
                   gout)
    G, Hpg, Ht, Wt = table.shape
    B, _, N = ys.shape
    dtable, dwy, df = _outputs(table, ys)
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    keys_per_block = -(-N // _chunks(B * G * Hpg, N, sms))
    call("lattice_bias_bwd", "lattice_bias_bwd_launch",
         (table, ys, ms, wy, f, u0, g, gout, dtable, dwy, df, B, G, Hpg, Ht,
          Wt, Xp, N, H, W, keys_per_block))
    launches += 1
    return dtable, dwy, df


def lattice_bias_wide_bwd_cuda(table, ys, ms, wy, f, u0, g, Xp: int, gout,
                               H: int, W: int):
    """``lattice_bias_bwd_cuda`` for a table of any size: a block keeps the
    gradient of a band of rows of the padded table (width ``Xp``) in shared
    memory, as many rows as fit, in equal bands over the padded height."""
    global launches_wide
    check_geometry("lattice_bias_wide_bwd_cuda", table, ys, ms, wy, f, u0, g,
                   H, W, gout)
    G, Hpg, Ht, Wt = table.shape
    B, _, N = ys.shape
    dtable, dwy, df = _outputs(table, ys)
    Yp = Ht + 2 * PAD
    bands = -(-Yp // (SMEM_PER_BLOCK // (4 * Xp)))
    band_rows = -(-Yp // bands)
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    keys_per_block = -(-N // _chunks(bands * B * G * Hpg, N, sms))
    call("lattice_bias_wide_bwd", "lattice_bias_wide_bwd_launch",
         (table, ys, ms, wy, f, u0, g, gout, dtable, dwy, df, B, G, Hpg, Ht,
          Wt, Xp, N, H, W, keys_per_block, band_rows))
    launches_wide += 1
    return dtable, dwy, df
