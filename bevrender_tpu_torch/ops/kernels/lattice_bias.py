"""Wrappers of the bias forward kernels: ``lattice_bias`` (csrc/
lattice_bias.cu), the counterpart of bevrender_tpu/ops/pallas/
lattice_bias.py::_fwd_call_sh, and ``lattice_bias_wide`` (csrc/
lattice_bias_wide.cu), the counterpart of ``_fwd_call`` there, for sites
whose table does not fit ``lattice_bias``'s shared memory
(``ops.deform_attn.bias_route``). Both compute the same function; its plain
version is ``ops.deform_attn.lattice_bias_plain``."""

from __future__ import annotations

import torch

from bevrender_tpu_torch.ops.kernels._launch import call, check_geometry

# kernel launches since the last reset (ops.kernels.reset_counts)
launches = 0  # lattice_bias
launches_wide = 0  # lattice_bias_wide


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
