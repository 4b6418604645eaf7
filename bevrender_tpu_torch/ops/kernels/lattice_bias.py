"""Wrapper of the ``lattice_bias`` CUDA kernel (csrc/lattice_bias.cu), the
counterpart of bevrender_tpu/ops/pallas/lattice_bias.py::_fwd_call_sh.
Its plain version is ``ops.deform_attn.lattice_bias_plain``."""

from __future__ import annotations

import torch

from bevrender_tpu_torch.ops.kernels._launch import call, check

launches = 0  # kernel launches since the last reset (ops.kernels.reset_counts)


def lattice_bias_cuda(table, ys, ms, wy, f, u0, g, Xp: int, H: int,
                      W: int) -> torch.Tensor:
    """table (G, Hpg, 2H-1, Wt) bf16; ys, ms (B, G, N) int32 window starts
    in the zero-padded table of width ``Xp``; wy, f (B, G, N) float32;
    u0 (W,) int32, g (W,) float32 -> (B, G, Hpg, N, H*W) bf16. The
    geometry comes from ``ops.deform_attn.lattice_geometry``. H*W must be a
    multiple of 8 (the kernel stores 8 outputs at once)."""
    global launches
    G, Hpg, Ht, Wt = table.shape
    B, _, N = ys.shape
    dev = table.device
    if (H * W) % 8:
        raise ValueError(f"lattice bias kernel takes H*W a multiple of 8, got {H * W}")
    if dev.type != "cuda":
        raise ValueError("lattice_bias_cuda takes CUDA tensors")
    check("table", table, torch.bfloat16, (G, Hpg, 2 * H - 1, Wt), dev)
    for name, t, dt in (("ys", ys, torch.int32), ("ms", ms, torch.int32),
                        ("wy", wy, torch.float32), ("f", f, torch.float32)):
        check(name, t, dt, (B, G, N), dev)
    check("u0", u0, torch.int32, (W,), dev)
    check("g", g, torch.float32, (W,), dev)
    out = torch.empty((B, G, Hpg, N, H * W), dtype=torch.bfloat16, device=dev)
    # about two blocks per SM over the whole launch, each loading its
    # group's table into shared memory once
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    keys_per_block = max(1, min(64, -(-B * G * N // (2 * sms))))
    call("lattice_bias", "lattice_bias_launch",
         (table, ys, ms, wy, f, u0, g, out, B, G, Hpg, Ht, Wt, Xp, N, H, W,
          keys_per_block))
    launches += 1
    return out
