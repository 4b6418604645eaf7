"""Wrapper of the ``lattice_bias_bwd`` CUDA kernel
(csrc/lattice_bias_bwd.cu), the counterpart of bevrender_tpu/ops/pallas/
lattice_bias.py::_bwd_call_sh. Its plain version is autograd through
``ops.deform_attn.lattice_bias_plain``."""

from __future__ import annotations

import torch

from bevrender_tpu_torch.ops.kernels._launch import call, check

launches = 0  # kernel launches since the last reset (ops.kernels.reset_counts)


def lattice_bias_bwd_cuda(table, ys, ms, wy, f, u0, g, Xp: int, gout, H: int,
                          W: int):
    """table and geometry as ``lattice_bias_cuda``; gout (B, G, Hpg, N, H*W)
    bf16, the cotangent of its output -> (dtable (G, Hpg, 2H-1, Wt), dwy
    (B, G, N), df (B, G, N)), all float32. Sums run through float atomics:
    their last bits vary from run to run."""
    global launches
    G, Hpg, Ht, Wt = table.shape
    B, _, N = ys.shape
    dev = table.device
    if dev.type != "cuda":
        raise ValueError("lattice_bias_bwd_cuda takes CUDA tensors")
    check("table", table, torch.bfloat16, (G, Hpg, 2 * H - 1, Wt), dev)
    for name, t, dt in (("ys", ys, torch.int32), ("ms", ms, torch.int32),
                        ("wy", wy, torch.float32), ("f", f, torch.float32)):
        check(name, t, dt, (B, G, N), dev)
    check("u0", u0, torch.int32, (W,), dev)
    check("g", g, torch.float32, (W,), dev)
    check("gout", gout, torch.bfloat16, (B, G, Hpg, N, H * W), dev)
    dtable = torch.zeros((G, Hpg, Ht, Wt), dtype=torch.float32, device=dev)
    dwy = torch.zeros((B, G, N), dtype=torch.float32, device=dev)
    df = torch.zeros((B, G, N), dtype=torch.float32, device=dev)
    # about two blocks per SM over the whole launch; each block flushes its
    # shared-memory table gradient once, so fewer, longer blocks are cheaper
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunks = max(1, min(-(-N // 8), -(-2 * sms // (B * G * Hpg))))
    keys_per_block = -(-N // chunks)
    call("lattice_bias_bwd", "lattice_bias_bwd_launch",
         (table, ys, ms, wy, f, u0, g, gout, dtable, dwy, df, B, G, Hpg, Ht,
          Wt, Xp, N, H, W, keys_per_block))
    launches += 1
    return dtable, dwy, df
