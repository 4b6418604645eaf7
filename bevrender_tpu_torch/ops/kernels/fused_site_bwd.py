"""Wrapper of the ``fused_site_bwd`` CUDA kernel (csrc/fused_site_bwd.cu),
the counterpart of bevrender_tpu/ops/pallas/fused_attn.py::site_bwd_call.
Its plain version is autograd through ``ops.deform_attn.site_plain``;
``ops.deform_attn.site_bwd_online`` repeats its roundings in PyTorch."""

from __future__ import annotations

import torch

from bevrender_tpu_torch.ops.kernels._launch import call, check
from bevrender_tpu_torch.ops.kernels.fused_site import check_site_args

launches = 0  # kernel launches since the last reset (ops.kernels.reset_counts)


def fused_site_bwd_cuda(table, ys, ms, wy, f, u0, g, Xp: int, q, k, v, dout,
                        lse, dsum, H: int, W: int, scale: float):
    """table, geometry, q, k, v as ``fused_site_cuda``; dout (B, G, Hpg,
    H*W, ch) float32, the cotangent of the site's output; lse and dsum
    (B, G, Hpg, H*W) float32, the forward's logsumexp and rowsum(dO * O)
    -> (dq, dk, dv, dtable, dwy, df), all float32. dq, dtable, dwy and df
    are summed through float atomics: their last bits vary from run to
    run."""
    global launches
    B, G, Hpg, Ht, Wt, N, ch = check_site_args(table, ys, ms, wy, f, u0, g,
                                               q, k, v, H, W)
    dev = table.device
    M = H * W
    check("dout", dout, torch.float32, (B, G, Hpg, M, ch), dev)
    check("lse", lse, torch.float32, (B, G, Hpg, M), dev)
    check("dsum", dsum, torch.float32, (B, G, Hpg, M), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dq = torch.zeros((B, G, Hpg, M, ch), **f32)
    dk = torch.empty((B, G, Hpg, N, ch), **f32)
    dv = torch.empty((B, G, Hpg, N, ch), **f32)
    dtable = torch.zeros((G, Hpg, Ht, Wt), **f32)
    dwy = torch.zeros((B, G, N), **f32)
    df = torch.zeros((B, G, N), **f32)
    call("fused_site_bwd", "fused_site_bwd_launch",
         (table, ys, ms, wy, f, u0, g, q, k, v, dout, lse, dsum, dq, dk, dv,
          dtable, dwy, df, B, G, Hpg, Ht, Wt, Xp, N, H, W, ch, float(scale)))
    launches += 1
    return dq, dk, dv, dtable, dwy, df
