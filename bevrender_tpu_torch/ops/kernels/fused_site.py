"""Wrappers of the ``fused_site`` CUDA kernel (csrc/fused_site.cu):
``fused_site_cuda``, the counterpart of bevrender_tpu/ops/pallas/
fused_attn.py::fused_site_call_sh (plain version
``ops.deform_attn.site_plain``), and ``fused_site_lse_cuda``, the instance
that also returns the logsumexp, the counterpart of ``fused_site_call_lse``
there (plain version ``ops.deform_attn.site_plain_lse``)."""

from __future__ import annotations

import torch

from bevrender_tpu_torch.ops.kernels._launch import call, check, check_geometry

launches = 0  # kernel launches since the last reset (ops.kernels.reset_counts)
launches_lse = 0  # launches of the instance that writes the logsumexp
HEAD_WIDTHS = (4, 8)  # the kernel's instances (csrc/fused_site.cu)
KEY_TILE = 32  # keys per online-softmax step, KT in csrc/site_common.cuh


def check_site_args(table, ys, ms, wy, f, u0, g, q, k, v, H: int, W: int):
    """Shape, dtype, device and layout checks shared by the site kernels'
    wrappers; returns (B, G, Hpg, Ht, Wt, N, ch)."""
    ch = q.shape[-1]
    if ch not in HEAD_WIDTHS:
        raise ValueError(f"fused site takes head widths {HEAD_WIDTHS}, got {ch}")
    check_geometry("the fused site kernels", table, ys, ms, wy, f, u0, g, H, W)
    G, Hpg, Ht, Wt = table.shape
    B, _, N = ys.shape
    dev = table.device
    check("q", q, torch.bfloat16, (B, G, Hpg, H * W, ch), dev)
    check("k", k, torch.bfloat16, (B, G, Hpg, N, ch), dev)
    check("v", v, torch.bfloat16, (B, G, Hpg, N, ch), dev)
    return B, G, Hpg, Ht, Wt, N, ch


def fused_site_cuda(table, ys, ms, wy, f, u0, g, Xp: int, q, k, v, H: int,
                    W: int, scale: float) -> torch.Tensor:
    """table (G, Hpg, 2H-1, Wt) bf16; geometry as ``lattice_bias_cuda``;
    q (B, G, Hpg, H*W, ch), k and v (B, G, Hpg, N, ch) bf16 with ch in
    ``HEAD_WIDTHS`` -> (B, G, Hpg, H*W, ch) float32."""
    global launches
    B, G, Hpg, Ht, Wt, N, ch = check_site_args(table, ys, ms, wy, f, u0, g,
                                               q, k, v, H, W)
    out = torch.empty((B, G, Hpg, H * W, ch), dtype=torch.float32,
                      device=table.device)
    call("fused_site", "fused_site_launch",
         (table, ys, ms, wy, f, u0, g, q, k, v, out, B, G, Hpg, Ht, Wt, Xp, N,
          H, W, ch, float(scale)))
    launches += 1
    return out


def fused_site_lse_cuda(table, ys, ms, wy, f, u0, g, Xp: int, q, k, v,
                        H: int, W: int, scale: float):
    """``fused_site_cuda`` that also returns the softmax's logsumexp over
    the keys, (B, G, Hpg, H*W) float32 in natural-log units."""
    global launches_lse
    B, G, Hpg, Ht, Wt, N, ch = check_site_args(table, ys, ms, wy, f, u0, g,
                                               q, k, v, H, W)
    dev = table.device
    out = torch.empty((B, G, Hpg, H * W, ch), dtype=torch.float32, device=dev)
    lse = torch.empty((B, G, Hpg, H * W), dtype=torch.float32, device=dev)
    call("fused_site", "fused_site_lse_launch",
         (table, ys, ms, wy, f, u0, g, q, k, v, out, lse, B, G, Hpg, Ht, Wt,
          Xp, N, H, W, ch, float(scale)))
    launches_lse += 1
    return out, lse
