"""Bilinear sampling on NHWC maps (counterpart of bevrender_tpu/ops/
grid_sample.py: ``grid_sample_2d_mm`` :97-134, ``normalized_grid`` :158-167).

``F.grid_sample(mode="bilinear", padding_mode="zeros", align_corners=True)``
computes the same function as the JAX package's hat-function matmul form:
out-of-range corners contribute zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """image (B, H, W, C); grid (B, ..., 2) in [-1, 1], ``(x, y)`` order.
    Returns (B, ..., C) in the image dtype."""
    B, H, W, C = image.shape
    batch_shape = grid.shape[:-1]
    g = grid.reshape(B, 1, -1, 2).to(image.dtype)
    out = F.grid_sample(
        image.permute(0, 3, 1, 2), g, mode="bilinear", padding_mode="zeros",
        align_corners=True,
    )  # (B, C, 1, n)
    return out[:, :, 0].permute(0, 2, 1).reshape(*batch_shape, C)


def normalized_grid(h: int, w: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """Pixel-center grid in [-1, 1] as (h, w, 2) in ``(y, x)`` order."""
    ys = torch.arange(h, dtype=dtype, device=device)
    xs = torch.arange(w, dtype=dtype, device=device)
    ys = ys / (h - 1.0) * 2.0 - 1.0 if h > 1 else torch.zeros_like(ys)
    xs = xs / (w - 1.0) * 2.0 - 1.0 if w > 1 else torch.zeros_like(xs)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gy, gx], dim=-1)
