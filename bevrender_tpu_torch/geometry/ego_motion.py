"""Ego-motion alignment of history BEV features (counterpart of
bevrender_tpu/geometry/ego_motion.py:30-112).

The sampling grid is built as torchvision's inverse affine (scale 1, no
shear, image-center pivot): for an output pixel ``p`` the source is
``R(theta) (p - c - t) + c``. ``F.affine_grid`` uses another convention, so
the grid is written out here. The two warps stay sequential, like the
reference's double interpolation.
"""

from __future__ import annotations

import torch

from bevrender_tpu_torch.ops.grid_sample import grid_sample_2d


def _inverse_affine_grid(angle_rad: torch.Tensor, translate: torch.Tensor,
                         h: int, w: int) -> torch.Tensor:
    """(B,) angles and (B, 2) pixel translations -> (B, h, w, 2) grid in
    [-1, 1], (x, y) order."""
    dev = angle_rad.device
    cx = (w - 1) / 2.0
    cy = (h - 1) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    cos = torch.cos(angle_rad)[:, None, None]
    sin = torch.sin(angle_rad)[:, None, None]
    tx = translate[:, 0][:, None, None]
    ty = translate[:, 1][:, None, None]
    px = gx[None] - cx - tx
    py = gy[None] - cy - ty
    sx = cos * px + sin * py + cx
    sy = -sin * px + cos * py + cy
    nx = sx / (w - 1) * 2.0 - 1.0 if w > 1 else torch.zeros_like(sx)
    ny = sy / (h - 1) * 2.0 - 1.0 if h > 1 else torch.zeros_like(sy)
    return torch.stack([nx, ny], dim=-1)


def affine_warp(bev: torch.Tensor, angle_rad: torch.Tensor,
                translate: torch.Tensor) -> torch.Tensor:
    """torchvision ``affine`` (bilinear, fill 0) on a (B, H, W, C) batch."""
    _, H, W, _ = bev.shape
    return grid_sample_2d(bev, _inverse_affine_grid(angle_rad, translate, H, W))


def project_history_bev(bev: torch.Tensor,
                        vehicle_pose: torch.Tensor) -> torch.Tensor:
    """Align the previous BEV map (B, H, W, C) to the current frame.
    ``vehicle_pose`` is (B, 2, 3): rows (x_pix, y_pix, heading) for the
    (previous, current) frames."""
    prev_rot = vehicle_pose[:, 0, 2]
    curr_rot = vehicle_pose[:, 1, 2]
    delta = vehicle_pose[:, 0, :2] - vehicle_pose[:, 1, :2]
    out = affine_warp(bev, prev_rot, delta)
    return affine_warp(out, -curr_rot, torch.zeros_like(delta))
