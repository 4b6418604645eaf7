"""Camera geometry of the reference: the BEV voxel centres projected into
each view, and the ego-motion warp of the history BEV.

Written from the model's description (a synthetic rig of level cameras at
the vehicle origin, yawed over [+60, -60] degrees, 90 degree field of view
at the capture size, intrinsics rescaled to the network's input size;
points outside the input image set to pixel (0, 0) before normalisation;
the history warp as torchvision's inverse affine about the map centre).
numpy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def camera_rig(n_views: int, width: int, height: int, fov_deg: float = 90.0,
               cam_height: float = 1.8, spread_deg: float = 60.0):
    """(imu -> camera 4x4 per view, 3x4 intrinsics at the capture size)."""
    f = (width / 2.0) / np.tan(np.radians(fov_deg) / 2.0)
    k = np.array([[f, 0.0, width / 2.0, 0.0],
                  [0.0, f, height / 2.0, 0.0],
                  [0.0, 0.0, 1.0, 0.0]])
    exts = []
    for yaw in np.radians(np.linspace(spread_deg, -spread_deg, n_views)):
        t = np.eye(4)
        t[:3, :3] = np.stack([[np.sin(yaw), -np.cos(yaw), 0.0],
                              [0.0, 0.0, -1.0],
                              [np.cos(yaw), np.sin(yaw), 0.0]], axis=1)
        t[:3, 3] = [0.0, 0.0, cam_height]
        exts.append(t)
    return exts, k


def voxel_centres(bound: dict, bev: int, depth: int, z_shift: float):
    """(4, h2, bev, depth) homogeneous centres: x over (0, X] at half the
    BEV resolution, y over [-Y, Y], z over [-Z, Z] shifted by ``z_shift``."""
    xh, yh, zh = bound["X"] / bev, bound["Y"] / bev, bound["Z"] / depth
    xs = np.arange(xh, bound["X"] + xh, 2 * xh, dtype=np.float64)
    ys = np.arange(-bound["Y"] + yh, bound["Y"] + yh, 2 * yh, dtype=np.float64)
    zs = np.arange(-bound["Z"] + zh + z_shift, bound["Z"] + zh + z_shift,
                   2 * zh, dtype=np.float64)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pts = np.empty((4,) + gx.shape + (zs.shape[0],), dtype=np.float32)
    pts[0] = gx[:, :, None]
    pts[1] = gy[:, :, None]
    pts[2] = zs[None, None, :]
    pts[3] = 1.0
    return pts


def view_points(m: dict, bev: int) -> np.ndarray:
    """(V, h2, bev * depth, 2) float32 (x, y) in [-1, 1] for one stage."""
    pts = voxel_centres(m["bev_bound"], bev, m["bev_depth_dim"],
                        m["sample_z_shift"])
    _, h, w, z = pts.shape
    flat = pts.reshape(4, -1).astype(np.float64)
    iw, ih = m["img_width"], m["img_height"]
    exts, k0 = camera_rig(m["num_views"], m["ori_img_width"],
                          m["ori_img_height"])
    out = []
    for ext in exts:
        k = k0.copy()
        k[0, 0] *= iw / m["ori_img_width"]
        k[0, 2] *= iw / m["ori_img_width"]
        k[1, 1] *= ih / m["ori_img_height"]
        k[1, 2] *= ih / m["ori_img_height"]
        cam = np.linalg.inv(ext) @ flat
        p = k[:3, :3] @ cam[:3]
        p = (p / p[-1])[:2]
        pi = p.astype(np.int32)
        inside = ((pi[1] >= 0) & (pi[1] < ih - 1) & (pi[0] >= 0)
                  & (pi[0] < iw - 1))
        p = np.where(inside[None], p, 0.0)
        p[0] /= iw - 1
        p[1] /= ih - 1
        p = (p * 2.0 - 1.0).reshape(2, h, w, z).astype(np.float32)
        out.append(p.transpose(1, 2, 3, 0).reshape(h, -1, 2))
    return np.stack(out).astype(np.float32)


def sample_nhwc(img: torch.Tensor, grid_xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (n, H, W, C) at (n, ..., 2) (x, y) in [-1, 1],
    corner-aligned, zero outside: (n, ..., C)."""
    n, _, _, c = img.shape
    shape = grid_xy.shape[:-1]
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid_xy.reshape(n, 1, -1, 2),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out[:, :, 0].permute(0, 2, 1).reshape(*shape, c)


def _warp(bev: torch.Tensor, angle: torch.Tensor, shift: torch.Tensor):
    """Output pixel p reads R(angle) (p - c - shift) + c."""
    _, h, w, _ = bev.shape
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=bev.device)
    xs = torch.arange(w, dtype=torch.float32, device=bev.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    c = torch.cos(angle)[:, None, None]
    s = torch.sin(angle)[:, None, None]
    px = gx[None] - cx - shift[:, 0, None, None]
    py = gy[None] - cy - shift[:, 1, None, None]
    sx = c * px + s * py + cx
    sy = -s * px + c * py + cy
    grid = torch.stack([sx / (w - 1) * 2.0 - 1.0, sy / (h - 1) * 2.0 - 1.0], -1)
    return sample_nhwc(bev, grid)


def align_history(bev: torch.Tensor, pose_pair: torch.Tensor) -> torch.Tensor:
    """The previous BEV moved into the current frame: pose_pair (B, 2, 3),
    rows (x_pix, y_pix, heading) of the previous and current frames."""
    delta = pose_pair[:, 0, :2] - pose_pair[:, 1, :2]
    out = _warp(bev, pose_pair[:, 0, 2], delta)
    return _warp(out, -pose_pair[:, 1, 2], torch.zeros_like(delta))
