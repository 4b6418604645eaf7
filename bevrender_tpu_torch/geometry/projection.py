"""BEV voxel grid and camera projection (numpy, run once at model build).

Own copy of bevrender_tpu/geometry/projection.py (``sample_3d_points``
:26, ``BEV2CameraProjector`` :65, ``reference_points_all_types`` :174 and
``default_camera_rig`` :219), without the gray-calibration mask, which the
render+register path does not use.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def sample_3d_points(bev_bound: Dict[str, float], bev_feat_shape: int,
                     bev_depth_dim: int, z_shift: float) -> np.ndarray:
    """(4, bev // 2, bev, depth) homogeneous voxel centers: x in (0, X] at
    half resolution, y in [-Y, Y], z in [-Z, Z] + z_shift."""
    x_half = bev_bound["X"] / bev_feat_shape
    y_half = bev_bound["Y"] / bev_feat_shape
    z_half = bev_bound["Z"] / bev_depth_dim
    xs = np.arange(x_half, bev_bound["X"] + x_half, 2 * x_half, dtype=np.float64)
    ys = np.arange(-bev_bound["Y"] + y_half, bev_bound["Y"] + y_half,
                   2 * y_half, dtype=np.float64)
    zs = np.arange(-bev_bound["Z"] + z_half + z_shift,
                   bev_bound["Z"] + z_half + z_shift, 2 * z_half,
                   dtype=np.float64)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    h2, w = gx.shape
    pts = np.empty((4, h2, w, zs.shape[0]), dtype=np.float32)
    pts[0] = gx[:, :, None]
    pts[1] = gy[:, :, None]
    pts[2] = zs[None, None, :]
    pts[3] = 1.0
    return pts


def _project_views(points_3d, extrinsics, intrinsics, img_width, img_height,
                   ori_img_width, ori_img_height):
    """Per-view (2, h, w, z) normalized (x, y) pixel coordinates; points
    outside the image are zeroed before normalization."""
    _, h, w, z = points_3d.shape
    flat = points_3d.reshape(4, -1).astype(np.float64)
    sx = img_width / ori_img_width
    sy = img_height / ori_img_height
    views = []
    for ext, k in zip(extrinsics, intrinsics):
        k = np.asarray(k, dtype=np.float64).copy()
        k[0, 0] *= sx
        k[0, 2] *= sx
        k[1, 1] *= sy
        k[1, 2] *= sy
        pts_cam = np.linalg.inv(np.asarray(ext, dtype=np.float64)) @ flat
        pts_2d = k[:3, :3] @ pts_cam[:3]
        pts_2d = (pts_2d / pts_2d[-1])[:2]
        pi = pts_2d.astype(np.int32)
        mask = ((pi[1] >= 0) & (pi[1] < img_height - 1)
                & (pi[0] >= 0) & (pi[0] < img_width - 1))
        pts_2d = np.where(mask[None, :], pts_2d, 0.0)
        pts_2d[0] = pts_2d[0] / (img_width - 1)
        pts_2d[1] = pts_2d[1] / (img_height - 1)
        pts_2d = pts_2d * 2.0 - 1.0
        views.append(pts_2d.reshape(2, h, w, z).astype(np.float32))
    return views


def reference_points_all_types(
    imu_to_rgb, K, vehicle_types: Sequence[int], bev_bound, bev_feat_shape: int,
    bev_depth_dim: int, z_shift: float, img_width: int, img_height: int,
    ori_img_width: int, ori_img_height: int,
) -> np.ndarray:
    """(n_types, n_views, h2, w * depth, 2) float32 (x, y) in [-1, 1]."""
    pts3d = sample_3d_points(bev_bound, bev_feat_shape, bev_depth_dim, z_shift)
    out = []
    for vt in vehicle_types:
        views = _project_views(pts3d, imu_to_rgb[vt], K[vt], img_width,
                               img_height, ori_img_width, ori_img_height)
        out.append(np.stack(
            [v.transpose(1, 2, 3, 0).reshape(v.shape[1], -1, 2) for v in views],
            axis=0,
        ))
    return np.stack(out, axis=0).astype(np.float32)


def default_camera_rig(n_views: int = 3, img_width: int = 224,
                       img_height: int = 224, fov_deg: float = 90.0,
                       cam_height: float = 1.8, yaw_spread_deg: float = 60.0):
    """Synthetic surround rig: level cameras at the vehicle origin yawed over
    ``[+spread, -spread]``. Returns ``(imu_to_rgb, K)`` keyed by vehicle
    type 0: imu->camera 4x4s and 3x4 intrinsics at capture resolution."""
    f = (img_width / 2.0) / np.tan(np.radians(fov_deg) / 2.0)
    K = np.array([
        [f, 0.0, img_width / 2.0, 0.0],
        [0.0, f, img_height / 2.0, 0.0],
        [0.0, 0.0, 1.0, 0.0],
    ])
    extrinsics = []
    for yaw in np.radians(np.linspace(yaw_spread_deg, -yaw_spread_deg, n_views)):
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        T = np.eye(4)
        T[:3, :3] = np.stack([right, down, fwd], axis=1)
        T[:3, 3] = [0.0, 0.0, cam_height]
        extrinsics.append(T)
    return {0: extrinsics}, {0: [K.copy() for _ in range(n_views)]}
