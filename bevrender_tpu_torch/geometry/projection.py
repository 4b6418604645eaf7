"""BEV voxel grid and camera projection (numpy, run once at model build).

Own copy of bevrender_tpu/geometry/projection.py (``sample_3d_points``
:26, ``BEV2CameraProjector`` :65 with its gray-calibration mask
``_in_bound_mask`` :150, ``reference_points_all_types`` :174 and
``default_camera_rig`` :219): the model reads the function form
(``_project_views``), on which the reference API's class is built. The
calibration PNGs are decoded by the port's native library
(``data/native.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from bevrender_tpu_torch.data.native import decode_png


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


def _in_bound_mask(points_2d: np.ndarray, img_width: int, img_height: int,
                   gray_img_path: Optional[str] = None) -> np.ndarray:
    """Points whose int-cast pixel lies inside the image; with
    ``gray_img_path``, also not on a gray (128, 128, 128) pixel of that
    view's calibration image."""
    pts = points_2d.astype(np.int32)
    mask = ((pts[1] >= 0) & (pts[1] < img_height - 1)
            & (pts[0] >= 0) & (pts[0] < img_width - 1))
    if gray_img_path is not None:
        ref_img = decode_png(gray_img_path)  # (H, W, 3)
        pts = np.where(mask[None, :], pts, 0)
        values = ref_img[pts[1], pts[0]]
        mask = mask & ~((values == 128).sum(axis=-1) == 3)
    return mask


def _project_views(points_3d, extrinsics, intrinsics, img_width, img_height,
                   ori_img_width, ori_img_height,
                   gray_img_paths: Optional[List[str]] = None):
    """Per-view (2, h, w, z) normalized (x, y) pixel coordinates; points
    outside the image (or on the view's gray calibration pixels) are
    zeroed before normalization."""
    _, h, w, z = points_3d.shape
    flat = points_3d.reshape(4, -1).astype(np.float64)
    sx = img_width / ori_img_width
    sy = img_height / ori_img_height
    views = []
    for view, (ext, k) in enumerate(zip(extrinsics, intrinsics)):
        k = np.asarray(k, dtype=np.float64).copy()
        k[0, 0] *= sx
        k[0, 2] *= sx
        k[1, 1] *= sy
        k[1, 2] *= sy
        pts_cam = np.linalg.inv(np.asarray(ext, dtype=np.float64)) @ flat
        pts_2d = k[:3, :3] @ pts_cam[:3]
        pts_2d = (pts_2d / pts_2d[-1])[:2]
        mask = _in_bound_mask(
            pts_2d, img_width, img_height,
            gray_img_paths[view] if gray_img_paths else None)
        pts_2d = np.where(mask[None, :], pts_2d, 0.0)
        pts_2d[0] = pts_2d[0] / (img_width - 1)
        pts_2d[1] = pts_2d[1] / (img_height - 1)
        pts_2d = pts_2d * 2.0 - 1.0
        views.append(pts_2d.reshape(2, h, w, z).astype(np.float32))
    return views


class BEV2CameraProjector:
    """The reference API's projector (``BEV2CameraProjector``,
    bevrender_tpu/geometry/projection.py:65): BEV voxel centers into each
    view of one vehicle type, on ``_project_views`` and
    ``_in_bound_mask``. ``K`` holds the intrinsics rescaled to the
    post-resize image size, as there; with ``remove_ref_in_gray`` and one
    calibration PNG a view in ``bound_check_img_paths`` (decoded by the
    port's own PNG decoder), points on its gray pixels are dropped."""

    def __init__(self, imu_to_rgb, K, vehicle_type_code: int, img_width: int,
                 img_height: int, ori_img_width: int, ori_img_height: int,
                 remove_ref_in_gray: bool = False,
                 bound_check_img_paths: Optional[List[str]] = None,
                 logger=None):
        self.scale_x = img_width / ori_img_width
        self.scale_y = img_height / ori_img_height
        self.img_width, self.img_height = img_width, img_height
        self.ori_img_width, self.ori_img_height = ori_img_width, ori_img_height
        self.vehicle_type_code = vehicle_type_code
        self.remove_ref_in_gray = remove_ref_in_gray
        self.bound_check_img_paths = bound_check_img_paths
        self.logger = logger
        self.imu_to_cmr = {k: [np.asarray(m, dtype=np.float64) for m in v]
                           for k, v in imu_to_rgb.items()}
        self._K_capture = K
        self.K = {}
        for key, mats in K.items():
            scaled = []
            for m in mats:
                m = np.asarray(m, dtype=np.float64).copy()
                m[0, 0] *= self.scale_x
                m[0, 2] *= self.scale_x
                m[1, 1] *= self.scale_y
                m[1, 2] *= self.scale_y
                scaled.append(m)
            self.K[key] = scaled

    def _gray_paths(self) -> Optional[List[str]]:
        return (self.bound_check_img_paths
                if self.remove_ref_in_gray and self.bound_check_img_paths
                else None)

    def bev_grid_to_camera(self, points_3d: np.ndarray
                           ) -> Dict[int, List[np.ndarray]]:
        """``{vehicle_type_code: [per-view (2, h, w, z) arrays]}`` of
        normalized [-1, 1] (x, y) pixel coordinates of the (4, h, w, z)
        homogeneous ``points_3d``; points outside the image (or on gray
        calibration pixels) are zeroed before normalization."""
        vt = self.vehicle_type_code
        return {vt: _project_views(
            points_3d, self.imu_to_cmr[vt], self._K_capture[vt],
            self.img_width, self.img_height, self.ori_img_width,
            self.ori_img_height, self._gray_paths())}

    def _in_bound_mask(self, points_2d: np.ndarray, module: int) -> np.ndarray:
        gray = self._gray_paths()
        return _in_bound_mask(points_2d, self.img_width, self.img_height,
                              gray[module] if gray else None)


def reference_points_all_types(
    imu_to_rgb, K, vehicle_types: Sequence[int], bev_bound, bev_feat_shape: int,
    bev_depth_dim: int, z_shift: float, img_width: int, img_height: int,
    ori_img_width: int, ori_img_height: int,
    remove_ref_in_gray: bool = False,
    bound_check_img_paths: Optional[List[str]] = None,
) -> np.ndarray:
    """(n_types, n_views, h2, w * depth, 2) float32 (x, y) in [-1, 1]. With
    ``remove_ref_in_gray`` and one calibration image a view in
    ``bound_check_img_paths``, points on its gray pixels are dropped."""
    pts3d = sample_3d_points(bev_bound, bev_feat_shape, bev_depth_dim, z_shift)
    gray = (bound_check_img_paths
            if remove_ref_in_gray and bound_check_img_paths else None)
    out = []
    for vt in vehicle_types:
        views = _project_views(pts3d, imu_to_rgb[vt], K[vt], img_width,
                               img_height, ori_img_width, ori_img_height,
                               gray)
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
