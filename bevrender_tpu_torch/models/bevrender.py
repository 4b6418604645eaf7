"""Top-level BEVRender model (counterpart of
bevrender_tpu/models/bevrender.py:36-313).

``BEVRenderNet``: a learned BEV query, T-1 history encoder passes under
``torch.no_grad()`` with eval semantics (frame 0 has no history), the final
pass on the current frame, and the render decoder. Public layout is NHWC:
images (B, T, V, H, W, 3) in, render (B, 224, 224, 3) out. The per-stage
voxel->camera reference points are computed once with numpy and kept as
buffers (not in the state_dict).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from bevrender_tpu_torch.config import ModelConfig
from bevrender_tpu_torch.geometry.projection import (
    default_camera_rig,
    reference_points_all_types,
)
from bevrender_tpu_torch.models.decoder import BEVImageRenderDecoder
from bevrender_tpu_torch.models.encoder import BEVEncoder
from bevrender_tpu_torch.models.layers import compute_dtype, make_norm


def reference_points(cfg: ModelConfig) -> list:
    """Per stage (n_types, V, h2, w * depth, 2) float32, (x, y) in [-1, 1]."""
    imu_to_rgb, K = cfg.imu_to_rgb, cfg.intrinsic_k
    if imu_to_rgb is None or K is None:
        imu_to_rgb, K = default_camera_rig(
            n_views=cfg.num_views, img_width=cfg.ori_img_width,
            img_height=cfg.ori_img_height)
    types = sorted(imu_to_rgb.keys())
    return [
        reference_points_all_types(
            imu_to_rgb=imu_to_rgb, K=K, vehicle_types=types,
            bev_bound=cfg.bev_bound, bev_feat_shape=shape,
            bev_depth_dim=cfg.bev_depth_dim, z_shift=cfg.sample_z_shift,
            img_width=cfg.img_width, img_height=cfg.img_height,
            ori_img_width=cfg.ori_img_width, ori_img_height=cfg.ori_img_height,
        )
        for shape in cfg.bev_shapes[: cfg.n_stages]
    ]


class BEVRenderNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        H0 = cfg.bev_shapes[0]
        self.bev_embedding = nn.Parameter(torch.zeros(H0 * H0, cfg.embed_dims[0]))
        self.encoder = BEVEncoder(cfg)
        self.decoder = BEVImageRenderDecoder(
            cfg.bev_shapes[-1], cfg.embed_dims[-1], cfg.decoder_hid_dim,
            make_norm(cfg.norm), compute_dtype(cfg.dtype))
        for s, rp in enumerate(reference_points(cfg)):
            self.register_buffer(f"ref_points{s}", torch.from_numpy(rp),
                                 persistent=False)

    def _ref_pts(self, vehicle_type: torch.Tensor) -> list:
        # the vehicle type is constant within a batch (element [0, 0])
        vt = vehicle_type.reshape(-1)[:1].long()
        return [
            getattr(self, f"ref_points{s}").index_select(
                0, vt.to(self.bev_embedding.device))[0]
            for s in range(self.cfg.n_stages)
        ]

    def forward(self, images: torch.Tensor, vehicle_pose: torch.Tensor,
                vehicle_type: torch.Tensor) -> torch.Tensor:
        """images (B, T, V, H, W, 3); vehicle_pose (B, T, 3) rows (x_pix,
        y_pix, heading); vehicle_type (B, 1) -> render (B, 224, 224, 3)."""
        B, T = images.shape[:2]
        H0 = self.cfg.bev_shapes[0]
        bev_query = self.bev_embedding.reshape(1, H0, H0, -1).expand(
            B, -1, -1, -1).to(images.dtype)
        ref_pts = self._ref_pts(vehicle_type)

        prev_bev = None
        if T > 1:
            was_training = self.training
            self.eval()
            with torch.no_grad():
                for t in range(T - 1):
                    prev_bev = self.encoder(
                        bev_query, images[:, t], prev_bev,
                        vehicle_pose[:, t:t + 2], ref_pts, align_history=True)
            self.train(was_training)

        if T == 1:
            pose_pair = torch.cat([vehicle_pose, vehicle_pose], dim=1)
        else:
            pose_pair = vehicle_pose[:, T - 2:T]
        bev = self.encoder(bev_query, images[:, -1], prev_bev, pose_pair,
                           ref_pts, align_history=not self.training)
        return self.decoder(bev)
