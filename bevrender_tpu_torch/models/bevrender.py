"""Top-level BEVRender model (counterpart of
bevrender_tpu/models/bevrender.py:36-313).

``BEVRenderNet``: a learned BEV query, T-1 history encoder passes under
``torch.no_grad()`` with eval semantics (frame 0 has no history), the final
pass on the current frame, and the render decoder. Public layout is NHWC:
images (B, T, V, H, W, 3) in, render (B, 224, 224, 3) out. The per-stage
voxel->camera reference points are computed once with numpy and kept as
buffers (not in the state_dict).

Streaming serving carries the BEV state from frame to frame instead:
``encode_step`` runs one encoder pass on a frame with the carried BEV, and
``decode`` renders a BEV. ``embed`` is the retrieval embedding of renders
and map tiles: the flatten, or the trained head
(``ModelConfig.retrieval_embed_dim > 0``).
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
from bevrender_tpu_torch.models.retrieval import RetrievalHead
from bevrender_tpu_torch.utils.profiling import annotation


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
            remove_ref_in_gray=cfg.remove_ref_in_gray,
            bound_check_img_paths=cfg.bound_check_img_paths,
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
        if cfg.retrieval_embed_dim > 0:
            self.retrieval_head = RetrievalHead(cfg.retrieval_embed_dim,
                                                cfg.retrieval_head_widths)
        for s, rp in enumerate(reference_points(cfg)):
            self.register_buffer(f"ref_points{s}", torch.from_numpy(rp),
                                 persistent=False)

    def _bev_query(self, batch: int, dtype: torch.dtype) -> torch.Tensor:
        H0 = self.cfg.bev_shapes[0]
        return self.bev_embedding.reshape(1, H0, H0, -1).expand(
            batch, -1, -1, -1).to(dtype)

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
        bev_query = self._bev_query(B, images.dtype)
        ref_pts = self._ref_pts(vehicle_type)

        prev_bev = None
        with torch.no_grad():
            for t in range(T - 1):
                prev_bev = self._history_pass(
                    bev_query, images[:, t], prev_bev,
                    vehicle_pose[:, t:t + 2], ref_pts)

        if T == 1:
            pose_pair = torch.cat([vehicle_pose, vehicle_pose], dim=1)
        else:
            pose_pair = vehicle_pose[:, T - 2:T]
        bev = self.encoder(bev_query, images[:, -1], prev_bev, pose_pair,
                           ref_pts, align_history=not self.training)
        return self.decode(bev)

    def _history_pass(self, bev_query: torch.Tensor, frame: torch.Tensor,
                      prev_bev, pose_pair: torch.Tensor,
                      ref_pts: list) -> torch.Tensor:
        """One encoder pass in eval semantics with the history warp: a
        history pass of ``forward`` and a step of ``encode_step``."""
        was_training = self.training
        self.eval()
        try:
            return self.encoder(bev_query, frame, prev_bev, pose_pair, ref_pts,
                                align_history=True)
        finally:
            self.train(was_training)

    def encode_step(self, frame: torch.Tensor, prev_bev, pose_pair: torch.Tensor,
                    vehicle_type: torch.Tensor) -> torch.Tensor:
        """One encoder pass of streaming serving (bevrender.py:159-172):
        frame (B, V, H, W, 3), the carried BEV (or None on the first frame),
        pose_pair (B, 2, 3) (previous, current) -> the BEV (B, h, w, C)."""
        return self._history_pass(
            self._bev_query(frame.shape[0], frame.dtype), frame, prev_bev,
            pose_pair, self._ref_pts(vehicle_type))

    def decode(self, bev: torch.Tensor) -> torch.Tensor:
        """The render of a BEV (bevrender.py:174-175), in the span
        ``model.decoder``."""
        with annotation("model.decoder"):
            return self.decoder(bev)

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """Retrieval embedding of renders or map tiles (bevrender.py:
        177-189): the flattened images with ``retrieval_embed_dim`` 0 (not
        normalised), else the head's unit vectors in float32."""
        if self.cfg.retrieval_embed_dim <= 0:
            return images.reshape(images.shape[0], -1)
        return self.retrieval_head(images)
