"""BEV encoder (counterpart of bevrender_tpu/models/encoder.py:48-349).

One ``EncoderLayer``::

    x += depthwise3x3(x)
    x  = x + DropPath(TSA(LN(x), prev_bev))
    x  = x + DropPath(ConvMLP(LN(x)))
    x += depthwise3x3(x)
    x  = x + DropPath(SCA(LN(x), camera feats))
    x  = x + DropPath(ConvMLP(LN(x)))

with one LayerNorm shared by the four uses. The flax tree stacks a stage's
layers along a leading depth axis; here they are ``stage{s}.layers.{i}``.
The history warp runs once per pass, in ``BEVEncoder``.

Pyramid configs (the reference default, BEV 56 -> 7 -> 56 at widths 64 to
512) add, per stage, a ``transition`` to the next stage's shape and width
(encoder.py:231-247): a 1x1 conv when only the width changes, a 3x3 stride-2
conv going down, a 2x2 stride-2 transposed conv going up; an
``img_width_fix{s}`` dense layer on the image features wherever their width
differs from the stage's; and the history ``prev_bev`` only at the stages
whose BEV shape and width equal stage 0's (encoder.py:293-345).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from bevrender_tpu_torch.config import ModelConfig
from bevrender_tpu_torch.geometry.ego_motion import project_history_bev
from bevrender_tpu_torch.models.attention import (
    SCADeformableAttention,
    TSADeformableAttention,
)
from bevrender_tpu_torch.models.backbone import build_backbone
from bevrender_tpu_torch.models.layers import (
    Conv,
    ConvMLP,
    ConvTranspose,
    Dense,
    DropPath,
    LayerNorm,
    compute_dtype,
    make_norm,
)
from bevrender_tpu_torch.utils.profiling import annotation


class EncoderLayer(nn.Module):
    def __init__(self, dim: int, bev: int, bev_depth_dim: int, n_heads: int,
                 n_groups: int, stride: int, kernel_size: int, n_views: int,
                 expansion: int, scale_offset_range: bool,
                 drop_path_rate: float = 0.0, cd=None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0):
        super().__init__()
        self.layer_norm = LayerNorm(dim)
        self.drop_path = DropPath(drop_path_rate)
        self.tsa_lpu = Conv(dim, dim, 3, padding=1, groups=dim, compute_dtype=cd)
        self.temporal_self_attn = TSADeformableAttention(
            dim, n_heads, n_groups, stride, kernel_size, bev,
            scale_offset_range, cd=cd, attn_drop_rate=attn_drop_rate,
            proj_drop_rate=drop_rate)
        self.tsa_mlp = ConvMLP(dim, expansion, cd, drop_rate)
        self.sca_lpu = Conv(dim, dim, 3, padding=1, groups=dim, compute_dtype=cd)
        self.spatial_cross_attn = SCADeformableAttention(
            dim, n_heads, n_groups, bev_depth_dim, bev, n_views,
            scale_offset_range, cd=cd, attn_drop_rate=attn_drop_rate,
            proj_drop_rate=drop_rate)
        self.sca_mlp = ConvMLP(dim, expansion, cd, drop_rate)

    def forward(self, bev_query: torch.Tensor, img_feat: torch.Tensor,
                prev_bev: Optional[torch.Tensor],
                reference_points: torch.Tensor) -> torch.Tensor:
        ln, dp = self.layer_norm, self.drop_path
        x = bev_query
        x = x + self.tsa_lpu(x)
        x = dp(self.temporal_self_attn(ln(x), prev_bev)) + x
        x = dp(self.tsa_mlp(ln(x))) + x
        x = x + self.sca_lpu(x)
        x = dp(self.spatial_cross_attn(ln(x), img_feat, reference_points)) + x
        return dp(self.sca_mlp(ln(x))) + x


def _transition(dim: int, next_dim: int, bev: int, next_bev: int, cd):
    """The stage's exit to the next stage's shape and width, or None."""
    if bev == next_bev:
        return None if dim == next_dim else Conv(dim, next_dim, 1,
                                                 compute_dtype=cd)
    if bev > next_bev:
        return Conv(dim, next_dim, 3, stride=2, padding=1, compute_dtype=cd)
    return ConvTranspose(dim, next_dim)


class BEVEncoderStage(nn.Module):
    """``depth`` EncoderLayers of one stage, then its ``transition``."""

    def __init__(self, depth: int, next_dim: int, next_bev: int, **layer_kw):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(**layer_kw) for _ in range(depth))
        self.transition = _transition(layer_kw["dim"], next_dim,
                                      layer_kw["bev"], next_bev,
                                      layer_kw["cd"])

    def forward(self, x, img_feat, prev_bev, reference_points):
        for layer in self.layers:
            x = layer(x, img_feat, prev_bev, reference_points)
        return x if self.transition is None else self.transition(x)


class BEVEncoder(nn.Module):
    """Backbone once per frame, the history warp once, then every stage."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        n = cfg.n_stages
        cd = compute_dtype(cfg.dtype)
        self.n_stages = n
        if cfg.backbone == "ResnetFPN":
            raise ValueError(
                "backbone ResnetFPN returns four feature maps (P2-P5) and the "
                "encoder takes one feature map, as in the JAX package "
                "(encoder.py:278-281)")
        self.img_backbone = build_backbone(
            cfg.backbone, cfg.embed_dims[0], cfg.bev_shapes[0], cfg.img_height,
            make_norm(cfg.norm), cd)
        feat_dim = self.img_backbone.out_dim
        # stages that see the history: BEV shape and width of stage 0
        self.with_history = [
            cfg.bev_shapes[s] == cfg.bev_shapes[0]
            and cfg.embed_dims[s] == cfg.embed_dims[0] for s in range(n)]
        for s in range(n):
            if cfg.embed_dims[s] != feat_dim:
                self.add_module(f"img_width_fix{s}",
                                Dense(feat_dim, cfg.embed_dims[s], cd))
            self.add_module(f"stage{s}", BEVEncoderStage(
                cfg.depths[s], next_dim=cfg.embed_dims[s + 1],
                next_bev=cfg.bev_shapes[s + 1],
                dim=cfg.embed_dims[s], bev=cfg.bev_shapes[s],
                bev_depth_dim=cfg.bev_depth_dim, n_heads=cfg.n_heads[s],
                n_groups=cfg.n_groups[s], stride=cfg.strides[s],
                kernel_size=cfg.kernel_sizes[s], n_views=cfg.num_views,
                expansion=cfg.expansion,
                scale_offset_range=cfg.scale_offset_range,
                drop_path_rate=cfg.drop_path_rate, cd=cd,
                drop_rate=cfg.drop_rate, attn_drop_rate=cfg.attn_drop_rate))

    def forward(self, bev_query: torch.Tensor, images: torch.Tensor,
                prev_bev: Optional[torch.Tensor], vehicle_pose: torch.Tensor,
                reference_points: Sequence[torch.Tensor],
                align_history: bool = True) -> torch.Tensor:
        """images (B, V, H, W, 3); vehicle_pose (B, 2, 3) (previous,
        current); reference_points: per stage (V, h2, w * depth, 2)."""
        B, V = images.shape[:2]
        with annotation("encoder.backbone"):
            feat = self.img_backbone(
                images.reshape((B * V,) + images.shape[2:]))
        img_feat = feat.reshape((B, V) + feat.shape[1:])
        if prev_bev is not None and align_history:
            prev_bev = project_history_bev(prev_bev, vehicle_pose)
        x = bev_query
        for s in range(self.n_stages):
            fix = getattr(self, f"img_width_fix{s}", None)
            with annotation(f"encoder.stage{s}"):
                x = getattr(self, f"stage{s}")(
                    x, img_feat if fix is None else fix(img_feat),
                    prev_bev if self.with_history[s] else None,
                    reference_points[s])
        return x
