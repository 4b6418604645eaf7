"""Configuration of the port: the fields of bevrender_tpu/config.py's
``ModelConfig`` that the render+register path reads, with the same names and
defaults, plus ``flagship_config`` and ``tiny_model_config``
(config.py:338-396 there). The window length is the input's T axis."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class ModelConfig:
    bev_shapes: Tuple[int, ...] = (56, 28, 14, 7, 14, 28, 56, 56)
    embed_dims: Tuple[int, ...] = (64, 128, 256, 512, 256, 128, 64, 64)
    n_stages: int = 7
    depths: Tuple[int, ...] = (2, 2, 2, 2, 2, 2, 2)
    n_heads: Tuple[int, ...] = (2, 4, 8, 16, 8, 4, 2)
    strides: Tuple[int, ...] = (8, 4, 2, 1, 2, 4, 8)
    n_groups: Tuple[int, ...] = (1, 2, 4, 8, 4, 2, 1)
    kernel_sizes: Tuple[int, ...] = (9, 7, 5, 3, 5, 7, 9)
    expansion: int = 4
    bev_depth_dim: int = 5
    scale_offset_range: bool = True
    drop_path_rate: float = 0.2
    backbone: str = "ResNet18"  # ResNet18 | PatchProjection
    decoder_hid_dim: int = 64
    num_views: int = 3
    dtype: str = "float32"  # compute dtype of conv/dense; params stay f32

    bev_bound: Dict[str, float] = field(
        default_factory=lambda: {"X": 25.2, "Y": 25.2, "Z": 2.5}
    )
    sample_z_shift: float = -1.0
    img_height: int = 224
    img_width: int = 224
    ori_img_height: int = 512
    ori_img_width: int = 640
    imu_to_rgb: Optional[Dict[int, List[Any]]] = None
    intrinsic_k: Optional[Dict[int, List[Any]]] = None

    norm: str = "batch"


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)


def flagship_config(**overrides) -> Config:
    """Uniform BEV 28 x 28 at width 64 (bevrender_tpu/config.py:338-369)."""
    cfg = Config()
    cfg.model = ModelConfig(
        bev_shapes=(28,) * 8,
        embed_dims=(64,) * 8,
        n_stages=7,
        depths=(2,) * 7,
        n_heads=(2, 4, 8, 16, 8, 4, 2),
        strides=(8, 4, 2, 1, 2, 4, 8),
        n_groups=(1, 2, 4, 8, 4, 2, 1),
        kernel_sizes=(9, 7, 5, 3, 5, 7, 9),
        backbone="ResNet18",
        img_height=224,
        img_width=224,
        ori_img_height=512,
        ori_img_width=640,
    )
    for k, v in overrides.items():
        if not hasattr(cfg.model, k):
            raise TypeError(f"flagship_config: unknown field {k!r}")
        setattr(cfg.model, k, v)
    return cfg


def tiny_model_config(**overrides) -> ModelConfig:
    """2 stages, BEV 8 x 8 at width 8, 2 views (config.py:372-396)."""
    base = dict(
        bev_shapes=(8, 8, 8),
        embed_dims=(8, 8, 8),
        n_stages=2,
        depths=(1, 1),
        n_heads=(2, 2),
        strides=(2, 2),
        n_groups=(1, 1),
        kernel_sizes=(3, 3),
        expansion=2,
        bev_depth_dim=2,
        num_views=2,
        img_height=32,
        img_width=32,
        ori_img_height=32,
        ori_img_width=32,
        backbone="PatchProjection",
        drop_path_rate=0.0,
        norm="batch",
    )
    base.update(overrides)
    return ModelConfig(**base)
