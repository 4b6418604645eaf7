"""Configuration of the port: the fields of bevrender_tpu/config.py's
``ModelConfig`` that the ported paths read and its ``TrainConfig``, with the
same names and defaults, plus ``flagship_config`` and ``tiny_model_config``
(config.py:338-396 there), and the port's own kernel choices
(``ModelConfig.lattice_route``, ``site_prefetch``, ``bias_forward``,
``site_fold_heads``, ``site_fold_rows``;
``TrainConfig.fused_bwd``, ``site_remat``, ``fused_fwd_fold``). The window
length is the input's T axis."""

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
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
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

    norm: str = "batch"  # batch | group (AdaptiveGroupNorm)
    # retrieval embedding: 0 flattens the render (the reference's); > 0 a
    # trained Siamese conv head of that output dimension embeds renders and
    # map tiles alike (models/retrieval.py)
    retrieval_embed_dim: int = 0
    retrieval_head_widths: Tuple[int, ...] = (32, 64, 128, 256)

    # The port's own kernel choice, in place of the JAX package's trace-time
    # environment knobs (ops.deform_attn.site_kernels). "auto": each site's
    # table shape picks the whole-table or the wide kernels; "wide": every
    # site takes the wide ones, which read the table through L1
    # (BEVRENDER_SHIFT_REPLICA=0).
    lattice_route: str = "auto"
    # a fused site on the wide route takes the prefetch kernel, which stages
    # its key tiles in shared memory by asynchronous copies
    # (BEVRENDER_SITE_DMA=1)
    site_prefetch: bool = False
    # the bias forward of every site that takes the bias: "kernel", the bias
    # kernels of the site's route; "prefetch", on the wide route their
    # variant that stages the key windows by asynchronous copies, in eval
    # and in training (BEVRENDER_BIAS_DMA=1); "windows", the JAX package's
    # windowed bias, _lattice_bias(use_kernel=True), on either route: each
    # key's window of the rearranged table cut by the lattice_windows
    # kernel, its backward a scatter-add, the corners mixed in bf16. The
    # last is the parity route of the JAX package's window kernels, slower
    # than the bias kernels, not a speed option. Fused sites are not changed
    bias_forward: str = "kernel"
    # that prefetch site serves all heads of a (b, g) cell in one block
    # where Hpg * W <= 128 (BEVRENDER_SITE_DMA=2); needs site_prefetch
    site_fold_heads: bool = False
    # so does the whole-table fused site of the "auto" route
    # (BEVRENDER_SITE_SH2=1)
    site_fold_rows: bool = False

    def site_options(self) -> dict:
        """The fields above, as ``models.attention.set_site_options``
        takes them."""
        return dict(lattice_route=self.lattice_route,
                    site_prefetch=self.site_prefetch,
                    bias_forward=self.bias_forward,
                    site_fold_heads=self.site_fold_heads,
                    site_fold_rows=self.site_fold_rows)


@dataclass
class TrainConfig:
    """Own copy of ``TrainConfig`` (bevrender_tpu/config.py:126-164), same
    names and defaults. ``data_axis`` and ``model_axis`` (mesh axis names of
    the JAX package's GSPMD sharding) are left out: nothing in the port reads
    them. ``steps_per_dispatch`` stays: the trainer accepts it and runs k
    plain steps, since the one-dispatch ``lax.scan`` it selects in the JAX
    package is a device of TPU dispatch. ``fused_bwd``, ``site_remat`` and
    ``fused_fwd_fold`` are the port's own: they replace the JAX package's
    trace-time environment knobs BEVRENDER_FUSED_BWD, BEVRENDER_SITE_REMAT
    and BEVRENDER_TRAIN_FWD_V2."""

    seed: int = 15213
    total_epochs: int = 100
    batch_size: int = 2
    k_fold: int = 5
    epoch_per_fold: int = 10
    num_workers: int = 4
    pin_memory: bool = True
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    eps: float = 1e-8
    warmup_epochs: int = 5
    grad_clip_norm: float = 1.0
    loss_type: str = "MSE"  # substring-matched, see training.trainer.select_losses
    validation_frequency: int = 1
    validation_metric: str = "LOSS"  # LOSS | RECALL
    apply_validation: bool = True
    save_ckpt: bool = True
    save_val_results: bool = False
    distributed: bool = False
    use_wandb: bool = False
    wandb_log_img_freq_train: int = 50
    wandb_log_img_freq_val: int = 20
    ckpt_dir: str = ""  # empty: <the system's temporary directory>/bevrender_ckpt
    work_dir: str = ""  # filled with ckpt_dir/<unix time>
    split_inf_set: bool = False
    inf_set_ratio: float = 0.1
    log_every_steps: int = 10
    steps_per_dispatch: int = 1
    # final-pass sites of head width <= 8 take the fused site with its fused
    # backward kernel instead of bias kernel + plain consumer
    fused_bwd: bool = False
    # "nothing": a plain-consumer site saves its inputs only and recomputes
    # bias, scores and softmax in the backward; "none": autograd keeps all
    site_remat: str = "nothing"
    # a fused_bwd site's forward folds the heads as ModelConfig.
    # site_fold_heads does (BEVRENDER_TRAIN_FWD_V2); None follows that field
    fused_fwd_fold: Optional[bool] = None


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


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
