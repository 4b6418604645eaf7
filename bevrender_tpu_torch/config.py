"""Configuration of the port: the fields of bevrender_tpu/config.py's
``ModelConfig`` that the ported paths read, its ``DataConfig`` and
``TrainConfig``, with the same names and defaults, the reference-dict and
JSON round trips of its ``Config`` (config.py:167-326 there), plus
``flagship_config`` and ``tiny_model_config`` (config.py:338-396), and the
port's own kernel choices (``ModelConfig.lattice_route``, ``site_prefetch``,
``bias_forward``, ``site_fold_heads``, ``site_fold_rows``;
``TrainConfig.fused_bwd``, ``site_remat``, ``fused_fwd_fold``). The window
length is the input's T axis."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
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
    # drop the reference points that land on gray (128, 128, 128) pixels of
    # each view's calibration PNG (geometry.projection)
    remove_ref_in_gray: bool = False
    bound_check_img_paths: Optional[List[str]] = None
    vehicle_type_code: int = 0
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

    @property
    def window_key_shape(self) -> Tuple[int, int]:
        """SCA key-plane shape at stage 0: (bev_h // 2, bev_w * depth)."""
        return self.bev_shapes[0] // 2, self.bev_shapes[0] * self.bev_depth_dim

    def site_options(self) -> dict:
        """The fields above, as ``models.attention.set_site_options``
        takes them."""
        return dict(lattice_route=self.lattice_route,
                    site_prefetch=self.site_prefetch,
                    bias_forward=self.bias_forward,
                    site_fold_heads=self.site_fold_heads,
                    site_fold_rows=self.site_fold_rows)


@dataclass
class DataConfig:
    """Own copy of ``DataConfig`` (bevrender_tpu/config.py:85-122), same
    names and defaults. ``window_timespin`` is in seconds.
    ``on_device_preprocess``: False, the host resizes, splits and normalises
    (``data.dataset``); True, the host decodes only and the device does the
    rest (``data.preprocess``); "cast", the host ships final-shaped uint8
    views and the device only scales them. ``frame_cache_mb`` caps the
    decoded-frame cache (0 turns it off). ``native_min_pixels`` has no
    effect in the port, which has one resize, the native one, at every
    frame size: it stays so that a JSON written by the JAX package loads."""

    dataset_dir: str = ""
    gps_file_path: str = ""
    rgb_img_dir: str = ""
    map_img_dir: str = ""
    overlap: bool = False
    window_timespin: float = 2.0
    window_num_imgs: int = 3
    num_views: int = 3
    resize_img: bool = True
    resize_img_height: int = 224
    resize_img_width: int = 672
    camera_norm_mean: Tuple[float, ...] = (0.485, 0.456, 0.406)
    camera_norm_std: Tuple[float, ...] = (0.229, 0.224, 0.225)
    map_norm_mean: Tuple[float, ...] = (0.485, 0.456, 0.406)
    map_norm_std: Tuple[float, ...] = (0.229, 0.224, 0.225)
    map_width: int = 10000
    map_height: int = 10000
    map_resize_scale: float = 1.0
    map_jgw_info: Tuple[float, ...] = (1.0, 0.0, 0.0, -1.0, 0.0, 10000.0)
    map_path: Optional[Dict[str, str]] = None
    map_month: Optional[str] = None
    map_tile: int = 224
    augmentation: str = "none"  # none | weak | strong
    on_device_preprocess: Any = False  # bool | "cast"
    frame_cache_mb: int = 256
    native_min_pixels: int = 100_000


@dataclass
class TrainConfig:
    """Own copy of ``TrainConfig`` (bevrender_tpu/config.py:126-164), same
    names and defaults. ``data_axis`` and ``model_axis`` (mesh axis names of
    the JAX package's GSPMD sharding) are left out: nothing in the port reads
    them. ``fused_bwd``, ``site_remat`` and
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
    # k > 1: the epoch loop groups k batches a dispatch, copies a group to
    # the device once, logs once a dispatch and sums the group's losses, as
    # the JAX package's lax.scan over k steps; on the card each sub-step is
    # one replay of a captured CUDA graph of the step (training.graph_step),
    # on the CPU a plain step. k = 1: one eager step a batch
    steps_per_dispatch: int = 1
    # final-pass sites of head width <= 8 take the fused site with its fused
    # backward kernel instead of bias kernel + plain consumer
    fused_bwd: bool = False
    # "nothing": a plain-consumer site saves its inputs only and recomputes
    # bias, scores and softmax in the backward; "dots": it also saves the
    # scores and AV products and recomputes the bias and the elementwise
    # tail; "none": autograd keeps all
    site_remat: str = "nothing"
    # a fused_bwd site's forward folds the heads as ModelConfig.
    # site_fold_heads does (BEVRENDER_TRAIN_FWD_V2); None follows that field
    fused_fwd_fold: Optional[bool] = None


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    # the reference's UPPER_CASE keys: (section, field)
    _REF_MAP = {
        "SEED": ("train", "seed"),
        "TOTAL_EPOCHS": ("train", "total_epochs"),
        "BATCH_SIZE": ("train", "batch_size"),
        "K_FOLD": ("train", "k_fold"),
        "NUM_WORKERS": ("train", "num_workers"),
        "PIN_MEMORY": ("train", "pin_memory"),
        "LEARNING_RATE": ("train", "learning_rate"),
        "WEIGHT_DECAY": ("train", "weight_decay"),
        "EPS": ("train", "eps"),
        "LOSS_TYPE": ("train", "loss_type"),
        "VALIDATION_FREQUENCY": ("train", "validation_frequency"),
        "VALIDATION_METRIC": ("train", "validation_metric"),
        "APPLY_VALIDATION": ("train", "apply_validation"),
        "SAVE_CKPT": ("train", "save_ckpt"),
        "SAVE_VAL_RESULTS": ("train", "save_val_results"),
        "DISTRIBUTED_TRAINING": ("train", "distributed"),
        "USE_WANDB": ("train", "use_wandb"),
        "WANDB_LOG_IMG_FERQ_TRAIN": ("train", "wandb_log_img_freq_train"),
        "WANDB_LOG_IMG_FERQ_VAL": ("train", "wandb_log_img_freq_val"),
        "CKPT_DIR": ("train", "ckpt_dir"),
        "WORK_DIR": ("train", "work_dir"),
        "SPLIT_INF_SET": ("train", "split_inf_set"),
        "INF_SET_RATIO": ("train", "inf_set_ratio"),
        "DATASET_DIR": ("data", "dataset_dir"),
        "GPS_FILE_PATH": ("data", "gps_file_path"),
        "RGB_IMG_DIR": ("data", "rgb_img_dir"),
        "MAP_IMG_DIR": ("data", "map_img_dir"),
        "OVERLAP": ("data", "overlap"),
        "WINDOW_TIMESPIN": ("data", "window_timespin"),
        "WINDOW_NUM_IMGS": ("data", "window_num_imgs"),
        "NUM_VIEWS": ("data", "num_views"),
        "RESIZE_IMG": ("data", "resize_img"),
        "RESIZE_IMG_HEIGHT": ("data", "resize_img_height"),
        "RESIZE_IMG_WIDTH": ("data", "resize_img_width"),
        "CAMERA_NORM_MEAN": ("data", "camera_norm_mean"),
        "CAMERA_NORM_STD": ("data", "camera_norm_std"),
        "MAP_NORM_MEAN": ("data", "map_norm_mean"),
        "MAP_NORM_STD": ("data", "map_norm_std"),
        "MAP_WIDTH": ("data", "map_width"),
        "MAP_HEIGHT": ("data", "map_height"),
        "MAP_RESIZE_SCALE": ("data", "map_resize_scale"),
        "MAP_JGW_INFO": ("data", "map_jgw_info"),
        "MAP_PATH": ("data", "map_path"),
        "MAP_MONTH": ("data", "map_month"),
        "VEHICLE_TYPE_CODE": ("model", "vehicle_type_code"),
        "IMU_TO_RGB": ("model", "imu_to_rgb"),
        "INTRINSIC_K": ("model", "intrinsic_k"),
        "IMG_HEIGHT": ("model", "img_height"),
        "IMG_WIDTH": ("model", "img_width"),
        "ORI_IMG_HEIGHT": ("model", "ori_img_height"),
        "ORI_IMG_WIDTH": ("model", "ori_img_width"),
        "REMOVE_REF_IN_GRAY": ("model", "remove_ref_in_gray"),
        "BOUND_CHECK_IMG_PATH": ("model", "bound_check_img_paths"),
        "BEV_BOUND": ("model", "bev_bound"),
        "SAMPLE_Z_SHIFT": ("model", "sample_z_shift"),
        "DAT_BEV_SHAPE": ("model", "bev_shapes"),
        "DAT_EMBED_DIMS": ("model", "embed_dims"),
        "DAT_NUM_STAGES": ("model", "n_stages"),
        "DAT_VIT_DEPTHS": ("model", "depths"),
        "DAT_NUM_HEADS": ("model", "n_heads"),
        "DAT_STRIDES": ("model", "strides"),
        "DAT_NUM_GROUPS": ("model", "n_groups"),
        "DAT_K_SIZES": ("model", "kernel_sizes"),
        "DAT_EXPANSION": ("model", "expansion"),
        "DAT_BEV_DEPTH_DIM": ("model", "bev_depth_dim"),
        "DAT_SCALE_OFFSET_RANGE": ("model", "scale_offset_range"),
        "DAT_DROP_RATE": ("model", "drop_rate"),
        "DAT_ATTN_DROP_RATE": ("model", "attn_drop_rate"),
        "DAT_DROP_PATH_RATE": ("model", "drop_path_rate"),
        "DAT_BACKBONE_TYPE": ("model", "backbone"),
        "DECODER_HID_DIM": ("model", "decoder_hid_dim"),
        "DATA_TYPE": ("model", "dtype"),
    }

    def to_reference_dict(self) -> Dict[str, Any]:
        """The reference's flat UPPER_CASE dict (tuples as lists)."""
        out: Dict[str, Any] = {}
        for key, (section, name) in self._REF_MAP.items():
            value = getattr(getattr(self, section), name)
            out[key] = list(value) if isinstance(value, tuple) else value
        return out

    @classmethod
    def from_reference_dict(cls, ref: Dict[str, Any]) -> "Config":
        """Inverse of ``to_reference_dict``; unknown keys are ignored."""
        cfg = cls()
        for key, value in ref.items():
            if key in cls._REF_MAP:
                section, name = cls._REF_MAP[key]
                _set(getattr(cfg, section), name, value)
        return cfg

    def print_config(self, num_char: int = 100) -> str:
        """Print the reference dict between rules and return the text."""
        lines = ["=" * num_char, "Configuration:", "=" * num_char]
        for key, value in self.to_reference_dict().items():
            if isinstance(value, dict):
                lines.append(f"{key}:")
                lines.extend(f"\t{k}\t{v}" for k, v in value.items())
            else:
                lines.append(f"{key}\t{value}")
        lines.append("=" * num_char)
        text = "\n".join(lines)
        print(text, flush=True)
        return text

    def save_config_given_dir(self, dirname: str) -> None:
        """Write ``<dirname>/config.yaml``, the reference's pseudo-YAML."""
        with open(Path(dirname) / "config.yaml", "w") as f:
            for key, value in self.to_reference_dict().items():
                if isinstance(value, dict):
                    f.write(f"{key}:\n")
                    for k, v in value.items():
                        f.write(f"\t{k}\t{v}\n")
                else:
                    f.write(f"{key}:\t{value}\n")
                f.write("\n")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        """Load ``to_json`` output, the port's or the JAX package's: keys
        that a section does not have (the JAX package's ``use_pallas``,
        ``attn_chunk``, ``data_axis`` ...) are ignored."""
        raw = json.loads(text)
        cfg = cls()
        for section in ("model", "data", "train"):
            obj = getattr(cfg, section)
            for k, v in raw.get(section, {}).items():
                if hasattr(obj, k):
                    _set(obj, k, v)
        return cfg


def _set(section, name: str, value) -> None:
    """Set a field, giving a list the tuple type of a tuple field."""
    if isinstance(getattr(section, name), tuple) and isinstance(value, list):
        value = tuple(value)
    setattr(section, name, value)


def get_config(print_or_not: bool = False,
               save_or_not: bool = False) -> Dict[str, Any]:
    """The reference API's entry (bevrender_tpu/config.py:328): the
    reference dict of ``Config()``, printed when ``print_or_not``;
    ``save_or_not`` is accepted and, as there, does nothing."""
    cfg = Config()
    if print_or_not:
        cfg.print_config()
    return cfg.to_reference_dict()


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
    cfg.data.window_num_imgs = 3
    # an override goes to every section that has the field (num_views is
    # in model and data), as there
    for k, v in overrides.items():
        sections = [s for s in (cfg.model, cfg.data, cfg.train)
                    if hasattr(s, k)]
        if not sections:
            raise TypeError(f"flagship_config: unknown field {k!r}")
        for s in sections:
            setattr(s, k, v)
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
