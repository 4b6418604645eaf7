"""Device-side image preprocessing (counterpart of
bevrender_tpu/data/preprocess.py): resize, view split and normalisation
of raw uint8 frames on the batch's device, after the host -> device copy.

  wide uint8 (..., T, Hw, Ww, 3)
    -> resize to (resize_h, num_views * view_w)   [jax.image.resize's
       "bilinear": a triangle filter, widened by the shrink factor on an
       axis that shrinks (antialiased), plain interpolation on one that
       grows, an axis of equal size untouched]
    -> split the width into ``num_views`` views
    -> /255 and per-channel mean/std normalisation
  map uint8 (..., Hm, Wm, 3) -> /255 only

The resize builds each axis' weight matrix as ``jax.image.scale_and_
translate`` does and contracts the image with it in float64, so that no
TF32 setting of the caller's touches it (a global switch would race with
the training thread, since the stage runs in the prefetch thread):
``F.interpolate`` cannot follow it, since without antialiasing it
does not widen the filter when shrinking (133 levels away at 512 x 1920 ->
224 x 672) and with it departs when growing. Every leading axis is a batch
axis, so a stack of k batches (``TrainConfig.steps_per_dispatch``) maps
over k. These are plain PyTorch ops: in the JAX package this stage is XLA,
not a Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch



def resize_weights(in_size: int, out_size: int,
                   device=None) -> torch.Tensor:
    """(in_size, out_size) float32 weights of ``jax.image.resize``'s
    bilinear method along one axis (``compute_weight_mat`` with the
    triangle kernel, antialias on, no translation)."""
    # 1 / scale in double, then float32, as there
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32) + 0.5)
                * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)
         [:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resize_images(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """float32 (..., H, W, C) -> float32 (..., out_h, out_w, C), each axis
    of changed size contracted with its ``resize_weights`` in float64."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    x = x.double()
    if h != out_h:
        x = torch.einsum("...hwc,ho->...owc", x,
                         resize_weights(h, out_h, x.device).double())
    if w != out_w:
        x = torch.einsum("...hwc,wo->...hoc", x,
                         resize_weights(w, out_w, x.device).double())
    return x.float()


def preprocess_batch(camera_u8: torch.Tensor, map_u8: torch.Tensor, *,
                     num_views: int, resize_h: int, resize_w: int,
                     cam_mean: Sequence[float], cam_std: Sequence[float],
                     resize: bool = True) -> Dict[str, torch.Tensor]:
    """camera uint8 (..., T, Hw, Ww, 3) and map uint8 (..., Hm, Wm, 3) ->
    ``{"camera": (..., T, V, h, w // V, 3), "map": (..., Hm, Wm, 3)}``
    float32 on their device."""
    x = camera_u8.float()
    if resize:
        x = resize_images(x, resize_h, resize_w)
    h, w = x.shape[-3], x.shape[-2]
    if w % num_views:
        raise ValueError(f"width {w} not divisible by num_views={num_views}")
    views = x.reshape(*x.shape[:-2], num_views, w // num_views, 3)
    views = views.movedim(-3, -4)  # (..., T, V, h, vw, 3)
    mean = torch.tensor(cam_mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(cam_std, dtype=torch.float32, device=x.device)
    camera = (views / 255.0 - mean) / std
    return {"camera": camera, "map": map_u8.float() * (1.0 / 255.0)}


def cast_uint8_batch(camera_u8: torch.Tensor, map_u8: torch.Tensor):
    """uint8 -> float32 / 255 with shapes unchanged, for datasets that
    already emit final-shaped views."""
    return camera_u8.float() * (1.0 / 255.0), map_u8.float() * (1.0 / 255.0)


def make_cast_preprocessor():
    """``DataConfig.on_device_preprocess = "cast"``: the uint8 camera and
    map of a device batch to float, other keys passed through."""

    def apply(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = dict(batch)
        out["camera"], out["map"] = cast_uint8_batch(batch["camera"],
                                                     batch["map"])
        return out

    return apply


def make_batch_preprocessor(data_cfg):
    """``preprocess_batch`` bound to a ``DataConfig``: a device batch with
    uint8 ``camera`` and ``map`` to the float batch the train step takes
    (other keys passed through)."""

    def apply(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = dict(batch)
        out.update(preprocess_batch(
            batch["camera"], batch["map"], num_views=data_cfg.num_views,
            resize_h=data_cfg.resize_img_height,
            resize_w=data_cfg.resize_img_width,
            cam_mean=tuple(data_cfg.camera_norm_mean),
            cam_std=tuple(data_cfg.camera_norm_std),
            resize=data_cfg.resize_img))
        return out

    return apply


def make_preprocessor(data_cfg):
    """The stage ``DataConfig.on_device_preprocess`` selects: None for
    False, the cast for "cast", else the full stage."""
    mode = data_cfg.on_device_preprocess
    if not mode:
        return None
    if mode == "cast":
        return make_cast_preprocessor()
    return make_batch_preprocessor(data_cfg)
