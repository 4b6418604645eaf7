"""Shared building blocks on NHWC tensors (counterpart of
bevrender_tpu/models/layers.py:29-197).

Precision follows flax: ``Conv`` and ``Dense`` with ``compute_dtype=bf16``
cast their input, weight and bias to bf16 and return bf16; with ``None``
they compute in the promoted type of input and weight. Params stay float32.
Norms compute in float32 and return float32, as flax's do for a bf16 input.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

import torch
import torch.nn as nn
import torch.nn.functional as F

from bevrender_tpu_torch.parallel import dist as pdist


def compute_dtype(name: str) -> Optional[torch.dtype]:
    """``ModelConfig.dtype`` -> the conv/dense compute dtype (None = f32)."""
    return torch.bfloat16 if name in ("bfloat16", "bf16") else None


def _dtype(x: torch.Tensor, w: torch.Tensor, cd: Optional[torch.dtype]):
    return cd if cd is not None else torch.promote_types(x.dtype, w.dtype)


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` on NHWC. ``padding`` is symmetric per side. flax's
    default SAME is 0 for every 1x1 conv; for the stride-(2,1) offset conv
    of SCA it is 0 at even heights and one row at the bottom at odd ones,
    which ``SCADeformableAttention`` adds with ``F.pad`` before the conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=1,
                 padding=0, groups: int = 1, bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding, groups=groups, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _dtype(x, self.weight, self.compute_dtype)
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), b,
                     self.stride, self.padding, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


def upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Bilinear upsample of an NHWC map by ``factor``:
    ``jax.image.resize(method="bilinear")``, which for an upsample equals
    ``F.interpolate(mode="bilinear", align_corners=False)`` (half-pixel
    centres)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=factor,
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose`` with kernel 2, stride 2 and its default
    SAME padding on NHWC: ``out[2i + a, 2j + b] = x[i, j] . K[1 - a, 1 - b]``
    for the flax kernel K (kh, kw, in, out), which is PyTorch's transposed
    conv with weight ``K[::-1, ::-1]`` as (in, out, kh, kw)
    (``convert.flax_to_state_dict`` flips it). flax computes it in the
    promoted type of input and kernel (no compute dtype: float32 params
    give float32 out), and so does this module."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2),
                               self.weight.to(dt), self.bias.to(dt), stride=2)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Linear):
    """flax ``nn.Dense`` over the last axis."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _dtype(x, self.weight, self.compute_dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: eps 1e-6, float32 out."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm`` (eps 1e-5, momentum 0.9 = torch 0.1) on NHWC,
    float32 out. Eval mode normalises with the running statistics. Train
    mode follows flax and not ``nn.BatchNorm2d``: the batch variance is the
    biased E[x^2] - E[x]^2 in float32, clipped at 0, and that same biased
    variance updates ``running_var`` (torch stores the unbiased one).

    With more than one data rank, the batch is the global one, as under
    the JAX package's GSPMD: the per-channel sums of x and x^2 and the row
    count are all-reduced over the data ranks (autograd-aware) before the
    mean and variance are taken, so every rank normalises with, and
    updates its running statistics from, the same global values. The
    model ranks of a data rank hold the same rows and take no part in the
    sum."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if pdist.data_world_size() > 1:
            C = x.shape[-1]
            stats = pdist.all_reduce_sum(torch.cat([
                x.sum(dim=(0, 1, 2)), (x * x).sum(dim=(0, 1, 2)),
                x.new_full((1,), x.numel() // C)]))
            mean = stats[:C] / stats[-1]
            var = torch.clamp(stats[C:2 * C] / stats[-1] - mean * mean,
                              min=0.0)
        else:
            mean = x.mean(dim=(0, 1, 2))
            var = torch.clamp((x * x).mean(dim=(0, 1, 2)) - mean * mean,
                              min=0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` on NHWC (``scale`` and ``bias`` as ``weight``
    and ``bias``): statistics over H, W and the group's channels in at
    least float32, the variance E[x^2] - E[x]^2 clipped at 0 as flax's
    fast variance, eps 1e-6, at least float32 out."""

    def __init__(self, num_groups: int, dim: int, eps: float = 1e-6):
        super().__init__()
        if dim % num_groups:
            raise ValueError(f"{num_groups} groups do not divide {dim} channels")
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        G, C = self.num_groups, x.shape[-1]
        xg = x.reshape(x.shape[0], -1, G, C // G)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=(1, 3), keepdim=True)
                          - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(G, C // G)
        y = (xg - mean) * mul + self.bias.reshape(G, C // G)
        return y.reshape(x.shape)


class AdaptiveGroupNorm(nn.Module):
    """``AdaptiveGroupNorm`` (layers.py:66-80): groups of gcd(C, 8)
    channels. The inner module is named as flax names it, so the flax path
    ``.../GroupNorm_0/{scale,bias}`` maps through ``convert``."""

    def __init__(self, dim: int, max_group_size: int = 8):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(dim // math.gcd(dim, max_group_size), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.GroupNorm_0(x)


def make_norm(norm: str):
    """Factory of the conv-net norm (``make_norm``, layers.py:37): ``batch``
    (flax BatchNorm) or ``group`` (``AdaptiveGroupNorm``, the same in
    training and eval); called with the channel count."""
    if norm == "batch":
        return BatchNorm
    if norm == "group":
        return AdaptiveGroupNorm
    raise ValueError(f"unknown norm: {norm}")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class DropPath(nn.Module):
    """Per-sample stochastic depth; identity at eval. The mask comes from
    ``generator`` (``set_generator``), or PyTorch's default generator when
    none is set; with D > 1 data ranks it is this rank's rows of the
    global batch's mask (``parallel.dist.local_rand``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = pdist.local_rand((x.shape[0],) + (1,) * (x.ndim - 1),
                                self.generator, x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Dropout(nn.Module):
    """flax ``nn.Dropout``: elementwise, kept values divided by the keep
    rate; identity at eval. Draws from ``generator`` like ``DropPath``.
    ``split=(part, parts)`` says that ``x`` is the ``part``-th of
    ``parts`` equal runs of the last axis of a whole tensor (a model
    rank's hidden channels): the whole tensor's mask is drawn and that run
    kept."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator = None

    def forward(self, x: torch.Tensor,
                split: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = pdist.local_rand(
            x.shape, self.generator, x.device,
            split=None if split is None else (x.ndim - 1,) + tuple(split))
        return torch.where(mask < keep, x / keep, torch.zeros_like(x))


def set_generator(module: nn.Module, generator) -> None:
    """Give every stochastic submodule (drop path, dropout, attention
    dropout) the ``torch.Generator`` it draws from. The trainer seeds one
    generator per step from (seed, step), as the JAX package folds the step
    into its dropout key."""
    for mod in module.modules():
        if hasattr(mod, "generator"):
            mod.generator = generator


class ConvMLP(nn.Module):
    """1x1 expand, dropout, + depthwise 3x3 branch, GELU, 1x1 project,
    dropout (``ConvMLP``, layers.py:111).

    With M model ranks (``parallel.dist.init_model_parallel``) the hidden
    channels split over them, as the JAX package shards them over its
    ``model`` axis (layers.py:135): model rank m takes the m-th run of
    hidden / M channels, so ``linear1`` by output channel, ``dwc`` by
    channel and ``linear2`` by input channel. The ranks' partial outputs
    of ``linear2`` are summed in float32 over the model group, its bias
    added once and the sum cast once to the compute dtype; the parameters
    stay whole, and their gradients are summed over the group
    (``enter_model``)."""

    def __init__(self, dim: int, expansion: int, cd=None,
                 drop_rate: float = 0.0):
        super().__init__()
        hidden = dim * expansion
        self.drop = Dropout(drop_rate)
        self.linear1 = Conv(dim, hidden, 1, compute_dtype=cd)
        self.dwc = Conv(hidden, hidden, 3, padding=1, groups=hidden,
                        compute_dtype=cd)
        self.linear2 = Conv(hidden, dim, 1, compute_dtype=cd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if pdist.model_parallel() > 1:
            return self._split_forward(x)
        x = self.drop(self.linear1(x))
        x = x + self.dwc(x)
        return self.drop(self.linear2(gelu(x)))

    def _split_forward(self, x: torch.Tensor) -> torch.Tensor:
        M, m = pdist.model_parallel(), pdist.model_rank()
        hidden = self.linear1.out_channels
        if hidden % M:
            raise ValueError(f"{hidden} hidden channels do not split over "
                             f"{M} model ranks")
        h = hidden // M
        run = slice(m * h, (m + 1) * h)
        x, w1, b1, wd, bd, w2 = pdist.enter_model(
            x, self.linear1.weight, self.linear1.bias, self.dwc.weight,
            self.dwc.bias, self.linear2.weight)
        cd = self.linear1.compute_dtype
        dt = _dtype(x, w1, cd)
        y = _conv_nhwc(x.to(dt), w1[run].to(dt), b1[run].to(dt))
        y = self.drop(y, split=(m, M))
        y = y + _conv_nhwc(y, wd[run].to(dt), bd[run].to(dt), padding=1,
                           groups=h)
        y = gelu(y)
        dt = _dtype(y, w2, cd)
        # products of the operands rounded to the compute dtype, summed in
        # float32 here and over the ranks: one rounding, as one process's
        part = _conv_nhwc(y.to(dt).float(), w2[:, run].to(dt).float())
        out = pdist.sum_model(part) + self.linear2.bias.to(dt).float()
        return self.drop(out.to(dt))


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, b=None, padding: int = 0,
               groups: int = 1) -> torch.Tensor:
    return F.conv2d(x.permute(0, 3, 1, 2), w, b, 1, padding, 1,
                    groups).permute(0, 2, 3, 1)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channel (last) axis of an NHWC tensor
    (``LayerNorm2d``, layers.py:29): flax's ``LayerNorm_0``, eps 1e-6,
    float32 out. A reference-API module that no model path calls."""

    def __init__(self, dim: int):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm_0(x)


class LayerScale(nn.Module):
    """Per-channel learned scale (``LayerScale``, layers.py:97), the flax
    parameter ``gamma`` filled with ``init_value``. A reference-API module
    that no model path calls."""

    def __init__(self, dim: int, init_value: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class FeedForwardLayer(nn.Module):
    """Linear FFN (``FeedForwardLayer``, layers.py:141): ``Dense_0`` to
    ``hidden_dim``, GELU, dropout, ``Dense_1`` back to ``in_dim``,
    dropout. A reference-API module: the reference builds two a layer and
    never calls them, nor does any model path here."""

    def __init__(self, in_dim: int, hidden_dim: int, drop_rate: float = 0.0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Dense_0 = Dense(in_dim, hidden_dim, compute_dtype)
        self.Dense_1 = Dense(hidden_dim, in_dim, compute_dtype)
        self.drop = Dropout(drop_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.drop(gelu(self.Dense_0(x)))
        return self.drop(self.Dense_1(y))


def _init_module(mod: nn.Module, gen: torch.Generator) -> None:
    if isinstance(mod, Conv):
        nn.init.kaiming_normal_(mod.weight, mode="fan_out",
                                nonlinearity="relu", generator=gen)
    elif isinstance(mod, Dense):
        nn.init.xavier_uniform_(mod.weight, generator=gen)
    elif isinstance(mod, ConvTranspose):
        # truncated at 2 std and rescaled, as jax's variance_scaling
        fan_in = mod.weight[:, 0].numel()  # in * kh * kw
        std = fan_in ** -0.5 / 0.87962566103423978
        nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                              generator=gen)
    if isinstance(mod, (Conv, Dense, ConvTranspose)) and mod.bias is not None:
        mod.bias.zero_()
    if isinstance(mod, (LayerNorm, BatchNorm, GroupNorm)):
        mod.reset_parameters()


@torch.no_grad()
def init_params(module: nn.Module, seed: int) -> nn.Module:
    """Seeded initialisation following the JAX package's initialisers
    (layers.py:160-197, bevrender.py:45-49): Kaiming normal (fan_out) for
    convs, Xavier uniform for dense layers, zero biases, unit norms, a
    trunc-normal(0.01) rpe table, a uniform [0, 1) BEV embedding, and flax's
    default LeCun normal (fan_in) for the transposed convs. The
    numbers differ from JAX's for the same seed; only the distributions
    match. The retrieval head, where there is one, draws from a generator
    of its own."""
    gen = torch.Generator().manual_seed(seed)
    for name, mod in module.named_modules():
        if not name.startswith("retrieval_head"):
            _init_module(mod, gen)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "rpe_table":
            nn.init.trunc_normal_(p, std=1.0, a=-2.0, b=2.0, generator=gen)
            p.mul_(0.01)
        elif leaf == "bev_embedding":
            p.uniform_(0.0, 1.0, generator=gen)
    head = getattr(module, "retrieval_head", None)
    if head is not None:
        # a generator of its own, so that a seed gives the rest of the model
        # the same numbers with or without the head
        head_seed = np.random.SeedSequence([seed, 1]).generate_state(
            1, np.uint64)[0] >> np.uint64(1)
        head_gen = torch.Generator().manual_seed(int(head_seed))
        for mod in head.modules():
            _init_module(mod, head_gen)
    return module
