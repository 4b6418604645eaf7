"""Deformable attention modules on NHWC: TSA (temporal) and SCA (spatial
cross), counterparts of bevrender_tpu/models/attention.py:126-450. Module
and parameter names follow the flax tree.

The JAX package sorts keys by their lattice shift class for its TPU
kernels (attention.py:59-94). Attention over keys does not depend on their
order, so the port keeps them as they come.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from bevrender_tpu_torch.models.layers import (
    Conv,
    Dense,
    Dropout,
    LayerNorm,
    gelu,
)
from bevrender_tpu_torch.ops.deform_attn import (
    SiteOptions,
    streamed_deform_attention,
)
from bevrender_tpu_torch.ops.grid_sample import grid_sample_2d, normalized_grid


def _split_heads(x: torch.Tensor, G: int, Hpg: int) -> torch.Tensor:
    """(B, M, C) -> (B, G, Hpg, M, ch); channels group-major, then head."""
    B, M, C = x.shape
    return x.reshape(B, M, G, Hpg, C // (G * Hpg)).permute(0, 2, 3, 1, 4)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, G, Hpg, M, ch) -> (B, M, C)."""
    B, G, Hpg, M, ch = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(B, M, G * Hpg * ch)


@functools.lru_cache(maxsize=None)
def _offset_range(hk: int, wk: int, dtype: torch.dtype, device: torch.device):
    # made once per shape: a host-to-device copy per call would stall the
    # stream at every site
    return torch.tensor([1.0 / (hk - 1.0), 1.0 / (wk - 1.0)], dtype=dtype,
                        device=device)


def _offset_scale(off: torch.Tensor, hk: int, wk: int, factor: float):
    """tanh-bounded offset range (attention.py:117-123)."""
    return torch.tanh(off) * _offset_range(hk, wk, off.dtype, off.device) * factor


class _Site(nn.Module):
    """What TSA and SCA share around ``streamed_deform_attention``: the
    kernel choice (``site_options``, set by ``set_site_options``), attention
    dropout and its generator, and the dropout after ``proj_out``."""

    def __init__(self, attn_drop_rate: float, proj_drop_rate: float):
        super().__init__()
        self.attn_drop_rate = attn_drop_rate
        self.proj_drop = Dropout(proj_drop_rate)
        self.site_options = SiteOptions()
        self.generator = None

    def _site_kwargs(self, ch: int) -> dict:
        return dict(
            scale=ch ** -0.5, fuse_site=not self.training,
            **dataclasses.asdict(self.site_options),
            dropout_rate=self.attn_drop_rate if self.training else 0.0,
            generator=self.generator)


def set_site_options(module: nn.Module, **options) -> None:
    """Set the named fields of ``ops.deform_attn.SiteOptions`` on every
    attention site under ``module``: the training pass's ``fused_bwd``,
    ``site_remat`` and ``fused_fwd_fold`` (``TrainConfig``), and
    ``lattice_route``, ``site_prefetch``, ``bias_forward``,
    ``site_fold_heads`` and ``site_fold_rows`` (``ModelConfig.
    site_options``). Fields not named keep their values; the result is
    checked as ``SiteOptions`` checks it."""
    for mod in module.modules():
        if isinstance(mod, _Site):
            mod.site_options = dataclasses.replace(mod.site_options, **options)


def _grouped(x: torch.Tensor, G: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * G, H, W, C / G)."""
    B, H, W, C = x.shape
    return x.reshape(B, H, W, G, C // G).permute(0, 3, 1, 2, 4).reshape(
        B * G, H, W, C // G)


class TSADeformableAttention(_Site):
    """Keys sampled from the aligned previous BEV (or the query itself when
    there is no history) around a strided reference grid."""

    def __init__(self, dim: int, n_heads: int, n_groups: int, stride: int,
                 kernel_size: int, bev: int, scale_offset_range: bool = True,
                 offset_range_factor: float = 0.5, cd=None,
                 attn_drop_rate: float = 0.0, proj_drop_rate: float = 0.0):
        super().__init__(attn_drop_rate, proj_drop_rate)
        self.dim, self.n_heads, self.G = dim, n_heads, n_groups
        self.scale_offset_range = scale_offset_range
        self.factor = offset_range_factor
        Cg = dim // n_groups
        pad = kernel_size // 2 if kernel_size != stride else 0
        self.offset_dwconv = Conv(Cg, Cg, kernel_size, stride=stride,
                                  padding=pad, groups=Cg, compute_dtype=cd)
        self.offset_norm = LayerNorm(Cg)
        self.offset_proj = Conv(Cg, 2, 1, bias=False, compute_dtype=cd)
        self.proj_k = Dense(dim, dim, cd)
        self.proj_v = Dense(dim, dim, cd)
        self.proj_out = Dense(dim, dim, cd)
        self.rpe_table = nn.Parameter(
            torch.zeros(n_heads, 2 * bev - 1, 2 * bev - 1))

    def forward(self, query: torch.Tensor,
                prev_bev: Optional[torch.Tensor]) -> torch.Tensor:
        B, H, W, C = query.shape
        G = self.G
        Hpg = self.n_heads // G
        ch = C // self.n_heads
        x = query if prev_bev is None else prev_bev

        off = self.offset_dwconv(_grouped(query, G))
        off = self.offset_proj(gelu(self.offset_norm(off)))  # (B*G, Hk, Wk, 2)
        Hk, Wk = off.shape[1], off.shape[2]
        N = Hk * Wk
        ref = normalized_grid(Hk, Wk, off.dtype, off.device)
        if self.scale_offset_range:
            pos = _offset_scale(off, Hk, Wk, self.factor) + ref[None]
        else:
            pos = torch.clamp(off + ref[None], -1.0, 1.0)

        kv = grid_sample_2d(_grouped(x, G), pos.reshape(B * G, N, 2).flip(-1))
        kv = kv.reshape(B, G, N, C // G).permute(0, 2, 1, 3).reshape(B, N, C)
        k = self.proj_k(kv)
        v = self.proj_v(kv)
        out = streamed_deform_attention(
            _split_heads(query.reshape(B, H * W, C), G, Hpg),
            _split_heads(k, G, Hpg),
            _split_heads(v, G, Hpg),
            pos.reshape(B, G, N, 2),
            self.rpe_table.reshape(G, Hpg, 2 * H - 1, 2 * W - 1),
            H, W, **self._site_kwargs(ch),
        )
        return self.proj_drop(
            self.proj_out(_merge_heads(out).reshape(B, H, W, C)))


class SCADeformableAttention(_Site):
    """BEV queries attend into each camera view around the projected voxel
    reference points, with a per-view offset head; views fold into one site
    call when G >= 4 (attention.py:324-325)."""

    def __init__(self, dim: int, n_heads: int, n_groups: int,
                 bev_depth_dim: int, bev: int, n_views: int = 3,
                 scale_offset_range: bool = True,
                 offset_range_factor: float = 5.0, cd=None,
                 attn_drop_rate: float = 0.0, proj_drop_rate: float = 0.0):
        super().__init__(attn_drop_rate, proj_drop_rate)
        self.dim, self.n_heads, self.G = dim, n_heads, n_groups
        self.d = bev_depth_dim
        self.V = n_views
        self.scale_offset_range = scale_offset_range
        self.factor = offset_range_factor
        Cg = dim // n_groups
        d = bev_depth_dim
        for v in range(n_views):
            self.add_module(f"offset_expand_m{v}",
                            Conv(Cg, Cg * d, 1, groups=Cg, compute_dtype=cd))
            self.add_module(f"offset_norm_m{v}", LayerNorm(Cg * d))
            self.add_module(f"offset_proj_m{v}",
                            Conv(Cg * d, 2 * d, (2, 1), stride=(2, 1),
                                 bias=False, compute_dtype=cd))
        self.proj_k = Dense(dim, dim, cd)
        self.proj_v = Dense(dim, dim, cd)
        self.proj_out = Dense(n_views * dim, dim, cd)
        self.rpe_table = nn.Parameter(
            torch.zeros(n_heads, 2 * bev - 1, 2 * bev * d - 1))

    def _view_pos(self, qg, view: int, ref, B: int, H: int, W: int):
        """(B, G, N, 2) sampled key positions, (y, x), for one view."""
        G, d = self.G, self.d
        H2 = ref.shape[0]
        off = getattr(self, f"offset_expand_m{view}")(qg)
        off = gelu(getattr(self, f"offset_norm_m{view}")(off))
        if H % 2:  # flax SAME pads the stride-2 conv one row at the bottom
            off = F.pad(off, (0, 0, 0, 0, 0, 1))
        off = getattr(self, f"offset_proj_m{view}")(off)[:, :H2]
        off = off.reshape(B * G, H2, W, d, 2).reshape(B * G, H2, W * d, 2)
        ref = ref.flip(-1)  # (x, y) -> (y, x)
        if self.scale_offset_range:
            pos = _offset_scale(off, H2, W * d, self.factor) + ref[None]
        else:
            pos = torch.clamp(off + ref[None], -1.0, 1.0)
        return pos.reshape(B, G, H2 * W * d, 2)

    def _kv(self, feat, pos, n_img: int):
        """K/V of the keys at ``pos`` (n_img, G, N, 2) in ``feat``
        (n_img, Hi, Wi, C)."""
        G = self.G
        C = feat.shape[-1]
        N = pos.shape[2]
        kv = grid_sample_2d(_grouped(feat, G),
                            pos.reshape(n_img * G, N, 2).flip(-1))
        kv = kv.reshape(n_img, G, N, C // G).permute(0, 2, 1, 3).reshape(
            n_img, N, C)
        return self.proj_k(kv), self.proj_v(kv)

    def forward(self, query: torch.Tensor, img_feat: torch.Tensor,
                reference_points: torch.Tensor) -> torch.Tensor:
        B, H, W, C = query.shape
        G, V, d = self.G, self.V, self.d
        Hpg = self.n_heads // G
        ch = C // self.n_heads
        qg = _grouped(query, G)
        q5 = _split_heads(query.reshape(B, H * W, C), G, Hpg)
        rpe = self.rpe_table.reshape(G, Hpg, 2 * H - 1, 2 * W * d - 1)
        view_pos = [self._view_pos(qg, v, reference_points[v], B, H, W)
                    for v in range(V)]
        attn = self._site_kwargs(ch)

        if G >= 4:
            pos = torch.stack(view_pos, dim=1).reshape(B * V, G, -1, 2)
            k, v = self._kv(img_feat.reshape((B * V,) + img_feat.shape[2:]),
                            pos, B * V)
            q_rep = q5[:, None].expand((B, V) + q5.shape[1:]).reshape(
                (B * V,) + q5.shape[1:])
            out = streamed_deform_attention(
                q_rep, _split_heads(k, G, Hpg), _split_heads(v, G, Hpg), pos,
                rpe, H, W, rows_per_sample=V, **attn)
            out = _merge_heads(out).reshape(B, V, H, W, C).permute(0, 2, 3, 1, 4)
            out = out.reshape(B, H, W, V * C)
        else:
            outs = []
            for view in range(V):
                k, v = self._kv(img_feat[:, view], view_pos[view], B)
                o = streamed_deform_attention(
                    q5, _split_heads(k, G, Hpg), _split_heads(v, G, Hpg),
                    view_pos[view], rpe, H, W, **attn)
                outs.append(_merge_heads(o).reshape(B, H, W, C))
            out = torch.cat(outs, dim=-1)
        return self.proj_drop(self.proj_out(out))
