"""BEV -> aerial RGB render decoder (counterpart of
bevrender_tpu/models/decoder.py:36-148), and ``SimpleDecoder``, the
minimal alternative the default wiring does not use. Module names follow
the flax tree.

The upsamples are ``jax.image.resize(method="bilinear")``
(``layers.upsample``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from bevrender_tpu_torch.models.layers import Conv, upsample


class DecoderConvBlock(nn.Module):
    """Four conv3x3 + norm pairs, ReLU out; no residual."""

    def __init__(self, in_ch: int, hidden: int, out_ch: int, norm, cd=None):
        super().__init__()
        c = in_ch
        for i in range(3):
            self.add_module(f"conv{i}", Conv(c, hidden, 3, padding=1, bias=False,
                                             compute_dtype=cd))
            self.add_module(f"bn{i}", norm(hidden))
            c = hidden
        self.conv3 = Conv(c, out_ch, 3, padding=1, bias=False, compute_dtype=cd)
        self.bn3 = norm(out_ch)

    def forward(self, x):
        for i in range(3):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x))
        return F.relu(self.bn3(self.conv3(x)))


class UpsampleBlock(nn.Module):
    def __init__(self, in_ch: int, hidden: int, out_ch: int, norm, cd=None):
        super().__init__()
        self.conv0 = Conv(in_ch, hidden, 3, padding=1, bias=False,
                          compute_dtype=cd)
        self.bn0 = norm(hidden)
        self.conv1 = Conv(hidden, out_ch, 3, padding=1, bias=False,
                          compute_dtype=cd)
        self.bn1 = norm(out_ch)

    def forward(self, x):
        x = self.bn0(self.conv0(upsample(x, 2)))
        return F.relu(self.bn1(self.conv1(x)))


class UpsampleHead(nn.Module):
    def __init__(self, in_ch: int, hidden: int, norm, cd=None):
        super().__init__()
        self.conv0 = Conv(in_ch, hidden, 3, padding=1, bias=False,
                          compute_dtype=cd)
        self.bn0 = norm(hidden)
        self.conv1 = Conv(hidden, 3, 1, bias=False, compute_dtype=cd)

    def forward(self, x):
        x = self.bn0(self.conv0(upsample(x, 2)))
        return torch.sigmoid(self.conv1(x))


class BEVImageRenderDecoder(nn.Module):
    """(B, bev, bev, model_dim) -> (B, 224, 224, 3) in [0, 1]."""

    def __init__(self, bev_spatial_dim: int, model_dim: int, hid_dim: int,
                 norm, cd=None):
        super().__init__()
        self.stem_conv = Conv(model_dim, hid_dim, 7, stride=2, padding=3,
                              bias=False, compute_dtype=cd)
        self.stem_bn = norm(hid_dim)
        self.block1 = DecoderConvBlock(hid_dim, hid_dim, hid_dim, norm, cd)
        self.block2 = DecoderConvBlock(hid_dim, hid_dim * 2, hid_dim * 2,
                                       norm, cd)
        self.block3 = DecoderConvBlock(hid_dim * 2, model_dim, model_dim,
                                       norm, cd)
        n_up = {56: 2, 28: 3, 14: 4}.get(bev_spatial_dim, 2)
        dims = [model_dim // 2, model_dim // 4]
        dims += [model_dim // 4] * max(0, n_up - 2)
        prev = model_dim
        self.n_up = n_up
        for i, dim in enumerate(dims[:n_up]):
            self.add_module(f"up{i}", UpsampleBlock(prev, dim, dim, norm, cd))
            prev = dim
        self.head = UpsampleHead(prev, max(model_dim // 8, 4), norm, cd)

    def forward(self, x):
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = self.block3(self.block2(self.block1(x)))
        for i in range(self.n_up):
            x = getattr(self, f"up{i}")(x)
        return self.head(x)


class SimpleDecoder(nn.Module):
    """x4 bilinear upsample, 3x3 conv (64, no bias), norm, 1x1 conv to RGB
    (no bias), ReLU (decoder_img_render.py:219-232)."""

    def __init__(self, in_ch: int, norm, cd=None):
        super().__init__()
        self.conv0 = Conv(in_ch, 64, 3, padding=1, bias=False,
                          compute_dtype=cd)
        self.bn0 = norm(64)
        self.conv1 = Conv(64, 3, 1, bias=False, compute_dtype=cd)

    def forward(self, x):
        return F.relu(self.conv1(self.bn0(self.conv0(upsample(x, 4)))))
