"""Image backbones on NHWC (counterpart of bevrender_tpu/models/backbone.py:
``BasicBlock`` :25, ``ResNetTrunk`` :87, ``ResNet18WoFPN`` :122,
``PatchProjection`` :146). Module names follow the flax tree."""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from bevrender_tpu_torch.models.layers import Conv, LayerNorm, gelu


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int, is_first: bool,
                 norm, cd=None):
        super().__init__()
        self.conv1 = Conv(in_ch, out_ch, 3, stride=stride, padding=1,
                          compute_dtype=cd)
        self.bn1 = norm(out_ch)
        self.conv2 = Conv(out_ch, out_ch, 3, padding=1, compute_dtype=cd)
        self.bn2 = norm(out_ch)
        self.has_down = is_first and stride != 1
        if self.has_down:
            self.down_conv = Conv(in_ch, out_ch, 1, stride=stride,
                                  compute_dtype=cd)
            self.down_bn = norm(out_ch)

    def forward(self, x):
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        identity = self.down_bn(self.down_conv(x)) if self.has_down else x
        return F.relu(y + identity)


class ResNetTrunk(nn.Module):
    """Stem + four stages of basic blocks (img_backbone.py:164-282)."""

    def __init__(self, n_blocks, out_channels, strides, norm, cd=None):
        super().__init__()
        self.stem_conv = Conv(3, 64, 3, stride=2, padding=1, compute_dtype=cd)
        self.stem_bn = norm(64)
        self.block_names = []
        c_in = 64
        for si, (n, c, s) in enumerate(zip(n_blocks, out_channels, strides)):
            for bi in range(n):
                name = f"layer{si + 2}_block{bi}"
                self.add_module(name, BasicBlock(c_in, c, s if bi == 0 else 1,
                                                 bi == 0, norm, cd))
                self.block_names.append(name)
                c_in = c

    def forward(self, x):
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        # max pool 3x3 / 2, padded with -inf like flax
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x


class ResNet18WoFPN(nn.Module):
    """Constant-64-channel ResNet-18; stride 2 in conv3_x at BEV 28."""

    out_dim = 64

    def __init__(self, bev_dim: int, norm, cd=None):
        super().__init__()
        strides = (1, 2, 1, 1) if bev_dim == 28 else (1, 1, 1, 1)
        self.resnet = ResNetTrunk((2, 2, 2, 2), (64, 64, 64, 64), strides,
                                  norm, cd)

    def forward(self, x):
        return self.resnet(x)


class PatchProjection(nn.Module):
    """Chain of stride-2 3x3 convs with LayerNorm + GELU (tiny configs)."""

    def __init__(self, embed_dim: int, patch_size: int, cd=None):
        super().__init__()
        self.out_dim = embed_dim
        self.n_convs = {4: 2, 8: 3, 16: 4}[patch_size]
        c_in = 3
        for i in range(self.n_convs):
            out = embed_dim if i == self.n_convs - 1 else embed_dim // 2
            self.add_module(f"conv{i}", Conv(c_in, out, 3, stride=2, padding=1,
                                             compute_dtype=cd))
            self.add_module(f"norm{i}", LayerNorm(out))
            c_in = out

    def forward(self, x):
        for i in range(self.n_convs):
            x = getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(x))
            if i != self.n_convs - 1:
                x = gelu(x)
        return x


def build_backbone(backbone: str, embed_dim: int, bev_dim: int,
                   img_height: int, norm, cd=None) -> nn.Module:
    if backbone == "ResNet18":
        return ResNet18WoFPN(bev_dim, norm, cd)
    if backbone == "PatchProjection":
        return PatchProjection(embed_dim, max(2, img_height // bev_dim), cd)
    raise NotImplementedError(f"backbone {backbone!r} is not ported yet")
