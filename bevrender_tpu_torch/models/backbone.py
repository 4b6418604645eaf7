"""Image backbones on NHWC (counterpart of bevrender_tpu/models/backbone.py:
``BasicBlock`` :25, ``BottleNeck`` :55, ``ResNetTrunk`` :87,
``ResNet18WoFPN`` :122, ``PatchProjection`` :146, ``FPNBlock`` :167,
``ResnetFPN`` :186). Module names follow the flax tree.

``ResnetFPN`` returns four maps (P2-P5); the encoder takes one feature map,
so, as in the JAX package (encoder.py:278-281), no model runs it: it is
held to the JAX module on its own.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from bevrender_tpu_torch.models.layers import Conv, LayerNorm, gelu, upsample


class BasicBlock(nn.Module):
    expansion = 1

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


class BottleNeck(nn.Module):
    """ResNet bottleneck block, expansion 4 (img_backbone.py:11-92): the
    first block of a stage always projects its identity."""

    expansion = 4

    def __init__(self, in_ch: int, out_ch: int, stride: int, is_first: bool,
                 norm, cd=None):
        super().__init__()
        wide = out_ch * self.expansion
        self.conv1 = Conv(in_ch, out_ch, 1, compute_dtype=cd)
        self.bn1 = norm(out_ch)
        self.conv2 = Conv(out_ch, out_ch, 3, stride=stride, padding=1,
                          compute_dtype=cd)
        self.bn2 = norm(out_ch)
        self.conv3 = Conv(out_ch, wide, 1, compute_dtype=cd)
        self.bn3 = norm(wide)
        self.has_down = is_first
        if is_first:
            self.down_conv = Conv(in_ch, wide, 1, stride=stride,
                                  compute_dtype=cd)
            self.down_bn = norm(wide)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = self.down_bn(self.down_conv(x)) if self.has_down else x
        return F.relu(y + identity)


class ResNetTrunk(nn.Module):
    """Stem + four stages of ``block`` (img_backbone.py:164-282): the last
    stage's map, or with ``return_stages`` all four (for the FPN)."""

    def __init__(self, n_blocks, out_channels, strides, norm, cd=None,
                 block=BasicBlock, return_stages: bool = False):
        super().__init__()
        self.stem_conv = Conv(3, 64, 3, stride=2, padding=1, compute_dtype=cd)
        self.stem_bn = norm(64)
        self.return_stages = return_stages
        self.stages = []
        c_in = 64
        for si, (n, c, s) in enumerate(zip(n_blocks, out_channels, strides)):
            names = []
            for bi in range(n):
                name = f"layer{si + 2}_block{bi}"
                self.add_module(name, block(c_in, c, s if bi == 0 else 1,
                                            bi == 0, norm, cd))
                names.append(name)
                c_in = c * block.expansion
            self.stages.append(names)

    def forward(self, x):
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        # max pool 3x3 / 2, padded with -inf like flax
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        outs = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return tuple(outs) if self.return_stages else x


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


class FPNBlock(nn.Module):
    """Lateral 1x1, plus the upper level upsampled x2 (``upsample``)
    through a 1x1 unless this is the highest level, then a 3x3 out
    (img_backbone.py:285-326). Returns
    (the merged lateral, which feeds the level below, and the output)."""

    def __init__(self, in_ch: int, out_ch: int, top_ch=None, cd=None):
        super().__init__()
        self.lateral = Conv(in_ch, out_ch, 1, compute_dtype=cd)
        if top_ch is not None:
            self.top_proj = Conv(top_ch, out_ch, 1, compute_dtype=cd)
        self.out_conv = Conv(out_ch, out_ch, 3, padding=1, compute_dtype=cd)

    def forward(self, x, top=None):
        x = self.lateral(x)
        if top is not None:
            x = x + self.top_proj(upsample(top, 2))
        return x, self.out_conv(x)


class ResnetFPN(nn.Module):
    """ResNet-18/34/50/101/152 with an FPN returning P2-P5
    (img_backbone.py:384-426), each level at its stage's width."""

    ARCHS = {"18": (BasicBlock, (2, 2, 2, 2)),
             "34": (BasicBlock, (3, 4, 6, 3)),
             "50": (BottleNeck, (3, 4, 6, 3)),
             "101": (BottleNeck, (3, 4, 23, 3)),
             "152": (BottleNeck, (3, 8, 36, 3))}

    def __init__(self, norm, resnet_arch: str = "18", cd=None):
        super().__init__()
        block, n_blocks = self.ARCHS[resnet_arch]
        self.resnet = ResNetTrunk(n_blocks, (64, 128, 256, 512),
                                  (1, 2, 2, 2), norm, cd, block=block,
                                  return_stages=True)
        c2, c3, c4, c5 = (c * block.expansion for c in (64, 128, 256, 512))
        self.P5 = FPNBlock(c5, c5, cd=cd)
        self.P4 = FPNBlock(c4, c4, c5, cd)
        self.P3 = FPNBlock(c3, c3, c4, cd)
        self.P2 = FPNBlock(c2, c2, c3, cd)

    def forward(self, x):
        c2, c3, c4, c5 = self.resnet(x)
        x5, p5 = self.P5(c5)
        x4, p4 = self.P4(c4, x5)
        x3, p3 = self.P3(c3, x4)
        _, p2 = self.P2(c2, x3)
        return p2, p3, p4, p5


def build_backbone(backbone: str, embed_dim: int, bev_dim: int,
                   img_height: int, norm, cd=None) -> nn.Module:
    if backbone == "ResNet18":
        return ResNet18WoFPN(bev_dim, norm, cd)
    if backbone == "PatchProjection":
        return PatchProjection(embed_dim, max(2, img_height // bev_dim), cd)
    if backbone == "ResnetFPN":
        return ResnetFPN(norm, cd=cd)
    raise ValueError(f"unknown backbone: {backbone}")
