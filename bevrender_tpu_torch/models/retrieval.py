"""Retrieval-embedding head (counterpart of
bevrender_tpu/models/retrieval.py:39-76).

A Siamese conv head: one set of weights embeds the render and the map tile
into a compact unit-norm space (``ModelConfig.retrieval_embed_dim > 0``;
0 keeps the flattened render). Each stage is a stride-2 conv without bias
(5 x 5 first, then 3 x 3) with flax's SAME padding, GroupNorm(min(8, w))
and tanh-GELU; then a global mean over H and W, a dense projection and L2
normalisation. Submodules carry flax's automatic names (``Conv_0``,
``GroupNorm_0``, ..., ``Dense_0``) so that ``convert`` maps them.

The head runs in float32 whatever the model's compute dtype (the JAX
docstring: bf16 GroupNorm quantises away the difference between
neighbouring tiles), and its forward pins full float32 convolutions and
matmuls (``tf32(False)``) whatever the global settings say: PyTorch's
default ``torch.backends.cudnn.allow_tf32 = True`` would run its convs in
TF32 on the card, which loses the same bits. Its backward, run later by
autograd, follows the global settings.
"""

from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bevrender_tpu_torch.models.layers import Conv, Dense, GroupNorm, gelu


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 on or off for cuDNN convolutions and float32 matmuls inside;
    the caller's ``torch.get_float32_matmul_precision()`` and
    ``torch.backends.cudnn.allow_tf32`` restored after."""
    cudnn = torch.backends.cudnn
    saved = torch.get_float32_matmul_precision(), cudnn.allow_tf32
    torch.set_float32_matmul_precision("high" if enabled else "highest")
    cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        cudnn.allow_tf32 = saved[1]


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """flax's SAME padding (before, after) of one axis of size ``n``: the
    output has ceil(n / stride) entries and the odd one of the padding goes
    after (``lax.padtype_to_pads``)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class RetrievalHead(nn.Module):
    """(B, H, W, 3) image -> (B, embed_dim) unit vector, in float32 (float64
    when its parameters are)."""

    def __init__(self, embed_dim: int = 256,
                 widths: Sequence[int] = (32, 64, 128, 256)):
        super().__init__()
        self.widths = tuple(widths)
        prev = 3
        for i, w in enumerate(self.widths):
            k = 5 if i == 0 else 3
            self.add_module(f"Conv_{i}", Conv(prev, w, k, stride=2, bias=False))
            self.add_module(f"GroupNorm_{i}", GroupNorm(min(8, w), w))
            prev = w
        self.Dense_0 = Dense(prev, embed_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(torch.promote_types(self.Dense_0.weight.dtype,
                                          torch.float32))
        with tf32(False):
            for i in range(len(self.widths)):
                conv = getattr(self, f"Conv_{i}")
                k = conv.kernel_size[0]
                top, bottom = same_pads(x.shape[1], k, 2)
                left, right = same_pads(x.shape[2], k, 2)
                x = conv(F.pad(x, (0, 0, left, right, top, bottom)))
                x = gelu(getattr(self, f"GroupNorm_{i}")(x))
            x = self.Dense_0(x.mean(dim=(1, 2)))
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                               min=1e-12)
