"""Rendering losses: MSE, L1 and soft-label cross entropy (counterpart of
bevrender_tpu/losses/rendering.py), as plain functions on tensors and as
the reference API's classes with a ``get_loss(input, target)`` method."""

from __future__ import annotations

import torch


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def cross_entropy_loss(pred: torch.Tensor, target: torch.Tensor,
                       class_axis: int = 1) -> torch.Tensor:
    """Cross entropy over ``class_axis`` with probability targets of the
    same shape as ``pred``."""
    logp = torch.log_softmax(pred, dim=class_axis)
    return torch.mean(-torch.sum(target * logp, dim=class_axis))


class MSELoss:
    def get_loss(self, pred, target):
        return mse_loss(pred, target)


class L1Loss:
    def get_loss(self, pred, target):
        return l1_loss(pred, target)


class CrossEntropyLoss:
    def get_loss(self, pred, target):
        return cross_entropy_loss(pred, target)
