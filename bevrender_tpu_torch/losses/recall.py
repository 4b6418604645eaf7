"""Retrieval recall@K (counterpart of bevrender_tpu/losses/recall.py). The
distance assumes L2-normalised embeddings: ``d = 2 - 2 * cam @ map.T``."""

from __future__ import annotations

from typing import Tuple

import torch


def _ranks(cam: torch.Tensor, map_: torch.Tensor) -> torch.Tensor:
    """Per map column, the number of cameras strictly closer than its own."""
    dist = 2.0 - 2.0 * cam @ map_.T
    gt = torch.diagonal(dist)
    return torch.sum(dist < gt[None, :], dim=0)


def recall_at_k(cam_embeddings: torch.Tensor, map_embeddings: torch.Tensor,
                ks: Tuple[int, ...] = (1, 5, 10)) -> Tuple[torch.Tensor, ...]:
    """Percentage of queries whose true match ranks inside the top k, one
    value per k."""
    ranks = _ranks(cam_embeddings, map_embeddings)
    return tuple(torch.mean((ranks < k).float()) * 100.0 for k in ks)


def recall_curve(cam_embeddings: torch.Tensor, map_embeddings: torch.Tensor,
                 length: int = 11) -> torch.Tensor:
    """Index i holds the fraction of queries ranked inside the top i."""
    ranks = _ranks(cam_embeddings, map_embeddings)
    return torch.stack([torch.mean((ranks < i).float()) for i in range(length)])
