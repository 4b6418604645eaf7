"""Metric-learning losses (counterpart of bevrender_tpu/losses/metric.py).

Camera embedding i and map embedding i are the only positive pair. All take
``(cam_embeddings, map_embeddings)`` of shape (B, D), or a query batch, a
resident database and the rows of the positives for the ``*_vs_db`` losses:

* ``contrastive_loss``: L2-normalised euclidean distance; positive pairs pay
  ``relu(d - pos_margin)``, negative pairs ``relu(neg_margin - d)``; each is
  averaged over its non-zero elements, then the two are summed.
* ``triplet_loss``: semihard triplets (the negative farther than the
  positive, within ``miner_margin``); per triplet ``relu(s_an - s_ap +
  margin)`` on cosine similarities, averaged over those below
  ``reducer_high``; plus the mean L2 norm of the raw embeddings.
* ``lifted_structure_loss``: per positive pair ``J = log(sum_neg exp(
  neg_margin - d)) + (d_pos - pos_margin)``, loss ``mean_pos(relu(J)^2) / 2``.
* ``infonce_loss_vs_db``: softmax cross entropy over cosine similarities to
  the database at a temperature.

The first three are also the reference API's classes with a
``get_loss(cam, map_)`` method.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=_EPS)


def _pair_setup(cam: torch.Tensor, map_: torch.Tensor):
    """Concatenated embeddings with paired labels: (emb, positive mask,
    negative mask), the diagonal excluded."""
    B = cam.shape[0]
    emb = torch.cat([cam, map_], dim=0)  # (2B, D)
    labels = torch.arange(B, device=cam.device).repeat(2)
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(2 * B, dtype=torch.bool, device=cam.device)
    return emb, same & ~eye, ~same


def _euclidean_dist(x: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(x * x, dim=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * x @ x.T
    return torch.sqrt(torch.clamp(d2, min=_EPS))


def _masked_mean_nonzero(values: torch.Tensor, mask: torch.Tensor):
    """Mean over the masked, strictly positive values (0 when none)."""
    nz = mask & (values > 0)
    total = torch.sum(torch.where(nz, values, torch.zeros_like(values)))
    count = torch.sum(nz)
    return torch.where(count > 0, total / torch.clamp(count, min=1),
                       torch.zeros_like(total))


def contrastive_loss(cam, map_, pos_margin: float = 0.0,
                     neg_margin: float = 1.0) -> torch.Tensor:
    emb, pos_mask, neg_mask = _pair_setup(cam, map_)
    d = _euclidean_dist(_l2_normalize(emb))
    pos_loss = _masked_mean_nonzero(torch.relu(d - pos_margin), pos_mask)
    neg_loss = _masked_mean_nonzero(torch.relu(neg_margin - d), neg_mask)
    return pos_loss + neg_loss


def contrastive_loss_vs_db(cam, db, labels, pos_margin: float = 0.0,
                           neg_margin: float = 1.0) -> torch.Tensor:
    """Contrastive loss of a query batch (B, D) against a resident database
    (N, D): every other row of the database is a negative. ``labels`` (B,)
    are the rows of the positives."""
    q = _l2_normalize(cam)
    t = _l2_normalize(db)
    sq = torch.sum(q * q, dim=-1)[:, None] + torch.sum(t * t, dim=-1)[None, :]
    d = torch.sqrt(torch.clamp(sq - 2.0 * q @ t.T, min=_EPS))  # (B, N)
    pos_mask = labels[:, None] == torch.arange(db.shape[0],
                                               device=db.device)[None, :]
    pos_loss = _masked_mean_nonzero(torch.relu(d - pos_margin), pos_mask)
    neg_loss = _masked_mean_nonzero(torch.relu(neg_margin - d), ~pos_mask)
    return pos_loss + neg_loss


def infonce_loss_vs_db(cam, db, labels,
                       temperature: float = 0.07) -> torch.Tensor:
    """Softmax cross entropy of a query batch against a resident database."""
    logits = (_l2_normalize(cam) @ _l2_normalize(db).T) / temperature
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None].long()))


def triplet_loss(cam, map_, margin: float = 0.05, miner_margin: float = 0.2,
                 reducer_high: float = 0.3,
                 reg_weight: float = 1.0) -> torch.Tensor:
    emb, pos_mask, neg_mask = _pair_setup(cam, map_)
    normed = _l2_normalize(emb)
    d = _euclidean_dist(normed)
    d_ap = d[:, :, None]
    d_an = d[:, None, :]
    semihard = (d_an > d_ap) & (d_an < d_ap + miner_margin)
    valid = pos_mask[:, :, None] & neg_mask[:, None, :] & semihard
    s = normed @ normed.T
    viol = torch.relu(s[:, None, :] - s[:, :, None] + margin)  # s_an - s_ap
    keep = valid & (viol < reducer_high)
    total = torch.sum(torch.where(keep, viol, torch.zeros_like(viol)))
    count = torch.sum(keep)
    loss = torch.where(count > 0, total / torch.clamp(count, min=1),
                       torch.zeros_like(total))
    reg = torch.mean(torch.linalg.vector_norm(emb, dim=-1))
    return loss + reg_weight * reg


def lifted_structure_loss(cam, map_, neg_margin: float = 1.0,
                          pos_margin: float = 0.0) -> torch.Tensor:
    emb, pos_mask, neg_mask = _pair_setup(cam, map_)
    d = _euclidean_dist(_l2_normalize(emb))
    neg_terms = torch.where(neg_mask, neg_margin - d,
                            torch.full_like(d, -torch.inf))
    row_lse = torch.logsumexp(neg_terms, dim=1)  # (2B,)
    pair_lse = torch.logaddexp(row_lse[:, None], row_lse[None, :])
    J = torch.relu(pair_lse + (d - pos_margin))
    n_pos = torch.sum(pos_mask)
    return torch.sum(torch.where(pos_mask, J ** 2, torch.zeros_like(J))) / \
        torch.clamp(2.0 * n_pos, min=1.0)


class ContrastiveLoss:
    def get_loss(self, cam, map_):
        return contrastive_loss(cam, map_)


class TripletLossMetricLearning:
    def get_loss(self, cam, map_):
        return triplet_loss(cam, map_)


class LiftedStructureLoss:
    def get_loss(self, cam, map_):
        return lifted_structure_loss(cam, map_)
