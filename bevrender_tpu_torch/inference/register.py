"""Render + register (counterpart of bevrender_tpu/inference/register.py:
``RegistrationPipeline.__init__/render/build_tile_database/register``
:40-110, 210-301, and ``evaluate_recall`` :374).

Render an aerial view from a window of surround-camera frames, flatten and
L2-normalise it, and take the top-k of the distance ``2 - 2 * sim`` to a
resident database of map-tile embeddings.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from bevrender_tpu_torch import resolve_device
from bevrender_tpu_torch.config import Config
from bevrender_tpu_torch.data.prefetch import DataLoader, device_prefetch
from bevrender_tpu_torch.losses.recall import recall_at_k
from bevrender_tpu_torch.models.bevrender import BEVRenderNet
from bevrender_tpu_torch.models.layers import init_params


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


class RegistrationPipeline:
    """Holds the model on ``device`` (CUDA unless the caller names another;
    raises when there is none). Weights come from ``state_dict`` (for
    example ``convert.flax_to_state_dict``), loaded strictly, or else from
    the seeded initialiser."""

    def __init__(self, config: Config, state_dict=None, *, device=None,
                 seed: int = 0):
        self.device = resolve_device(device)
        self.config = config
        net = BEVRenderNet(config.model)
        if state_dict is None:
            init_params(net, seed)
        else:
            net.load_state_dict(state_dict, strict=True)
        self.net = net.to(self.device).eval()
        self._tile_db: Optional[torch.Tensor] = None

    def _inputs(self, batch: Dict) -> tuple:
        return tuple(
            torch.as_tensor(np.asarray(batch[k]) if not torch.is_tensor(batch[k])
                            else batch[k]).to(self.device)
            for k in ("camera", "vehicle_pose", "vehicle_type")
        )

    @torch.no_grad()
    def render(self, batch: Dict) -> torch.Tensor:
        """(B, T, V, H, W, 3) camera window -> (B, 224, 224, 3) render."""
        return self.net(*self._inputs(batch))

    @torch.no_grad()
    def build_tile_database(self, tiles: Iterable[np.ndarray],
                            batch_size: int = 256) -> torch.Tensor:
        """Embed map tiles (each (H, W, 3)) into the resident (N, D)
        database, ``batch_size`` tiles per transfer. A sized ``tiles`` fills
        one preallocated buffer and must yield exactly ``len(tiles)``."""
        n_total = len(tiles) if hasattr(tiles, "__len__") else None
        db, row, parts, buf = None, 0, [], []

        def flush():
            nonlocal db, row
            if not buf:
                return
            x = torch.from_numpy(np.stack(buf)).to(self.device)
            e = _l2n(x.reshape(x.shape[0], -1))
            if n_total is None:
                parts.append(e)
            else:
                if db is None:
                    db = torch.zeros((n_total, e.shape[1]), dtype=e.dtype,
                                     device=self.device)
                if row + e.shape[0] > n_total:
                    raise ValueError(f"tiles yielded more than len(tiles)={n_total}")
                db[row:row + e.shape[0]] = e
                row += e.shape[0]
            buf.clear()

        for tile in tiles:
            buf.append(np.asarray(tile, dtype=np.float32))
            if len(buf) == batch_size:
                flush()
        flush()
        if n_total is not None and row != n_total:
            raise ValueError(f"tiles yielded {row} rows, len(tiles)={n_total}")
        if db is None and not parts:
            raise ValueError("build_tile_database: no tiles provided")
        self._tile_db = db if db is not None else torch.cat(parts)
        return self._tile_db

    @torch.no_grad()
    def register(self, batch: Dict, top_k: int = 10
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Render, embed and match: (render, top-k tile indices, top-k
        distances), nearest first."""
        if self._tile_db is None:
            raise RuntimeError("call build_tile_database first")
        db = self._tile_db
        out = self.net(*self._inputs(batch))
        emb = _l2n(out.reshape(out.shape[0], -1)).to(db.dtype)
        sims = torch.matmul(emb, db.T).float()
        neg_dist, idx = torch.topk(-(2.0 - 2.0 * sims), min(top_k, db.shape[0]))
        return out, idx, -neg_dist

    @torch.no_grad()
    def evaluate_recall(self, dataset, batch_size: int = 1) -> Dict[str, float]:
        """Paired recall@1/5/10 over a dataset of (camera window, map tile):
        each render's embedding against every tile's."""
        cams, maps = [], []
        loader = DataLoader(dataset, batch_size, shuffle=False, drop_last=False)
        for batch in device_prefetch(iter(loader), self.device):
            out = self.net(batch["camera"], batch["vehicle_pose"],
                           batch["vehicle_type"])
            cams.append(_l2n(out.reshape(out.shape[0], -1)).float())
            tiles = batch["map"].float()
            maps.append(_l2n(tiles.reshape(tiles.shape[0], -1)))
        r1, r5, r10 = recall_at_k(torch.cat(cams), torch.cat(maps), (1, 5, 10))
        return {"R@1": float(r1), "R@5": float(r5), "R@10": float(r10)}
