"""Render + register (counterpart of bevrender_tpu/inference/register.py:
``RegistrationPipeline.__init__`` with its embedding choice :43-67,
``from_checkpoint`` :112-133, ``make_streaming_step`` and
``make_replay_scan`` :136-208, ``render/build_tile_database/register``
:210-301, ``make_sharded_matcher`` and ``pad_tile_db`` :304-372, and
``evaluate_recall`` :374-390).

Render an aerial view from a window of surround-camera frames, embed it,
and take the top-k of the distance ``2 - 2 * sim`` to a resident database
of map-tile embeddings. The embedding is, in the JAX package's order of
choice, a caller's ``embed_fn`` (L2-normalised), the model's trained
retrieval head (``ModelConfig.retrieval_embed_dim > 0``), or the flattened,
L2-normalised image. Streaming serving carries the BEV state from frame to
frame: one encoder pass and one decode a frame. A database too large for
one card is split over the data ranks of a process group, each holding a
contiguous shard of rows (``make_sharded_matcher``), the model ranks of a
data rank the same shard. With a model split
(``parallel.dist.init_model_parallel``) every model rank of a data rank
calls ``render`` and ``register`` together: the attention sites gather
their heads over them.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from bevrender_tpu_torch import resolve_device
from bevrender_tpu_torch.config import Config
from bevrender_tpu_torch.data.prefetch import DataLoader, device_prefetch
from bevrender_tpu_torch.losses.recall import recall_at_k
from bevrender_tpu_torch.models.attention import set_site_options
from bevrender_tpu_torch.models.bevrender import BEVRenderNet
from bevrender_tpu_torch.models.layers import init_params
from bevrender_tpu_torch.parallel import dist as pdist
from bevrender_tpu_torch.training.checkpoint import restore_model
from bevrender_tpu_torch.utils.profiling import annotation


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


class RegistrationPipeline:
    """Holds the model on ``device`` (CUDA unless the caller names another;
    raises when there is none). Weights come from ``state_dict`` (for
    example ``convert.flax_to_state_dict``), loaded strictly, or else from
    the seeded initialiser. ``embed_fn`` (images -> (B, D)), when given,
    replaces the model's embedding."""

    def __init__(self, config: Config, state_dict=None, *, device=None,
                 seed: int = 0,
                 embed_fn: Optional[Callable[[torch.Tensor],
                                             torch.Tensor]] = None):
        self.device = resolve_device(device)
        self.config = config
        net = BEVRenderNet(config.model)
        if state_dict is None:
            init_params(net, seed)
        else:
            net.load_state_dict(state_dict, strict=True)
        set_site_options(net, **config.model.site_options())
        self.net = net.to(self.device).eval()
        self.embed_fn = embed_fn
        self._tile_db: Optional[torch.Tensor] = None

    @classmethod
    def from_checkpoint(cls, config: Config, path: str, *, device=None,
                        embed_fn=None) -> "RegistrationPipeline":
        """A pipeline over the ``model`` entry of a checkpoint that
        ``Trainer.save_checkpoint`` wrote (``training/checkpoint.py``)."""
        state_dict = restore_model(path)["model"]
        return cls(config, state_dict, device=device, embed_fn=embed_fn)

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """Unit-norm (B, D) embeddings of renders or map tiles: ``embed_fn``
        if given, else the trained head, else the flatten."""
        if self.embed_fn is not None:
            return _l2n(self.embed_fn(images))
        if self.config.model.retrieval_embed_dim > 0:
            return self.net.embed(images)
        return _l2n(images.reshape(images.shape[0], -1))

    def _device(self, x) -> torch.Tensor:
        return torch.as_tensor(x if torch.is_tensor(x)
                               else np.asarray(x)).to(self.device)

    def _inputs(self, batch: Dict) -> tuple:
        return tuple(self._device(batch[k])
                     for k in ("camera", "vehicle_pose", "vehicle_type"))

    @torch.no_grad()
    def render(self, batch: Dict) -> torch.Tensor:
        """(B, T, V, H, W, 3) camera window -> (B, 224, 224, 3) render."""
        return self.net(*self._inputs(batch))

    @torch.no_grad()
    def build_tile_database(self, tiles: Iterable[np.ndarray],
                            batch_size: int = 256) -> torch.Tensor:
        """Embed map tiles (each (H, W, 3)) into the resident (N, D)
        database, ``batch_size`` tiles per transfer, in the embedding's
        dtype. A sized ``tiles`` fills one preallocated buffer and must
        yield exactly ``len(tiles)``."""
        n_total = len(tiles) if hasattr(tiles, "__len__") else None
        db, row, parts, buf = None, 0, [], []

        def flush():
            nonlocal db, row
            if not buf:
                return
            e = self.embed(torch.from_numpy(np.stack(buf)).to(self.device))
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
        distances), nearest first. Spans: ``register`` around the whole
        request, ``register.match`` around the embedding, the product with
        the database and the top-k."""
        if self._tile_db is None:
            raise RuntimeError("call build_tile_database first")
        db = self._tile_db
        with annotation("register"):
            out = self.net(*self._inputs(batch))
            with annotation("register.match"):
                sims = torch.matmul(self.embed(out).to(db.dtype), db.T).float()
                neg_dist, idx = torch.topk(-(2.0 - 2.0 * sims),
                                           min(top_k, db.shape[0]))
        return out, idx, -neg_dist

    def _frame_step(self, frame, prev_bev, pose_pair, vtype, tiles):
        """One streaming frame: (BEV, render, distances to ``tiles``)."""
        bev = self.net.encode_step(frame, prev_bev, pose_pair, vtype)
        out = self.net.decode(bev)
        emb = self.embed(out)
        return bev, out, 2.0 - 2.0 * emb.to(tiles.dtype) @ tiles.T

    def make_streaming_step(self):
        """``step(frame, prev_bev, pose_pair, vtype, tiles) -> (bev, render,
        argmin tile index)``: one encoder pass on frame (B, V, H, W, 3) with
        the carried BEV (None on the first frame), pose_pair (B, 2, 3)
        (previous, current), against the (N, D) tile embeddings ``tiles``.
        Carrying the BEV over a window's frames, with the pose pair
        ``pose[:, lo:lo + 2]`` where ``lo = min(t, T - 2)``, gives the
        window's render."""

        @torch.no_grad()
        def step(frame, prev_bev, pose_pair, vtype, tiles):
            bev, out, dist = self._frame_step(
                self._device(frame), prev_bev, self._device(pose_pair),
                self._device(vtype), self._device(tiles))
            return bev, out, torch.argmin(dist, dim=-1)

        return step

    def make_replay_scan(self):
        """``replay(frames, pose_pairs, vtype, tiles) -> (final bev, (T, B)
        tile indices, (T, B) distances)``: a recorded sequence of frames
        (T, B, V, H, W, 3) with their pose pairs (T, B, 2, 3) registered
        frame by frame with the BEV carried, frame 0 with none. The loop
        enqueues every frame's work on the device without waiting for it:
        nothing is read back to the host before the end."""

        @torch.no_grad()
        def replay(frames, pose_pairs, vtype, tiles):
            frames, pose_pairs = self._device(frames), self._device(pose_pairs)
            vtype, tiles = self._device(vtype), self._device(tiles)
            bev, idx, dist = None, [], []
            for t in range(frames.shape[0]):
                bev, _, d = self._frame_step(frames[t], bev, pose_pairs[t],
                                             vtype, tiles)
                idx.append(torch.argmin(d, dim=-1))
                dist.append(torch.amin(d, dim=-1))
            return bev, torch.stack(idx), torch.stack(dist)

        return replay

    @staticmethod
    def make_sharded_matcher(top_k: int = 10):
        """``match(query_emb, db_shard, n_real) -> (top-k indices, top-k
        distances)``, nearest first, for a database split over the ranks of
        the process group (one rank without one): rank r holds the
        contiguous rows ``[r * nl, (r + 1) * nl)`` of the (W * nl, D)
        database that ``pad_tile_db`` padded, of which the first ``n_real``
        are tiles. Each rank takes the distances ``2 - 2 q . shard^T`` of
        the (B, D) queries to its rows (pad rows +inf), its (B, k) top-k
        with k = min(top_k, nl), and one ``all_gather`` of the candidates
        in rank order; the top-k of those is the exact global top-k, with
        global row indices, on every rank. The (B, N) distances never
        leave their rank. With a model split the shards and the gather
        are the data ranks' (``make_sharded_matcher(mesh, axis="data")``):
        W is the number of data ranks, r this rank's data rank, and the
        model ranks of a data rank hold the same shard."""

        @torch.no_grad()
        def match(q: torch.Tensor, db_shard: torch.Tensor, n_real: int):
            W, r = pdist.data_world_size(), pdist.data_rank()
            nl = db_shard.shape[0]
            sims = torch.matmul(q.to(db_shard.dtype), db_shard.T).float()
            dist = 2.0 - 2.0 * sims
            rows = r * nl + torch.arange(nl, device=dist.device)
            dist = torch.where(rows[None, :] < n_real, dist,
                               torch.full_like(dist, torch.inf))
            neg, lidx = torch.topk(-dist, min(top_k, nl))
            cand_d, cand_i = -neg, lidx + r * nl
            if W > 1:
                parts_d = [torch.empty_like(cand_d) for _ in range(W)]
                parts_i = [torch.empty_like(cand_i) for _ in range(W)]
                group = pdist.data_group()
                torch.distributed.all_gather(parts_d, cand_d.contiguous(),
                                             group=group)
                torch.distributed.all_gather(parts_i, cand_i.contiguous(),
                                             group=group)
                cand_d, cand_i = torch.cat(parts_d, 1), torch.cat(parts_i, 1)
            neg, sel = torch.topk(-cand_d, min(top_k, cand_d.shape[1]))
            return torch.gather(cand_i, 1, sel), -neg

        return match

    @staticmethod
    def pad_tile_db(db: torch.Tensor, n_shards: int
                    ) -> Tuple[torch.Tensor, int]:
        """(the (N, D) database padded with zero rows to a multiple of
        ``n_shards``, N): N is the matcher's ``n_real``, so that pad rows
        are never matched while ``top_k`` <= N."""
        n = db.shape[0]
        pad = (-n) % n_shards
        if pad:
            db = torch.cat([db, db.new_zeros((pad, db.shape[1]))])
        return db, n

    @torch.no_grad()
    def evaluate_recall(self, dataset, batch_size: int = 1) -> Dict[str, float]:
        """Paired recall@1/5/10 over a dataset of (camera window, map tile):
        each render's embedding against every tile's."""
        cams, maps = [], []
        loader = DataLoader(dataset, batch_size, shuffle=False, drop_last=False)
        for batch in device_prefetch(iter(loader), self.device):
            out = self.net(batch["camera"], batch["vehicle_pose"],
                           batch["vehicle_type"])
            cams.append(self.embed(out).float())
            maps.append(self.embed(batch["map"].float()))
        r1, r5, r10 = recall_at_k(torch.cat(cams), torch.cat(maps), (1, 5, 10))
        return {"R@1": float(r1), "R@5": float(r5), "R@10": float(r10)}
