"""Data-parallel runtime over ``torch.distributed`` (counterpart of
bevrender_tpu/parallel/mesh.py).

The JAX package shards the global batch over a one-axis ``data`` mesh and
lets GSPMD insert the collectives. Here one process runs per GPU, as
``torchrun`` starts them, and the port calls the collectives itself. A rank
holds the rows ``r::W`` of each global batch (``rank_rows``, the strided
shard of ``DataLoader(process_shard=...)``), and what the JAX package
computes over the global batch is computed here from all-reduced sums or
from gathered rows:

* ``BatchNorm`` in train mode all-reduces its per-channel sums
  (``all_reduce_sum``, autograd-aware);
* drop path and dropout draw the global batch's mask and keep this rank's
  rows (``local_rand``);
* the retrieval losses run on the gathered embeddings (``all_gather_rows``);
* the trainer all-reduces the flattened gradients and losses once a step
  (``all_reduce_mean_``) before the global-norm clip.

The collectives are ``all_reduce``, ``all_gather`` and ``broadcast`` only:
NCCL and gloo both take them on CPU and CUDA tensors. With no process group,
or a group of one, every function here leaves its input as it is.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from bevrender_tpu_torch import resolve_device

_log = logging.getLogger("bevrender_tpu_torch")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main() -> bool:
    """Rank 0, or the only process: the one that writes files and logs."""
    return rank() == 0


def initialize_distributed(device=None, *, init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None) -> torch.device:
    """Join the process group that ``torchrun`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, and
    ``MASTER_ADDR``/``MASTER_PORT``, which ``env://`` reads), or the one
    that ``init_method``, ``rank`` and ``world_size`` name. Returns the
    device this rank runs on: ``cuda:LOCAL_RANK`` (NCCL) unless ``device``
    names the CPU (gloo). Without ``WORLD_SIZE`` it logs why and stays one
    process, as the JAX package's ``initialize_distributed`` does. A group
    that fails to form raises: no rank goes on alone."""
    if is_initialized():
        raise RuntimeError("a process group is already initialised")
    if world_size is None:
        if "WORLD_SIZE" not in os.environ:
            dev = resolve_device(device)
            _log.info("WORLD_SIZE is not set (not started by torchrun); "
                      "continuing as one process on %s", dev)
            return dev
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local)
        resolve_device(dev)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    _log.info("rank %d of %d on %s (%s)", rank, world_size, dev, backend)
    return dev


def rank_rows(n: int, world: int, rank: int) -> torch.Tensor:
    """The rows of an ``n``-row global batch that rank ``rank`` of
    ``world`` holds: ``rank::world``."""
    if n % world:
        raise ValueError(f"a global batch of {n} rows does not split over "
                         f"{world} ranks")
    return torch.arange(rank, n, world)


def local_rand(shape: Sequence[int], generator, device,
               rows_per_sample: int = 1) -> torch.Tensor:
    """``torch.rand(shape)`` for this rank's part of the global batch:
    with a group of W > 1, the (W * shape[0], ...) draw that one process
    makes for the whole global batch, of which this rank keeps its rows,
    so that W ranks drop what one process drops. ``shape[0]`` is the local
    batch times ``rows_per_sample`` (a batch folded with views, say), each
    sample's rows contiguous."""
    shape = tuple(shape)
    W = world_size()
    if W == 1:
        return torch.rand(shape, generator=generator, device=device)
    full = torch.rand((W * shape[0],) + shape[1:], generator=generator,
                      device=device)
    per = rows_per_sample
    return full.reshape((shape[0] // per, W, per) + shape[1:])[:, rank()] \
        .reshape(shape)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks. Autograd-aware: the gradient of
    every rank's loss with respect to the sum is summed back to each
    input, which is the gradient of the sum of the ranks' losses (the
    trainer divides the all-reduced gradient by W)."""
    return _AllReduceSum.apply(x) if world_size() > 1 else x


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        W = dist.get_world_size()
        parts = [torch.empty_like(x) for _ in range(W)]
        dist.all_gather(parts, x.contiguous())
        # rank r's row j is global row j * W + r
        return torch.stack(parts, dim=1).reshape((W * x.shape[0],)
                                                 + x.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g)
        W = dist.get_world_size()
        return g.reshape((g.shape[0] // W, W) + g.shape[1:])[:, dist.get_rank()]


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch's rows, in its order, from each rank's strided
    share ``x``: one ``all_gather`` in rank order, interleaved so that
    rank r's row j lands at global row j * W + r. The backward
    all-reduces the gathered gradient and keeps this rank's rows: every
    rank computes the same global loss from the gathered rows, so the
    gradient reaching a rank's rows is W times that loss's, which the
    trainer's division by W restores."""
    return _GatherRows.apply(x) if world_size() > 1 else x


def all_reduce_mean_(tensors: List[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place, with one
    ``all_reduce`` of their flattened float32 concatenation (with a group
    of one, a copy of the same values). Nothing is done without a group."""
    if not is_initialized() or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat.div_(world_size())
    with torch.no_grad():
        torch._foreach_copy_(tensors, [
            c.view(t.shape) for c, t in zip(flat.split([t.numel() for t in
                                                        tensors]), tensors)])


def broadcast_tensors_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Every rank's ``tensors`` set to rank ``src``'s, in place."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src)


def broadcast_module_(net: torch.nn.Module, src: int = 0) -> None:
    """Parameters and buffers of ``net`` set to rank ``src``'s."""
    broadcast_tensors_(list(net.parameters()) + list(net.buffers()), src)


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` (picklable) on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]
