"""Data- and model-parallel runtime over ``torch.distributed``
(counterpart of bevrender_tpu/parallel/mesh.py).

The JAX package shards the global batch over the ``data`` axis of its mesh,
and optionally the attention heads and the MLP's hidden channels over a
``model`` axis, and lets GSPMD insert the collectives. Here one process runs
per GPU, as ``torchrun`` starts them, and the port calls the collectives
itself. With ``model_parallel=M`` the W ranks form D = W / M data ranks of M
model ranks each, global rank ``d * M + m`` as ``make_mesh`` lays out its
devices (mesh.py:56); with M = 1 (the default) every rank is a data rank
and the data group is the whole group.

A data rank holds the rows ``d::D`` of each global batch (``rank_rows``,
the strided shard of ``DataLoader(process_shard=...)``), and what the JAX
package computes over the global batch is computed here over the data
group from all-reduced sums or from gathered rows:

* ``BatchNorm`` in train mode all-reduces its per-channel sums
  (``all_reduce_sum``, autograd-aware);
* drop path and dropout draw the global batch's mask and keep this rank's
  rows (``local_rand``);
* the retrieval losses run on the gathered embeddings (``all_gather_rows``);
* the trainer all-reduces the flattened gradients and losses once a step
  (``all_reduce_mean_``, over every rank) before the global-norm clip.

The M model ranks of a data rank hold the same rows and the same whole
parameters. Each runs its share of every attention site's heads and of each
``ConvMLP``'s hidden channels, with Megatron's two operators at the edges of
such a split region: ``enter_model`` (identity forward, its gradient summed
over the model group) where whole tensors enter, and ``gather_model`` (the
heads gathered, backward this rank's part) or ``sum_model`` (partial sums
added, backward identity) where the region's output leaves, whole, for
every model rank alike. So after the backward every model rank holds every
parameter's whole gradient (the same bits, but where the card's backward
sums with float atomics), and the trainer's mean over every rank is the
data ranks' mean, the same bits on every rank.

The collectives are ``all_reduce``, ``all_gather`` and ``broadcast`` only:
NCCL and gloo both take them on CPU and CUDA tensors. With no process group,
or a group of one, every function here leaves its input as it is.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Optional, Sequence, Tuple

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


@dataclasses.dataclass(frozen=True)
class _Groups:
    """This rank's data and model subgroups (``init_model_parallel``); a
    group of one rank is None, and needs no collective."""

    model_parallel: int
    data: Optional[dist.ProcessGroup]
    model: dist.ProcessGroup


_groups: Optional[_Groups] = None


def _split() -> Optional[_Groups]:
    return _groups if _groups is not None and is_initialized() else None


def model_parallel() -> int:
    """M, the model ranks of a data rank (1 without a model split)."""
    g = _split()
    return 1 if g is None else g.model_parallel


def data_world_size() -> int:
    """D = W / M, the data ranks that share the global batch."""
    return world_size() // model_parallel()


def data_rank() -> int:
    return rank() // model_parallel()


def model_rank() -> int:
    return rank() % model_parallel()


def data_group() -> Optional[dist.ProcessGroup]:
    """The group of this rank's data-parallel peers, the ranks of its model
    rank: the whole group (None) without a model split."""
    g = _split()
    return None if g is None else g.data


def model_group() -> dist.ProcessGroup:
    g = _split()
    if g is None:
        raise RuntimeError("no model split: call init_model_parallel(M > 1)")
    return g.model


def _check_split(world: int, model_parallel: int) -> None:
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} ranks not divisible by model_parallel="
                         f"{model_parallel}")


def init_model_parallel(model_parallel: int = 1) -> None:
    """Split the initialised group of W ranks into W / M data ranks x M
    model ranks (``make_mesh(model_axis="model", model_parallel=M)``,
    mesh.py:41-57): global rank ``d * M + m`` is model rank m of data rank
    d. Every rank calls it, with the same M: it builds each data and model
    subgroup with ``dist.new_group``. M = 1 takes the split away."""
    global _groups
    W = world_size()
    _check_split(W, model_parallel)
    _groups = None
    if model_parallel == 1:
        return
    M, D, r = model_parallel, W // model_parallel, rank()
    data = model = None
    if D > 1:
        for m in range(M):
            g = dist.new_group([d * M + m for d in range(D)])
            data = g if r % M == m else data
    for d in range(D):
        g = dist.new_group(list(range(d * M, (d + 1) * M)))
        model = g if r // M == d else model
    _groups = _Groups(M, data, model)


def initialize_distributed(device=None, *, init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           model_parallel: int = 1) -> torch.device:
    """Join the process group that ``torchrun`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, and
    ``MASTER_ADDR``/``MASTER_PORT``, which ``env://`` reads), or the one
    that ``init_method``, ``rank`` and ``world_size`` name, and split it
    into data and model ranks (``init_model_parallel``). Returns the
    device this rank runs on: ``cuda:LOCAL_RANK`` (NCCL) unless ``device``
    names the CPU (gloo). Without ``WORLD_SIZE`` it logs why and stays one
    process, as the JAX package's ``initialize_distributed`` does. A group
    that fails to form raises: no rank goes on alone."""
    if is_initialized():
        raise RuntimeError("a process group is already initialised")
    if world_size is None:
        if "WORLD_SIZE" not in os.environ:
            init_model_parallel(model_parallel)
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
    _check_split(world_size, model_parallel)  # before joining the group
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    init_model_parallel(model_parallel)
    _log.info("rank %d of %d on %s (%s), %d model ranks a data rank", rank,
              world_size, dev, backend, model_parallel)
    return dev


def rank_rows(n: int, world: int, rank: int) -> torch.Tensor:
    """The rows of an ``n``-row global batch that rank ``rank`` of
    ``world`` holds: ``rank::world``."""
    if n % world:
        raise ValueError(f"a global batch of {n} rows does not split over "
                         f"{world} ranks")
    return torch.arange(rank, n, world)


def local_rand(shape: Sequence[int], generator, device,
               rows_per_sample: int = 1,
               split: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """``torch.rand(shape)`` for this rank's part of the global batch:
    with D > 1 data ranks, the (D * shape[0], ...) draw that one process
    makes for the whole global batch, of which this data rank keeps its
    rows, so that D ranks drop what one process drops; the model ranks of
    a data rank draw the same bits. ``shape[0]`` is the local batch times
    ``rows_per_sample`` (a batch folded with views, say), each sample's
    rows contiguous. ``split = (axis, part, parts)`` says that the tensor
    to mask is the ``part``-th of ``parts`` equal runs of a whole tensor
    along ``axis`` (a model rank's hidden channels or heads): the whole
    tensor's mask is drawn and that run kept."""
    shape = list(shape)
    if split is not None:
        axis, part, parts = split
        shape[axis] *= parts
    shape = tuple(shape)
    D = data_world_size()
    if D == 1:
        r = torch.rand(shape, generator=generator, device=device)
    else:
        full = torch.rand((D * shape[0],) + shape[1:], generator=generator,
                          device=device)
        per = rows_per_sample
        r = full.reshape((shape[0] // per, D, per) + shape[1:])[
            :, data_rank()].reshape(shape)
    if split is not None:
        n = shape[axis] // parts
        r = r.narrow(axis, part * n, n)
    return r


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y, group=data_group())
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=data_group())
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data ranks. Autograd-aware: the gradient
    of every data rank's loss with respect to the sum is summed back to
    each input, which is the gradient of the sum of the ranks' losses (the
    trainer divides the all-reduced gradient by D)."""
    return _AllReduceSum.apply(x) if data_world_size() > 1 else x


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        D = data_world_size()
        parts = [torch.empty_like(x) for _ in range(D)]
        dist.all_gather(parts, x.contiguous(), group=data_group())
        # data rank d's row j is global row j * D + d
        return torch.stack(parts, dim=1).reshape((D * x.shape[0],)
                                                 + x.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=data_group())
        D = data_world_size()
        return g.reshape((g.shape[0] // D, D) + g.shape[1:])[:, data_rank()]


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch's rows, in its order, from each data rank's
    strided share ``x``: one ``all_gather`` in data-rank order,
    interleaved so that data rank d's row j lands at global row j * D + d.
    The backward all-reduces the gathered gradient and keeps this rank's
    rows: every rank computes the same global loss from the gathered rows,
    so the gradient reaching a rank's rows is D times that loss's, which
    the trainer's division by D restores."""
    return _GatherRows.apply(x) if data_world_size() > 1 else x


def all_reduce_mean_(tensors: List[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place, with one
    ``all_reduce`` of their flattened float32 concatenation (with a group
    of one, a copy of the same values). Nothing is done without a group.
    With a model split the mean is over every rank too: the data ranks'
    mean of their model ranks' values, which are the same whole gradients
    and losses, but for the last bits where a backward on the card sums
    with float atomics in another order in every process; the mean gives
    every rank the same bits, and so the same parameters."""
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


# ---- the model axis: Megatron's f and g around a split region ----------

class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        ctx.like = [(x.shape, x.dtype) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        want = [i for i, need in enumerate(ctx.needs_input_grad) if need]
        if not want:
            return (None,) * len(grads)
        dt = torch.float32  # or wider: float64 gradients stay float64
        for i in want:
            dt = torch.promote_types(dt, grads[i].dtype)
        flat = torch.cat([grads[i].reshape(-1).to(dt) for i in want])
        dist.all_reduce(flat, group=model_group())
        out = [None] * len(grads)
        for i, part in zip(want, flat.split([grads[i].numel()
                                             for i in want])):
            shape, dtype = ctx.like[i]
            out[i] = part.view(shape).to(dtype)
        return tuple(out)


def enter_model(*tensors: torch.Tensor) -> tuple:
    """The whole ``tensors`` as they enter a model-split region (Megatron's
    f): the same tensors forward; backward, each one's gradient summed
    over the model group, with one ``all_reduce`` for all of them (in
    float32, or float64 where a gradient is),
    so that the part each model rank's share contributes reaches every
    rank. Where the shares read disjoint slices (a rank's heads of q, k, v
    or of the table, its hidden channels' rows of a weight) the sum adds
    zeros and is exact. Without a model split, or without a gradient to
    take, the tensors as they are."""
    if model_parallel() == 1 or not torch.is_grad_enabled():
        return tensors
    return _EnterModel.apply(*tensors)


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        dt = torch.promote_types(x.dtype, torch.float32)
        parts = [torch.empty(x.shape, dtype=dt, device=x.device)
                 for _ in range(model_parallel())]
        dist.all_gather(parts, x.to(dt).contiguous(), group=model_group())
        return torch.cat(parts, dim).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, model_rank() * ctx.n, ctx.n), None


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' parts ``x`` joined along ``dim`` in model-rank
    order (a site's heads, each group's run from every rank). Backward:
    this rank's run of the gradient, with no collective, because what
    reads the whole tensor is computed alike on every model rank."""
    return _GatherModel.apply(x, dim) if model_parallel() > 1 else x


class _SumModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y, group=model_group())
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad


def sum_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the model ranks' partial results ``x`` (Megatron's g):
    backward the identity, because the sum's consumers run alike on every
    model rank and each partial's gradient is the sum's."""
    return _SumModel.apply(x) if model_parallel() > 1 else x
