"""One training step as a captured CUDA graph: the port's counterpart of
the JAX package's jitted ``lax.scan`` over k steps (``_train_step_multi``,
bevrender_tpu/training/trainer.py:280-306), which exists to take the
per-step host dispatch out of a step.

``GraphedStep`` captures ``Trainer._step_body`` (forward, losses,
backward, the global-norm clip and AdamW) once, after warm-up steps on a
side stream, and each sub-step of a group is one ``replay``:

* the sub-step's slice of the group is copied into the graph's static
  batch (``STEP_INPUTS``) before the replay, and the metrics and render
  are cloned after it, before the next replay overwrites them;
* the trainer's dropout generator is registered with the graph and seeded
  with ``_mix(rng, step)`` before each replay, as the eager step seeds it.
  A replay reads the generator's seed and offset when it starts, so a
  sub-step draws the eager step's drop-path and dropout masks. That held
  on an H100: from one state a graphed step's loss (drop path 0.2) is the
  eager step's bit for bit, and eight graphed steps stay within the
  spread of two eager runs (chip_smoke phase 29);
* AdamW is built with ``capturable=True`` and a learning rate that is a
  tensor on the device (``Trainer._conform_optimizer``), so that the
  per-epoch rate reaches the graph: a Python float would be frozen into it
  at capture;
* the warm-up steps build the kernel libraries, set the kernels' shared
  memory attributes at these shapes, create AdamW's moments and let cuDNN
  and cuBLAS choose and allocate; the model, its buffers and AdamW's state
  are put back afterwards, in place, so the captured step starts from the
  state the caller passed;
* the graph reads the state's tensors by address: a state whose
  parameters, buffers or optimizer tensors are other tensors than at
  capture (``signature``) is captured anew by the trainer.

A capture that fails raises: there is no eager fallback on the card. One
graph of one step, replayed k times, keeps the per-step reseed, and a
trailing partial group is fewer replays of the same graph.

In a process group the step's one all-reduce of the gradients and losses
(``parallel.dist.all_reduce_mean_``) is captured with the rest: NCCL's
collectives can be, on the capture stream. gloo's cannot, and a graphed
step on gloo raises (``check_capturable``) rather than step eagerly.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from bevrender_tpu_torch.parallel import dist as pdist

# the batch entries a training step reads
STEP_INPUTS = ("camera", "vehicle_pose", "vehicle_type", "map")
# eager steps before the capture, on the capture's side stream
WARMUP_STEPS = 2


def _optimizer_tensors(optimizer: torch.optim.Optimizer):
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            yield group["lr"]
    for state in optimizer.state.values():
        for v in state.values():
            if torch.is_tensor(v):
                yield v


def signature(state) -> Tuple[int, ...]:
    """Addresses of every tensor a captured step reads or writes in
    place: parameters, buffers, AdamW's state and learning rate."""
    tensors = (list(state.net.parameters()) + list(state.net.buffers())
               + list(_optimizer_tensors(state.optimizer)))
    return tuple(t.data_ptr() for t in tensors)


def check_capturable() -> None:
    """Raise ValueError when a process group is initialised whose
    collectives a CUDA graph cannot capture (any backend but NCCL)."""
    if pdist.is_initialized() and dist.get_backend() != "nccl":
        raise ValueError(
            f"a graphed training step cannot capture the collectives of the "
            f"{dist.get_backend()!r} backend; graphed steps across ranks need "
            f"NCCL (or steps_per_dispatch = 1)")


class GraphedStep:
    """A captured training step of ``trainer`` on ``state`` for batches
    shaped as ``batch`` (one step's batch, on the device)."""

    def __init__(self, trainer, state, batch: Dict[str, torch.Tensor]):
        check_capturable()
        self.trainer = trainer
        self.static = {k: batch[k].detach().clone() for k in STEP_INPUTS
                       if k in batch}
        self.key = self.batch_key(batch)
        self.graph = torch.cuda.CUDAGraph()
        self.stream = torch.cuda.Stream(trainer.device)
        t0 = time.perf_counter()
        self._warm_up(state)
        self._capture(state)
        torch.cuda.synchronize(trainer.device)
        self.capture_s = time.perf_counter() - t0
        self.signature = signature(state)

    @staticmethod
    def batch_key(batch) -> tuple:
        return tuple((k, tuple(batch[k].shape), batch[k].dtype)
                     for k in STEP_INPUTS if k in batch)

    def _body(self, state):
        return self.trainer._step_body(state.net, state.optimizer,
                                       self.static,
                                       self.trainer._forward_losses)

    def _warm_up(self, state) -> None:
        opt = state.optimizer
        params = list(state.net.parameters())
        saved = [t.detach().clone() for t in
                 params + list(state.net.buffers())]
        had = {id(p): {k: v.clone() if torch.is_tensor(v) else v
                       for k, v in opt.state[p].items()}
               for p in params if p in opt.state}
        self.stream.wait_stream(torch.cuda.current_stream(self.trainer.device))
        with torch.cuda.stream(self.stream):
            for _ in range(WARMUP_STEPS):
                self.trainer._gen.manual_seed(0)
                self._body(state)
        torch.cuda.current_stream(self.trainer.device).wait_stream(self.stream)
        with torch.no_grad():
            for t, s in zip(params + list(state.net.buffers()), saved):
                t.copy_(s)
            for p in params:  # AdamW's moments and count as they were
                before = had.get(id(p))
                for k, v in opt.state[p].items():
                    if not torch.is_tensor(v):
                        continue
                    if before is None:
                        v.zero_()  # a fresh AdamW state is all zeros
                    else:
                        v.copy_(before[k])

    def _capture(self, state) -> None:
        state.optimizer.zero_grad(set_to_none=True)
        self.graph.register_generator_state(self.trainer._gen)
        # "thread_local": the epoch loop's feeder thread pins and copies
        # the next batches while the step is captured, which the default
        # "global" mode forbids to every thread
        with torch.cuda.graph(self.graph, stream=self.stream,
                              capture_error_mode="thread_local"):
            self.metrics, self.render = self._body(state)

    def __call__(self, state, batch: Dict[str, torch.Tensor], seed: int):
        """One replay on ``batch`` (one step's slice, on the device) with
        the dropout generator seeded by ``seed``; returns fresh copies of
        the step's metrics and render."""
        for k, dst in self.static.items():
            dst.copy_(batch[k], non_blocking=True)
        self.trainer._gen.manual_seed(seed)
        self.graph.replay()
        return ({k: v.clone() for k, v in self.metrics.items()},
                self.render.clone())
