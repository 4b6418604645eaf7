"""Trainer (counterpart of bevrender_tpu/training/trainer.py): train and
eval steps, the K-fold loop, validation with recall and the best/last
checkpoint policy.

What differs from the JAX package, and why:

* the state is a ``BEVRenderNet`` and a ``torch.optim.AdamW`` over all its
  parameters (``optax.adamw`` without a mask decays every parameter too),
  updated in place, plus the step counter;
* the gradient clip follows ``optax.clip_by_global_norm``: the scale is
  ``max_norm / max(norm, max_norm)``, without the 1e-6 that
  ``torch.nn.utils.clip_grad_norm_`` adds to the denominator;
* drop path and dropout draw from one ``torch.Generator`` on the model's
  device, seeded per step from (epoch key, step) as the JAX package folds
  the step into its dropout key; the masks are not JAX's;
* the K-fold split is written with numpy and gives the folds of
  ``sklearn.model_selection.KFold(n_splits, shuffle=True, random_state=seed)``;
* ``TrainConfig.steps_per_dispatch`` > 1 selects a ``lax.scan`` over k steps
  in one dispatch there; here ``train_step_multi`` runs k steps over the
  group, each on the card one replay of a captured CUDA graph of the step
  (``training.graph_step``) and on the CPU a plain step: the same
  arithmetic as k ``train_step`` calls, with the epoch loop's grouping,
  logging and loss sums of the JAX package;
* the retrieval embedding is chosen as there: a caller's ``embed_fn``,
  else the model's trained retrieval head when
  ``ModelConfig.retrieval_embed_dim > 0`` (``use_embed_head``; its
  parameters train through autograd from both sides of the pair), else the
  flattened render; ``_embed(net, images)`` takes the live model, as
  ``_embed(variables, images)`` does there;
* kernel choice comes from ``TrainConfig.fused_bwd``, ``site_remat`` and
  ``fused_fwd_fold`` and from ``ModelConfig.site_options()``, not from
  environment variables;
* ``DataConfig.on_device_preprocess`` selects the device-side stage of
  ``data.preprocess`` (``self.preprocess``), which ``device_prefetch`` runs
  on every batch after its copy, as there;
* validation renders are written with the port's own PNG encoder and the
  log image is resized by the native library: the port needs no PIL;
* data parallelism is one process a GPU (``parallel.dist``), not a mesh:
  ``batch_size`` stays the global batch, of which each of W ranks loads
  the strided ``batch_size // W`` rows (``DataLoader(process_shard=...)``);
  the state is broadcast from rank 0; a step all-reduces the flattened
  gradients and losses once and divides by W before the clip; the
  retrieval losses run on the gathered embeddings, BatchNorm on global
  statistics and the masks on the global batch's draws, so W ranks take
  the step one process takes on the global batch. Checkpoints, validation
  images, wandb and the epoch log are rank 0's, as there.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from bevrender_tpu_torch import resolve_device
from bevrender_tpu_torch.config import Config
from bevrender_tpu_torch.data import native
from bevrender_tpu_torch.data.png import encode_png
from bevrender_tpu_torch.data.prefetch import (
    DataLoader,
    device_prefetch,
    group_batches,
)
from bevrender_tpu_torch.data.preprocess import make_preprocessor
from bevrender_tpu_torch.losses import metric as metric_losses
from bevrender_tpu_torch.losses import rendering as render_losses
from bevrender_tpu_torch.losses.recall import recall_at_k
from bevrender_tpu_torch.models.attention import set_site_options
from bevrender_tpu_torch.models.bevrender import BEVRenderNet
from bevrender_tpu_torch.models.layers import init_params, set_generator
from bevrender_tpu_torch.parallel import dist as pdist
from bevrender_tpu_torch.training import checkpoint as ckpt
from bevrender_tpu_torch.training.graph_step import GraphedStep, signature
from bevrender_tpu_torch.training.metrics import MetricsLogger, get_logger
from bevrender_tpu_torch.training.schedule import warmup_cosine_lambda


@dataclasses.dataclass
class TrainState:
    net: BEVRenderNet
    optimizer: torch.optim.Optimizer
    step: int = 0


def select_losses(loss_type: str):
    """Loss modes and implementations matched by substring of
    ``loss_type``: (image_rendering, image_retrieval, render_fn,
    retrieval_fn)."""
    image_rendering = any(
        s in loss_type for s in ("MSE", "L1", "CROSS_ENTROPY_RENDER"))
    image_retrieval = any(
        s in loss_type
        for s in ("LIFT", "TRIPLET", "CONTRASTIVE", "CROSS_ENTROPY_RTRVL"))
    render_fn = None
    if "MSE" in loss_type:
        render_fn = render_losses.mse_loss
    elif "L1" in loss_type:
        render_fn = render_losses.l1_loss
    elif "CROSS_ENTROPY_RENDER" in loss_type:
        render_fn = lambda p, t: render_losses.cross_entropy_loss(  # noqa: E731
            p, t, class_axis=-1)
    retrieval_fn = None
    if "LIFT" in loss_type:
        retrieval_fn = metric_losses.lifted_structure_loss
    elif "TRIPLET" in loss_type:
        retrieval_fn = metric_losses.triplet_loss
    elif "CONTRASTIVE" in loss_type:
        retrieval_fn = metric_losses.contrastive_loss
    elif "CROSS_ENTROPY_RTRVL" in loss_type:
        retrieval_fn = render_losses.cross_entropy_loss
    return image_rendering, image_retrieval, render_fn, retrieval_fn


def kfold_indices(n: int, n_splits: int,
                  seed: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(train indices, validation indices) per fold, both ascending: the
    folds of ``KFold(n_splits, shuffle=True, random_state=seed).split``."""
    if not 2 <= n_splits <= n:
        raise ValueError(f"k_fold={n_splits} needs 2 <= k_fold <= {n} samples")
    indices = np.arange(n)
    np.random.RandomState(seed).shuffle(indices)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    start = 0
    for size in sizes:
        mask = np.zeros(n, dtype=bool)
        mask[indices[start:start + size]] = True
        yield np.arange(n)[~mask], np.arange(n)[mask]
        start += size


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / max(norm, max_norm)`` and
    return the global norm before the clip (no host synchronisation)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, max_norm / torch.clamp(norm, min=max_norm))
    return norm


def adamw(net: torch.nn.Module, tc) -> torch.optim.AdamW:
    """AdamW over all of ``net``'s parameters with ``TrainConfig`` ``tc``'s
    rate, eps and weight decay (``optax.adamw``'s betas)."""
    return torch.optim.AdamW(net.parameters(), lr=tc.learning_rate,
                             betas=(0.9, 0.999), eps=tc.eps,
                             weight_decay=tc.weight_decay)


def _mix(*ints: int) -> int:
    """One 63-bit seed out of several integers."""
    return int(np.random.SeedSequence([int(i) for i in ints]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


class Trainer:
    """Runs on ``device`` (CUDA unless the caller names another; raises
    when there is none)."""

    def __init__(self, config: Config, train_val_dataset, logger=None, *,
                 device=None,
                 embed_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.device = resolve_device(device)
        self.config = config
        self.tc = config.train
        self.dataset = train_val_dataset
        self.logger = logger or get_logger()
        self.metrics = MetricsLogger(self.tc.use_wandb and pdist.is_main(),
                                     self.logger)
        self.use_embed_head = (embed_fn is None
                               and config.model.retrieval_embed_dim > 0)
        self.embed_fn = embed_fn or (lambda out: out.reshape(out.shape[0], -1))
        (self.image_rendering, self.image_retrieval, self.render_fn,
         self.retrieval_fn) = select_losses(self.tc.loss_type)
        if not (self.image_rendering or self.image_retrieval):
            raise ValueError(f"LOSS_TYPE selects no loss: {self.tc.loss_type}")
        self.best_epoch = 0
        self.best_epoch_loss = 1e8
        self.best_epoch_recall = 0.0
        ckpt_dir = self.tc.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                                    "bevrender_ckpt")
        # named by rank 0's clock, which every rank takes; made by rank 0
        self.work_dir = self.tc.work_dir or pdist.broadcast_object(str(
            Path(ckpt_dir) / str(int(time.time()))))
        if pdist.is_main():
            Path(self.work_dir).mkdir(parents=True, exist_ok=True)
        self._gen = torch.Generator(device=self.device)
        # k > 1 steps a dispatch on the card: each a CUDA graph replay, so
        # AdamW is capturable with its learning rate on the device
        self.graphed = (self.device.type == "cuda"
                        and self.tc.steps_per_dispatch > 1)
        self.step_graph: Optional[GraphedStep] = None
        # True: resize, split and normalise raw uint8 frames on the
        # device; "cast": uint8 -> float only; False: None
        self.preprocess = make_preprocessor(config.data)

    # ------------------------------------------------------------------
    def create_state(self, seed: int = 0, state_dict=None) -> TrainState:
        """A model on the device, from ``state_dict`` (strict) or the seeded
        initialiser, and AdamW over all of its parameters; with several
        ranks, rank 0's model on every rank."""
        net = BEVRenderNet(self.config.model)
        if state_dict is None:
            init_params(net, seed)
        else:
            net.load_state_dict(state_dict, strict=True)
        net = net.to(self.device)
        pdist.broadcast_module_(net)
        set_site_options(net, fused_bwd=self.tc.fused_bwd,
                         site_remat=self.tc.site_remat,
                         fused_fwd_fold=self.tc.fused_fwd_fold,
                         **self.config.model.site_options())
        set_generator(net, self._gen)
        optimizer = adamw(net, self.tc)
        self._conform_optimizer(optimizer)
        return TrainState(net=net, optimizer=optimizer, step=0)

    def _conform_optimizer(self, optimizer: torch.optim.Optimizer) -> None:
        """AdamW as this trainer steps it: for graphed steps ``capturable``,
        its learning rate a tensor on the device and its step counts on the
        device (where ``torch.optim`` keeps a capturable step); else a
        float rate and step counts on the CPU. Also run after loading a
        state saved in the other mode."""
        for group in optimizer.param_groups:
            group["capturable"] = self.graphed
            lr = float(group["lr"])
            group["lr"] = (torch.tensor(lr, device=self.device)
                           if self.graphed else lr)
        where = self.device if self.graphed else "cpu"
        for st in optimizer.state.values():
            if "step" in st:
                st["step"] = torch.as_tensor(st["step"]).to(
                    device=where, dtype=torch.float32)

    def set_epoch_lr(self, state: TrainState, epoch: int) -> TrainState:
        """Per-epoch warmup-cosine factor on the base learning rate (filled
        in place where the rate is a device tensor, so a captured step
        reads it)."""
        lr = self.tc.learning_rate * warmup_cosine_lambda(
            epoch, self.tc.warmup_epochs, self.tc.total_epochs)
        for group in state.optimizer.param_groups:
            if torch.is_tensor(group["lr"]):
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr
        return state

    # ------------------------------------------------------------------
    def _to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
                    ).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _embed(self, net: BEVRenderNet, images: torch.Tensor) -> torch.Tensor:
        """Retrieval embedding of renders or tiles (trainer.py:203-209):
        ``net``'s head (``use_embed_head``), else ``embed_fn``. Inside a
        step, gradients reach the head."""
        if self.use_embed_head:
            return net.embed(images)
        return self.embed_fn(images)

    def _forward_losses(self, net: BEVRenderNet, out, batch):
        parts = {}
        total = 0.0
        if self.image_rendering:
            parts["render"] = self.render_fn(out, batch["map"])
            total = total + parts["render"]
        if self.image_retrieval:
            # every rank takes the global batch's retrieval loss; the
            # render loss stays a mean over this rank's equal share
            parts["retrieval"] = self.retrieval_fn(
                pdist.all_gather_rows(self._embed(net, out)),
                pdist.all_gather_rows(self._embed(net, batch["map"])))
            total = total + parts["retrieval"]
        return total, parts

    def _step_with(self, state: TrainState, batch, rng: int, losses_fn):
        """One optimizer step with a caller-chosen loss
        ``losses_fn(net, out, batch) -> (total, parts)``: forward in train mode
        (the history passes run in eval mode without gradient), backward,
        global-norm clip, AdamW. ``rng`` is the epoch's key; the step
        counter is mixed into it for the dropout stream."""
        batch = self._to_device(batch)
        self._gen.manual_seed(_mix(rng, state.step))
        metrics, out = self._step_body(state.net, state.optimizer, batch,
                                       losses_fn)
        state.step += 1
        return state, metrics, out

    def _step_body(self, net: BEVRenderNet, opt: torch.optim.Optimizer,
                   batch, losses_fn):
        """The step's device work on a device batch, the dropout generator
        already seeded: (metrics, render). No host synchronisation, so it
        can be captured as a CUDA graph (``graph_step.GraphedStep``). In a
        process group the gradients and losses are averaged over the ranks
        with one all-reduce before the clip, which then sees the global
        gradient."""
        net.train()
        out = net(batch["camera"], batch["vehicle_pose"], batch["vehicle_type"])
        total, parts = losses_fn(net, out, batch)
        opt.zero_grad(set_to_none=True)
        total.backward()
        params = list(net.parameters())
        for p in params:  # optax updates (and decays) every parameter
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        losses = {"train_batch_loss": total.detach()}
        for k, v in parts.items():
            losses[f"train_batch_{k}_loss"] = v.detach()
        if pdist.is_initialized():
            losses = {k: v.clone() for k, v in losses.items()}
            pdist.all_reduce_mean_([p.grad for p in params]
                                   + list(losses.values()))
        grad_norm = clip_by_global_norm_([p.grad for p in params],
                                         self.tc.grad_clip_norm)
        opt.step()
        metrics = {"train_batch_loss": losses.pop("train_batch_loss"),
                   "camera_encoder_grad_norm": grad_norm, **losses}
        return metrics, out.detach()

    def train_step(self, state: TrainState, batch, rng: int = 0):
        """(state, metrics, render) after one optimizer step. Metrics are
        0-d tensors on the device: reading one synchronises."""
        return self._step_with(state, batch, rng, self._forward_losses)

    def train_step_multi(self, state: TrainState, batches, rng: int = 0):
        """k optimizer steps over a stacked (k, B, ...) super-batch
        (``_train_step_multi_impl``, trainer.py:280-306): (state, metrics
        stacked to (k,), render of the last sub-step). Each sub-step mixes
        its own step count into ``rng``, so the k steps are k
        ``train_step`` calls. On the card each sub-step is one replay of a
        CUDA graph of the step (``graph_step.GraphedStep``, captured at the
        first call for a batch shape and again when the state's tensors
        change), which needs ``steps_per_dispatch`` > 1 (a capturable
        AdamW); on the CPU each is a plain step."""
        batches = self._to_device(batches)
        k = next(iter(batches.values())).shape[0]
        per_step = []
        for i in range(k):
            batch = {key: v[i] for key, v in batches.items()}
            if self.device.type == "cuda":
                state, metrics, render = self._graph_step(state, batch, rng)
            else:
                # a fresh tensor each, as ``train_step``'s batch is: a CPU
                # kernel may sum in another order on a view at an offset
                state, metrics, render = self._step_with(
                    state, {key: v.clone() for key, v in batch.items()}, rng,
                    self._forward_losses)
            per_step.append(metrics)
        metrics = {key: torch.stack([m[key] for m in per_step])
                   for key in per_step[0]}
        return state, metrics, render

    def _graph_step(self, state: TrainState, batch, rng: int):
        if not self.graphed:
            raise ValueError("graphed steps need a capturable AdamW: set "
                             "TrainConfig.steps_per_dispatch > 1")
        graph = self.step_graph
        if (graph is None or graph.key != GraphedStep.batch_key(batch)
                or graph.signature != signature(state)):
            self.step_graph = graph = None  # free the old graph's pool first
            graph = self.step_graph = GraphedStep(self, state, batch)
        metrics, render = graph(state, batch, _mix(rng, state.step))
        state.step += 1
        return state, metrics, render

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch):
        """(metrics, camera embeddings, map embeddings, render) in eval
        mode; in a process group the metrics are the ranks' mean and the
        rest this rank's rows."""
        batch = self._to_device(batch)
        state.net.eval()
        out = state.net(batch["camera"], batch["vehicle_pose"],
                        batch["vehicle_type"])
        total, parts = self._forward_losses(state.net, out, batch)
        metrics = {"val_batch_loss": total}
        for k, v in parts.items():
            metrics[f"val_batch_{k}_loss"] = v
        if pdist.is_initialized():
            metrics = {k: v.clone() for k, v in metrics.items()}
            pdist.all_reduce_mean_(list(metrics.values()))
        return (metrics, self._embed(state.net, out),
                self._embed(state.net, batch["map"]), out)

    # ------------------------------------------------------------------
    def _run_epoch(self, state: TrainState, epoch: int, fold: int,
                   train_loader: DataLoader, val_loader: DataLoader,
                   apply_validation: bool,
                   rng: int) -> Tuple[TrainState, Dict[str, float]]:
        main = pdist.is_main()  # the one rank that logs and writes
        if main:
            self.logger.info(
                "Training epoch %d, fold %d, train batches: %d, val batches: "
                "%d", epoch, fold, len(train_loader), len(val_loader))
        train_loader.set_epoch(epoch)
        state = self.set_epoch_lr(state, epoch)
        epoch_metrics: Dict[str, float] = {}
        n_train = max(len(train_loader), 1)
        # the loss accumulates on the device; the host reads it only at the
        # logging cadence, so the launches stay ahead of the device
        tr_losses: list = []
        log_every = max(self.tc.log_every_steps, 1)
        # k > 1: k host batches a dispatch, copied to the device once; the
        # logging and image cadences then count dispatches, not steps
        k_disp = max(self.tc.steps_per_dispatch, 1)
        batch_it = iter(train_loader)
        if k_disp > 1:
            batch_it = group_batches(batch_it, k_disp)
        for idx, batch in enumerate(device_prefetch(
                batch_it, self.device, preprocess=self.preprocess)):
            if k_disp > 1:
                state, metrics, render = self.train_step_multi(state, batch,
                                                               rng)
                # metrics are (group,): the losses summed for the epoch
                # mean, the last sub-step's values logged
                tr_losses.append(metrics["train_batch_loss"].sum())
                metrics = {k: v[-1] for k, v in metrics.items()}
                last_map, last_cam = batch["map"][-1], batch["camera"][-1]
            else:
                state, metrics, render = self.train_step(state, batch, rng)
                tr_losses.append(metrics["train_batch_loss"])
                last_map, last_cam = batch["map"], batch["camera"]
            want_img = (self.image_rendering and self.metrics.run is not None
                        and idx % max(self.tc.wandb_log_img_freq_train, 1) == 0)
            if main and (idx % log_every == 0 or want_img):
                m = {k: float(v) for k, v in metrics.items()}
                self.metrics.log_batch(
                    idx, n_train, m["train_batch_loss"],
                    m.get("train_batch_render_loss"),
                    m.get("train_batch_retrieval_loss"),
                    m.get("camera_encoder_grad_norm"))
                lr = float(state.optimizer.param_groups[0]["lr"])
                self.metrics.log({**m, "learning_rate": lr, "epoch": epoch})
            if want_img:
                # the render of the train step itself (drop path active)
                img = self.get_log_image(
                    render[0].float().cpu().numpy(),
                    np.asarray(last_map[0].cpu()),
                    np.asarray(last_cam[0, -1].cpu()))
                self.metrics.log_image("train_image", img,
                                       f"train epoch {epoch}", epoch)
        epoch_metrics["train_epoch_loss"] = (
            float(torch.stack(tr_losses).sum()) / n_train if tr_losses else 0.0)

        run_val = (apply_validation
                   and (epoch + 1) % self.tc.validation_frequency == 0)
        if run_val:
            val_loss = 0.0
            cam_embs: List[torch.Tensor] = []
            map_embs: List[torch.Tensor] = []
            n_val = max(len(val_loader), 1)
            for idx, batch in enumerate(device_prefetch(
                    iter(val_loader), self.device,
                    preprocess=self.preprocess)):
                metrics, cam_e, map_e, val_out = self.eval_step(state, batch)
                val_loss += float(metrics["val_batch_loss"]) / n_val
                if self.image_retrieval:  # the global batch's rows
                    cam_embs.append(pdist.all_gather_rows(cam_e).float().cpu())
                    map_embs.append(pdist.all_gather_rows(map_e).float().cpu())
                self.metrics.log(
                    {**{k: float(v) for k, v in metrics.items()}, "epoch": epoch})
                if (self.image_rendering and self.metrics.run is not None
                        and idx % max(self.tc.wandb_log_img_freq_val, 1) == 0):
                    img = self.get_log_image(
                        val_out[0].float().cpu().numpy(),
                        np.asarray(batch["map"][0].cpu()),
                        np.asarray(batch["camera"][0, -1].cpu()))
                    self.metrics.log_image("val_image", img,
                                           f"val epoch {epoch}", epoch)
            epoch_metrics["val_epoch_loss"] = val_loss

            if self.image_retrieval and cam_embs:
                r1, r5, r10 = (float(r) for r in recall_at_k(
                    _l2n(torch.cat(cam_embs)), _l2n(torch.cat(map_embs)),
                    (1, 5, 10)))
                recalls = {"val_R@1": r1, "val_R@5": r5, "val_R@10": r10}
                epoch_metrics.update(recalls)
                self.metrics.log({**recalls, "epoch": epoch})

            # rank 0's numbers decide the best epoch on every rank
            val_loss, r5 = pdist.broadcast_object(
                (val_loss, epoch_metrics.get("val_R@5", 0.0)))
            is_best = False
            if self.tc.validation_metric == "LOSS":
                if val_loss < self.best_epoch_loss:
                    self.best_epoch_loss = val_loss
                    self.best_epoch = epoch
                    is_best = True
            elif self.tc.validation_metric == "RECALL":
                if r5 > self.best_epoch_recall:
                    self.best_epoch_recall = r5
                    self.best_epoch = epoch
                    is_best = True
            if self.tc.save_ckpt and main:
                self.save_checkpoint(state, epoch, best=is_best)
            if is_best and self.tc.save_val_results and main:
                self.save_val_images(state, val_loader, epoch)

        if main:
            self.logger.info(
                "Summary of epoch %d/%d - training loss: %.8f%s", epoch,
                self.tc.total_epochs, epoch_metrics["train_epoch_loss"],
                (f",  validation loss: {epoch_metrics['val_epoch_loss']:.8f}"
                 if run_val else ""))
        return state, epoch_metrics

    # ------------------------------------------------------------------
    def train(self, state: TrainState, apply_validation: Optional[bool] = None,
              rng: Optional[int] = None,
              max_epochs: Optional[int] = None) -> TrainState:
        """K-fold outer loop: fresh folds, ``epoch_per_fold`` epochs per
        fold, until ``total_epochs``. With W ranks each loads the strided
        ``batch_size // W`` rows of every global batch, which needs
        ``batch_size`` to be a positive multiple of W."""
        apply_validation = (self.tc.apply_validation
                            if apply_validation is None else apply_validation)
        rng = self.tc.seed if rng is None else rng
        total = max_epochs or self.tc.total_epochs
        world = pdist.world_size()
        if self.tc.batch_size % world or self.tc.batch_size < world:
            raise ValueError(
                f"batch_size={self.tc.batch_size} must be a positive "
                f"multiple of world_size={world} (each process feeds "
                f"batch_size/world_size rows of the global batch)")
        shard = (pdist.rank(), world) if world > 1 else None
        per_rank = self.tc.batch_size // world
        num_epoch = 0
        while num_epoch + 1 < total:
            for fold, (train_idx, val_idx) in enumerate(kfold_indices(
                    len(self.dataset), self.tc.k_fold, self.tc.seed)):
                train_loader = DataLoader(
                    self.dataset, per_rank, shuffle=True,
                    num_workers=self.tc.num_workers, drop_last=True,
                    seed=self.tc.seed, sampler=train_idx,
                    process_shard=shard)
                val_loader = DataLoader(
                    self.dataset, per_rank, shuffle=False,
                    num_workers=self.tc.num_workers, drop_last=True,
                    sampler=val_idx, process_shard=shard)
                for _ in range(self.tc.epoch_per_fold):
                    state, _ = self._run_epoch(
                        state, num_epoch, fold, train_loader, val_loader,
                        apply_validation, _mix(rng, num_epoch))
                    num_epoch += 1
                    if num_epoch + 1 >= total:
                        return state
        return state

    # ------------------------------------------------------------------
    def save_checkpoint(self, state: TrainState, epoch: int,
                        best: bool = False) -> str:
        path = ckpt.save_model(
            self.work_dir,
            {"model": state.net.state_dict(),
             "optimizer": state.optimizer.state_dict(), "step": state.step},
            epoch, best=best)
        self.logger.info("model saved at epoch %d -> %s", epoch, path)
        return path

    def restore_checkpoint(self, state: TrainState, path: str) -> TrainState:
        """Load model and optimizer; the step counter (which seeds the
        dropout stream) is recovered from the optimizer's own update count,
        so a resumed run continues the stream instead of replaying it.
        With several ranks, rank 0's model and AdamW tensors on the device
        are then every rank's."""
        restored = ckpt.restore_model(path, map_location=self.device)
        state.net.load_state_dict(restored["model"], strict=True)
        state.optimizer.load_state_dict(restored["optimizer"])
        self._conform_optimizer(state.optimizer)
        pdist.broadcast_module_(state.net)
        pdist.broadcast_tensors_([
            v for st in state.optimizer.state.values() for v in st.values()
            if torch.is_tensor(v) and v.device.type == self.device.type])
        steps = [int(s["step"]) for s in state.optimizer.state.values()
                 if "step" in s]
        state.step = max(steps, default=0)
        return state

    @torch.no_grad()
    def save_val_images(self, state: TrainState, val_loader, epoch: int) -> None:
        """Write the best epoch's validation renders as PNGs. A rank's
        loader (``process_shard``) is widened to the whole validation set,
        which this rank renders alone: eval mode runs no collective."""
        out_dir = Path(self.work_dir) / "best_epoch_val"
        out_dir.mkdir(parents=True, exist_ok=True)
        if val_loader.process_shard is not None:
            val_loader = DataLoader(
                self.dataset, val_loader.batch_size * val_loader.process_shard[1],
                shuffle=False, num_workers=val_loader.num_workers,
                drop_last=val_loader.drop_last, sampler=val_loader.sampler)
        state.net.eval()
        for batch in device_prefetch(iter(val_loader), self.device,
                                     preprocess=self.preprocess):
            out = state.net(batch["camera"], batch["vehicle_pose"],
                            batch["vehicle_type"])
            for render, ts in zip(out.float().cpu().numpy(),
                                  np.asarray(batch["timestamp"].cpu())):
                img = (np.clip(render, 0, 1) * 255).astype(np.uint8)
                encode_png(out_dir / f"{int(ts)}.png", img)
        self.logger.info("val images saved at epoch %d -> %s", epoch, out_dir)

    @staticmethod
    def get_log_image(render: np.ndarray, map_tile: np.ndarray,
                      cameras: np.ndarray) -> np.ndarray:
        """Composite: the camera views in one row above [map | zeros |
        render]. All inputs NHWC float; the camera row is resized by the
        native triangle filter (PIL's BILINEAR within 2 levels)."""

        def norm(x):
            lo, hi = x.min(), x.max()
            return (x - lo) / max(hi - lo, 1e-8)

        h = render.shape[0]
        bottom = np.concatenate(
            [norm(map_tile), np.zeros_like(map_tile), np.clip(render, 0, 1)],
            axis=1)
        wide = np.concatenate(list(norm(cameras)), axis=1)
        wide = native.resize_u8((wide * 255).astype(np.uint8), h,
                                bottom.shape[1]).astype(np.float32) / 255.0
        return np.concatenate([wide, bottom], axis=0)
