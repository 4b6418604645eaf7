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
  in one dispatch there; here it runs k plain steps, which is the same
  arithmetic;
* the retrieval embedding is the flattened render or a caller's
  ``embed_fn``; the trained retrieval head is not ported yet;
* kernel choice for the training pass comes from ``TrainConfig.fused_bwd``
  and ``TrainConfig.site_remat``, not from environment variables.
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
from bevrender_tpu_torch.data.prefetch import DataLoader, device_prefetch
from bevrender_tpu_torch.losses import metric as metric_losses
from bevrender_tpu_torch.losses import rendering as render_losses
from bevrender_tpu_torch.losses.recall import recall_at_k
from bevrender_tpu_torch.models.attention import set_site_options
from bevrender_tpu_torch.models.bevrender import BEVRenderNet
from bevrender_tpu_torch.models.layers import init_params, set_generator
from bevrender_tpu_torch.training import checkpoint as ckpt
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
        self.metrics = MetricsLogger(self.tc.use_wandb, self.logger)
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
        self.work_dir = self.tc.work_dir or str(
            Path(ckpt_dir) / str(int(time.time())))
        Path(self.work_dir).mkdir(parents=True, exist_ok=True)
        self._gen = torch.Generator(device=self.device)

    # ------------------------------------------------------------------
    def create_state(self, seed: int = 0, state_dict=None) -> TrainState:
        """A model on the device, from ``state_dict`` (strict) or the seeded
        initialiser, and AdamW over all of its parameters."""
        net = BEVRenderNet(self.config.model)
        if state_dict is None:
            init_params(net, seed)
        else:
            net.load_state_dict(state_dict, strict=True)
        net = net.to(self.device)
        set_site_options(net, fused_bwd=self.tc.fused_bwd,
                         site_remat=self.tc.site_remat)
        set_generator(net, self._gen)
        optimizer = torch.optim.AdamW(
            net.parameters(), lr=self.tc.learning_rate, betas=(0.9, 0.999),
            eps=self.tc.eps, weight_decay=self.tc.weight_decay)
        return TrainState(net=net, optimizer=optimizer, step=0)

    def set_epoch_lr(self, state: TrainState, epoch: int) -> TrainState:
        """Per-epoch warmup-cosine factor on the base learning rate."""
        lr = self.tc.learning_rate * warmup_cosine_lambda(
            epoch, self.tc.warmup_epochs, self.tc.total_epochs)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        return state

    # ------------------------------------------------------------------
    def _to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
                    ).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _forward_losses(self, out, batch):
        parts = {}
        total = 0.0
        if self.image_rendering:
            parts["render"] = self.render_fn(out, batch["map"])
            total = total + parts["render"]
        if self.image_retrieval:
            parts["retrieval"] = self.retrieval_fn(
                self.embed_fn(out), self.embed_fn(batch["map"]))
            total = total + parts["retrieval"]
        return total, parts

    def _step_with(self, state: TrainState, batch, rng: int, losses_fn):
        """One optimizer step with a caller-chosen loss
        ``losses_fn(out, batch) -> (total, parts)``: forward in train mode
        (the history passes run in eval mode without gradient), backward,
        global-norm clip, AdamW. ``rng`` is the epoch's key; the step
        counter is mixed into it for the dropout stream."""
        batch = self._to_device(batch)
        net, opt = state.net, state.optimizer
        net.train()
        self._gen.manual_seed(_mix(rng, state.step))
        out = net(batch["camera"], batch["vehicle_pose"], batch["vehicle_type"])
        total, parts = losses_fn(out, batch)
        opt.zero_grad(set_to_none=True)
        total.backward()
        params = list(net.parameters())
        for p in params:  # optax updates (and decays) every parameter
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grad_norm = clip_by_global_norm_([p.grad for p in params],
                                         self.tc.grad_clip_norm)
        opt.step()
        state.step += 1
        metrics = {"train_batch_loss": total.detach(),
                   "camera_encoder_grad_norm": grad_norm}
        for k, v in parts.items():
            metrics[f"train_batch_{k}_loss"] = v.detach()
        return state, metrics, out.detach()

    def train_step(self, state: TrainState, batch, rng: int = 0):
        """(state, metrics, render) after one optimizer step. Metrics are
        0-d tensors on the device: reading one synchronises."""
        return self._step_with(state, batch, rng, self._forward_losses)

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch):
        """(metrics, camera embeddings, map embeddings, render) in eval
        mode."""
        batch = self._to_device(batch)
        state.net.eval()
        out = state.net(batch["camera"], batch["vehicle_pose"],
                        batch["vehicle_type"])
        total, parts = self._forward_losses(out, batch)
        metrics = {"val_batch_loss": total}
        for k, v in parts.items():
            metrics[f"val_batch_{k}_loss"] = v
        return metrics, self.embed_fn(out), self.embed_fn(batch["map"]), out

    # ------------------------------------------------------------------
    def _run_epoch(self, state: TrainState, epoch: int, fold: int,
                   train_loader: DataLoader, val_loader: DataLoader,
                   apply_validation: bool,
                   rng: int) -> Tuple[TrainState, Dict[str, float]]:
        self.logger.info(
            "Training epoch %d, fold %d, train batches: %d, val batches: %d",
            epoch, fold, len(train_loader), len(val_loader))
        train_loader.set_epoch(epoch)
        state = self.set_epoch_lr(state, epoch)
        epoch_metrics: Dict[str, float] = {}
        n_train = max(len(train_loader), 1)
        # the loss accumulates on the device; the host reads it only at the
        # logging cadence, so the launches stay ahead of the device
        tr_losses: list = []
        log_every = max(self.tc.log_every_steps, 1)
        for idx, batch in enumerate(device_prefetch(iter(train_loader),
                                                    self.device)):
            state, metrics, render = self.train_step(state, batch, rng)
            tr_losses.append(metrics["train_batch_loss"])
            want_img = (self.image_rendering and self.metrics.run is not None
                        and idx % max(self.tc.wandb_log_img_freq_train, 1) == 0)
            if idx % log_every == 0 or want_img:
                m = {k: float(v) for k, v in metrics.items()}
                self.metrics.log_batch(
                    idx, n_train, m["train_batch_loss"],
                    m.get("train_batch_render_loss"),
                    m.get("train_batch_retrieval_loss"),
                    m.get("camera_encoder_grad_norm"))
                lr = state.optimizer.param_groups[0]["lr"]
                self.metrics.log({**m, "learning_rate": lr, "epoch": epoch})
            if want_img:
                # the render of the train step itself (drop path active)
                img = self.get_log_image(
                    render[0].float().cpu().numpy(),
                    np.asarray(batch["map"][0].cpu()),
                    np.asarray(batch["camera"][0, -1].cpu()))
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
            for idx, batch in enumerate(device_prefetch(iter(val_loader),
                                                        self.device)):
                metrics, cam_e, map_e, val_out = self.eval_step(state, batch)
                val_loss += float(metrics["val_batch_loss"]) / n_val
                if self.image_retrieval:
                    cam_embs.append(cam_e.float().cpu())
                    map_embs.append(map_e.float().cpu())
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

            is_best = False
            if self.tc.validation_metric == "LOSS":
                if val_loss < self.best_epoch_loss:
                    self.best_epoch_loss = val_loss
                    self.best_epoch = epoch
                    is_best = True
            elif self.tc.validation_metric == "RECALL":
                r5 = epoch_metrics.get("val_R@5", 0.0)
                if r5 > self.best_epoch_recall:
                    self.best_epoch_recall = r5
                    self.best_epoch = epoch
                    is_best = True
            if self.tc.save_ckpt:
                self.save_checkpoint(state, epoch, best=is_best)
            if is_best and self.tc.save_val_results:
                self.save_val_images(state, val_loader, epoch)

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
        fold, until ``total_epochs``."""
        apply_validation = (self.tc.apply_validation
                            if apply_validation is None else apply_validation)
        rng = self.tc.seed if rng is None else rng
        total = max_epochs or self.tc.total_epochs
        num_epoch = 0
        while num_epoch + 1 < total:
            for fold, (train_idx, val_idx) in enumerate(kfold_indices(
                    len(self.dataset), self.tc.k_fold, self.tc.seed)):
                train_loader = DataLoader(
                    self.dataset, self.tc.batch_size, shuffle=True,
                    num_workers=self.tc.num_workers, drop_last=True,
                    seed=self.tc.seed, sampler=train_idx)
                val_loader = DataLoader(
                    self.dataset, self.tc.batch_size, shuffle=False,
                    num_workers=self.tc.num_workers, drop_last=True,
                    sampler=val_idx)
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
             "optimizer": state.optimizer.state_dict()},
            epoch, best=best)
        self.logger.info("model saved at epoch %d -> %s", epoch, path)
        return path

    def restore_checkpoint(self, state: TrainState, path: str) -> TrainState:
        """Load model and optimizer; the step counter (which seeds the
        dropout stream) is recovered from the optimizer's own update count,
        so a resumed run continues the stream instead of replaying it."""
        restored = ckpt.restore_model(path, map_location=self.device)
        state.net.load_state_dict(restored["model"], strict=True)
        state.optimizer.load_state_dict(restored["optimizer"])
        steps = [int(s["step"]) for s in state.optimizer.state.values()
                 if "step" in s]
        state.step = max(steps, default=0)
        return state

    def save_val_images(self, state: TrainState, val_loader, epoch: int) -> None:
        """Write the best epoch's validation renders as PNGs."""
        from PIL import Image

        out_dir = Path(self.work_dir) / "best_epoch_val"
        out_dir.mkdir(parents=True, exist_ok=True)
        for batch in device_prefetch(iter(val_loader), self.device):
            _, _, _, out = self.eval_step(state, batch)
            for render, ts in zip(out.float().cpu().numpy(),
                                  np.asarray(batch["timestamp"].cpu())):
                img = (np.clip(render, 0, 1) * 255).astype(np.uint8)
                Image.fromarray(img).save(out_dir / f"{int(ts)}.png")
        self.logger.info("val images saved at epoch %d -> %s", epoch, out_dir)

    @staticmethod
    def get_log_image(render: np.ndarray, map_tile: np.ndarray,
                      cameras: np.ndarray) -> np.ndarray:
        """Composite: the camera views in one row above [map | zeros |
        render]. All inputs NHWC float."""
        from PIL import Image

        def norm(x):
            lo, hi = x.min(), x.max()
            return (x - lo) / max(hi - lo, 1e-8)

        h = render.shape[0]
        bottom = np.concatenate(
            [norm(map_tile), np.zeros_like(map_tile), np.clip(render, 0, 1)],
            axis=1)
        wide = np.concatenate(list(norm(cameras)), axis=1)
        wide = np.asarray(
            Image.fromarray((wide * 255).astype(np.uint8)).resize(
                (bottom.shape[1], h), Image.BILINEAR),
            dtype=np.float32) / 255.0
        return np.concatenate([wide, bottom], axis=0)
