"""Logging, with wandb when it is installed and asked for (counterpart of
bevrender_tpu/training/metrics.py). Metric names: ``train_batch_loss``,
``train_batch_render_loss``, ``train_batch_retrieval_loss``,
``learning_rate``, ``camera_encoder_grad_norm``, ``train_epoch_loss``,
``val_batch_*``, ``val_epoch_loss``, ``val_R@1/5/10``, ``epoch``."""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional


def get_logger() -> logging.Logger:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(filename)-22s:%(lineno)3d] %(message)s",
        datefmt="%Y-%m-%d:%H:%M:%S",
    )
    return logging.getLogger("bevrender_tpu_torch")


class MetricsLogger:
    """wandb if available and enabled, always the Python logger."""

    def __init__(self, use_wandb: bool, logger: Optional[logging.Logger] = None,
                 project: str = "bev"):
        self.logger = logger or get_logger()
        self.run = None
        if use_wandb:
            try:
                import wandb

                self.run = wandb.init(project=project)
            except Exception as e:  # wandb missing or offline
                self.logger.warning("wandb unavailable (%s); logging locally", e)

    def log(self, metrics: Dict[str, Any]) -> None:
        if self.run is not None:
            self.run.log(metrics)

    def log_image(self, key: str, image, caption: str, epoch: int) -> None:
        """One composite image to wandb; nothing without a run."""
        if self.run is None:
            return
        import wandb

        self.run.log({key: wandb.Image(image, caption=caption), "epoch": epoch})

    def log_batch(self, idx: int, num_batches: int, total_loss: float,
                  render_loss: Optional[float] = None,
                  retrieval_loss: Optional[float] = None,
                  camera_grad_norm: Optional[float] = None) -> None:
        s = f"step: {idx:3d}/{num_batches:3d},"
        if render_loss is not None:
            s += f" render_ls {render_loss:4.6f},"
        if retrieval_loss is not None:
            s += f" retrvl_ls {retrieval_loss:4.6f},"
        s += f" total_ls {total_loss:4.6f},"
        if camera_grad_norm is not None:
            s += f" cmr_grad {camera_grad_norm:6.4f},"
        self.logger.info(s)
