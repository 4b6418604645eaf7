"""Checkpoints as ``torch.save`` files (counterpart of
bevrender_tpu/training/checkpoint.py, which writes Orbax directories):
``<work_dir>/best_epoch_<e>.pt`` and ``<work_dir>/last_epoch.pt`` holding
``{epoch, model, optimizer, step}``, with the same best/last naming."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import torch


def save_model(save_path: str, state: Dict[str, Any], epoch: int,
               best: bool = False) -> str:
    """Write ``state`` plus the epoch; ``best`` chooses the name."""
    name = f"best_epoch_{epoch}.pt" if best else "last_epoch.pt"
    path = Path(save_path) / name
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    torch.save({**state, "epoch": int(epoch)}, tmp)
    tmp.replace(path)
    return str(path)


def restore_model(path: str, map_location="cpu") -> Dict[str, Any]:
    """Read a checkpoint written by ``save_model``."""
    return torch.load(path, map_location=map_location, weights_only=True)


def latest_best(work_dir: str) -> Optional[str]:
    """The ``best_epoch_*`` checkpoint of the highest epoch under
    ``work_dir``."""
    bests = sorted(Path(work_dir).glob("best_epoch_*.pt"),
                   key=lambda p: int(p.stem.rsplit("_", 1)[1]))
    return str(bests[-1]) if bests else None
