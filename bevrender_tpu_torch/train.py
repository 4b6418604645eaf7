"""Training entry point of the port (counterpart of bevrender_tpu/train.py):
config -> work directory and config snapshot -> seeds -> dataset from a GPS
trace and PNG frames (or synthetic data) -> optional inference split, saved
to disk -> ``Trainer.train``.

Usage::

    python -m bevrender_tpu_torch.train --config cfg.json       # a trace
    python -m bevrender_tpu_torch.train --synthetic --epochs 2  # smoke run
    python -m bevrender_tpu_torch.train --tiny --device cpu     # on the CPU
    python -m bevrender_tpu_torch.train --config cfg.json --steps-per-dispatch 4
    torchrun --nproc_per_node N -m bevrender_tpu_torch.train --config cfg.json --distributed

It runs on the GPU unless ``--device`` names another device, and raises
when there is none. ``cfg.json`` is ``Config.to_json`` output, the port's
or the JAX package's. ``Trainer.train`` trains while the epoch count plus
one is below ``--epochs``, so ``--epochs 2`` trains one epoch.
``--steps-per-dispatch K`` (K > 1) groups K batches a dispatch; on the card
each of its steps replays one captured CUDA graph of the training step.
``--distributed`` (or ``TrainConfig.distributed``) joins the process group
that ``torchrun`` describes (``parallel.dist.initialize_distributed``):
each rank trains on ``cuda:LOCAL_RANK`` over NCCL, or on the CPU over gloo
with ``--device cpu``, on its share of every global batch of
``batch_size`` rows; rank 0 names the work directory and writes the config
and the inference split. Without torchrun's environment it logs that and
trains as one process.
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def build_dataset(config, logger):
    """The ``GPSDeniedDataset`` of ``config.data``'s trace."""
    from bevrender_tpu_torch.data.dataset import GPSDeniedDataset
    from bevrender_tpu_torch.data.processor import DatasetProcessor

    dc = config.data
    processor = DatasetProcessor(
        gps_file_path=dc.gps_file_path,
        rgb_img_dir=dc.rgb_img_dir,
        map_img_dir=dc.map_img_dir,
        jgw_info=dc.map_jgw_info,
        map_width=dc.map_width,
        map_height=dc.map_height,
        window_timespin=dc.window_timespin * 1e6,  # s -> us
        window_num_imgs=dc.window_num_imgs,
        overlap=dc.overlap,
        map_resize_scale=dc.map_resize_scale,
        dataset_dir=dc.dataset_dir,
        logger=logger,
    )
    windows = processor.process_windows()
    logger.info("overlapping: %s, dataset size: %d", dc.overlap, len(windows))
    return GPSDeniedDataset(
        windows,
        mode="train",
        data_augmentation=dc.augmentation,
        num_views=dc.num_views,
        window_num_imgs=dc.window_num_imgs,
        resize_cmr_img=dc.resize_img,
        resize_img_height=dc.resize_img_height,
        resize_img_width=dc.resize_img_width,
        img_norm_mean=dc.camera_norm_mean,
        img_norm_std=dc.camera_norm_std,
        map_norm_mean=dc.map_norm_mean,
        map_norm_std=dc.map_norm_std,
        seed=config.train.seed,
        logger=logger,
        raw_uint8=dc.on_device_preprocess,
        cache_mb=dc.frame_cache_mb,
    )


def split_inf_set(n: int, ratio: float, seed: int):
    """(train indices, inference indices) of ``n`` samples: those of
    ``sklearn.model_selection.train_test_split(np.arange(n),
    test_size=ratio, random_state=seed)``, with numpy alone: a
    ``RandomState(seed)`` permutation, the first ceil(ratio * n) for
    inference, the rest for training."""
    n_test = math.ceil(ratio * n)
    if not 0 < n_test < n:
        raise ValueError(f"inf_set_ratio={ratio} leaves no train or no "
                         f"inference sample of {n}")
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]


def main(argv=None):
    from bevrender_tpu_torch import resolve_device
    from bevrender_tpu_torch.config import (Config, flagship_config,
                                            tiny_model_config)
    from bevrender_tpu_torch.data.synthetic import SyntheticDataset
    from bevrender_tpu_torch.parallel import dist as pdist
    from bevrender_tpu_torch.training.metrics import get_logger
    from bevrender_tpu_torch.training.trainer import Trainer

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", help="JSON config (Config.to_json format)")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on synthetic data (smoke run)")
    ap.add_argument("--tiny", action="store_true", help="tiny model config")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--restore", help="checkpoint path to resume from")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--steps-per-dispatch", type=int, default=None,
                    metavar="K",
                    help="TrainConfig.steps_per_dispatch: k > 1 trains k "
                         "steps a dispatch, each a CUDA graph replay on the "
                         "card")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only on request)")
    args = ap.parse_args(argv)

    logger = get_logger()
    if args.config:
        config = Config.from_json(Path(args.config).read_text())
    elif args.tiny:
        config = Config()
        config.model = tiny_model_config()
        config.data.window_num_imgs = 2
    else:
        config = flagship_config()
    if args.epochs:
        config.train.total_epochs = args.epochs
    if args.steps_per_dispatch:
        config.train.steps_per_dispatch = args.steps_per_dispatch
    if args.distributed or config.train.distributed:
        device = pdist.initialize_distributed(args.device)
    else:
        device = resolve_device(args.device)
    main_rank = pdist.is_main()

    ckpt_dir = config.train.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                                     "bevrender_ckpt")
    work_dir = Path(pdist.broadcast_object(
        str(Path(ckpt_dir) / str(int(time.time())))))
    config.train.work_dir = str(work_dir)
    if main_rank:
        work_dir.mkdir(parents=True, exist_ok=True)
        config.save_config_given_dir(str(work_dir))
        logger.info("Working directory: %s", work_dir)
        logger.info("Loss type: %s", config.train.loss_type)

    np.random.seed(config.train.seed)
    torch.manual_seed(config.train.seed)

    if args.synthetic or args.tiny:
        m = config.model
        dataset = SyntheticDataset(
            n_items=max(4 * config.train.batch_size, 16),
            num_views=m.num_views,
            window_num_imgs=config.data.window_num_imgs,
            img_height=m.img_height,
            img_width=m.img_width,
            map_tile=(224 if m.bev_shapes[-1] in (14, 28, 56)
                      else m.bev_shapes[-1] * 4),
        )
    else:
        dataset = build_dataset(config, logger)

    if config.train.split_inf_set:
        train_idx, inf_indices = split_inf_set(
            len(dataset), config.train.inf_set_ratio, config.train.seed)
        if main_rank:
            np.save(work_dir / "inference_indices.npy", inf_indices)
        dataset = _Subset(dataset, train_idx)

    trainer = Trainer(config, dataset, logger=logger, device=device)
    state = trainer.create_state(seed=config.train.seed)
    logger.info("model parameters : %.2fM",
                sum(p.numel() for p in state.net.parameters()) / 1e6)
    if args.restore:
        state = trainer.restore_checkpoint(state, args.restore)
        logger.info("restored from %s", args.restore)
    return trainer.train(state)


class _Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


if __name__ == "__main__":
    main()
