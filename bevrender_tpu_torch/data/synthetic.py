"""Disk-free inputs with the dataset's sample contract (own copy of
``SyntheticDataset``, bevrender_tpu/data/dataset.py:349-396). Samples are
numpy arrays made from the seed, so the JAX package and the port can be fed
the same bytes."""

from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticDataset:
    def __init__(self, n_items: int = 32, num_views: int = 3,
                 window_num_imgs: int = 3, img_height: int = 224,
                 img_width: int = 224, map_tile: int = 224,
                 n_vehicle_types: int = 1, seed: int = 0):
        self.n = n_items
        self.num_views = num_views
        self.T = window_num_imgs + 1
        self.h = img_height
        self.w = img_width
        self.map_tile = map_tile
        self.n_types = n_vehicle_types
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 100003 + index)
        t = np.arange(self.T, dtype=np.float32)
        return {
            "timestamp": np.int64(1_700_000_000_000_000 + index * 250_000),
            "camera": rng.standard_normal(
                (self.T, self.num_views, self.h, self.w, 3), dtype=np.float32
            ),
            "map": rng.uniform(0, 1, (self.map_tile, self.map_tile, 3)).astype(
                np.float32
            ),
            "vehicle_pose": np.stack(
                [100.0 + 2.0 * t + index, 200.0 + 1.0 * t, 0.1 * t], axis=1
            ),
            "vehicle_type": np.asarray([index % self.n_types], np.int32),
        }

    def batch(self, n: int) -> Dict[str, np.ndarray]:
        """The first ``n`` samples stacked along a new batch axis."""
        items = [self[i] for i in range(n)]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}
