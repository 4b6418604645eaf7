"""Full geo-map loading (counterpart of bevrender_tpu/data/maploader.py):
one geo-referenced aerial map PNG by month key, cut into the tile database
of render+register serving. Decoded by the port's native library
(``data/native.py``)."""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from bevrender_tpu_torch.data import native


class MapLoader:
    def __init__(self, map_path: Dict[str, str], map_month: str, logger=None):
        self.map_dir = map_path[map_month]
        self.logger = logger

    def get_map_array(self, normalize_or_not: bool = True) -> np.ndarray:
        """The whole map, (H, W, 3): float32 in [0, 1], or uint8."""
        img = native.decode_png(self.map_dir)
        return img.astype(np.float32) / 255.0 if normalize_or_not else img

    def get_map_img(self) -> np.ndarray:
        """The map as decoded, uint8 (H, W, 3) (there is no PIL image)."""
        return self.get_map_array(normalize_or_not=False)

    def iter_tiles(self, tile: int = 224, stride: Optional[int] = None,
                   normalize: bool = True
                   ) -> Iterator[Tuple[Tuple[int, int], np.ndarray]]:
        """((pixel_y, pixel_x), tile) over a regular grid, row by row."""
        stride = stride or tile
        arr = self.get_map_array(normalize)
        h, w = arr.shape[:2]
        for y in range(0, h - tile + 1, stride):
            for x in range(0, w - tile + 1, stride):
                yield (y, x), arr[y:y + tile, x:x + tile]
