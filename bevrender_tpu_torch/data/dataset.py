"""Window dataset and host image pipeline (counterpart of
bevrender_tpu/data/dataset.py): ``_ByteLRU``, ``Augmenter``,
``GPSDeniedDataset`` and ``SyntheticGeoDataset``, with the same samples bit
for bit. ``SyntheticDataset`` is in ``data/synthetic.py``.

``GPSDeniedDataset.__getitem__``: randomly subsample ``window_num_imgs``
history frames from the window and always keep its last frame as the
current one (T = window_num_imgs + 1 in train and validation; the whole
window in inference); decode one wide image a frame, resize, split into
``num_views`` views, scale to [0, 1] and normalise by mean and std; decode
the last frame's aerial map tile and scale it to [0, 1] only. A sample is
``{timestamp, camera (T, V, Hv, Wv, 3), map (Hm, Wm, 3), vehicle_pose
(T, 3) rows (x_pix, y_pix, yaw), vehicle_type (1,)}``, NHWC.

Where the JAX package decodes through libpng or PIL and resizes small
frames through PIL, every decode and resize here is the port's native
library (``data/native.py``), at every frame size.
"""

from __future__ import annotations

import collections
import random
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from bevrender_tpu_torch.data import native
from bevrender_tpu_torch.data.processor import (
    REC_MAP_PATH,
    REC_PIXEL_X,
    REC_PIXEL_Y,
    REC_RGB_PATH,
    REC_TIMESTAMP,
    REC_VEHICLE_TYPE,
    REC_YAW,
)


class _ByteLRU:
    """Byte-capped, thread-safe LRU of numpy arrays keyed by path.

    A frame recurs in every window it belongs to and again each epoch;
    caching the decoded (and, for camera frames, resized) uint8 frame skips
    its repeat decodes. The byte cap bounds residency on long traces; the
    lock serves the loader's thread pool. Cached arrays are read-only, so
    a caller that writes into one raises instead of corrupting every later
    hit.
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._data: "collections.OrderedDict[str, np.ndarray]" = (
            collections.OrderedDict())
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Optional[np.ndarray]:
        with self._lock:
            arr = self._data.get(key)
            if arr is None:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return arr

    def put(self, key: str, arr: np.ndarray) -> None:
        if arr.nbytes > self.max_bytes:
            return
        arr.flags.writeable = False
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._data[key] = arr
            self._bytes += arr.nbytes
            while self._bytes > self.max_bytes:
                _, evicted = self._data.popitem(last=False)
                self._bytes -= evicted.nbytes


class Augmenter:
    """Seeded numpy augmentations of the reference's menus (none, weak,
    strong), as the JAX package's: brightness, contrast and saturation
    jitter in one multiplicative pass with one final clip (no hue jitter),
    RandomGrayscale(p=0.2), and for "strong" RandomPosterize(p=0.2,
    bits=4)."""

    def __init__(self, kind: str, rng: random.Random):
        if kind not in ("none", "weak", "strong"):
            raise RuntimeError("wrong data augmentation type!")
        self.kind = kind
        self.rng = rng

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if self.kind == "none":
            return img
        jitter = 0.2 if self.kind == "strong" else 0.1
        img = img.astype(np.float32)
        img = img * self.rng.uniform(1 - jitter, 1 + jitter)
        mean = img.mean()
        img = (img - mean) * self.rng.uniform(1 - jitter, 1 + jitter) + mean
        gray = img.mean(axis=-1, keepdims=True)
        img = (img - gray) * self.rng.uniform(1 - jitter, 1 + jitter) + gray
        img = np.clip(img, 0, 255)
        if self.rng.random() < 0.2:
            img = np.broadcast_to(img.mean(axis=-1, keepdims=True), img.shape)
        if self.kind == "strong" and self.rng.random() < 0.2:
            img = np.floor(img / 16.0) * 16.0
        return img.astype(np.uint8)


class GPSDeniedDataset:
    """Map-style dataset over temporal windows (records of
    ``data.processor``)."""

    def __init__(
        self,
        datalist: List[List[list]],
        mode: str = "train",
        data_augmentation: str = "none",
        num_views: int = 3,
        window_num_imgs: int = 3,
        resize_cmr_img: bool = True,
        resize_img_height: int = 224,
        resize_img_width: int = 672,
        img_norm_mean: Sequence[float] = (0.485, 0.456, 0.406),
        img_norm_std: Sequence[float] = (0.229, 0.224, 0.225),
        map_norm_mean: Sequence[float] = (0.485, 0.456, 0.406),
        map_norm_std: Sequence[float] = (0.229, 0.224, 0.225),
        map_tile: int = 224,
        seed: int = 0,
        logger=None,
        raw_uint8: bool = False,
        cache_mb: int = 256,
    ):
        """``raw_uint8=True`` keeps only decode (and augmentation) on the
        host and returns uint8 wide frames at their source size and uint8
        map tiles; resize, view split and normalisation then run on the
        device (``data.preprocess``). ``cache_mb`` caps the decoded-frame
        cache in MiB; 0 turns it off. The map is scaled to [0, 1] only:
        ``map_norm_mean`` and ``map_norm_std`` are accepted and unused, as
        in the reference, whose map normalisation is disabled."""
        self.datalist = datalist
        self.raw_uint8 = raw_uint8
        self.mode = mode
        self.num_views = num_views
        self.window_num_imgs = window_num_imgs
        self.resize_cmr_img = resize_cmr_img
        self.resize_img_height = resize_img_height
        self.resize_img_width = resize_img_width
        self.img_norm_mean = np.asarray(img_norm_mean, np.float32)
        self.img_norm_std = np.asarray(img_norm_std, np.float32)
        self.map_tile = map_tile
        self.rng = random.Random(seed)
        self.augment = Augmenter(data_augmentation, self.rng)
        self.cache = _ByteLRU(cache_mb << 20) if cache_mb > 0 else None

    def __len__(self) -> int:
        return len(self.datalist)

    def _cached(self, path: str, load) -> np.ndarray:
        if self.cache is not None:
            hit = self.cache.get(path)
            if hit is not None:
                return hit
        img = load(path)
        if self.cache is not None:
            self.cache.put(path, img)
        return img

    def _decode_cached(self, path: str) -> np.ndarray:
        """A frame or tile at its source size, through the cache."""
        return self._cached(path, native.decode_png)

    def _load_wide_image(self, path: str) -> np.ndarray:
        """A camera frame decoded and resized to uint8, through the cache
        (which keeps the resized frame: a hit skips decode and resize)."""
        if not self.resize_cmr_img:
            return self._decode_cached(path)
        return self._cached(path, lambda p: native.decode_png_resize_u8(
            p, self.resize_img_height, self.resize_img_width))

    def _frame_views(self, path: str) -> np.ndarray:
        """A camera frame -> (V, Hv, Wv, 3) float32 normalised views. With
        the cache off and no augmentation, one native call from file to
        views; else the cached uint8 frame, augmented, then split and
        normalised in one native pass."""
        if (self.cache is None and self.augment.kind == "none"
                and self.resize_cmr_img):
            return native.decode_png_views(
                path, self.num_views, self.resize_img_height,
                self.resize_img_width, self.img_norm_mean, self.img_norm_std)
        img = self.augment(self._load_wide_image(path))
        h, w, _ = img.shape
        return native.fused_views(img, self.num_views, h, w,
                                  self.img_norm_mean, self.img_norm_std)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        window = self.datalist[index]
        if self.mode in ("train", "validation"):
            take = sorted(
                self.rng.sample(range(len(window) - 1), self.window_num_imgs))
            frames = [window[i] for i in take] + [window[-1]]
        else:  # inference: the whole window
            frames = list(window)

        if self.raw_uint8:
            cameras = np.stack([
                self.augment(self._decode_cached(fr[REC_RGB_PATH]))
                for fr in frames])  # (T, Hw, Ww, 3) uint8
            map_img = self._decode_cached(frames[-1][REC_MAP_PATH])
        else:
            cameras = np.stack([self._frame_views(fr[REC_RGB_PATH])
                                for fr in frames])
            map_img = native.to_unit_f32(
                self._decode_cached(frames[-1][REC_MAP_PATH]))
        poses = np.stack([
            np.asarray([fr[REC_PIXEL_X], fr[REC_PIXEL_Y], fr[REC_YAW]],
                       np.float32)
            for fr in frames])
        return {
            "timestamp": np.int64(frames[-1][REC_TIMESTAMP]),
            "camera": cameras,  # (T, V, Hv, Wv, 3)
            "map": map_img,  # (Hm, Wm, 3)
            "vehicle_pose": poses,  # (T, 3)
            "vehicle_type": np.asarray([frames[-1][REC_VEHICLE_TYPE]],
                                       np.int32),
        }


class SyntheticGeoDataset:
    """Geo-consistent synthetic trace: camera views and aerial map tiles are
    carved from ONE shared world image, so pose retrieval is *learnable* —
    the render+register loop (train.py:551-572) can be validated end to end
    without the (unshipped) off-road trace.

    A smooth random world map is generated; sample ``i`` sits at pose ``p_i``
    on a trace. Its aerial tile is the world crop at ``p_i``; its camera
    views are overlapping world crops around ``p_i`` (one per view, offset
    like a surround rig) with additive noise, and history frames come from
    the earlier trace poses. A model that learns to render the aerial view
    from the cameras will therefore beat chance at recall@K against the tile
    database.
    """

    def __init__(
        self,
        n_items: int = 16,
        num_views: int = 2,
        window_num_imgs: int = 1,
        img_height: int = 32,
        img_width: int = 32,
        map_tile: int = 32,
        world: int = 256,
        noise: float = 0.05,
        seed: int = 0,
        raw_uint8: bool = False,
        detail: float = 0.0,
    ):
        """``raw_uint8=True`` emits camera/map quantized to uint8 (the views
        are already final-shaped, so pair with
        ``DataConfig.on_device_preprocess = "cast"`` — the host->device
        transfer shrinks 4x, which is the input bottleneck on
        host-bandwidth-limited links)."""
        self.n = n_items
        self.num_views = num_views
        self.T = window_num_imgs + 1
        self.h = img_height
        self.w = img_width
        self.map_tile = map_tile
        self.noise = noise
        self.seed = seed
        self.raw_uint8 = raw_uint8
        rng = np.random.default_rng(seed)

        # smooth world: low-res noise, bilinear-upsampled
        def _octave(res: int) -> np.ndarray:
            low = rng.standard_normal((res, res, 3)).astype(np.float32)
            ys = np.linspace(0, res - 1, world)
            xs = np.linspace(0, res - 1, world)
            y0 = np.floor(ys).astype(int); x0 = np.floor(xs).astype(int)
            y1 = np.minimum(y0 + 1, res - 1)
            x1 = np.minimum(x0 + 1, res - 1)
            wy = (ys - y0)[:, None, None]; wx = (xs - x0)[None, :, None]
            return (low[y0][:, x0] * (1 - wy) * (1 - wx)
                    + low[y0][:, x1] * (1 - wy) * wx
                    + low[y1][:, x0] * wy * (1 - wx)
                    + low[y1][:, x1] * wy * wx)

        up = _octave(world // 16)
        if detail > 0.0:
            # mid-frequency octave: without it a map_tile-sized crop spans
            # only ~2 base-octave pixels, so tiles are near-duplicates
            # (measured mean inter-tile MSE 0.013 at the defaults) and no
            # render accuracy can separate them at recall time — tests that
            # assert retrieval learning need distinctive tiles
            up = up + detail * _octave(world // 4)
        up = (up - up.min()) / max(up.max() - up.min(), 1e-6)
        self.world_img = up  # (world, world, 3) in [0, 1]
        # a trace with margins for the crops
        m = map_tile + img_height
        if world < 2 * m + 8:
            raise ValueError(
                f"world={world} too small for map_tile={map_tile} + "
                f"img_height={img_height}: the trace span [m, world-m] with "
                f"m={m} collapses (all poses/tiles identical -> retrieval "
                f"unlearnable); use world >= {2 * m + 8}"
            )
        self.trace = np.stack([
            np.linspace(m, world - m, n_items),
            m + (world - 2 * m) * 0.5 * (1 + np.sin(np.linspace(0, 3, n_items))),
            np.linspace(0, 0.5, n_items),
        ], axis=1).astype(np.float32)

    def __len__(self):
        return self.n

    def _crop(self, cy, cx, size):
        y = int(round(cy)) - size // 2
        x = int(round(cx)) - size // 2
        return self.world_img[y : y + size, x : x + size]

    def _views_at(self, i, rng):
        # views overlap the aerial tile (a surround rig sees the ground the
        # tile covers) — small offsets keep the task learnable
        offs = np.linspace(-self.h / 4, self.h / 4, self.num_views)
        cy, cx, _ = self.trace[i]
        views = []
        for o in offs:
            v = self._crop(cy + o * 0.5, cx + o, self.h)
            views.append(v + rng.standard_normal(v.shape).astype(np.float32) * self.noise)
        return np.stack(views)  # (V, h, h, 3)

    def __getitem__(self, index: int):
        rng = np.random.default_rng(self.seed * 7919 + index)
        hist = [max(index - k, 0) for k in range(self.T - 1, 0, -1)] + [index]
        cameras = np.stack([self._views_at(j, rng) for j in hist]).astype(np.float32)
        tile = self._crop(*self.trace[index][:2], self.map_tile).astype(np.float32)
        if self.raw_uint8:
            q = lambda a: np.clip(a * 255.0, 0, 255).round().astype(np.uint8)
            cameras, tile = q(cameras), q(tile)
        return {
            "timestamp": np.int64(1_700_000_000_000_000 + index * 250_000),
            "camera": cameras,
            "map": np.ascontiguousarray(tile),
            "vehicle_pose": self.trace[hist].copy(),
            "vehicle_type": np.asarray([0], np.int32),
        }
