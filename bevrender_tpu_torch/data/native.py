"""The native host library of the data feed (counterpart of
bevrender_tpu/data/native.py), bound with ctypes.

``csrc/preprocess.cc`` resizes (triangle filter, PIL BILINEAR semantics),
splits a wide frame into views and normalises it in one pass;
``csrc/png.cc`` undoes a PNG's row filters and converts it to RGB8, and
feeds the fused entry points. The PNG container is parsed and inflated in
``data/png.py``. The results equal those of the JAX package's library
bit for bit; its libpng decode and its PIL fallbacks have no counterpart:
this library needs neither libpng nor PIL.

The library is built with g++ at first use into
``build/bevrender_tpu_torch/<hash>/libbevdata.so`` at the repository root,
keyed by a hash of the sources and flags (a per-process temporary file,
then an atomic rename, so concurrent builds do not collide). A failed
build or load raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

from bevrender_tpu_torch.data import png

CSRC = Path(__file__).resolve().parent / "csrc"
# where ops/kernels/build.py puts the CUDA libraries
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "bevrender_tpu_torch"
SOURCES = ("preprocess.cc", "png.cc")
# -mfma lets the explicit std::fma calls inline (every x86-64 CPU since
# 2013 has the instruction); the results do not depend on it
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off") + (
    ("-mfma",) if platform.machine() in ("x86_64", "AMD64") else ())

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SIGNATURES = {
    "bev_fused_views": (None, [_P, _I, _I, _P, _I, _I, _I, _P, _P]),
    "bev_resize_u8": (None, [_P, _I, _I, _P, _I, _I]),
    "bev_u8_to_unit_f32": (None, [_P, _P, _I64]),
    "bev_stack": (None, [_P, _I, _I64, _P]),
    "bev_png_decode_rgb": (_I, [_P, _I64, _I, _I, _I, _I, _P, _I, _P]),
    "bev_png_views": (_I, [_P, _I64, _I, _I, _I, _I, _P, _I, _P, _I, _I, _I,
                           _P, _P]),
    "bev_png_resize_u8": (_I, [_P, _I64, _I, _I, _I, _I, _P, _I, _P, _I,
                               _I]),
}
_ERRORS = {1: "the image data is shorter than the image",
           2: "a row has an unknown filter type",
           3: "a palette index lies past the palette",
           4: "unsupported format", 5: "the width does not split into views"}


def lib_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libbevdata.so"


def _build(target: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the data feed's native library "
                           "builds with g++")
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [cxx, *FLAGS, *[str(CSRC / s) for s in SOURCES], "-o", tmp],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for the data feed's library:\n"
                               f"{proc.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> ctypes.CDLL:
    """The library, built at first use."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                target = lib_path()
                if not target.exists():
                    _build(target)
                lib = ctypes.CDLL(str(target))
                for name, (res, args) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = res, args
                _lib = lib
    return _lib


def _c8(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.uint8)
    if a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"expected a uint8 (H, W, 3) image, got {a.shape}")
    return a


def _f3(x: Sequence[float]) -> np.ndarray:
    a = np.ascontiguousarray(x, dtype=np.float32)
    if a.shape != (3,):
        raise ValueError(f"expected 3 per-channel values, got {a.shape}")
    return a


def _check_views(num_views: int, out_w: int) -> None:
    if num_views <= 0 or out_w % num_views:
        raise ValueError(f"out_w={out_w} not divisible by "
                         f"num_views={num_views}")


def fused_views(img_u8: np.ndarray, num_views: int, out_h: int, out_w: int,
                mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    """Wide uint8 frame -> (V, out_h, out_w // V, 3) float32 normalised
    views in one pass (resize + split + /255 + normalise)."""
    _check_views(num_views, out_w)
    src, mean, std = _c8(img_u8), _f3(mean), _f3(std)
    hs, ws, _ = src.shape
    dst = np.empty((num_views, out_h, out_w // num_views, 3), np.float32)
    load().bev_fused_views(src.ctypes.data, hs, ws, dst.ctypes.data,
                           num_views, out_h, out_w, mean.ctypes.data,
                           std.ctypes.data)
    return dst


def resize_u8(img_u8: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """uint8 HWC -> uint8 triangle-filter resize, rounded."""
    src = _c8(img_u8)
    hs, ws, _ = src.shape
    dst = np.empty((out_h, out_w, 3), np.uint8)
    load().bev_resize_u8(src.ctypes.data, hs, ws, dst.ctypes.data, out_h,
                         out_w)
    return dst


def to_unit_f32(img_u8: np.ndarray) -> np.ndarray:
    """uint8 -> float32 / 255 (the map tile's ToTensor)."""
    src = np.ascontiguousarray(img_u8, dtype=np.uint8)
    dst = np.empty(src.shape, np.float32)
    load().bev_u8_to_unit_f32(src.ctypes.data, dst.ctypes.data, src.size)
    return dst


def stack(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """``np.stack`` by one memcpy a sample (arrays of one dtype and
    shape; others go through ``np.stack``)."""
    first = arrays[0]
    if any(a.dtype != first.dtype or a.shape != first.shape for a in arrays):
        return np.stack(arrays)
    srcs = [np.ascontiguousarray(a) for a in arrays]
    out = np.empty((len(srcs),) + first.shape, first.dtype)
    ptrs = (ctypes.c_void_p * len(srcs))(*[s.ctypes.data for s in srcs])
    load().bev_stack(ptrs, len(srcs), first.nbytes, out.ctypes.data)
    return out


def probe_png(path) -> tuple:
    """(H, W) of a PNG from its header."""
    return png.probe(path)


def _png_call(fn, path, img: png.Image, *out_args) -> None:
    h = img.header
    rc = fn(img.data, len(img.data), h.height, h.width, h.color_type,
            h.depth, img.palette or None, len(img.palette) // 3, *out_args)
    if rc:
        raise ValueError(f"{path}: {_ERRORS.get(rc, f'error {rc}')} "
                         f"({h.describe()} PNG)")


def decode_png(path) -> np.ndarray:
    """A PNG file -> (H, W, 3) uint8 RGB."""
    img = png.read(path)
    dst = np.empty((img.header.height, img.header.width, 3), np.uint8)
    _png_call(load().bev_png_decode_rgb, path, img, dst.ctypes.data)
    return dst


def decode_png_views(path, num_views: int, out_h: int, out_w: int,
                     mean: Sequence[float],
                     std: Sequence[float]) -> np.ndarray:
    """A camera PNG -> (V, out_h, out_w // V, 3) float32 normalised views:
    decode, resize, split and normalise in one native call."""
    _check_views(num_views, out_w)
    mean, std = _f3(mean), _f3(std)
    dst = np.empty((num_views, out_h, out_w // num_views, 3), np.float32)
    _png_call(load().bev_png_views, path, png.read(path), dst.ctypes.data,
              num_views, out_h, out_w, mean.ctypes.data, std.ctypes.data)
    return dst


def decode_png_resize_u8(path, out_h: int, out_w: int) -> np.ndarray:
    """A PNG -> (out_h, out_w, 3) uint8: decode and triangle resize (a copy
    at the source size)."""
    dst = np.empty((out_h, out_w, 3), np.uint8)
    _png_call(load().bev_png_resize_u8, path, png.read(path),
              dst.ctypes.data, out_h, out_w)
    return dst
