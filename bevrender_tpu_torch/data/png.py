"""The PNG container, read and written with the standard library alone.

``read`` parses the signature and chunks of a file and inflates its IDAT
stream with ``zlib`` (which releases the GIL while it inflates); undoing
the row filters and converting to RGB happen in the native library
(``data/native.py``, ``csrc/png.cc``). ``encode_png`` writes an RGB8 file
with a filter chosen per row, as libpng's default heuristic does.

Decoded: non-interlaced 8-bit gray, RGB, palette, gray + alpha and RGBA,
and 1, 2 and 4-bit gray and palette; alpha is dropped. Anything else
(16-bit samples, Adam7 interlacing, a file that is not a PNG) raises
``ValueError`` naming the file and what it holds.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha",
                6: "RGBA"}


@dataclass
class Header:
    height: int
    width: int
    depth: int
    color_type: int
    interlace: int

    def describe(self) -> str:
        name = _COLOR_NAMES.get(self.color_type, f"color type "
                                f"{self.color_type}")
        lace = ", Adam7 interlaced" if self.interlace else ""
        return f"{self.depth}-bit {name}{lace}"

    def supported(self) -> bool:
        if self.interlace or self.color_type not in _CHANNELS:
            return False
        if self.depth == 8:
            return True
        return self.color_type in (0, 3) and self.depth in (1, 2, 4)


@dataclass
class Image:
    """A PNG's header, palette (3 bytes an entry) and inflated stream."""

    header: Header
    palette: bytes
    data: bytes


def _header(path, head: bytes) -> Header:
    if len(head) < 33 or head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h, depth, color_type, _, _, interlace = struct.unpack(
        ">IIBBBBB", head[16:29])
    return Header(h, w, depth, color_type, interlace)


def probe(path) -> tuple:
    """(height, width) from the header (the first 33 bytes)."""
    with open(path, "rb") as f:
        hdr = _header(path, f.read(33))
    return hdr.height, hdr.width


def read(path) -> Image:
    """Parse and inflate ``path``; raises ``ValueError`` on a format the
    decoder does not take."""
    raw = Path(path).read_bytes()
    hdr = _header(path, raw[:33])
    if not hdr.supported():
        raise ValueError(f"{path}: {hdr.describe()} PNG is not supported "
                         f"(8-bit gray, RGB, palette, gray+alpha or RGBA, or "
                         f"1/2/4-bit gray or palette, not interlaced)")
    pos, palette, idat = 8, b"", []
    while pos + 8 <= len(raw):
        length, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        body = raw[pos + 8:pos + 8 + length]
        if kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if hdr.color_type == 3 and not palette:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    bits = _CHANNELS[hdr.color_type] * hdr.depth
    size = hdr.height * ((hdr.width * bits + 7) // 8 + 1)
    try:
        data = zlib.decompress(b"".join(idat), bufsize=max(size, 1))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt IDAT stream ({e})") from None
    return Image(hdr, palette, data)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filtered(img: np.ndarray) -> np.ndarray:
    """Each row under the filter (0-4) whose bytes, read as signed, have
    the least absolute sum, with its filter byte in front: (H, 1 + W*3)."""
    x = img.reshape(img.shape[0], -1).astype(np.int16)
    left = np.zeros_like(x)
    left[:, 3:] = x[:, :-3]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    corner = np.zeros_like(x)
    corner[1:, 3:] = x[:-1, :-3]
    p = left + up - corner
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - corner)
    pred = np.where((pa <= pb) & (pa <= pc), left,
                    np.where(pb <= pc, up, corner))
    cands = np.stack([x, x - left, x - up, x - ((left + up) >> 1),
                      x - pred]).astype(np.uint8)           # (5, H, W*3)
    cost = np.abs(cands.view(np.int8).astype(np.int32)).sum(axis=2)
    best = cost.argmin(axis=0)                               # (H,)
    rows = cands[best, np.arange(x.shape[0])]
    return np.concatenate([best.astype(np.uint8)[:, None], rows], axis=1)


def encode_png(path, img: np.ndarray, level: int = 6) -> None:
    """Write a uint8 (H, W, 3) array as an 8-bit RGB PNG."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes uint8 (H, W, 3), not "
                         f"{img.dtype} {img.shape}")
    h, w, _ = img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    body = zlib.compress(_filtered(img).tobytes(), level)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", body)
                + _chunk(b"IEND", b""))
