"""PNG read/write.

Counterpart of the reference's stb-based image I/O (``image/image.cpp``).
PIL is the fast path; a pure-Python zlib encoder is the fallback so image
output never depends on an optional package.

The port's own copy of ``ptx/io/png.py``: nothing differs, and both
packages write the same PNG bytes (``tests/test_torch_host.py``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, rgba: np.ndarray) -> None:
    """Write an [H, W, 3|4] uint8 array as PNG."""
    rgba = np.ascontiguousarray(rgba)
    try:
        from PIL import Image

        Image.fromarray(rgba).save(path)
        return
    except ImportError:
        pass
    _write_png_pure(path, rgba)


def _write_png_pure(path: str, rgba: np.ndarray) -> None:
    h, w = rgba.shape[:2]
    channels = rgba.shape[2] if rgba.ndim == 3 else 1
    color_type = {1: 0, 3: 2, 4: 6}[channels]
    raw = b"".join(
        b"\x00" + rgba[y].tobytes() for y in range(h)
    )  # filter type 0 per scanline

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    payload = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(payload)


def read_png(path: str) -> np.ndarray:
    """Read an image file to [H, W, 4] uint8 (any format PIL knows)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))
