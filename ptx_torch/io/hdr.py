"""Radiance .hdr (RGBE) read/write.

Counterpart of the reference's stb HDR path (``image/image.cpp:84-105``,
stb_image's .hdr support) used for equirectangular environment maps.  Pure
numpy implementation of the RGBE format with new-style RLE scanlines.

The port's own copy of ``ptx/io/hdr.py``: nothing differs, and both
packages read and write the same bytes (``tests/test_torch_host.py``).
"""

from __future__ import annotations

import numpy as np


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file -> [H, W, 3] float32 linear radiance."""
    with open(path, "rb") as f:
        data = f.read()

    # Header: lines until blank, then resolution line.
    pos = 0
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance HDR file")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    pos = eol + 1
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported orientation {res!r}")
    h, w = int(res[1]), int(res[3])

    buf = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = np.zeros((h, w, 4), np.uint8)
    i = 0
    for y in range(h):
        # New-style RLE scanline: 0x02 0x02 hi lo.
        if w >= 8 and w < 32768 and buf[i] == 2 and buf[i + 1] == 2:
            i += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = int(buf[i])
                    i += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = buf[i]
                        i += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = buf[i : i + count]
                        i += count
                        x += count
        else:  # flat scanline
            row = buf[i : i + 4 * w].reshape(w, 4)
            rgbe[y] = row
            i += 4 * w

    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def write_hdr(path: str, rgb: np.ndarray) -> None:
    """Write [H, W, 3] float32 linear radiance as flat (non-RLE) RGBE."""
    rgb = np.asarray(rgb, np.float32)
    h, w = rgb.shape[:2]
    maxc = rgb.max(axis=-1)
    exp = np.zeros((h, w), np.int32)
    mant = np.zeros((h, w), np.float32)
    nz = maxc > 1e-32
    mant[nz], exp[nz] = np.frexp(maxc[nz])
    scale = np.zeros((h, w, 1), np.float32)
    scale[nz, 0] = mant[nz] * 256.0 / maxc[nz]
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    header = (
        b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
        + f"-Y {h} +X {w}\n".encode()
    )
    with open(path, "wb") as f:
        f.write(header + rgbe.tobytes())


def load_env_image(path: str) -> np.ndarray:
    """Load an environment image (.hdr or LDR via PIL) as [H, W, 3] linear."""
    if path.lower().endswith(".hdr"):
        return read_hdr(path)
    from PIL import Image

    with Image.open(path) as im:
        raw = np.asarray(im.convert("RGB"), np.float32) / 255.0
    return np.power(raw, 2.2)  # sRGB decode (image.cpp:138-141)
