"""Dependency-free image IO: PNG (stdlib zlib) and PPM writers (host,
NumPy): a copy of ``raytracer_tpu/utils/image.py``, byte for byte the same
files.

The reference presents to a canvas; the headless analog writes image files
from the rgba8 framebuffer for golden tests, the debug surface, and the apps.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

__all__ = ["encode_png", "write_png", "write_ppm", "read_ppm"]


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """Encode (H,W,3|4) uint8 (or (H,W) grayscale) as PNG bytes in memory
    (the live viewer streams these without touching disk)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("write_png expects uint8")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, level))
        + chunk(b"IEND", b"")
    )


def write_png(path: str | Path, img: np.ndarray) -> None:
    """Write (H,W,3|4) uint8 (or (H,W) grayscale) as a PNG."""
    Path(path).write_bytes(encode_png(img))


def write_ppm(path: str | Path, img: np.ndarray) -> None:
    """Write (H,W,3) uint8 as binary PPM (P6)."""
    img = np.asarray(img)[..., :3]
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(img, dtype=np.uint8).tobytes())


def read_ppm(path: str | Path) -> np.ndarray:
    data = Path(path).read_bytes()
    parts = data.split(b"\n", 3)
    assert parts[0] == b"P6"
    w, h = map(int, parts[1].split())
    assert parts[2] == b"255"
    return np.frombuffer(parts[3], dtype=np.uint8, count=w * h * 3).reshape(h, w, 3)
