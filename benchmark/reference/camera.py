"""Primary rays of the documented pinhole camera, the jitter hash and the
lane order of a progressive sample, written from their descriptions.

* Camera: pixel (px, py) at subpixel offset (jx, jy) maps to
  u = (px + jx) / W · 2 − 1 and v = (py + jy) / H · 2 − 1 (row 0 is the
  top row; v is not flipped); the direction (u · aspect, v, −focal), with
  aspect = W / H and focal = 1 / tan(fov / 2) rounded to f32, is normalised
  and rotated by the camera quaternion (x, y, z, w).
* Jitter: the integer finalizer hash of (px, py, seed) in 32-bit unsigned
  arithmetic, its top 24 bits scaled to [0, 1); x takes seed 2·s, y 2·s + 1.
* Lanes: a sample's rays are laid out in 32 × 32 pixel blocks, blocks in
  row-major order and each block's pixels row-major, the blocks on the
  right and bottom edges packing fewer lanes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["primary_dirs", "rotate", "subpixel_hash01", "lane_of_pixel", "TILE"]

TILE = 32
_MASK = np.uint64(0xFFFFFFFF)


def rotate(v: torch.Tensor, q) -> torch.Tensor:
    """v rotated by the unit quaternion q = (x, y, z, w): v + 2w(q×v) + 2q×(q×v)."""
    qv = torch.as_tensor(q, dtype=v.dtype, device=v.device)
    u, w = qv[:3].expand_as(v), qv[3]
    uv = torch.linalg.cross(u, v, dim=-1)
    uuv = torch.linalg.cross(u, uv, dim=-1)
    return v + 2.0 * (w * uv + uuv)


def primary_dirs(px: torch.Tensor, py: torch.Tensor, width: int, height: int, quat,
                 fov_degrees: float, jx=0.5, jy=0.5, dtype=torch.float32) -> torch.Tensor:
    """Unit directions (P, 3) through pixels (px, py) at offsets (jx, jy)."""
    focal = float(np.float32(1.0 / math.tan(0.5 * math.radians(fov_degrees))))
    aspect = float(np.float32(width / height))
    u = ((px.to(dtype) + jx) / width) * 2.0 - 1.0
    v = ((py.to(dtype) + jy) / height) * 2.0 - 1.0
    d = torch.stack([u * aspect, v, torch.full_like(u, -focal)], dim=-1)
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    return rotate(d, quat)


def subpixel_hash01(px: np.ndarray, py: np.ndarray, seed: int) -> np.ndarray:
    """Jitter in [0, 1) of pixels (px, py) under ``seed`` (f32)."""
    def mul(a, c):
        return (a * np.uint64(c)) & _MASK

    x = np.asarray(px, dtype=np.uint64) & _MASK
    y = np.asarray(py, dtype=np.uint64) & _MASK
    h = (mul(x, 0x9E3779B1) + mul(y, 0x85EBCA77) + mul(np.uint64(seed & 0xFFFFFFFF),
                                                       0xC2B2AE3D)) & _MASK
    h ^= h >> np.uint64(16)
    h = mul(h, 0x7FEB352D)
    h ^= h >> np.uint64(15)
    h = mul(h, 0x846CA68B)
    h ^= h >> np.uint64(16)
    return (h >> np.uint64(8)).astype(np.float32) * np.float32(2.0 ** -24)


def lane_of_pixel(px: np.ndarray, py: np.ndarray, width: int, height: int) -> np.ndarray:
    """The lane (int64) of pixels (px, py) in a sample's block order."""
    px, py = np.asarray(px, np.int64), np.asarray(py, np.int64)
    by, bx = py // TILE, px // TILE
    block_h = np.minimum(height - by * TILE, TILE)
    block_w = np.minimum(width - bx * TILE, TILE)
    return by * (TILE * width) + block_h * bx * TILE + (py % TILE) * block_w + px % TILE
