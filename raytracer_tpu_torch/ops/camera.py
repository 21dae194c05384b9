"""Primary-ray generation — pinhole camera, quaternion orientation.

Torch counterpart of ``raytracer_tpu/ops/camera.py`` with the normalization
of the traversal kernels (``raytracer_tpu/ops/pallas/traverse.py:714-736``):
pixel centers at (px+0.5, py+0.5)/res mapped to NDC [-1,1], direction
(u·aspect, v, −focal) scaled by 1/sqrt(|d|²) and rotated by the camera
quaternion (xyzw). Row 0 is the top image row and v is not flipped.

Every operation is one IEEE f32 operation in the order the CUDA kernel
(``csrc/traverse_tiles.cu``) performs it, so on the card this module and the
kernel give bit-equal directions. Two torch habits would break that and are
avoided: a division by a Python scalar, which CUDA torch runs as a multiply
by the reciprocal, and ``torch.rsqrt``, which CUDA approximates.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["rotate_by_quat", "safe_inv_dir", "camera_constants", "primary_dirs", "generate_rays",
           "INF"]

INF = 1e30


def rotate_by_quat(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """v' = 2(s·(u×v) + u×(u×v)) + v with q = [x,y,z,w]; v (..., 3)."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    dx, dy, dz = v[..., 0], v[..., 1], v[..., 2]
    uvx = qy * dz - qz * dy
    uvy = qz * dx - qx * dz
    uvz = qx * dy - qy * dx
    uuvx = qy * uvz - qz * uvy
    uuvy = qz * uvx - qx * uvz
    uuvz = qx * uvy - qy * uvx
    return torch.stack([
        2.0 * (qw * uvx + uuvx) + dx,
        2.0 * (qw * uvy + uuvy) + dy,
        2.0 * (qw * uvz + uuvz) + dz,
    ], dim=-1)


def safe_inv_dir(d: torch.Tensor) -> torch.Tensor:
    """1/d with |d| <= 1e-8 clamped to INF."""
    return torch.where(d.abs() > 1e-8, d.reciprocal(), torch.full_like(d, INF))


def camera_constants(width: int, height: int, fov_degrees: float) -> tuple[float, float]:
    """(focal, aspect) rounded to f32, as the kernel wrappers compute them."""
    focal = float(np.float32(1.0 / math.tan(0.5 * math.radians(fov_degrees))))
    return focal, float(np.float32(width / height))


def primary_dirs(px: torch.Tensor, py: torch.Tensor, width: int, height: int,
                 cam_quat, fov_degrees: float = 70.0) -> torch.Tensor:
    """Unit directions (P, 3) of the primary rays through pixels (px, py)."""
    dev = px.device
    f32 = torch.float32
    focal, aspect = camera_constants(width, height, fov_degrees)
    w = torch.tensor(float(width), dtype=f32, device=dev)
    h = torch.tensor(float(height), dtype=f32, device=dev)
    u = (px.to(f32) + 0.5) / w * 2.0 - 1.0
    v = (py.to(f32) + 0.5) / h * 2.0 - 1.0
    dx = u * aspect
    dy = v
    dz = torch.full_like(u, -focal)
    inv_len = torch.sqrt(dx * dx + dy * dy + dz * dz).reciprocal()
    d = torch.stack([dx * inv_len, dy * inv_len, dz * inv_len], dim=-1)
    q = torch.as_tensor(cam_quat, dtype=f32).to(dev).reshape(4)
    return rotate_by_quat(d, q)


def generate_rays(width: int, height: int, cam_pos, cam_quat,
                  fov_degrees: float = 70.0, *, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Primary rays for every pixel → (origins (H,W,3), dirs (H,W,3))."""
    py, px = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    d = primary_dirs(px.reshape(-1), py.reshape(-1), width, height, cam_quat,
                     fov_degrees).reshape(height, width, 3)
    o = torch.as_tensor(cam_pos, dtype=torch.float32).to(device).reshape(1, 1, 3)
    return o.expand(height, width, 3), d
