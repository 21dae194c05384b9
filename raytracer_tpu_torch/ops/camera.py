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
           "subpixel_hash01", "generate_rays_jittered", "to_device", "INF"]

INF = 1e30

_MASK32 = 0xFFFFFFFF
# the hash's int32 multipliers (-1640531535, -2048144777, -1028477379) as uint32
_HASH_PX, _HASH_PY, _HASH_SEED = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D


def to_device(values, device, dtype=torch.float32) -> torch.Tensor:
    """A few host values as a tensor on ``device``, copied without a stream
    synchronisation: a blocking host-to-device copy would wait for all the
    work queued on the card, so the host could not issue ahead of it."""
    return torch.as_tensor(values, dtype=dtype).to(device, non_blocking=True)


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
                 cam_quat, fov_degrees: float = 70.0, jx=0.5, jy=0.5) -> torch.Tensor:
    """Unit directions (P, 3) of the primary rays through pixels (px, py) at
    subpixel offsets (jx, jy): the pixel centre, or per-pixel f32 tensors."""
    dev = px.device
    f32 = torch.float32
    focal, aspect = camera_constants(width, height, fov_degrees)
    w = torch.full((), float(width), dtype=f32, device=dev)
    h = torch.full((), float(height), dtype=f32, device=dev)
    u = (px.to(f32) + jx) / w * 2.0 - 1.0
    v = (py.to(f32) + jy) / h * 2.0 - 1.0
    dx = u * aspect
    dy = v
    dz = torch.full_like(u, -focal)
    inv_len = torch.sqrt(dx * dx + dy * dy + dz * dz).reciprocal()
    d = torch.stack([dx * inv_len, dy * inv_len, dz * inv_len], dim=-1)
    q = to_device(cam_quat, dev).reshape(4)
    return rotate_by_quat(d, q)


def generate_rays(width: int, height: int, cam_pos, cam_quat,
                  fov_degrees: float = 70.0, *, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Primary rays for every pixel → (origins (H,W,3), dirs (H,W,3))."""
    py, px = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    d = primary_dirs(px.reshape(-1), py.reshape(-1), width, height, cam_quat,
                     fov_degrees).reshape(height, width, 3)
    o = to_device(cam_pos, device).reshape(1, 1, 3)
    return o.expand(height, width, 3), d


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a · c) mod 2^32 for int64 ``a`` in [0, 2^32) and a constant c < 2^32.
    The product is taken in 16-bit halves of c, so no partial product leaves
    int64 (a · c itself can reach 2^64)."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _MASK32


def subpixel_hash01(px, py, seed) -> torch.Tensor:
    """Counter-based subpixel jitter in [0, 1): the integer finalizer hash of
    (pixel x, pixel y, seed) of ``raytracer_tpu/ops/camera.py``, bit for bit.
    The JAX package wraps in int32/uint32; torch lacks uint32 arithmetic on
    the CPU, so every step runs in int64 masked to 32 bits; a Python int
    seed stays a host scalar."""
    px = torch.as_tensor(px)
    dev = px.device

    def u32(x):
        if isinstance(x, int):
            return x & _MASK32
        return torch.as_tensor(x, device=dev).to(torch.int64) & _MASK32

    h = (_mul32(u32(px), _HASH_PX) + _mul32(u32(py), _HASH_PY)
         + _mul32(u32(seed), _HASH_SEED)) & _MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * 2.0 ** -24


def generate_rays_jittered(width: int, height: int, cam_pos, cam_quat, seed: int,
                           fov_degrees: float = 70.0, *, device
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Primary rays at hash-jittered subpixel offsets (``subpixel_hash01``
    with seeds 2·seed and 2·seed + 1) → (origins (H,W,3), dirs (H,W,3)): the
    rays of the jittered tile kernel K1b, bit for bit. The JAX function
    normalizes with ``lax.rsqrt``; this one with 1/sqrt, so the two agree
    within 2·2^-23 per component, not bit for bit."""
    py, px = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    jx = subpixel_hash01(px, py, 2 * int(seed))
    jy = subpixel_hash01(px, py, 2 * int(seed) + 1)
    d = primary_dirs(px, py, width, height, cam_quat, fov_degrees, jx, jy).reshape(height, width, 3)
    o = to_device(cam_pos, device).reshape(1, 1, 3)
    return o.expand(height, width, 3), d
