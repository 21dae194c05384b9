"""What the renderer's frames should hold, worked out from the triangles.

* ``shade_pixels``: the primary-ray frame: the closest hit's geometric
  normal n (not flipped), Lambert light ρ·(0.15 + max(n·l, 0)) with
  ρ = (0.9, 0.7, 0.3) and l = normalize(1, 1.5, 1), 0.01 where the ray
  misses; stored as rgba8 (round(clamp(x, 0, 1)·255), alpha 255).
* ``sample_pixels``: one path-traced sample: jittered camera rays, at every
  hit a shadow ray toward the sun l (next-event estimation: ρ·max(n·l, 0)
  unless occluded), then a cosine-weighted bounce (throughput ×= ρ), the
  normal flipped to face the ray and the hit point moved 1e-4 along it; a
  miss sees 0.01 on the camera wave and the sky 0.15 after it, and a path
  still alive after the last bounce collects the sky.
* The random numbers of a sample are inputs, drawn as the renderer documents
  them for sample ``frame_count``: the jitter seed from a CPU
  ``torch.Generator`` seeded with it (one ``randint(0, 2^22)``), then for
  each bounce b two ``torch.rand(W·H)`` from a generator on the device seeded
  with it, u1[b] and u2[b], indexed by lane. The cosine sample maps (u1, u2)
  to r = √u1, φ = 2π·u2, z = √(1 − u1) in the orthonormal basis of Duff et
  al. (2017), "Building an Orthonormal Basis, Revisited".
* ``accumulate``: the running mean (acc·n + s) / (n + 1), the product and
  sum rounded once; ``present``: rgba8 of (x / (x + 1))^(1 / 2.2).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import camera
from .intersect import INF, Triangles, any_hit, closest_hit

__all__ = ["shade_pixels", "sample_pixels", "draws", "accumulate", "present", "quantize"]

BASE = (0.9, 0.7, 0.3)
LIGHT = (1.0, 1.5, 1.0)
AMBIENT = 0.15
MISS = 0.01
SKY = 0.15
OFFSET = 1e-4
_PSEED_RANGE = 1 << 22


def _unit(v, device, dtype):
    t = torch.tensor(v, dtype=torch.float64)
    return (t / torch.linalg.vector_norm(t)).to(device=device, dtype=dtype)


def quantize(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) → (..., 4) uint8, alpha 255."""
    q = torch.round(torch.clamp(rgb.float(), 0.0, 1.0) * 255.0).to(torch.uint8)
    return torch.cat([q, torch.full_like(q[..., :1], 255)], dim=-1)


def shade_pixels(tri: Triangles, cam_pos, cam_quat, width: int, height: int, fov: float,
                 px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """rgba8 (P, 4) of pixels (px, py) of the primary-ray frame."""
    dev, dt = px.device, tri.dtype
    d = camera.primary_dirs(px, py, width, height, cam_quat, fov, dtype=dt)
    o = torch.as_tensor(cam_pos, dtype=dt, device=dev).expand_as(d)
    _, idx = closest_hit(tri, o, d)
    n = tri.normals(idx)
    ndotl = torch.clamp_min((n * _unit(LIGHT, dev, dt)).sum(-1), 0.0)
    lit = torch.as_tensor(BASE, dtype=dt, device=dev) * (AMBIENT + ndotl)[:, None]
    return quantize(torch.where((idx >= 0)[:, None], lit, torch.full_like(lit, MISS)))


def draws(frame_count: int, rays: int, bounces: int, device) -> tuple[int, list]:
    """(jitter seed, [(u1[b], u2[b]) for each bounce]) of sample ``frame_count``."""
    host = torch.Generator(device="cpu").manual_seed(frame_count)
    pseed = int(torch.randint(0, _PSEED_RANGE, (), generator=host))
    gen = torch.Generator(device=device).manual_seed(frame_count)
    u = [(torch.rand(rays, generator=gen, device=device),
          torch.rand(rays, generator=gen, device=device)) for _ in range(bounces)]
    return pseed, u


def _face(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    s = torch.sign(-(n * d).sum(-1, keepdim=True))
    return n * torch.where(s == 0.0, torch.ones_like(s), s)


def _cosine(n: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    nx, ny, nz = n.unbind(-1)
    s = torch.where(nz >= 0.0, torch.ones_like(nz), -torch.ones_like(nz))
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=-1)
    bt = torch.stack([b, s + ny * ny * a, -ny], dim=-1)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    z = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    return t * (r * torch.cos(phi))[:, None] + bt * (r * torch.sin(phi))[:, None] + n * z[:, None]


def sample_pixels(tri: Triangles, cam_pos, cam_quat, width: int, height: int, fov: float,
                  bounces: int, frame_count: int, px: np.ndarray, py: np.ndarray,
                  device) -> torch.Tensor:
    """Radiance (P, 3) of pixels (px, py) in sample ``frame_count``."""
    dt = tri.dtype
    pseed, u = draws(frame_count, width * height, bounces, device)
    lanes = torch.from_numpy(camera.lane_of_pixel(px, py, width, height)).to(device)
    jx = torch.from_numpy(camera.subpixel_hash01(px, py, 2 * pseed)).to(device, dt)
    jy = torch.from_numpy(camera.subpixel_hash01(px, py, 2 * pseed + 1)).to(device, dt)
    tpx, tpy = (torch.from_numpy(np.asarray(a)).to(device) for a in (px, py))
    d = camera.primary_dirs(tpx, tpy, width, height, cam_quat, fov, jx, jy, dtype=dt)
    o = torch.as_tensor(cam_pos, dtype=dt, device=device).expand_as(d).clone()
    p_count = d.shape[0]
    sun = _unit(LIGHT, device, dt)
    base = torch.as_tensor(BASE, dtype=dt, device=device)
    radiance = torch.zeros((p_count, 3), dtype=dt, device=device)
    through = torch.ones((p_count, 3), dtype=dt, device=device)
    alive = torch.ones((p_count,), dtype=torch.bool, device=device)
    for b in range(bounces):
        live = torch.nonzero(alive).squeeze(1)
        t = torch.full((p_count,), INF, dtype=dt, device=device)
        idx = torch.full((p_count,), -1, dtype=torch.int64, device=device)
        t[live], idx[live] = closest_hit(tri, o[live], d[live])
        hit = alive & (idx >= 0)
        miss = alive & (idx < 0)
        radiance = radiance + torch.where(miss[:, None], through * (MISS if b == 0 else SKY), 0.0)
        n = _face(tri.normals(idx), d)
        p = o + d * torch.where(hit, t, torch.zeros_like(t))[:, None] + n * OFFSET
        ndotl = torch.clamp_min((n * sun).sum(-1), 0.0)
        nee = torch.nonzero(hit & (ndotl > 0.0)).squeeze(1)
        occ = torch.zeros((p_count,), dtype=torch.bool, device=device)
        occ[nee] = any_hit(tri, p[nee], sun.expand(nee.numel(), 3))
        direct = base * (ndotl * (~occ).to(dt))[:, None]
        radiance = radiance + torch.where(hit[:, None], through * direct, 0.0)
        u1, u2 = (x[lanes].to(dt) for x in u[b])
        new_d = _cosine(n, u1, u2)
        through = torch.where(hit[:, None], through * base, through)
        o = torch.where(hit[:, None], p, o)
        d = torch.where(hit[:, None], new_d, d)
        alive = hit
    return radiance + torch.where(alive[:, None], through * SKY, 0.0)


def accumulate(acc: torch.Tensor, sample: torch.Tensor, n: int) -> torch.Tensor:
    """The running mean after one more sample, ``n`` samples already in ``acc``."""
    if acc.dtype == torch.float32:
        fused = (acc.double() * n + sample.double()).float()
        return fused / torch.tensor(n + 1.0, dtype=torch.float32, device=acc.device)
    return (acc * n + sample.to(acc.dtype)) / (n + 1.0)


def present(acc: torch.Tensor) -> torch.Tensor:
    """rgba8 of the tonemapped mean: (x / (x + 1))^(1 / 2.2)."""
    return quantize(torch.pow(acc / (acc + 1.0), 1.0 / 2.2))
