"""Shading, framebuffer quantization, tonemap — the constants of
``raytracer_tpu/ops/shade.py``.

* Lambert shade: fixed directional light normalize(1, 1.5, 1), base color
  (0.9, 0.7, 0.3), ambient 0.15, miss color 0.01. Normals are the raw
  geometric normal, not flipped toward the ray.
* Framebuffer: rgba8unorm store semantics — round(clamp(v,0,1)·255).
* Present: Reinhard x/(x+1) + gamma 1/2.2 applied to that LDR image.
"""

from __future__ import annotations

import torch

from .camera import to_device

__all__ = ["triangle_normals", "shade_lambert", "quantize_rgba8", "downscale_rgb8",
           "present_frame", "MISS_COLOR"]

_LIGHT_DIR = (1.0, 1.5, 1.0)
_BASE_COLOR = (0.9, 0.7, 0.3)
_AMBIENT = 0.15
MISS_COLOR = 0.01


def triangle_normals(tris: torch.Tensor, tri_idx: torch.Tensor) -> torch.Tensor:
    """Geometric normal of tris[tri_idx]: normalize(cross(v1-v0, v2-v0))."""
    v = tris[tri_idx.clamp(0, tris.shape[0] - 1).long()]
    e1 = v[..., 1, :] - v[..., 0, :]
    e2 = v[..., 2, :] - v[..., 0, :]
    n = torch.linalg.cross(e1, e2, dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def shade_lambert(normals: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """(..., 3) normals + (...) hit mask → (..., 3) linear LDR color."""
    light = torch.tensor(_LIGHT_DIR, dtype=torch.float32)
    light = to_device(light / torch.linalg.vector_norm(light), normals.device)
    base = to_device(_BASE_COLOR, normals.device)
    ndotl = torch.clamp_min((normals * light).sum(-1), 0.0)
    lit = base * (_AMBIENT + ndotl)[..., None]
    return torch.where(hit[..., None], lit, torch.full_like(lit, MISS_COLOR))


def quantize_rgba8(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) f32 → (..., 4) uint8 with rgba8unorm store rounding."""
    q = torch.round(torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)
    alpha = torch.full(q.shape[:-1] + (1,), 255, dtype=torch.uint8, device=q.device)
    return torch.cat([q, alpha], dim=-1)


def downscale_rgb8(rgb: torch.Tensor, scale: int) -> torch.Tensor:
    """(H, W, 3) f32 in [0, 1] → (H // scale, W // scale, 3) uint8 by a box
    filter, on the image's device, so that a consumer bound by the transfer
    pulls scale² times fewer pixels. Trailing rows and columns that do not
    fill a box are dropped."""
    h, w = rgb.shape[0] - rgb.shape[0] % scale, rgb.shape[1] - rgb.shape[1] % scale
    a = rgb[:h, :w].reshape(h // scale, scale, w // scale, scale, 3)
    m = a.mean(dim=(1, 3))
    return torch.round(torch.clamp(m, 0.0, 1.0) * 255.0).to(torch.uint8)


def present_frame(ldr_u8: torch.Tensor) -> torch.Tensor:
    """Tonemap pass over the rgba8 framebuffer → display rgba8
    (Reinhard + gamma 1/2.2 on the sampled LDR)."""
    c = ldr_u8[..., :3].to(torch.float32) / 255.0
    mapped = c / (c + 1.0)
    return quantize_rgba8(torch.pow(mapped, 1.0 / 2.2))
