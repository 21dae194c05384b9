"""Morton (Z-order) codes over triangle centroids, on the device of the
triangles.

Torch counterpart of ``raytracer_tpu/ops/morton.py``, bit for bit: 10 bits
an axis of the centroid quantised against the centroids' own box (extents
clamped to ≥ 1e-20), truncated toward zero and clamped to [0, 1023], the
code (x << 2) | (y << 1) | z of the spread bits, and a stable sort, which
breaks equal codes by triangle index.

Torch has no full uint32 arithmetic: codes are int64 holding u32 values.
The centroid is what XLA makes of the JAX package's ``mean``: the three
vertices summed in order, then multiplied by the f32 reciprocal of 3 (XLA
turns the division by a constant into that product). A true division by 3
differs in the last bit of most centroids of seeded meshes, and one ulp can
move a centroid across a quantisation step. The factor is a tensor on the
triangles' device, so the product is the same on the CPU and on a card.
"""

from __future__ import annotations

import torch

__all__ = ["expand_bits10", "morton3d", "morton_codes", "build_morton_and_sort"]


def expand_bits10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``v`` to every third bit (int64)."""
    v = v.to(torch.int64) & 1023
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3d(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """30-bit Morton code, x in bit 2, y in bit 1, z in bit 0."""
    return (expand_bits10(x) << 2) | (expand_bits10(y) << 1) | expand_bits10(z)


def morton_codes(centroids: torch.Tensor) -> torch.Tensor:
    """(N, 3) f32 centroids, quantised against their own box → (N,) codes."""
    mn = centroids.amin(dim=0)
    mx = centroids.amax(dim=0)
    ext = torch.maximum(mx - mn, torch.full_like(mx, 1e-20))
    n = (centroids - mn[None, :]) / ext[None, :]
    q = (n * 1023.0).trunc().to(torch.int32).clamp(0, 1023)
    return morton3d(q[:, 0], q[:, 1], q[:, 2])


def centroids(triangles: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) → (N, 3): ((v0 + v1) + v2) · f32(1/3), XLA's mean."""
    third = torch.full((1,), 1.0 / 3.0, dtype=torch.float32, device=triangles.device)
    return (triangles[:, 0] + triangles[:, 1] + triangles[:, 2]) * third


def build_morton_and_sort(triangles: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, 3, 3) triangles → (sorted codes, triangle index of each sorted
    position), both int64 on the triangles' device."""
    codes = morton_codes(centroids(triangles))
    order = torch.argsort(codes, stable=True)
    return codes[order], order
