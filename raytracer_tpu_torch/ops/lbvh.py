"""What the refit of a packed-cluster tree needs from
``raytracer_tpu/ops/lbvh.py``: the per-triangle AABB and the static height
bound of a Karras tree. The Karras builder itself is not ported yet.

XLA's min and max order −0 below +0, where ``torch.minimum`` /
``torch.amin`` return either zero; the conservative fp16 packing then steps
the two zeros to different halfwords. So min and max here run on an integer
key that orders every non-NaN f32 by value with −0 < +0, and give the JAX
package's bits on any device.
"""

from __future__ import annotations

import math

import torch

__all__ = ["ordered_key", "from_ordered_key", "_tri_bounds", "_static_height_bound"]


def ordered_key(x: torch.Tensor) -> torch.Tensor:
    """f32 → int32 whose order is the f32 order with −0 < +0 (non-NaN)."""
    i = x.view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def from_ordered_key(k: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`ordered_key`."""
    return torch.where(k < 0, k ^ 0x7FFFFFFF, k).view(torch.float32)


def _tri_bounds(triangles: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N,3,3) → per-triangle AABB min/max (N,3)."""
    k = ordered_key(triangles)
    return from_ordered_key(k.amin(dim=1)), from_ordered_key(k.amax(dim=1))


def _static_height_bound(n: int) -> int:
    """Upper bound on Karras-tree height: ≤30 morton levels + balanced
    tie-break subtrees of depth ≤ ceil(log2 n), +2 slack."""
    return 32 + int(math.ceil(math.log2(max(n, 2)))) + 2
