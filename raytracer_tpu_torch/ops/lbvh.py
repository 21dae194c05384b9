"""The LBVH2 builder (Karras 2012 over Morton codes) and its refit, on the
device of the triangles, and what the refit of a packed-cluster tree shares
with them: the per-triangle AABB and the static height bound of a Karras
tree. Also :func:`build_sah2`, the native binned-SAH build of single
triangles in the same layout.

Torch counterpart of ``raytracer_tpu/ops/lbvh.py``, node for node and bit
for bit: every internal node's range and split come from the same fixed-trip
searches (32 doubling steps, 32 binary steps, 33 split steps), leaves sit at
rows [n − 1, 2n − 1) in Morton order, and the boxes are swept bottom-up with
the conservative fp16 pack (one fp16 ulp outward at every level).

Torch has no full uint32 arithmetic: u32 words travel as int64, and the
count of leading zeros of a 32-bit value x is 32 − the binary exponent of
x (exact in f64; ``frexp`` gives 0 for 0, so clz(0) = 32).

XLA's min and max order −0 below +0, where ``torch.minimum`` /
``torch.amin`` return either zero; the conservative fp16 packing then steps
the two zeros to different halfwords. So min and max here run on an integer
key that orders every non-NaN f32 by value with −0 < +0, and give the JAX
package's bits on any device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..native.bvhtool import build_sah_native
from ..utils.fp16 import pack_bounds_conservative
from .morton import build_morton_and_sort

__all__ = ["LBVH2", "LEAF_FLAG", "INVALID", "build_lbvh2", "build_sah2", "refit_lbvh2", "ordered_key",
           "from_ordered_key", "f16_order", "f16_unorder", "_tri_bounds",
           "_static_height_bound", "_karras_connectivity", "_bounds_fixed_point"]

LEAF_FLAG = 0x80000000
INVALID = 0xFFFFFFFF


class LBVH2(NamedTuple):
    """BVH2 in struct-of-arrays form, int64 tensors of u32 words (the node
    layout of ``raytracer_tpu/ops/lbvh.py::LBVH2``)."""

    bounds_u32: torch.Tensor  # (M, 3) packed fp16 AABBs
    left: torch.Tensor        # (M,) child index (0 for leaves)
    right: torch.Tensor       # (M,)
    meta: torch.Tensor        # (M,) LEAF_FLAG|triangle or cluster for leaves, 0 internal
    parent: torch.Tensor      # (M,) INVALID at the root

    @property
    def num_nodes(self) -> int:
        return self.bounds_u32.shape[0]

    @property
    def num_internal(self) -> int:
        return (self.num_nodes - 1) // 2


def ordered_key(x: torch.Tensor) -> torch.Tensor:
    """f32 → int32 whose order is the f32 order with −0 < +0 (non-NaN)."""
    i = x.view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def from_ordered_key(k: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`ordered_key`."""
    return torch.where(k < 0, k ^ 0x7FFFFFFF, k).view(torch.float32)


def f16_order(h: torch.Tensor) -> torch.Tensor:
    """fp16 bit patterns → keys in [0, 2^16) ordered by value, −0 < +0:
    the ordered space of ``increment_f16``."""
    return torch.where((h & 0x8000) != 0, (~h) & 0xFFFF, h ^ 0x8000)


def f16_unorder(k: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`f16_order`."""
    return torch.where((k & 0x8000) != 0, k ^ 0x8000, (~k) & 0xFFFF)


def _tri_bounds(triangles: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N,3,3) → per-triangle AABB min/max (N,3)."""
    k = ordered_key(triangles)
    return from_ordered_key(k.amin(dim=1)), from_ordered_key(k.amax(dim=1))


def _static_height_bound(n: int) -> int:
    """Upper bound on Karras-tree height: ≤30 morton levels + balanced
    tie-break subtrees of depth ≤ ceil(log2 n), +2 slack."""
    return 32 + int(math.ceil(math.log2(max(n, 2)))) + 2


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit values held in int64 (clz(0) = 32)."""
    return 32 - torch.frexp(x.double()).exponent.to(torch.int64)


def _delta(codes: torch.Tensor, i: torch.Tensor, j: torch.Tensor, n: int) -> torch.Tensor:
    """Karras δ(i, j): the common prefix of codes i and j, 32 + that of the
    indices where the codes are equal; −1 for j out of range."""
    valid = (j >= 0) & (j < n)
    x = codes[i] ^ codes[j.clamp(0, n - 1)]
    y = (i ^ j) & 0xFFFFFFFF
    d = torch.where(x == 0, 32 + _clz32(y), _clz32(x))
    return torch.where(valid, d, -1)


def _karras_connectivity(codes: torch.Tensor, n: int):
    """(left, right, parent) of the n − 1 internal nodes over n sorted codes
    (leaves offset by n − 1), every node at once: direction, doubling
    search for the range end, binary refinement, split search, each a loop
    of the JAX package's fixed trip count."""
    i = torch.arange(n - 1, dtype=torch.int64, device=codes.device)

    def delta(a, b):
        return _delta(codes, a, b, n)

    d = torch.where(delta(i, i + 1) - delta(i, i - 1) > 0, 1, -1)
    delta_min = delta(i, i - d)

    lmax = torch.full_like(i, 2)
    done = torch.zeros_like(i, dtype=torch.bool)
    for _ in range(32):
        done = done | ~(delta(i, i + lmax * d) > delta_min)
        lmax = torch.where(done, lmax, lmax << 1)

    length, t = torch.zeros_like(i), lmax >> 1
    for _ in range(32):
        active = t > 0
        pred = active & (delta(i, i + (length + t) * d) > delta_min)
        length = torch.where(pred, length + t, length)
        t = torch.where(active, t >> 1, t)

    j = i + length * d
    first, last = torch.minimum(i, j), torch.maximum(i, j)
    delta_node = delta(first, last)
    split, step = first, last - first
    for _ in range(33):
        active = step > 1
        step = torch.where(active, (step + 1) >> 1, step)
        new_split = split + step
        pred = active & (new_split < last) & (delta(first, new_split) > delta_node)
        split = torch.where(pred, new_split, split)

    leaf_base = n - 1
    left = torch.where(split == first, leaf_base + split, split)
    right = torch.where(split + 1 == last, leaf_base + split + 1, split + 1)
    parent = torch.full((2 * n - 1,), INVALID, dtype=torch.int64, device=codes.device)
    parent[left] = i
    parent[right] = i
    parent[0] = INVALID
    return left, right, parent


def _bounds_fixed_point(bounds_u32: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                        num_internal: int, sweeps: int) -> torch.Tensor:
    """Bottom-up propagation of the boxes: ``sweeps`` times, every internal
    row becomes the conservative fp16 pack of the union of its children's
    boxes. Run with no test: the JAX package stops at the first sweep that
    changes nothing (at most ``sweeps``), and once a tree has converged more
    sweeps change nothing, so the result is its bit for bit.

    A union of fp16 values is an fp16 value, so each sweep is taken on the
    halfwords' ordered keys (:func:`f16_order`): the min key less one and
    the max key plus one, masked to 16 bits, are exactly the JAX package's
    unpack → f32 min / max (−0 below +0) → ``pack_bounds_conservative``."""
    h = torch.stack([(bounds_u32[:, c // 2] >> (16 * (c % 2))) & 0xFFFF for c in range(6)], -1)
    key = f16_order(h)
    kmn, kmx = key[:, :3].clone(), key[:, 3:].clone()
    li, ri = left[:num_internal], right[:num_internal]
    for _ in range(sweeps):
        kmn[:num_internal] = (torch.minimum(kmn[li], kmn[ri]) - 1) & 0xFFFF
        kmx[:num_internal] = (torch.maximum(kmx[li], kmx[ri]) + 1) & 0xFFFF
    h = f16_unorder(torch.cat([kmn, kmx], dim=1))
    return torch.stack([h[:, 0] | (h[:, 1] << 16), h[:, 2] | (h[:, 3] << 16),
                        h[:, 4] | (h[:, 5] << 16)], -1)


def build_lbvh2(triangles: torch.Tensor) -> LBVH2:
    """The LBVH2 of (N, 3, 3) f32 triangles (N ≥ 1), on their device: 2N − 1
    rows, internal nodes 0 … N − 2, leaf N − 1 + s holding the triangle of
    Morton position s (meta LEAF_FLAG | its index)."""
    n = int(triangles.shape[0])
    if n < 1:
        raise ValueError("build_lbvh2 requires at least one triangle")
    dev = triangles.device
    codes, order = build_morton_and_sort(triangles)
    leaf_bounds = pack_bounds_conservative(*_tri_bounds(triangles[order]))
    num_internal, num_nodes = n - 1, 2 * n - 1
    bounds = torch.zeros((num_nodes, 3), dtype=torch.int64, device=dev)
    bounds[num_internal:] = leaf_bounds
    meta = torch.zeros(num_nodes, dtype=torch.int64, device=dev)
    meta[num_internal:] = LEAF_FLAG | order
    zeros = torch.zeros(num_nodes, dtype=torch.int64, device=dev)
    if n == 1:
        return LBVH2(bounds, zeros, zeros.clone(),
                     meta, torch.full((1,), INVALID, dtype=torch.int64, device=dev))
    ileft, iright, parent = _karras_connectivity(codes, n)
    left, right = zeros, zeros.clone()
    left[:num_internal], right[:num_internal] = ileft, iright
    bounds = _bounds_fixed_point(bounds, left, right, num_internal, _static_height_bound(n))
    return LBVH2(bounds, left, right, meta, parent)


def build_sah2(triangles, device) -> tuple[LBVH2, int]:
    """The native binned-SAH BVH2 of (N, 3, 3) f32 host triangles (N ≥ 1),
    built on the host and moved to ``device``, and its height: the layout
    of :func:`build_lbvh2` (2N − 1 rows, root 0, leaf meta LEAF_FLAG |
    triangle, conservative fp16 bounds) with SAH topology. Word for word
    ``raytracer_tpu/ops/lbvh.py::build_sah2`` (the same C++ source and
    flags)."""
    tris = np.asarray(triangles, dtype=np.float32).reshape(-1, 3, 3)
    if len(tris) < 1:
        raise ValueError("build_sah2 requires at least one triangle")
    arrays, height = build_sah_native(tris)
    return LBVH2(*(torch.from_numpy(arrays[k].astype(np.int64)).to(device)
                   for k in ("bounds", "left", "right", "meta", "parent"))), height


def refit_lbvh2(bvh: LBVH2, triangles: torch.Tensor, num_sweeps: int | None = None) -> LBVH2:
    """Recompute every box of a (single-triangle-leaf) LBVH2 for moved
    triangles of the original order, keeping the topology: leaf boxes from
    the triangles, then the bounds sweep, ``num_sweeps`` times (default the
    static height bound of a Karras tree, the JAX package's cap)."""
    num_internal = bvh.num_internal
    n = num_internal + 1
    tri_idx = bvh.meta[num_internal:] & 0x7FFFFFFF
    bounds = torch.zeros((bvh.num_nodes, 3), dtype=torch.int64, device=triangles.device)
    bounds[num_internal:] = pack_bounds_conservative(*_tri_bounds(triangles[tri_idx]))
    if num_internal > 0:
        sweeps = num_sweeps if num_sweeps is not None else _static_height_bound(n)
        bounds = _bounds_fixed_point(bounds, bvh.left, bvh.right, num_internal, sweeps)
    return bvh._replace(bounds_u32=bounds)
