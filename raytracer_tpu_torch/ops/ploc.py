"""PLOC builder — BVH2 by parallel locally-ordered clustering, on the
device of the triangles.

Torch counterpart of ``raytracer_tpu/ops/ploc.py``, word for word: the
clusters, sorted by Morton code, each find their nearest neighbour (by the
surface area of the union box) within ±``radius`` positions; mutual pairs
merge, the merged cluster taking the lower position and a new internal id
counted down from N − 2, so that the last merge is the root 0; survivors
are compacted to the front; rounds repeat until one cluster is left. The
output has the LBVH2 layout of :func:`~raytracer_tpu_torch.ops.lbvh.
build_lbvh2` (leaves at N − 1 … 2N − 2 in Morton order, boxes swept up with
the conservative fp16 pack), so every widener and the records take it as
they take the LBVH.

The JAX package keeps its arrays at N and masks the clusters past the live
count c; here the arrays shrink to c every round. The masked tail never
reaches a live cluster there (a pair past c is never a candidate, nothing
merges into or out of it, compaction drops it), so the trees are the same.
The round loop runs on the host: one read of c a round.

The merge cost is compared with a strict ``<``, so one last-bit difference
in it can change the tree. XLA on the CPU contracts the JAX package's
``d0·d1 + d1·d2 + d2·d0`` into ``fma(d2, d0, fma(d0, d1, d1·d2))``; the port
computes that form on every device, each f32 FMA rounded once.
"""

from __future__ import annotations

import torch

from ..utils.fp16 import pack_bounds_conservative
from .cuda.traverse import _fma_f32
from .lbvh import (INVALID, LBVH2, LEAF_FLAG, _bounds_fixed_point, _static_height_bound,
                   _tri_bounds)
from .morton import build_morton_and_sort

__all__ = ["build_ploc2", "union_area"]

_BIG = 3.0e38


def union_area(mn_a: torch.Tensor, mx_a: torch.Tensor, mn_b: torch.Tensor,
               mx_b: torch.Tensor) -> torch.Tensor:
    """Surface area of the union of two boxes (..., 3), the PLOC merge cost,
    as XLA computes the JAX package's ``_union_area`` on the CPU."""
    d = torch.clamp_min(torch.maximum(mx_a, mx_b) - torch.minimum(mn_a, mn_b), 0.0)
    d0, d1, d2 = d[..., 0], d[..., 1], d[..., 2]
    return _fma_f32(d2, d0, _fma_f32(d0, d1, d1 * d2))


def _nearest(cmn: torch.Tensor, cmx: torch.Tensor, radius: int) -> torch.Tensor:
    """Each cluster's nearest neighbour within ±radius positions, visited in
    the JAX order: for d = 1 … radius, first the right candidate i + d, then
    (through the same costs) the left candidate i − d, each taken only on a
    strictly smaller cost; a cluster with no candidate keeps itself."""
    c = cmn.shape[0]
    idx = torch.arange(c, device=cmn.device)
    best_sa = torch.full((c,), _BIG, dtype=torch.float32, device=cmn.device)
    best_j = idx.clone()
    for d in range(1, min(radius, c - 1) + 1):
        sa = union_area(cmn[:-d], cmx[:-d], cmn[d:], cmx[d:])   # pair (i, i + d), i < c − d
        upd = sa < best_sa[:-d]
        best_j[:-d] = torch.where(upd, idx[d:], best_j[:-d])
        best_sa[:-d] = torch.where(upd, sa, best_sa[:-d])
        back = sa < best_sa[d:]                                 # pair (i − d, i), i >= d
        best_j[d:] = torch.where(back, idx[:-d], best_j[d:])
        best_sa[d:] = torch.where(back, sa, best_sa[d:])
    return best_j


def build_ploc2(triangles: torch.Tensor, radius: int = 8) -> LBVH2:
    """The PLOC BVH2 of (N, 3, 3) f32 triangles (N ≥ 1), on their device;
    the layout and words of ``raytracer_tpu/ops/ploc.py::build_ploc2``."""
    n = int(triangles.shape[0])
    if n < 1:
        raise ValueError("build_ploc2 requires at least one triangle")
    dev = triangles.device
    num_internal, num_nodes = n - 1, 2 * n - 1
    _, order = build_morton_and_sort(triangles)
    cmn, cmx = _tri_bounds(triangles[order])
    bounds = torch.zeros((num_nodes, 3), dtype=torch.int64, device=dev)
    bounds[num_internal:] = pack_bounds_conservative(cmn, cmx)
    meta = torch.zeros(num_nodes, dtype=torch.int64, device=dev)
    meta[num_internal:] = LEAF_FLAG | (order & 0x7FFFFFFF)
    if n == 1:
        zeros = torch.zeros(1, dtype=torch.int64, device=dev)
        return LBVH2(bounds, zeros, zeros.clone(), meta,
                     torch.full((1,), INVALID, dtype=torch.int64, device=dev))

    # one spare row each: the merges of a round write their children with a
    # single index_put_, the rows that do not merge write to the spare
    left = torch.zeros(num_nodes + 1, dtype=torch.int64, device=dev)
    right = torch.zeros_like(left)
    node_ids = num_internal + torch.arange(n, device=dev)
    next_internal = torch.tensor(num_internal - 1, device=dev)
    c = n
    while c > 1:
        idx = torch.arange(c, device=dev)
        nn = _nearest(cmn, cmx, radius)
        mutual = (nn[nn] == idx) & (idx < nn)
        # liveness guard: exact surface-area ties can leave a round with no
        # mutual pair; then the first two clusters merge
        stuck = ~mutual.any() & (idx == 0)
        mutual = mutual | stuck
        nn = torch.where(stuck, 1, nn)

        m = mutual.long()
        new_id = next_internal - (torch.cumsum(m, 0) - m)
        tgt = torch.where(mutual, new_id, num_nodes)
        left.index_put_((tgt,), node_ids)
        right.index_put_((tgt,), node_ids[nn])
        next_internal = next_internal - m.sum()

        cmn = torch.where(mutual[:, None], torch.minimum(cmn, cmn[nn]), cmn)
        cmx = torch.where(mutual[:, None], torch.maximum(cmx, cmx[nn]), cmx)
        node_ids = torch.where(mutual, new_id, node_ids)

        # the absorbed partners leave; the survivors move to the front
        keep = torch.ones(c + 1, dtype=torch.bool, device=dev)
        keep[torch.where(mutual, nn, c)] = False
        keep = keep[:c]
        pos = torch.where(keep, torch.cumsum(keep.long(), 0) - 1, c)
        c_next = int(keep.sum())
        cmn = _compact(cmn, pos, c_next)
        cmx = _compact(cmx, pos, c_next)
        node_ids = _compact(node_ids, pos, c_next)
        c = c_next

    left, right = left[:num_nodes], right[:num_nodes]
    parent = torch.full((num_nodes,), INVALID, dtype=torch.int64, device=dev)
    ids = torch.arange(num_internal, device=dev)
    parent[left[:num_internal]] = ids
    parent[right[:num_internal]] = ids
    parent[0] = INVALID
    bounds = _bounds_fixed_point(bounds, left, right, num_internal, _static_height_bound(n))
    return LBVH2(bounds, left, right, meta, parent)


def _compact(x: torch.Tensor, pos: torch.Tensor, count: int) -> torch.Tensor:
    """The rows of ``x`` at their ``pos`` (the rows to drop carry the spare
    position ``len(x)``), the first ``count`` kept."""
    out = torch.empty((x.shape[0] + 1, *x.shape[1:]), dtype=x.dtype, device=x.device)
    out.index_put_((pos,), x)
    return out[:count]
