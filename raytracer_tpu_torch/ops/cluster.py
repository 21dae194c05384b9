"""Packed-leaf (K triangles per leaf) trees: the SAH cluster build, the
Morton cluster build, their refit to deformed triangles, and the records
pipeline of the main path.

Torch counterpart of ``raytracer_tpu/ops/cluster.py``: cluster ``c`` owns
the sorted triangles [cK, min(N, (c+1)K)); the tree's leaves reference
cluster indices, and the records inline the sorted vertices together with
the original triangle ids, so hits report the scene's own indices.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..native.bvhtool import build_sah_clustered_native
from ..utils.fp16 import _halfwords, _pack_halfwords, pack_bounds_conservative
from .collapse import widen
from .cuda.traverse import make_qnodes
from .lbvh import (INVALID, LBVH2, LEAF_FLAG, _bounds_fixed_point, _karras_connectivity,
                   _static_height_bound, _tri_bounds, f16_order, f16_union_order,
                   f16_union_unorder, f16_unorder, xla_reduce)
from .morton import build_morton_and_sort
from .trace import WideBVH, make_wide_bvh

__all__ = ["ClusteredScene", "build_lbvh2_clustered", "build_sah2_clustered",
           "refit_lbvh2_clustered", "tree_height", "records_pipeline", "wide_pipeline",
           "state_from_numpy", "bvh2_from_numpy"]


class ClusteredScene(NamedTuple):
    """A packed-leaf BVH2 plus the cluster-ordered geometry it indexes."""

    bvh2: LBVH2                # leaves carry LEAF_FLAG|cluster
    tris_sorted: torch.Tensor  # (N,3,3) f32 — cluster members contiguous
    tri_order: torch.Tensor    # (N,) int64 — original index per sorted position
    leaf_size: int             # K — max triangles per cluster


def bvh2_from_numpy(arrays: dict) -> LBVH2:
    """The BVH2 arrays of the JAX package's npz checkpoint (``bvh2_{bounds,
    left,right,meta,parent}``, u32) → an :class:`LBVH2` on the host."""
    return LBVH2(*(torch.from_numpy(np.asarray(arrays[f"bvh2_{k}"], np.uint32).astype(np.int64))
                   for k in ("bounds", "left", "right", "meta", "parent")))


def state_from_numpy(arrays: dict, device) -> ClusteredScene:
    """The JAX package's clustered-tree arrays (as numpy, under the keys of
    its npz checkpoint: ``triangles``, ``bvh2_{bounds,left,right,meta,
    parent}``, ``tri_order``, ``leaf_size``) → the port's tensors. The
    state is the BVH2 and its cluster order: the same for every widener,
    which only decides how the records are made from it."""
    tris = torch.from_numpy(np.asarray(arrays["triangles"], np.float32).reshape(-1, 3, 3))
    order = torch.from_numpy(np.asarray(arrays["tri_order"], np.uint32).astype(np.int64))
    return ClusteredScene(bvh2_from_numpy(arrays), tris[order].to(device), order.to(device),
                          int(np.asarray(arrays["leaf_size"]).reshape(-1)[0]))


def _cluster_reduce(x: torch.Tensor, upper: bool) -> torch.Tensor:
    """XLA's ``jnp.min(x, axis=1)`` (``jnp.max`` with ``upper``) of the (C, K,
    3) member boxes of C clusters, in the form XLA on the CPU compiles the
    JAX package's unpadded cluster union (C·K = N) to, bit for bit.

    Every form propagates NaN and gives the same numbers; they differ in
    which NaN's payload is returned, the choice of each pairwise min / max
    (:func:`~raytracer_tpu_torch.ops.lbvh.xla_reduce`). For K = 8 and 16 ≤ K
    ≤ 32 the union of a cluster is vectorized: its first 8·⌊K/8⌋ members
    fold into 2 vectors of 4 lanes (member j into lane j mod 4 of vector
    ⌊j/4⌋ mod 2), the two vectors are combined lane by lane, the 4 lanes
    are folded in order, and the members left fold in after them. For every
    other K, and wherever the triangles were padded to C·K, the members
    fold in order. Read off the JAX package (``tests/test_torch_nan_bounds.py``)."""
    c, k = x.shape[0], x.shape[1]
    if not (k == 8 or 16 <= k <= 32):
        return xla_reduce(x, 1, upper)
    main = 8 * (k // 8)
    lanes = xla_reduce(x[:, :main].reshape(c, main // 8, 2, 4, 3), 1, upper)
    acc = xla_reduce(xla_reduce(lanes, 1, upper), 1, upper)
    if main == k:
        return acc
    return xla_reduce(torch.cat([acc[:, None], x[:, main:]], dim=1), 1, upper)


def _cluster_bounds(tris_sorted: torch.Tensor, c: int, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 boxes (C, 3) min / max of the C clusters of K triangles of
    the cluster-ordered (N, 3, 3) triangles: the JAX package's per-triangle
    reductions, a pad to C·K with ±inf, and the cluster unions."""
    tmn, tmx = _tri_bounds(tris_sorted)
    n = tris_sorted.shape[0]
    if c * k == n:
        return (_cluster_reduce(tmn.reshape(c, k, 3), False),
                _cluster_reduce(tmx.reshape(c, k, 3), True))
    pad = torch.full((c * k - n, 3), torch.inf, dtype=torch.float32, device=tris_sorted.device)
    return (xla_reduce(torch.cat([tmn, pad]).reshape(c, k, 3), 1, False),
            xla_reduce(torch.cat([tmx, -pad]).reshape(c, k, 3), 1, True))


def build_lbvh2_clustered(triangles: torch.Tensor, leaf_size: int) -> ClusteredScene:
    """Packed-leaf LBVH2 over (N, 3, 3) triangles, on their device: clusters
    are runs of K = ``leaf_size`` triangles in Morton order (cluster c owns
    sorted triangles [cK, min(N, (c+1)K))), each leaf's box the
    conservatively packed union of its members', the Karras tree built over
    each cluster's leading code and its boxes swept up as in
    :func:`~raytracer_tpu_torch.ops.lbvh.build_lbvh2`. Node for node and bit
    for bit ``raytracer_tpu/ops/cluster.py::build_lbvh2_clustered``."""
    n, k = int(triangles.shape[0]), int(leaf_size)
    if n < 1:
        raise ValueError("build_lbvh2_clustered requires at least one triangle")
    if k < 1:
        raise ValueError("leaf_size must be >= 1")
    dev = triangles.device
    c = -(-n // k)
    num_internal, num_nodes = c - 1, 2 * c - 1
    codes, order = build_morton_and_sort(triangles)
    tris_sorted = triangles[order]
    cl_mn, cl_mx = _cluster_bounds(tris_sorted, c, k)
    bounds = torch.zeros((num_nodes, 3), dtype=torch.int64, device=dev)
    bounds[num_internal:] = pack_bounds_conservative(cl_mn, cl_mx)
    meta = torch.zeros(num_nodes, dtype=torch.int64, device=dev)
    meta[num_internal:] = LEAF_FLAG | torch.arange(c, device=dev)
    left = torch.zeros(num_nodes, dtype=torch.int64, device=dev)
    right = torch.zeros_like(left)
    parent = torch.full((num_nodes,), INVALID, dtype=torch.int64, device=dev)
    if c > 1:
        ileft, iright, parent = _karras_connectivity(codes[::k].contiguous(), c)
        left[:num_internal], right[:num_internal] = ileft, iright
        bounds = _bounds_fixed_point(bounds, left, right, num_internal, _static_height_bound(c))
    return ClusteredScene(LBVH2(bounds, left, right, meta, parent), tris_sorted, order, k)


def build_sah2_clustered(triangles: np.ndarray, leaf_size: int, device
                         ) -> tuple[ClusteredScene, int]:
    """SAH-quality packed-leaf BVH2 (native binned SAH on the host) + its
    height. Splits snap to multiples of K, so clusters are spatially
    compact."""
    tris = np.asarray(triangles, dtype=np.float32).reshape(-1, 3, 3)
    if len(tris) < 1:
        raise ValueError("build_sah2_clustered requires at least one triangle")
    arrays, order, height = build_sah_clustered_native(tris, leaf_size)
    state = state_from_numpy({
        "triangles": tris, "tri_order": order, "leaf_size": [leaf_size],
        **{f"bvh2_{k}": v for k, v in arrays.items()},
    }, device)
    return state, height


def tree_height(bvh2: LBVH2) -> int:
    """Max leaf depth (0 for a single leaf), read on the host: the number of
    bottom-up union sweeps after which a refit's bounds stop changing."""
    left, right, meta = (a.cpu().numpy() for a in (bvh2.left, bvh2.right, bvh2.meta))
    leaf = (meta & LEAF_FLAG) != 0
    level, height = np.zeros(1, np.int64), 0
    while True:
        level = level[~leaf[level]]
        if level.size == 0:
            return height
        level = np.concatenate([left[level], right[level]]).astype(np.int64)
        height += 1


def refit_lbvh2_clustered(cs: ClusteredScene, triangles: torch.Tensor,
                          num_sweeps: int | None = None) -> ClusteredScene:
    """Refit a packed-cluster tree to deformed triangles (same count,
    ORIGINAL order), keeping topology and the cluster assignment; only the
    bounds move. Runs on the device of ``triangles``, where the returned
    scene's tree lives: the topology is copied there once, by the first
    refit of a tree built on the host.

    Leaf rows (found by ``LEAF_FLAG``, never by row position: the SAH tree
    is pre-order with leaves interleaved) get their cluster's union, packed
    conservatively; internal rows the plain-packed union of their children,
    swept bottom-up. The JAX package sweeps until nothing changes (at most
    ``num_sweeps``), which on the card would read a flag back every sweep.
    Here ``num_sweeps`` sweeps run with no test (pass ``height + 2`` from
    the build: a bounded frame that never waits on the card); the result is
    the same bit for bit, because the sweeps converge in ``tree_height``
    steps to the one fixed point of an acyclic tree and change nothing
    after. Without ``num_sweeps`` (the JAX package's cap is then the node
    count, never below the height) the height is read on the host and
    that many sweeps run.

    Each sweep takes the min/max on fp16 keys ordered by value: a union of
    fp16 values is an fp16 value, so this is the JAX package's unpack →
    f32 min/max (−0 below +0, NaN propagated as
    :func:`~raytracer_tpu_torch.ops.lbvh.f16_union_key` says) → pack,
    without the conversions: one ``minimum`` of the keys' orders
    (:func:`~raytracer_tpu_torch.ops.lbvh.f16_union_order`) a sweep."""
    dev = triangles.device
    bvh = LBVH2(*(a.to(dev) for a in cs.bvh2))
    order = cs.tri_order.to(dev)
    k, c = cs.leaf_size, bvh.num_internal + 1
    if num_sweeps is None:
        num_sweeps = tree_height(bvh)

    tris_sorted = triangles[order]
    cl_mn, cl_mx = _cluster_bounds(tris_sorted, c, k)

    leaf = (bvh.meta & LEAF_FLAG) != 0
    cidx = torch.where(leaf, bvh.meta & 0x7FFFFFFF, 0)
    leaf_bounds = torch.where(leaf[:, None], pack_bounds_conservative(cl_mn[cidx], cl_mx[cidx]), 0)
    bounds = leaf_bounds
    if bvh.num_internal > 0:
        union = f16_union_order(f16_order(_halfwords(bounds)))
        left, right = bvh.left, bvh.right
        for _ in range(num_sweeps):
            union = torch.where(leaf[:, None], union, torch.minimum(union[left], union[right]))
        packed = _pack_halfwords(f16_unorder(f16_union_unorder(union)))
        bounds = torch.where(leaf[:, None], leaf_bounds, packed)
    return ClusteredScene(bvh._replace(bounds_u32=bounds), tris_sorted, order, k)


def wide_pipeline(cs: ClusteredScene, *, height: int | None = None, width: int = 4) -> WideBVH:
    """collapse → the wide tree with ``width`` (4 or 8) child slots per node,
    on the device of ``cs.tris_sorted`` (:func:`~raytracer_tpu_torch.ops.
    collapse.widen`, ``height`` as there)."""
    if width not in (4, 8):
        raise ValueError(f"records have 4 or 8 child slots, got width={width}")
    dev = cs.tris_sorted.device
    return make_wide_bvh(widen(LBVH2(*(a.to(dev) for a in cs.bvh2)),
                               "collapse" if width == 4 else "collapse8", height))


def records_pipeline(cs: ClusteredScene, *, height: int | None = None,
                     width: int = 4) -> torch.Tensor:
    """collapse → widen (:func:`wide_pipeline`) → supernode records (M, recw)
    f32 on the device of ``cs.tris_sorted``, with ``width`` child slots per
    record."""
    return make_qnodes(wide_pipeline(cs, height=height, width=width), cs.tris_sorted,
                       tri_ids=cs.tri_order, leaf_size=cs.leaf_size)
