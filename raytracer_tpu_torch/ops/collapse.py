"""BVH2 → BVH4 collapse: the native greedy re-emission collapse for a
build, and the collapse plan for a refit.

The JAX package collapses on the device (``raytracer_tpu/ops/collapse.py``).
On the SAH-clustered trees of the main path its result equals the C++
collapse (``raytracer_tpu/native/bvh_convert.cpp::bvh_collapse4``) word for
word over the emitted rows; the JAX version then pads to the BVH2 row count
with rows of bounds 0, children INVALID and meta 0. This module calls the
C++ collapse and pads the same way, so the records built from either are
byte-equal. The device collapse comes with a later slice.

For dynamic scenes the topology half of the collapse (treelet gathering,
reachability, subtree sizes, pre-order indices) is computed once per tree
(:func:`collapse_plan`, on the device of the tree, with host-checked
fixed points); each refitted frame is then one gather of the BVH2 bounds
(:func:`collapse_apply_refit`) with no host synchronisation.

Tensors here hold u32 words as int64: torch has no full uint32 arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..io import artifacts
from ..native.bvhtool import collapse4_native
from .lbvh import _static_height_bound

__all__ = ["LBVH2", "BVH4", "collapse_lbvh2_to_bvh4", "CollapsePlan", "collapse_plan",
           "collapse_apply_refit", "LEAF_FLAG", "INVALID"]

LEAF_FLAG = 0x80000000
INVALID = 0xFFFFFFFF


class LBVH2(NamedTuple):
    """BVH2 in struct-of-arrays form, int64 tensors of u32 words (the node
    layout of ``raytracer_tpu/ops/lbvh.py::LBVH2``): on the host after a
    build, on the triangles' device after a refit."""

    bounds_u32: torch.Tensor  # (M, 3) packed fp16 AABBs
    left: torch.Tensor        # (M,) child index (0 for leaves)
    right: torch.Tensor       # (M,)
    meta: torch.Tensor        # (M,) LEAF_FLAG|cluster for leaves, 0 internal
    parent: torch.Tensor      # (M,) INVALID at the root

    @property
    def num_nodes(self) -> int:
        return self.bounds_u32.shape[0]

    @property
    def num_internal(self) -> int:
        return (self.num_nodes - 1) // 2


class BVH4(NamedTuple):
    """BVH4 in struct-of-arrays form: packed fp16 bounds, 4 children
    (INVALID for empty), meta = LEAF_FLAG|cluster for leaves / 0 internal."""

    bounds_u32: torch.Tensor  # (M, 3) int64
    children: torch.Tensor    # (M, 4) int64
    meta: torch.Tensor        # (M,) int64
    num_nodes: int            # emitted rows; the rest are padding


def collapse_lbvh2_to_bvh4(bvh2: LBVH2) -> BVH4:
    """Greedy re-emission collapse, padded to the BVH2's row count."""
    buf2 = artifacts.bvh2_to_u32(*(a.cpu().numpy() for a in
                                   (bvh2.bounds_u32, bvh2.left, bvh2.right, bvh2.meta)))
    b4, c4, m4 = artifacts.bvh4_from_u32(collapse4_native(buf2))
    rows, n4 = bvh2.num_nodes, len(m4)
    bounds = np.zeros((rows, 3), np.int64)
    children = np.full((rows, 4), INVALID, np.int64)
    meta = np.zeros(rows, np.int64)
    bounds[:n4], children[:n4], meta[:n4] = b4, c4, m4
    return BVH4(torch.from_numpy(bounds), torch.from_numpy(children),
                torch.from_numpy(meta), n4)


class CollapsePlan(NamedTuple):
    """The topology half of the greedy collapse, computed once per tree:
    refitting moves bounds but never topology."""

    children: torch.Tensor  # (M, 4) int64 — BVH4 children per pre-order row
    meta: torch.Tensor      # (M,) int64 — LEAF_FLAG|cluster or 0
    src: torch.Tensor       # (M,) int64 — source BVH2 node of each BVH4 row
    emitted: torch.Tensor   # (M,) bool — row < num_nodes (pre-order is dense)
    num_nodes: int


def _gather_kids(left: torch.Tensor, right: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """(M,4) kid ids per node (INVALID pad): the closed form of the greedy
    treelet gathering (expand the first internal kid, at most twice). Leaf
    rows are INVALID."""
    m = left.shape[0]

    def g(arr, idx):
        return arr[idx.clamp(0, m - 1)]

    def sel(c, a, b):
        return torch.where(c, a, b)

    inv = torch.full_like(left, INVALID)
    L, R = left, right
    LL, LR, RL, RR = g(left, L), g(right, L), g(left, R), g(right, R)
    leafL, leafR = g(leaf, L), g(leaf, R)
    leafLL, leafLR, leafRL, leafRR = g(leaf, LL), g(leaf, LR), g(leaf, RL), g(leaf, RR)

    # ~leafL: after one step the kids are [LL, LR, R]; expand the first internal
    LLL, LLR, LRL, LRR = g(left, LL), g(right, LL), g(left, LR), g(right, LR)
    nl_k0 = sel(~leafLL, LLL, LL)
    nl_k1 = sel(~leafLL, LLR, sel(~leafLR, LRL, LR))
    nl_k2 = sel(~leafLL, LR, sel(~leafLR, LRR, sel(~leafR, RL, R)))
    nl_k3 = sel(~leafLL, R, sel(~leafLR, R, sel(~leafR, RR, inv)))
    # leafL & ~leafR: after one step the kids are [L, RL, RR]
    RLL, RLR, RRL, RRR = g(left, RL), g(right, RL), g(left, RR), g(right, RR)
    lr_k1 = sel(~leafRL, RLL, RL)
    lr_k2 = sel(~leafRL, RLR, sel(~leafRR, RRL, RR))
    lr_k3 = sel(~leafRL, RR, sel(~leafRR, RRR, inv))
    # leafL & leafR: [L, R, INVALID, INVALID]
    kids = torch.stack([sel(~leafL, nl_k0, L),
                        sel(~leafL, nl_k1, sel(~leafR, lr_k1, R)),
                        sel(~leafL, nl_k2, sel(~leafR, lr_k2, inv)),
                        sel(~leafL, nl_k3, sel(~leafR, lr_k3, inv))], dim=-1)
    return torch.where(leaf[:, None], INVALID, kids)


def _fixed_point(body, init: torch.Tensor, max_iters: int) -> torch.Tensor:
    """Iterate ``body`` until the state stops changing or ``max_iters`` is
    hit. The test reads the state on the host: for once-per-tree work."""
    state = init
    for _ in range(max_iters):
        new = body(state)
        if torch.equal(new, state):
            break
        state = new
    return state


def _scatter(base: torch.Tensor, tgt: torch.Tensor, vals: torch.Tensor,
             reduce: str | None = None) -> torch.Tensor:
    """``base.at[tgt].set/max(vals, mode="drop")`` of the JAX package:
    targets equal to ``len(base)`` land in a sink row that is cut off."""
    m = base.shape[0]
    ext = torch.cat([base, base[:1]])
    idx = tgt.reshape(tgt.shape[0], *([1] * (base.dim() - 1))).expand_as(vals)
    if reduce is None:
        ext.scatter_(0, idx, vals)
    else:
        ext.scatter_reduce_(0, idx, vals, reduce=reduce)
    return ext[:m]


def collapse_plan(bvh2: LBVH2, sweeps: int | None = None) -> CollapsePlan:
    """The static (topology) half of the collapse, on the device of
    ``bvh2``. ``sweeps`` caps each fixed point (≥ tree height; default the
    static bound of a Karras tree, as in the JAX package)."""
    left, right, meta = bvh2.left, bvh2.right, bvh2.meta
    m = bvh2.num_nodes
    dev = meta.device
    if sweeps is None:
        sweeps = _static_height_bound((m + 1) // 2)
    leaf = (meta & LEAF_FLAG) != 0
    if m == 1:
        return CollapsePlan(torch.full((1, 4), INVALID, dtype=torch.int64, device=dev),
                            meta.clone(), torch.zeros(1, dtype=torch.int64, device=dev),
                            torch.ones(1, dtype=torch.bool, device=dev), 1)

    kids = _gather_kids(left, right, leaf)
    kid_valid = kids != INVALID
    kids_i = kids.clamp(0, m - 1)
    sink = torch.full_like(kids_i[:, 0], m)

    def reach_body(is4):
        src = (is4 > 0) & ~leaf
        upd = is4
        for k in range(4):
            tgt = torch.where(src & kid_valid[:, k], kids_i[:, k], sink)
            upd = _scatter(upd, tgt, src.to(torch.int32), "amax")
        return upd

    is4 = torch.zeros(m, dtype=torch.int32, device=dev)
    is4[0] = 1
    is4b = _fixed_point(reach_body, is4, sweeps) > 0

    def size_body(size):
        s = 1 + torch.where(kid_valid, size[kids_i], 0).sum(dim=-1)
        return torch.where(leaf, 1, s)

    size = _fixed_point(size_body, torch.ones(m, dtype=torch.int64, device=dev), sweeps)
    kid_sizes = torch.where(kid_valid, size[kids_i], 0)
    elder = kid_sizes.cumsum(dim=-1) - kid_sizes  # exclusive prefix sum

    def idx_body(idx):
        src = is4b & ~leaf
        upd = idx
        for k in range(4):
            tgt = torch.where(src & kid_valid[:, k], kids_i[:, k], sink)
            upd = _scatter(upd, tgt, idx + 1 + elder[:, k])
        return upd

    idx = _fixed_point(idx_body, torch.zeros(m, dtype=torch.int64, device=dev), sweeps)

    node_children = torch.where(leaf[:, None] | ~kid_valid, INVALID, idx[kids_i])
    node_meta = torch.where(leaf, meta, 0)
    rows = torch.where(is4b, idx, sink)
    children = _scatter(torch.full((m, 4), INVALID, dtype=torch.int64, device=dev), rows,
                        node_children)
    out_meta = _scatter(torch.zeros_like(meta), rows, node_meta)
    src = _scatter(torch.zeros(m, dtype=torch.int64, device=dev), rows,
                   torch.arange(m, device=dev))
    emitted = _scatter(torch.zeros(m, dtype=torch.bool, device=dev), rows,
                       torch.ones(m, dtype=torch.bool, device=dev))
    return CollapsePlan(children, out_meta, src, emitted, int(is4b.sum()))


def _flush_f16_subnormals(b: torch.Tensor) -> torch.Tensor:
    """Flush the fp16 subnormal halfwords of packed u32 words to signed zero,
    as the full collapse's truncating re-pack does."""
    def fl(h):
        return torch.where((h & 0x7C00) == 0, h & 0x8000, h)

    return fl(b & 0xFFFF) | (fl(b >> 16) << 16)


def collapse_apply_refit(plan: CollapsePlan, bounds2_u32: torch.Tensor) -> BVH4:
    """BVH4 from a plan and REFITTED BVH2 bounds: one gather, and the flush
    of subnormal halfwords on internal rows. Equal to the full collapse when
    every parent bound is the fp16 union of its children's, which
    :func:`~raytracer_tpu_torch.ops.cluster.refit_lbvh2_clustered`
    guarantees."""
    m = plan.src.shape[0]
    b4 = bounds2_u32[plan.src.clamp(0, m - 1)]
    b4 = torch.where((plan.meta == 0)[:, None], _flush_f16_subnormals(b4), b4)
    b4 = torch.where(plan.emitted[:, None], b4, 0)
    return BVH4(b4, plan.children, plan.meta, plan.num_nodes)
