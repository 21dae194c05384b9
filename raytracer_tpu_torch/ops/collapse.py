"""BVH2 → wide-tree wideners: the greedy re-emission collapse to 4 or 8
slots on the device, the collapse plan for a refit, and the two
index-preserving 4-wide views.

:func:`collapse_lbvh2_to_bvh4` and :func:`collapse_lbvh2_to_bvh8` are the
torch counterparts of the JAX package's device collapse
(``raytracer_tpu/ops/collapse.py``), node for node and bit for bit, on the
device of their input: treelets gathered (the first internal kid expanded
at 4 slots, the largest subtree at 8), bounds re-merged bottom-up and
re-packed with the truncating fp16 codec, the rows padded to the BVH2 row
count with bounds 0, children INVALID and meta 0.
:func:`collapse4_native_padded` runs the C++ collapse of the JAX package's
native tool (``raytracer_tpu/native/bvh_convert.cpp::bvh_collapse4``) and
pads the same way: an independent check of the device collapse.
:func:`promote_lbvh2_to_bvh4_wide` and :func:`bvh2_as_bvh4` are closed-form
index expressions over the BVH2's own rows.

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
from ..utils.fp16 import unpack_bounds
from .lbvh import INVALID, LBVH2, LEAF_FLAG, _static_height_bound, from_ordered_key, ordered_key

__all__ = ["LBVH2", "BVH4", "collapse_lbvh2_to_bvh4", "collapse_lbvh2_to_bvh8",
           "collapse4_native_padded",
           "promote_lbvh2_to_bvh4_wide", "bvh2_as_bvh4", "WIDENERS", "widen", "CollapsePlan",
           "collapse_plan", "collapse_apply_refit", "LEAF_FLAG", "INVALID"]

class BVH4(NamedTuple):
    """Wide BVH in struct-of-arrays form: packed fp16 bounds, w = 4 or 8
    children (INVALID for empty), meta = LEAF_FLAG|cluster for leaves / 0
    internal. The 8-wide tree travels in the same container, as in the JAX
    package."""

    bounds_u32: torch.Tensor  # (M, 3) int64
    children: torch.Tensor    # (M, w) int64
    meta: torch.Tensor        # (M,) int64
    num_nodes: int            # emitted rows; the rest are padding


def collapse4_native_padded(bvh2: LBVH2) -> BVH4:
    """The native C++ greedy collapse (``bvh_convert.cpp::bvh_collapse4``,
    on the host), padded to the BVH2's row count as the device collapse
    pads: rows of bounds 0, children INVALID and meta 0. Equal to
    :func:`collapse_lbvh2_to_bvh4` on the SAH cluster trees of the main path
    but in the sign of a zero where the C++ ``std::fmax`` keeps −0; kept as
    an independent cross-check of the device collapse."""
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


def _fixed_point(body, init: torch.Tensor, max_iters: int, same=torch.equal) -> torch.Tensor:
    """Iterate ``body`` until a step leaves the state unchanged (by
    ``same``) or ``max_iters`` is hit; returns the last state computed, as
    the JAX package's loop does. The test reads the state on the host: for
    once-per-tree work."""
    state = init
    for _ in range(max_iters):
        new = body(state)
        done = same(new, state)
        state = new
        if done:
            break
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


class _Layout(NamedTuple):
    """Steps 1–3 of the collapse for (M, w) treelets ``kids``: which BVH2
    nodes survive as wide nodes, and the pre-order row of each."""

    kid_valid: torch.Tensor  # (M, w) bool
    kids_i: torch.Tensor     # (M, w) int64 — kids clamped to valid rows
    reached: torch.Tensor    # (M,) bool — the node is emitted
    idx: torch.Tensor        # (M,) int64 — its pre-order row

    @property
    def rows(self) -> torch.Tensor:
        """Scatter target of each node: its row, or the sink when dropped."""
        return torch.where(self.reached, self.idx, self.idx.shape[0])

    def node_children(self, leaf: torch.Tensor) -> torch.Tensor:
        """(M, w) children of each node as pre-order rows (INVALID pad)."""
        return torch.where(leaf[:, None] | ~self.kid_valid, INVALID, self.idx[self.kids_i])


def _preorder_layout(kids: torch.Tensor, leaf: torch.Tensor, sweeps: int) -> _Layout:
    """Reachability top-down, wide-subtree sizes bottom-up, then the
    pre-order index ``idx(kid_k) = idx(n) + 1 + Σ_{j<k} size(kid_j)`` top-down,
    each a fixed point of at most ``sweeps`` sweeps, for any slot count."""
    m, width = kids.shape
    dev = kids.device
    kid_valid = kids != INVALID
    kids_i = kids.clamp(0, m - 1)
    sink = torch.full_like(kids_i[:, 0], m)

    def reach_body(isw):
        src = (isw > 0) & ~leaf
        upd = isw
        for k in range(width):
            tgt = torch.where(src & kid_valid[:, k], kids_i[:, k], sink)
            upd = _scatter(upd, tgt, src.to(torch.int32), "amax")
        return upd

    isw = torch.zeros(m, dtype=torch.int32, device=dev)
    isw[0] = 1
    reached = _fixed_point(reach_body, isw, sweeps) > 0

    def size_body(size):
        s = 1 + torch.where(kid_valid, size[kids_i], 0).sum(dim=-1)
        return torch.where(leaf, 1, s)

    size = _fixed_point(size_body, torch.ones(m, dtype=torch.int64, device=dev), sweeps)
    kid_sizes = torch.where(kid_valid, size[kids_i], 0)
    elder = kid_sizes.cumsum(dim=-1) - kid_sizes  # exclusive prefix sum

    def idx_body(idx):
        src = reached & ~leaf
        upd = idx
        for k in range(width):
            tgt = torch.where(src & kid_valid[:, k], kids_i[:, k], sink)
            upd = _scatter(upd, tgt, idx + 1 + elder[:, k])
        return upd

    idx = _fixed_point(idx_body, torch.zeros(m, dtype=torch.int64, device=dev), sweeps)
    return _Layout(kid_valid, kids_i, reached, idx)


def collapse_plan(bvh2: LBVH2, sweeps: int | None = None) -> CollapsePlan:
    """The static (topology) half of the 4-wide collapse, on the device of
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

    lay = _preorder_layout(_gather_kids(left, right, leaf), leaf, sweeps)
    rows = lay.rows
    children = _scatter(torch.full((m, 4), INVALID, dtype=torch.int64, device=dev), rows,
                        lay.node_children(leaf))
    out_meta = _scatter(torch.zeros_like(meta), rows, torch.where(leaf, meta, 0))
    src = _scatter(torch.zeros(m, dtype=torch.int64, device=dev), rows,
                   torch.arange(m, device=dev))
    emitted = _scatter(torch.zeros(m, dtype=torch.bool, device=dev), rows,
                       torch.ones(m, dtype=torch.bool, device=dev))
    return CollapsePlan(children, out_meta, src, emitted, int(lay.reached.sum()))


def _subtree_tri_counts(left: torch.Tensor, right: torch.Tensor, leaf: torch.Tensor,
                        sweeps: int) -> torch.Tensor:
    """Per-node leaf count of the BVH2 subtree (leaves = 1), bottom-up."""
    def body(cnt):
        return torch.where(leaf, 1, cnt[left] + cnt[right])

    return _fixed_point(body, torch.ones_like(left), sweeps)


def _gather_kids_wide(left: torch.Tensor, right: torch.Tensor, leaf: torch.Tensor,
                      width: int, weight: torch.Tensor) -> torch.Tensor:
    """(M, width) greedy treelet gather: starting from [L, R], ``width − 2``
    times split the valid internal kid with the largest ``weight`` in place
    and append its sibling at slot ``nvalid``, until the slots are full or
    every kid is a leaf. Among equal weights the first slot wins (the JAX
    package's ``argmax``): the choice is taken on weight·width + (width − 1 −
    slot), a key that cannot tie, so it is the same on every device. Leaf
    rows are INVALID."""
    m = left.shape[0]
    cols = torch.arange(width, device=left.device)[None, :]
    kids = torch.full((m, width), INVALID, dtype=torch.int64, device=left.device)
    kids[:, 0], kids[:, 1] = left, right
    nvalid = torch.full((m,), 2, dtype=torch.int64, device=left.device)
    for _ in range(width - 2):
        ki = kids.clamp(0, m - 1)
        internal = (kids != INVALID) & ~leaf[ki]
        w = torch.where(internal, weight[ki], -1)
        j = (w * width + (width - 1 - cols)).argmax(dim=-1)
        can = (w.amax(dim=-1) > 0) & (nvalid < width)
        node = ki.gather(1, j[:, None])[:, 0]
        kids = torch.where((cols == j[:, None]) & can[:, None], left[node][:, None], kids)
        kids = torch.where((cols == nvalid[:, None]) & can[:, None], right[node][:, None], kids)
        nvalid = nvalid + can
    return torch.where(leaf[:, None], INVALID, kids)


def _f32_to_f16_bits_trunc(x: torch.Tensor) -> torch.Tensor:
    """Truncating f32 → fp16 bit pattern (int64): mantissa bits dropped,
    exponent ≤ 0 flushed to signed zero, exponent ≥ 31 saturated to ±inf."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    s = (u >> 16) & 0x8000
    e = ((u >> 23) & 0xFF) - 112
    val = s | (e << 10) | ((u >> 13) & 0x03FF)
    return torch.where(e <= 0, s, torch.where(e >= 31, s | 0x7C00, val))


def _pack_bounds_trunc(mn: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """AABB (..., 3) min/max f32 → (..., 3) u32 words (int64) with the
    truncating codec."""
    def pack2(a, b):
        return _f32_to_f16_bits_trunc(a) | (_f32_to_f16_bits_trunc(b) << 16)

    return torch.stack([pack2(mn[..., 0], mn[..., 1]), pack2(mn[..., 2], mx[..., 0]),
                        pack2(mx[..., 1], mx[..., 2])], dim=-1)


def _same_f32(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equality of two ordered-key states as the f32 values they stand for
    (−0 equals +0): the JAX package's change test on its f32 bounds."""
    return not bool((from_ordered_key(a) != from_ordered_key(b)).any())


def _collapse(bvh2: LBVH2, width: int, sweeps: int | None) -> BVH4:
    """The device collapse at ``width`` slots: the treelets (4: the closed
    form of the first-internal expansion; 8: largest subtree first), then
    reachability, sizes and pre-order rows (:func:`_preorder_layout`),
    bounds merged bottom-up from the decoded fp16 boxes, internal rows
    re-packed with the truncating codec and leaf rows verbatim. The unions
    are taken on integer keys that order −0 below +0, as XLA's min and max
    do, where torch's would return either zero."""
    bounds2, left, right, meta = bvh2.bounds_u32, bvh2.left, bvh2.right, bvh2.meta
    m = bvh2.num_nodes
    dev = meta.device
    if sweeps is None:
        sweeps = _static_height_bound((m + 1) // 2)
    leaf = (meta & LEAF_FLAG) != 0
    if m == 1:
        return BVH4(bounds2, torch.full((1, width), INVALID, dtype=torch.int64, device=dev),
                    meta, 1)

    if width == 4:
        kids = _gather_kids(left, right, leaf)
    else:
        kids = _gather_kids_wide(left, right, leaf, width,
                                 _subtree_tri_counts(left, right, leaf, sweeps))
    lay = _preorder_layout(kids, leaf, sweeps)

    # merged bounds, bottom-up: state (2, M, 3) of ordered keys, [0] = min
    mn0, mx0 = unpack_bounds(bounds2)
    key0 = torch.stack([ordered_key(mn0), ordered_key(mx0)])
    inf = torch.full((1,), torch.inf, dtype=torch.float32, device=dev)
    key_inf, key_ninf = ordered_key(inf), ordered_key(-inf)
    valid = lay.kid_valid[..., None]

    def bounds_body(key):
        kmn = torch.where(valid, key[0][lay.kids_i], key_inf).amin(dim=1)
        kmx = torch.where(valid, key[1][lay.kids_i], key_ninf).amax(dim=1)
        return torch.where(leaf[None, :, None], key0, torch.stack([kmn, kmx]))

    key = _fixed_point(bounds_body, key0, sweeps, same=_same_f32)
    merged = _pack_bounds_trunc(from_ordered_key(key[0]), from_ordered_key(key[1]))

    rows = lay.rows
    bounds = _scatter(torch.zeros((m, 3), dtype=torch.int64, device=dev), rows,
                      torch.where(leaf[:, None], bounds2, merged))
    children = _scatter(torch.full((m, width), INVALID, dtype=torch.int64, device=dev), rows,
                        lay.node_children(leaf))
    out_meta = _scatter(torch.zeros_like(meta), rows, torch.where(leaf, meta, 0))
    return BVH4(bounds, children, out_meta, int(lay.reached.sum()))


def collapse_lbvh2_to_bvh4(bvh2: LBVH2, sweeps: int | None = None) -> BVH4:
    """4-wide greedy re-emission collapse (each node absorbs up to 4
    grandchildren, always expanding the first internal kid) → a BVH4
    padded to the BVH2's row count, on the device of ``bvh2``: the JAX
    package's device collapse, node for node and bit for bit. ``sweeps``
    caps each fixed point (≥ tree height; default the static bound of a
    Karras tree)."""
    return _collapse(bvh2, 4, sweeps)


def collapse_lbvh2_to_bvh8(bvh2: LBVH2, sweeps: int | None = None) -> BVH4:
    """8-wide greedy re-emission collapse → a BVH8 in the :class:`BVH4`
    container (children (M, 8)), padded to the BVH2's row count, on the
    device of ``bvh2``; treelets are gathered largest subtree first, as in
    the JAX package. ``sweeps`` as for :func:`collapse_lbvh2_to_bvh4`."""
    return _collapse(bvh2, 8, sweeps)


def promote_lbvh2_to_bvh4_wide(bvh2: LBVH2) -> BVH4:
    """O(N) index-preserving promotion: the BVH2's own rows and bounds, each
    internal node's (left, right) replaced by up to 4 grandchildren (a
    leaf child stays itself), compacted to the front."""
    left, right, meta = bvh2.left, bvh2.right, bvh2.meta
    m = bvh2.num_nodes
    leaf = (meta & LEAF_FLAG) != 0
    inv = torch.full_like(left, INVALID)

    def g(arr, c):
        return arr[c.clamp(0, m - 1)]

    lleaf, rleaf = (left >= m) | g(leaf, left), (right >= m) | g(leaf, right)
    a0 = torch.where(lleaf, left, g(left, left))
    a1 = torch.where(lleaf, inv, g(right, left))
    b0 = torch.where(rleaf, right, g(left, right))
    b1 = torch.where(rleaf, inv, g(right, right))
    children = torch.stack([a0, torch.where(lleaf, b0, a1), torch.where(lleaf, b1, b0),
                            torch.where(lleaf, inv, b1)], dim=-1)
    children = torch.where(leaf[:, None], INVALID, children)
    return BVH4(bvh2.bounds_u32, children, torch.where(leaf, meta, 0), m)


def bvh2_as_bvh4(bvh2: LBVH2) -> BVH4:
    """The binary tree in the 4-wide node struct (children = [left, right,
    INVALID, INVALID]), so the same kernels run a pure BVH2 traversal."""
    leaf = (bvh2.meta & LEAF_FLAG) != 0
    inv = torch.full_like(bvh2.left, INVALID)
    children = torch.stack([bvh2.left, bvh2.right, inv, inv], dim=-1)
    children = torch.where(leaf[:, None], INVALID, children)
    return BVH4(bvh2.bounds_u32, children, bvh2.meta, bvh2.num_nodes)


WIDENERS = ("collapse", "collapse8", "promote", "bvh2")


def widen(bvh2: LBVH2, widener: str = "collapse", height: int | None = None) -> BVH4:
    """The BVH2 through one of the JAX package's wideners (:data:`WIDENERS`)
    → its wide tree, on the device of ``bvh2``: the 4- or 8-wide device
    collapse, the promotion, or the BVH2 in the 4-wide struct. ``height``
    (the tree's, where the builder knows it) caps the collapse's sweeps at
    ``height + 2``; without it the static bound of a Karras tree does. The
    sweeps stop where they converge, so the cap changes no result."""
    if widener not in WIDENERS:
        raise ValueError(f"unknown widener {widener!r}")
    if widener in ("collapse", "collapse8"):
        return _collapse(bvh2, 8 if widener == "collapse8" else 4,
                         None if height is None else height + 2)
    return {"promote": promote_lbvh2_to_bvh4_wide, "bvh2": bvh2_as_bvh4}[widener](bvh2)


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
