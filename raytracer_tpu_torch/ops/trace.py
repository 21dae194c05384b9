"""Wide-node layout and the brute-force oracle tracer.

Torch counterparts of ``raytracer_tpu/ops/trace.py``: :func:`make_wide_bvh`
folds each node's children's bounds and kind into the parent (the input of
the supernode records), and :func:`trace_rays_brute` tests every ray against
every triangle — the independent oracle for the traversal kernel.

Möller–Trumbore here uses the component formulas and operation order of the
kernel (eps 1e-7, strict t > eps), so an oracle pixel differs from the
kernel only where two triangles tie.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.fp16 import unpack_bounds
from .camera import INF
from .collapse import BVH4, INVALID, LEAF_FLAG

__all__ = ["WideBVH", "make_wide_bvh", "trace_rays_brute", "moller_trumbore",
           "STACK_MAX", "MT_EPS"]

STACK_MAX = 64
MT_EPS = 1e-7
_CREF_LEAF_BIT = 1 << 30
# rays × triangles per brute-force chunk: bounds the (R, T) temporaries
_BRUTE_CHUNK_ELEMS = 1 << 24


class WideBVH(NamedTuple):
    """Traversal-ready BVH: per node, its w = 4 or 8 children's boxes and
    refs inline (w is the child count of the tree it was made from)."""

    cmn: torch.Tensor      # (M, w, 3) f32 — child box minima (+inf for empty)
    cmx: torch.Tensor      # (M, w, 3) f32 — child box maxima (−inf for empty)
    cref: torch.Tensor     # (M, w) int32 — -1 empty, bit 30 → leaf|cluster, else node
    root_mn: torch.Tensor  # (3,) f32
    root_mx: torch.Tensor  # (3,) f32


def make_wide_bvh(bvh: BVH4) -> WideBVH:
    """Fold each node's children's bounds/kind into the parent record.

    Child slots that are INVALID, out of range, or carry a degenerate
    (min>max) box are disabled."""
    m = bvh.bounds_u32.shape[0]
    mn, mx = unpack_bounds(bvh.bounds_u32)
    ch = bvh.children
    valid = (ch != INVALID) & (ch < bvh.num_nodes)
    ci = ch.clamp(0, m - 1)
    cmn, cmx, cmeta = mn[ci], mx[ci], bvh.meta[ci]
    valid = valid & ~(cmn > cmx).any(dim=-1)

    child_leaf = (cmeta & LEAF_FLAG) != 0
    cref = torch.where(child_leaf, (cmeta & 0x7FFFFFFF) | _CREF_LEAF_BIT, ci)
    cref = torch.where(valid, cref, -1).to(torch.int32)
    cmn = torch.where(valid[..., None], cmn, torch.inf)
    cmx = torch.where(valid[..., None], cmx, -torch.inf)
    return WideBVH(cmn=cmn, cmx=cmx, cref=cref, root_mn=mn[0], root_mx=mx[0])


def moller_trumbore(o, d, v0, e1, e2):
    """Möller–Trumbore from (v0, e1=v1−v0, e2=v2−v0); all (..., 3), broadcast.
    Returns (t, ok) without the t < best test."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = torch.where(det == 0.0, torch.ones_like(det), det).reciprocal()
    s = o - v0
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    uu = inv_det * (sx * px + sy * py + sz * pz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    vv = inv_det * (dx * qx + dy * qy + dz * qz)
    tt = inv_det * (e2x * qx + e2y * qy + e2z * qz)
    ok = ((det.abs() >= MT_EPS) & (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0)
          & (uu + vv <= 1.0) & (tt > MT_EPS))
    return tt, ok


def trace_rays_brute(tris: torch.Tensor, origins: torch.Tensor, dirs: torch.Tensor):
    """Ground-truth closest hit: every ray (R,3) against every triangle
    (T,3,3) → (t (R,), tri (R,) int32; 1e30 / −1 on a miss).

    O(R·T), chunked over rays. Tie-break: lowest triangle index."""
    r, n = origins.shape[0], tris.shape[0]
    t_out = torch.full((r,), INF, dtype=torch.float32, device=origins.device)
    tri_out = torch.full((r,), -1, dtype=torch.int32, device=origins.device)
    if n == 0:
        return t_out, tri_out
    v0 = tris[None, :, 0, :]
    e1 = tris[None, :, 1, :] - v0
    e2 = tris[None, :, 2, :] - v0
    step = max(1, _BRUTE_CHUNK_ELEMS // n)
    for a in range(0, r, step):
        o = origins[a:a + step, None, :]
        d = dirs[a:a + step, None, :]
        t, ok = moller_trumbore(o, d, v0, e1, e2)
        t = torch.where(ok, t, torch.full_like(t, INF))
        idx = torch.argmin(t, dim=-1)  # the first minimum: lowest index wins
        best = t.gather(-1, idx[:, None])[:, 0]
        t_out[a:a + step] = best
        tri_out[a:a + step] = torch.where(best < INF, idx, -1).to(torch.int32)
    return t_out, tri_out
