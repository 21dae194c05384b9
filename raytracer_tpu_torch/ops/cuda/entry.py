"""Per-tile traversal entry nodes — a conservative descent of each tile's
frustum through the top of the tree.

Torch counterpart of ``raytracer_tpu/ops/pallas/entry.py`` (plain tensor
code there as here; it sits beside the kernel that consumes its result).
The rays of one 32×32-pixel tile share the camera origin and span a narrow
cone, so the top of the BVH is the same work for every ray of the tile.
:func:`compute_tile_entries` walks each tile's cone down from the root:
while exactly one child of the current node can be hit by the cone, and
that child is an internal node, it descends. K1d (``trace_tiles(entries=…)``)
then starts the tile's rays at that node instead of the root.

Conservativeness: unnormalized ray directions are affine in the pixel
coordinates, so their per-axis extremes over a tile are at its corner rays;
interval arithmetic over [d_min, d_max] (an interval that spans zero widened
to (−∞, ∞)) gives a slab test that can only over-report hits. Descending
only while a single child may be hit therefore never skips a node that a
ray of the tile could enter.

The descent is a fixed number of steps over the whole tile grid at once, on
the device of the tree: nothing is read back to the host. It is written over
the slot axis, so it takes 4-wide and 8-wide trees.
"""

from __future__ import annotations

import torch

from ..camera import camera_constants, to_device
from ..trace import WideBVH

__all__ = ["compute_tile_entries"]

_INF = 3.4e38
_LEAF_BIT = 1 << 30


def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u × v for u (3,) and v (..., 3), in the component order of
    ``jnp.cross``."""
    return torch.stack([u[1] * v[..., 2] - u[2] * v[..., 1],
                        u[2] * v[..., 0] - u[0] * v[..., 2],
                        u[0] * v[..., 1] - u[1] * v[..., 0]], dim=-1)


def _corner_dirs(width: int, height: int, nty: int, ntx: int, tile: int, cam_quat,
                 fov_degrees: float, device) -> torch.Tensor:
    """Unnormalized, rotated directions of each tile's four corner rays
    (through the centres of its corner pixels) → (nty, ntx, 4, 3)."""
    f32 = torch.float32
    focal, aspect = camera_constants(width, height, fov_degrees)
    w = torch.full((), float(width), dtype=f32, device=device)
    h = torch.full((), float(height), dtype=f32, device=device)
    tx = torch.arange(ntx, dtype=f32, device=device)
    ty = torch.arange(nty, dtype=f32, device=device)
    x0 = (tx * tile + 0.5) / w * 2.0 - 1.0
    x1 = (tx * tile + tile - 0.5) / w * 2.0 - 1.0
    y0 = (ty * tile + 0.5) / h * 2.0 - 1.0
    y1 = (ty * tile + tile - 0.5) / h * 2.0 - 1.0

    xs = torch.stack([x0, x1], dim=-1) * aspect            # (ntx, 2)
    ys = torch.stack([y0, y1], dim=-1)                      # (nty, 2)
    cx = xs[None, :, None, :].expand(nty, ntx, 2, 2)
    cy = ys[:, None, :, None].expand(nty, ntx, 2, 2)
    d = torch.stack([cx, cy, torch.full_like(cx, -focal)], dim=-1).reshape(nty, ntx, 4, 3)

    # rotate by the camera quaternion (the slab test needs no unit length)
    q = to_device(cam_quat, device).reshape(4)
    u, s = q[:3], q[3]
    uv = _cross(u, d)
    uuv = _cross(u, uv)
    return d + 2.0 * (s * uv + uuv)


def _interval_inv(dmin: torch.Tensor, dmax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Reciprocal of a direction interval; one that spans zero → (−inf, inf)."""
    spans_zero = (dmin <= 0.0) & (dmax >= 0.0)
    one = torch.ones_like(dmin)
    a = torch.where(spans_zero, one, dmin).reciprocal()
    b = torch.where(spans_zero, one, dmax).reciprocal()
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    return (torch.where(spans_zero, torch.full_like(lo, -_INF), lo),
            torch.where(spans_zero, torch.full_like(hi, _INF), hi))


def compute_tile_entries(wide: WideBVH, cam_pos, cam_quat, width: int, height: int,
                         tile: int = 32, fov_degrees: float = 70.0,
                         max_depth: int = 16) -> torch.Tensor:
    """The entry node of every whole tile → (height // tile, width // tile)
    int32 on the tree's device (0 = the root). Tiles of a partial last row
    or column are left out: K1d starts them at the root."""
    dev = wide.cref.device
    nty, ntx = height // tile, width // tile
    m = wide.cref.shape[0]

    d = _corner_dirs(width, height, nty, ntx, tile, cam_quat, fov_degrees, dev)
    inv_lo, inv_hi = _interval_inv(d.amin(dim=2), d.amax(dim=2))   # (nty, ntx, 3)
    inv_lo, inv_hi = inv_lo[..., None, :], inv_hi[..., None, :]
    o = to_device(cam_pos, dev).reshape(3)

    def possible_hit(cmn, cmx):
        """Interval slab test of (nty, ntx, w, 3) child boxes against each
        tile's cone."""
        rel_lo, rel_hi = cmn - o, cmx - o
        cands = torch.stack([rel_lo * inv_lo, rel_lo * inv_hi,
                             rel_hi * inv_lo, rel_hi * inv_hi])
        tmin_lo = cands.amin(dim=0).amax(dim=-1)
        tmax_hi = cands.amax(dim=0).amin(dim=-1)
        ok = tmax_hi >= tmin_lo.clamp_min(0.0)
        # an empty slot's inverted box (+inf / −inf) is excluded outright, so
        # no NaN of its products decides anything
        return ok & (cmn <= cmx).all(dim=-1)

    cref = wide.cref.long()
    node = torch.zeros((nty, ntx), dtype=torch.int64, device=dev)
    for _ in range(max_depth):
        ci = node.clamp(0, m - 1)
        kids = cref[ci]                                             # (nty, ntx, w)
        hit = possible_hit(wide.cmn[ci], wide.cmx[ci]) & (kids >= 0)
        only = torch.argmax(hit.to(torch.uint8), dim=-1, keepdim=True)  # the first hit slot
        only_ref = kids.gather(-1, only)[..., 0]
        descend = (hit.sum(dim=-1) == 1) & ((only_ref & _LEAF_BIT) == 0)
        node = torch.where(descend, only_ref, node)
    return node.to(torch.int32)
