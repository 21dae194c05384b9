"""Closest hit and any hit of rays against every triangle of a scene.

Möller–Trumbore (1997) from (v0, e1 = v1 − v0, e2 = v2 − v0): a triangle is
hit where |det| ≥ 1e-7, 0 ≤ u, 0 ≤ v, u + v ≤ 1 and t > 1e-7, the
intersection semantics the renderer states. Brute force: each block of rays
is tested against all triangles at once, so the cost is rays × triangles and
nothing depends on a tree. ``dtype`` sets the precision of every operation:
float32 for the reference, bfloat16 for its control.
"""

from __future__ import annotations

import torch

__all__ = ["Triangles", "closest_hit", "any_hit", "hit_pairs", "INF", "EPS"]

INF = 1e30
EPS = 1e-7
_BLOCK_ELEMENTS = 1 << 26  # rays × triangles tested by one block


class Triangles:
    """A scene's triangles (T, 3, 3) as v0, e1, e2 columns in ``dtype``."""

    def __init__(self, tris: torch.Tensor, dtype=torch.float32) -> None:
        v = tris.to(dtype)
        self.dtype = dtype
        self.count = v.shape[0]
        self.v0 = v[:, 0].T.contiguous()
        self.e1 = (v[:, 1] - v[:, 0]).T.contiguous()
        self.e2 = (v[:, 2] - v[:, 0]).T.contiguous()

    def normals(self, idx: torch.Tensor) -> torch.Tensor:
        """Unit geometric normals normalize(e1 × e2) of triangles ``idx``."""
        i = idx.clamp(0, self.count - 1)
        n = torch.linalg.cross(self.e1[:, i].T, self.e2[:, i].T, dim=-1)
        return n / torch.sqrt((n * n).sum(-1, keepdim=True))


def _mt(o, d, v0, e1, e2) -> tuple[torch.Tensor, torch.Tensor]:
    """(t, ok) of rays against triangles; each argument is a triple of
    broadcastable component tensors."""
    dx, dy, dz = d
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    sx, sy, sz = (oi - vi for oi, vi in zip(o, v0))
    u = inv * (sx * px + sy * py + sz * pz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = inv * (dx * qx + dy * qy + dz * qz)
    t = inv * (e2x * qx + e2y * qy + e2z * qz)
    ok = (det.abs() >= EPS) & (u >= 0.0) & (v >= 0.0) & (u <= 1.0) & (u + v <= 1.0) & (t > EPS)
    return t, ok


def _all(tri: Triangles, o: torch.Tensor, d: torch.Tensor):
    """(t, ok) (B, T): rays o, d (B, 3) against every triangle."""
    cols = [tuple(a[i][None] for i in range(3)) for a in (tri.v0, tri.e1, tri.e2)]
    return _mt(tuple(o[:, i, None] for i in range(3)), tuple(d[:, i, None] for i in range(3)),
               *cols)


def hit_pairs(tri: Triangles, idx: torch.Tensor, o: torch.Tensor, d: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(t, ok) (R,): ray j against triangle ``idx[j]`` alone."""
    i = idx.clamp(0, tri.count - 1)
    o, d = o.to(tri.dtype), d.to(tri.dtype)
    cols = [tuple(a[k][i] for k in range(3)) for a in (tri.v0, tri.e1, tri.e2)]
    return _mt(tuple(o[:, k] for k in range(3)), tuple(d[:, k] for k in range(3)), *cols)


def _blocks(tri: Triangles, rays: int):
    step = max(1, _BLOCK_ELEMENTS // max(tri.count, 1))
    return ((a, min(a + step, rays)) for a in range(0, rays, step))


def closest_hit(tri: Triangles, o: torch.Tensor, d: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(t (R,), triangle (R,) int64): the nearest hit; t = 1e30, −1 on a miss."""
    o, d = o.to(tri.dtype), d.to(tri.dtype)
    t_out = torch.full((o.shape[0],), INF, dtype=tri.dtype, device=o.device)
    i_out = torch.full((o.shape[0],), -1, dtype=torch.int64, device=o.device)
    for a, b in _blocks(tri, o.shape[0]):
        t, ok = _all(tri, o[a:b], d[a:b])
        t = torch.where(ok, t, torch.full_like(t, INF))
        tmin, imin = t.min(dim=1)
        t_out[a:b] = tmin
        i_out[a:b] = torch.where(tmin < INF, imin, -1)
    return t_out, i_out


def any_hit(tri: Triangles, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(R,) bool: the ray hits some triangle."""
    o, d = o.to(tri.dtype), d.to(tri.dtype)
    out = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    for a, b in _blocks(tri, o.shape[0]):
        out[a:b] = _all(tri, o[a:b], d[a:b])[1].any(dim=1)
    return out
