"""Host-side mesh preprocessing (numpy only): a copy of
``raytracer_tpu/utils/meshops.py``.

``split_large_triangles`` is the SBVH-flavored answer to scenes mixing huge
architectural triangles (walls/floors spanning the scene) with dense
detail: a cluster containing one wall triangle gets a scene-sized AABB that
every packet slab-passes, so traversal degenerates toward brute force.
Bisecting the big triangles in place (same planes, exact partition of the
same surface) lets the SAH cluster builder form spatially tight leaves.
Fragments report their ORIGINAL triangle id through the record builder's
``tri_ids`` channel, so hit output is indistinguishable from the unsplit
mesh up to measure-zero shared-edge ties.
"""

from __future__ import annotations

import numpy as np

__all__ = ["split_large_triangles"]


def split_large_triangles(
    tris: np.ndarray, max_extent: float, max_rounds: int = 32
) -> tuple[np.ndarray, np.ndarray]:
    """Longest-edge-bisect every triangle whose AABB extent exceeds
    ``max_extent`` (world units), repeating until none does.

    Returns ``(fragments (M,3,3) float32, orig_ids (M,) int32)`` with
    M >= N; fragments of triangle i carry ``orig_ids == i``. Bisection at
    the exact midpoint keeps fragments coplanar with, winding-consistent
    with, and an exact partition of their source triangle.
    """
    tris = np.asarray(tris, np.float32).reshape(-1, 3, 3)
    ids = np.arange(len(tris), dtype=np.int32)
    for _ in range(max_rounds):
        ext = (tris.max(axis=1) - tris.min(axis=1)).max(axis=1)
        big = ext > max_extent
        if not big.any():
            break
        keep_t, keep_i = tris[~big], ids[~big]
        bt, bi = tris[big], ids[big]
        e = np.stack(
            [bt[:, 1] - bt[:, 0], bt[:, 2] - bt[:, 1], bt[:, 0] - bt[:, 2]],
            axis=1,
        )
        k = (e ** 2).sum(-1).argmax(axis=1)
        ar = np.arange(len(bt))
        v0, v1, v2 = bt[ar, k], bt[ar, (k + 1) % 3], bt[ar, (k + 2) % 3]
        m = 0.5 * (v0 + v1)
        half1 = np.stack([v0, m, v2], axis=1)
        half2 = np.stack([m, v1, v2], axis=1)
        tris = np.concatenate([keep_t, half1, half2])
        ids = np.concatenate([keep_i, bi, bi])
    return tris, ids
