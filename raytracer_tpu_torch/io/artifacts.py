"""BVH artifact formats (host, NumPy) — a copy of the parts of
``raytracer_tpu/io/artifacts.py`` that the port's build chain and
checkpoint loader use.

Layouts:
  BVH2 image : u32[1 + 6*M]  — [numNodes2, (b0,b1,b2,left,right,meta)*M]
  BVH4 image : u32[1 + 8*M]  — [numNodes4, (b0,b1,b2,c0,c1,c2,c3,meta)*M]
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["bvh2_to_u32", "bvh4_from_u32", "load_scene_npz"]

NODE2_STRIDE_U32 = 6
NODE4_STRIDE_U32 = 8


def bvh2_to_u32(bounds_u32, left, right, meta) -> np.ndarray:
    """SoA LBVH2 → flat BVH2 u32 image (header + stride-6 nodes)."""
    bounds_u32 = np.asarray(bounds_u32, dtype=np.uint32)
    m = bounds_u32.shape[0]
    nodes = np.empty((m, NODE2_STRIDE_U32), dtype=np.uint32)
    nodes[:, 0:3] = bounds_u32
    nodes[:, 3] = np.asarray(left, dtype=np.uint32)
    nodes[:, 4] = np.asarray(right, dtype=np.uint32)
    nodes[:, 5] = np.asarray(meta, dtype=np.uint32)
    return np.concatenate([np.array([m], dtype=np.uint32), nodes.reshape(-1)])


def bvh4_from_u32(buf: np.ndarray):
    """Flat BVH4 image → (bounds_u32 (M,3), children (M,4), meta (M,))."""
    buf = np.asarray(buf, dtype=np.uint32)
    m = int(buf[0])
    nodes = buf[1 : 1 + m * NODE4_STRIDE_U32].reshape(m, NODE4_STRIDE_U32)
    return nodes[:, 0:3].copy(), nodes[:, 3:7].copy(), nodes[:, 7].copy()


def load_scene_npz(path: str | Path) -> dict:
    """Read a checkpoint written by ``raytracer_tpu``'s ``save_scene_npz``."""
    with np.load(str(path)) as z:
        return {k: z[k] for k in z.files}
