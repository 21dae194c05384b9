"""BVH artifact serialization (host, NumPy) — a copy of
``raytracer_tpu/io/artifacts.py``: the same u32 images, npz checkpoints and
JSON dump, byte for byte, so either package reads the other's files.

Layouts:
  BVH2.bin      : u32[1 + 6*M]  — [numNodes2, (b0,b1,b2,left,right,meta)*M]
  BVH4_wide.bin : u32[1 + 8*M]  — [numNodes4, (b0,b1,b2,c0,c1,c2,c3,meta)*M]
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..utils.fp16 import unpack_bounds_u32

__all__ = [
    "bvh2_to_u32",
    "bvh2_from_u32",
    "bvh4_to_u32",
    "bvh4_from_u32",
    "save_u32_bin",
    "load_u32_bin",
    "save_scene_npz",
    "load_scene_npz",
    "bvh_to_json_dict",
    "dump_bvh_json",
]

NODE2_STRIDE_U32 = 6
NODE4_STRIDE_U32 = 8
LEAF_FLAG = np.uint32(0x80000000)
INVALID = np.uint32(0xFFFFFFFF)


# -- struct-of-arrays ↔ flat u32 buffers -------------------------------------

def bvh2_to_u32(bounds_u32, left, right, meta) -> np.ndarray:
    """SoA LBVH2 → flat BVH2.bin u32 image (header + stride-6 nodes)."""
    bounds_u32 = np.asarray(bounds_u32, dtype=np.uint32)
    m = bounds_u32.shape[0]
    nodes = np.empty((m, NODE2_STRIDE_U32), dtype=np.uint32)
    nodes[:, 0:3] = bounds_u32
    nodes[:, 3] = np.asarray(left, dtype=np.uint32)
    nodes[:, 4] = np.asarray(right, dtype=np.uint32)
    nodes[:, 5] = np.asarray(meta, dtype=np.uint32)
    return np.concatenate([np.array([m], dtype=np.uint32), nodes.reshape(-1)])


def bvh2_from_u32(buf: np.ndarray):
    """Flat BVH2.bin image → (bounds_u32 (M,3), left, right, meta)."""
    buf = np.asarray(buf, dtype=np.uint32)
    m = int(buf[0])
    nodes = buf[1 : 1 + m * NODE2_STRIDE_U32].reshape(m, NODE2_STRIDE_U32)
    return nodes[:, 0:3].copy(), nodes[:, 3].copy(), nodes[:, 4].copy(), nodes[:, 5].copy()


def bvh4_to_u32(bounds_u32, children, meta) -> np.ndarray:
    """SoA BVH4 → flat BVH4 u32 image (header + stride-8 nodes).

    children: (M, 4) uint32 with INVALID for empty slots.
    """
    bounds_u32 = np.asarray(bounds_u32, dtype=np.uint32)
    m = bounds_u32.shape[0]
    nodes = np.empty((m, NODE4_STRIDE_U32), dtype=np.uint32)
    nodes[:, 0:3] = bounds_u32
    nodes[:, 3:7] = np.asarray(children, dtype=np.uint32)
    nodes[:, 7] = np.asarray(meta, dtype=np.uint32)
    return np.concatenate([np.array([m], dtype=np.uint32), nodes.reshape(-1)])


def bvh4_from_u32(buf: np.ndarray):
    """Flat BVH4 image → (bounds_u32 (M,3), children (M,4), meta (M,))."""
    buf = np.asarray(buf, dtype=np.uint32)
    m = int(buf[0])
    nodes = buf[1 : 1 + m * NODE4_STRIDE_U32].reshape(m, NODE4_STRIDE_U32)
    return nodes[:, 0:3].copy(), nodes[:, 3:7].copy(), nodes[:, 7].copy()


# -- file IO ------------------------------------------------------------------

def save_u32_bin(path: str | Path, buf: np.ndarray) -> None:
    np.asarray(buf, dtype=np.uint32).tofile(str(path))


def load_u32_bin(path: str | Path) -> np.ndarray:
    return np.fromfile(str(path), dtype=np.uint32)


def save_scene_npz(path: str | Path, triangles: np.ndarray, **arrays) -> None:
    """Persist the triangle SoA (+ any BVH arrays) for offline/resumable use."""
    np.savez_compressed(str(path), triangles=np.asarray(triangles, np.float32), **arrays)


def load_scene_npz(path: str | Path) -> dict:
    with np.load(str(path)) as z:
        return {k: z[k] for k in z.files}


# -- debug JSON export (the working replacement for the broken debug surface,
#    SURVEY.md §3.5) -----------------------------------------------------------

def bvh_to_json_dict(buf: np.ndarray, *, stride: int) -> dict:
    """Decode a BVH2 (stride 6) or BVH4 (stride 8) u32 image into a JSON-able
    dict with f32 AABBs per node — the analog of data/BVH_full.json that the
    reference oracle consumes (tests/test.py:237), but generated from a
    working exporter."""
    buf = np.asarray(buf, dtype=np.uint32)
    m = int(buf[0])
    nodes = buf[1 : 1 + m * stride].reshape(m, stride)
    mn, mx = unpack_bounds_u32(nodes[:, 0:3])
    out_nodes = []
    for i in range(m):
        meta = int(nodes[i, stride - 1])
        node = {
            "index": i,
            "min": [float(v) for v in mn[i]],
            "max": [float(v) for v in mx[i]],
            "isLeaf": bool(meta & int(LEAF_FLAG)),
            "meta": meta,
        }
        if stride == NODE2_STRIDE_U32:
            node["children"] = [int(nodes[i, 3]), int(nodes[i, 4])]
        else:
            node["children"] = [int(c) for c in nodes[i, 3:7]]
        if node["isLeaf"]:
            node["triIndex"] = meta & 0x7FFFFFFF
        out_nodes.append(node)
    return {"numNodes": m, "stride": stride, "nodes": out_nodes}


def dump_bvh_json(path: str | Path, buf: np.ndarray, *, stride: int) -> None:
    Path(path).write_text(json.dumps(bvh_to_json_dict(buf, stride=stride)))
