"""Packed-leaf (K triangles per leaf) trees: the SAH cluster build and the
records pipeline of the main path.

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
from .collapse import LBVH2, collapse_lbvh2_to_bvh4
from .cuda.traverse import make_qnodes
from .trace import make_wide_bvh

__all__ = ["ClusteredScene", "build_sah2_clustered", "records_pipeline",
           "state_from_numpy"]


class ClusteredScene(NamedTuple):
    """A packed-leaf BVH2 plus the cluster-ordered geometry it indexes."""

    bvh2: LBVH2                # host tensors; leaves carry LEAF_FLAG|cluster
    tris_sorted: torch.Tensor  # (N,3,3) f32 — cluster members contiguous
    tri_order: torch.Tensor    # (N,) int64 — original index per sorted position
    leaf_size: int             # K — max triangles per cluster


def state_from_numpy(arrays: dict, device) -> ClusteredScene:
    """The JAX package's clustered-tree arrays (as numpy, under the keys of
    its npz checkpoint: ``triangles``, ``bvh2_{bounds,left,right,meta,
    parent}``, ``tri_order``, ``leaf_size``) → the port's tensors."""
    def u32(name):
        return torch.from_numpy(np.asarray(arrays[name], np.uint32).astype(np.int64))

    bvh2 = LBVH2(u32("bvh2_bounds"), u32("bvh2_left"), u32("bvh2_right"),
                 u32("bvh2_meta"), u32("bvh2_parent"))
    tris = torch.from_numpy(np.asarray(arrays["triangles"], np.float32).reshape(-1, 3, 3))
    order = u32("tri_order")
    return ClusteredScene(bvh2, tris[order].to(device), order.to(device),
                          int(np.asarray(arrays["leaf_size"]).reshape(-1)[0]))


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


def records_pipeline(cs: ClusteredScene) -> torch.Tensor:
    """collapse → widen → supernode records (M, recw) f32 on the device of
    ``cs.tris_sorted``."""
    dev = cs.tris_sorted.device
    bvh4 = collapse_lbvh2_to_bvh4(cs.bvh2)
    bvh4 = bvh4._replace(bounds_u32=bvh4.bounds_u32.to(dev),
                         children=bvh4.children.to(dev), meta=bvh4.meta.to(dev))
    return make_qnodes(make_wide_bvh(bvh4), cs.tris_sorted, tri_ids=cs.tri_order,
                       leaf_size=cs.leaf_size)
