"""BVH2 → BVH4 collapse through the native greedy re-emission collapse.

The JAX package collapses on the device (``raytracer_tpu/ops/collapse.py``).
On the SAH-clustered trees of the main path its result equals the C++
collapse (``raytracer_tpu/native/bvh_convert.cpp::bvh_collapse4``) word for
word over the emitted rows; the JAX version then pads to the BVH2 row count
with rows of bounds 0, children INVALID and meta 0. This module calls the
C++ collapse and pads the same way, so the records built from either are
byte-equal. The device collapse and its refit come with a later slice.

Tensors here hold u32 words as int64: torch has no full uint32 arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..io import artifacts
from ..native.bvhtool import collapse4_native

__all__ = ["LBVH2", "BVH4", "collapse_lbvh2_to_bvh4", "LEAF_FLAG", "INVALID"]

LEAF_FLAG = 0x80000000
INVALID = 0xFFFFFFFF


class LBVH2(NamedTuple):
    """BVH2 in struct-of-arrays form, host int64 tensors of u32 words
    (the node layout of ``raytracer_tpu/ops/lbvh.py::LBVH2``)."""

    bounds_u32: torch.Tensor  # (M, 3) packed fp16 AABBs
    left: torch.Tensor        # (M,) child index (0 for leaves)
    right: torch.Tensor       # (M,)
    meta: torch.Tensor        # (M,) LEAF_FLAG|cluster for leaves, 0 internal
    parent: torch.Tensor      # (M,) INVALID at the root

    @property
    def num_nodes(self) -> int:
        return self.bounds_u32.shape[0]


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
