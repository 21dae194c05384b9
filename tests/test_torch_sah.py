"""The port's native SAH build of single triangles and the index-preserving
promotion (``native/bvhtool.py``, ``ops/lbvh.py::build_sah2``) against the
JAX package's bindings of the same C++ sources, and PathTracer's ``sah`` and
``ploc`` builders at K = 1 against the JAX PathTracer.

Tolerances: equal arrays and height (the same C++ source and flags); the
promoted image equal to the JAX binding's and to the numpy oracle's; records
byte-equal; images byte-equal, where a pixel may differ only at a tie that
brute force proves (both triangles accepted hits of the ray with t within
rtol 1e-6).
"""

import numpy as np
import pytest
import torch

from raytracer_tpu import PathTracer as JaxPathTracer
from raytracer_tpu.io import artifacts as jax_artifacts
from raytracer_tpu.native import bvhtool as jax_bvhtool
from raytracer_tpu.ops.lbvh import build_lbvh2 as jax_build_lbvh2
from raytracer_tpu.ops.lbvh import build_sah2 as jax_build_sah2
from raytracer_tpu.reference.collapse_oracle import promote_wide_oracle
from raytracer_tpu_torch import PathTracer
from raytracer_tpu_torch.io import artifacts
from raytracer_tpu_torch.native import bvhtool
from raytracer_tpu_torch.ops.lbvh import LEAF_FLAG, build_sah2
from raytracer_tpu_torch.utils import procgen
from raytracer_tpu_torch.utils.fp16 import unpack_bounds
from torch_parity import CAM_POS, CAM_QUAT, FOV, assert_hits_parity, image_dirs, seeded_scene

SEED = 41


def soup(n: int = 700) -> np.ndarray:
    rng = np.random.default_rng(SEED)
    v0 = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    e = rng.uniform(-0.4, 0.4, (n, 2, 3)).astype(np.float32)
    return np.stack([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1)


SCENES = {"icosphere3": lambda: procgen.make_icosphere(3), "soup": soup}
FIELDS = ("bounds", "left", "right", "meta", "parent")


@pytest.mark.parametrize("scene", list(SCENES))
def test_build_sah_native_matches_jax(scene):
    tris = SCENES[scene]()
    ours, height = bvhtool.build_sah_native(tris)
    ref, ref_height = jax_bvhtool.build_sah_native(tris)
    assert height == ref_height > 0
    for k in FIELDS:
        assert ours[k].dtype == np.uint32 and np.array_equal(ours[k], ref[k]), k


@pytest.mark.parametrize("scene", list(SCENES))
def test_build_sah2_matches_jax(scene):
    tris = SCENES[scene]()
    ours, height = build_sah2(tris, "cpu")
    ref, ref_height = jax_build_sah2(tris)
    assert height == ref_height
    for k, a, b in zip(FIELDS, ours, ref):
        assert a.dtype == torch.int64 and np.array_equal(a.numpy(), np.asarray(b).astype(np.int64)), k


def test_build_sah2_structure_and_bounds():
    """2n − 1 rows, every triangle in one leaf, every node but the root a
    child once; boxes finite (also with coordinates in the fp16 subnormal
    range), the root's holding every vertex, parents holding children."""
    rng = np.random.RandomState(7)
    scales = np.concatenate([np.full(200, 1e-6), np.full(200, 1e-4), np.full(600, 1.0)])
    tris = (rng.randn(1000, 3, 3) * scales[:, None, None]).astype(np.float32)
    bvh, height = build_sah2(tris, "cpu")
    n, m = len(tris), bvh.num_nodes
    assert m == 2 * n - 1 and 0 < height < 64
    meta, left, right = bvh.meta.numpy(), bvh.left.numpy(), bvh.right.numpy()
    leaf = (meta & LEAF_FLAG) != 0
    assert leaf.sum() == n and len(np.unique(meta[leaf] & 0x7FFFFFFF)) == n
    deg = np.zeros(m, np.int64)
    np.add.at(deg, left[~leaf], 1)
    np.add.at(deg, right[~leaf], 1)
    assert deg[0] == 0 and (deg[1:] == 1).all()
    mn, mx = (a.numpy() for a in unpack_bounds(bvh.bounds_u32))
    assert np.isfinite(mn).all() and np.isfinite(mx).all()
    assert (mn[0] <= tris.reshape(-1, 3).min(0)).all() and (mx[0] >= tris.reshape(-1, 3).max(0)).all()
    for c in (left[~leaf], right[~leaf]):
        assert (mn[~leaf] <= mn[c]).all() and (mx[~leaf] >= mx[c]).all()


@pytest.mark.parametrize("tree", ["lbvh", "sah"])
def test_promote_wide_native_matches_jax_and_the_oracle(tree):
    """The index-preserving 4-wide promotion of a BVH2 image: equal to the
    JAX package's binding and to its numpy oracle; counts of leaves and
    internal rows."""
    tris = procgen.make_icosphere(3)
    if tree == "lbvh":
        b = jax_build_lbvh2(tris)
        buf2 = jax_artifacts.bvh2_to_u32(*(np.asarray(a) for a in (b.bounds_u32, b.left,
                                                                      b.right, b.meta)))
    else:
        arrays, _ = bvhtool.build_sah_native(tris)
        buf2 = artifacts.bvh2_to_u32(*(arrays[k] for k in FIELDS[:4]))
    out, leaves, internals = bvhtool.promote_wide_native(buf2)
    ref, ref_leaves, ref_internals = jax_bvhtool.promote_wide_native(buf2)
    assert np.array_equal(out, ref) and (leaves, internals) == (ref_leaves, ref_internals)
    want = artifacts.bvh4_to_u32(*promote_wide_oracle(*artifacts.bvh2_from_u32(buf2)))
    assert np.array_equal(out, want)
    m = int(buf2[0])
    assert leaves == (m + 1) // 2 and internals == m // 2


K1_SIZE = (96, 64)


@pytest.mark.parametrize("builder", ["sah", "ploc"])
def test_pathtracer_k1_builders_match_the_jax_pathtracer(builder):
    """PathTracer(builder=…, leaf_size=1) on the CPU against the JAX
    PathTracer with the same builder (which traces K = 1 through its XLA
    traversal): BVH2 image and records byte-equal, the image byte-equal but
    at proven ties; build_stats keeps the reference's keys."""
    w, h = K1_SIZE
    tris = seeded_scene(3)
    pt = PathTracer(w, h, builder=builder, leaf_size=1, device="cpu")
    jpt = JaxPathTracer(w, h, builder=builder, leaf_size=1)
    for tracer in (pt, jpt):
        tracer.build_bvh(tris)
        tracer.set_camera_position(*CAM_POS)
        tracer.set_camera_quaternion(*CAM_QUAT)
        tracer.fov_degrees = FOV
    assert {"num_triangles", "num_nodes2", "num_nodes4", "lbvh2_ms", "collapse_ms", "widen_ms",
            "records_ms", "total_ms"} <= set(pt.build_stats)
    assert pt.build_stats["num_nodes4"] == int(jpt._bvh4.num_nodes)
    assert np.array_equal(pt.bvh2_artifact(), jpt.bvh2_artifact())
    ref_qn = np.asarray(jpt._qnodes)
    assert np.array_equal(pt._qnodes.numpy().view(np.uint32),
                          ref_qn.reshape(ref_qn.shape[0], -1).view(np.uint32))
    _, t, tri = pt._render_planes()
    _, rt, rtri = jpt._render_planes()
    same = assert_hits_parity(t, tri, rt, rtri, tris, image_dirs(w, h)).reshape(h, w)
    ours, ref = pt.render().numpy(), np.asarray(jpt.render())
    assert np.array_equal(ours[same], ref[same]) and same.mean() > 0.999
