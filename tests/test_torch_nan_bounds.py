"""Triangles with NaN coordinates in the PyTorch port's builds, against the
JAX package.

About 2% of the coordinates of a seeded icosphere(2) are NaNs of both signs
and random payloads (quiet and signalling). Every word must equal the JAX
package's (tolerance: bit-equal): the BVH2 of the SAH K = 8 tree refitted to
those triangles and its 4-wide records, and the BVH2 that ``build_lbvh2``,
``build_lbvh2_clustered`` (with its records) and ``build_ploc2`` make of
them. The leaf and cluster boxes are XLA's min / max reductions, which
propagate NaN: the rule of each fold is read off the JAX package below.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_records import seeded_mesh

from raytracer_tpu.ops import cluster as jax_cluster
from raytracer_tpu.ops import lbvh as jax_lbvh
from raytracer_tpu.ops import ploc as jax_ploc
from raytracer_tpu.ops.collapse import collapse_lbvh2_to_bvh4 as jax_collapse
from raytracer_tpu.ops.pallas.traverse import make_qnodes as jax_make_qnodes
from raytracer_tpu.ops.trace import make_wide_bvh as jax_make_wide_bvh
from raytracer_tpu_torch.ops import cluster, lbvh, ploc

NAN_SHARE = 0.02
LEAF_K = 8


def with_nans(tris: np.ndarray, seed: int = 5) -> np.ndarray:
    """``tris`` with about 2% of its coordinates replaced by NaNs of random
    sign and payload (quiet and signalling alike)."""
    rng = np.random.default_rng(seed)
    out = tris.copy()
    words = out.view(np.uint32)
    nan = rng.random(words.shape) < NAN_SHARE
    words[nan] = ((rng.integers(0, 2, nan.sum()).astype(np.uint32) << 31) | 0x7F800000
                  | rng.integers(1, 1 << 23, nan.sum()).astype(np.uint32))
    return out


def assert_same_tree(ref, ours, what: str) -> None:
    for field, a, b in zip(("bounds", "left", "right", "meta", "parent"), ref, ours):
        a = np.asarray(a).astype(np.int64)
        assert a.shape == tuple(b.shape), (what, field)
        diff = int((a != b.numpy()).sum())
        assert diff == 0, (f"{what}: {field} differs from the JAX package in {diff} words "
                           "(tolerance: bit-equal)")


def assert_same_records(ref_cs, ours_cs, what: str) -> None:
    """The 4-wide records of both trees, word for word."""
    ref = np.asarray(jax_make_qnodes(jax_make_wide_bvh(jax_collapse(ref_cs.bvh2)),
                                     ref_cs.tris_sorted, tri_ids=ref_cs.tri_order,
                                     leaf_size=int(ref_cs.leaf_size)))
    ref = ref.reshape(ref.shape[0], -1).view(np.uint32)
    ours = cluster.records_pipeline(ours_cs).numpy().view(np.uint32)
    assert ref.shape == ours.shape, what
    diff = int((ref != ours).sum())
    assert diff == 0, f"{what}: {diff} record words differ (tolerance: bit-equal)"


@pytest.fixture(scope="module")
def mesh():
    tris = seeded_mesh(2)
    bad = with_nans(tris)
    assert np.isnan(bad).any(axis=(1, 2)).mean() > 0.1
    return tris, bad


@pytest.mark.parametrize("op", ["min", "max"])
def test_xla_reduction_nan_rule(op):
    """The fold that the port's reductions follow, read off the JAX package:
    every triple of two NaNs of each sign and a number, through
    ``_tri_bounds`` in both packages, bit for bit."""
    vals = np.array([0x7F800001, 0x7FC12345, 0xFF800003, 0xFFC54321, 0x3F800000,
                     0x80000000, 0x00000000], np.uint32)
    idx = np.stack(np.meshgrid(*[np.arange(len(vals))] * 3, indexing="ij"), -1).reshape(-1, 3)
    tris = np.repeat(vals[idx].view(np.float32)[:, :, None], 3, axis=2)
    which = 0 if op == "min" else 1
    ref = np.asarray(jax_lbvh._tri_bounds(jnp.asarray(tris))[which]).view(np.uint32)
    ours = lbvh._tri_bounds(torch.from_numpy(tris))[which].numpy().view(np.uint32)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("leaf_k", [8, 12, 20, 32, 33])
@pytest.mark.parametrize("padded", [False, True])
def test_cluster_union_nan_rule(leaf_k, padded):
    """The cluster unions of the refit, for leaf sizes that XLA compiles in
    each of its forms (vectorized for K = 8 and 16 ≤ K ≤ 32 when the
    triangles fill the clusters, in order otherwise): leaf rows word for
    word the JAX package's, with NaNs of both signs and many payloads."""
    rng = np.random.default_rng(leaf_k)
    n = 16 * leaf_k - int(padded)
    ref = jax_cluster.build_lbvh2_clustered(jnp.asarray(rng.random((n, 3, 3), np.float32)),
                                            leaf_k)
    words = rng.random((n, 3, 3), np.float32).view(np.uint32)
    kind = rng.integers(0, 4, words.shape)
    nan = ((kind == 1).astype(np.uint32) << 31) | 0x7F800000 | (
        rng.integers(1, 512, words.shape).astype(np.uint32) << 13)
    moved = np.where(kind < 2, nan, words).astype(np.uint32).view(np.float32)
    ref_r = jax_cluster.refit_lbvh2_clustered(ref, jnp.asarray(moved))
    ours = cluster.refit_lbvh2_clustered(
        cluster.ClusteredScene(cluster.bvh2_from_numpy(
            {f"bvh2_{k}": getattr(ref.bvh2, f) for k, f in
             (("bounds", "bounds_u32"), ("left", "left"), ("right", "right"),
              ("meta", "meta"), ("parent", "parent"))}),
            torch.from_numpy(np.array(ref.tris_sorted)),
            torch.from_numpy(np.asarray(ref.tri_order).astype(np.int64)), leaf_k),
        torch.from_numpy(moved))
    assert_same_tree(ref_r.bvh2, ours.bvh2, f"K = {leaf_k} refit, padded={padded}")


def test_sah_refit_with_nan_coordinates_word_equal(mesh):
    tris, bad = mesh
    ref = jax_cluster.build_sah2_clustered(tris, LEAF_K)[0]
    ours, height = cluster.build_sah2_clustered(tris, LEAF_K, "cpu")
    ref_r = jax_cluster.refit_lbvh2_clustered(ref, jnp.asarray(bad))
    ours_r = cluster.refit_lbvh2_clustered(ours, torch.from_numpy(bad), height + 2)
    assert_same_tree(ref_r.bvh2, ours_r.bvh2, "SAH K = 8 refit")
    assert_same_records(ref_r, ours_r, "SAH K = 8 refit")


def test_lbvh_with_nan_coordinates_word_equal(mesh):
    _, bad = mesh
    assert_same_tree(jax_lbvh.build_lbvh2(jnp.asarray(bad)),
                     lbvh.build_lbvh2(torch.from_numpy(bad)), "build_lbvh2")


def test_lbvh_clustered_with_nan_coordinates_word_equal(mesh):
    _, bad = mesh
    ref = jax_cluster.build_lbvh2_clustered(jnp.asarray(bad), LEAF_K)
    ours = cluster.build_lbvh2_clustered(torch.from_numpy(bad), LEAF_K)
    assert_same_tree(ref.bvh2, ours.bvh2, "build_lbvh2_clustered")
    assert_same_records(ref, ours, "build_lbvh2_clustered")


def test_ploc_with_nan_coordinates_word_equal(mesh):
    _, bad = mesh
    assert_same_tree(jax_ploc.build_ploc2(jnp.asarray(bad)),
                     ploc.build_ploc2(torch.from_numpy(bad)), "build_ploc2")
