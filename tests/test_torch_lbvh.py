"""The port's Morton / LBVH build chain against the JAX package: Morton codes
and order, the Karras LBVH2 and its refit, Morton clusters, the device
4-wide collapse, K = 1 and K = 8 records, and PathTracer's lbvh builder
(its defaults) end to end.

Tolerances: bit-equal for every integer and packed stage (codes, order,
nodes, fp16 bounds, collapse, records); images byte-equal, where a pixel may
differ only at a tie that brute force proves (both triangles accepted hits
of the ray with t within rtol 1e-6).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu import PathTracer as JaxPathTracer
from raytracer_tpu.ops.cluster import build_lbvh2_clustered as jax_build_clustered
from raytracer_tpu.ops.collapse import collapse_lbvh2_to_bvh4 as jax_collapse
from raytracer_tpu.ops.lbvh import build_lbvh2 as jax_build_lbvh2
from raytracer_tpu.ops.lbvh import refit_lbvh2 as jax_refit_lbvh2
from raytracer_tpu.ops.morton import build_morton_and_sort as jax_morton_sort
from raytracer_tpu.reference.collapse_oracle import collapse_oracle
from raytracer_tpu.reference.lbvh_oracle import build_lbvh2_oracle, morton_codes_py
from raytracer_tpu_torch import PathTracer
from raytracer_tpu_torch.ops.cluster import (build_lbvh2_clustered, build_sah2_clustered,
                                             tree_height)
from raytracer_tpu_torch.ops.collapse import collapse4_native_padded, collapse_lbvh2_to_bvh4
from raytracer_tpu_torch.ops.lbvh import build_lbvh2, refit_lbvh2
from raytracer_tpu_torch.ops.morton import build_morton_and_sort, centroids, morton_codes
from raytracer_tpu_torch.ops.trace import trace_rays_brute
from torch_parity import CAM_POS, CAM_QUAT, FOV, assert_hits_parity, image_dirs, seeded_scene

SEED = 23


def random_tris(n: int, seed: int = SEED) -> np.ndarray:
    """The JAX package's test triangles: small, scattered, seeded."""
    rng = np.random.default_rng(seed + n)
    v0 = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    e = rng.uniform(-0.4, 0.4, (n, 2, 3)).astype(np.float32)
    return np.stack([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1)


def u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def assert_tree_equal(ours, ref) -> None:
    for name, a, b in zip(("bounds", "left", "right", "meta", "parent"), ours, ref):
        assert np.array_equal(a.numpy(), u32(b)), f"{name}: tolerance is bit-equal"


@pytest.mark.parametrize("n", [1, 257, 3000])
def test_morton_matches_jax_and_the_oracle(n):
    tris = random_tris(n)
    if n == 3000:  # coordinates on a grid: many equal codes, the index tie-break
        tris = np.round(tris * 4) / 4
    codes, order = build_morton_and_sort(torch.from_numpy(tris))
    j_codes, j_order = jax_morton_sort(jnp.asarray(tris))
    assert np.array_equal(codes.numpy(), u32(j_codes))
    assert np.array_equal(order.numpy(), u32(j_order))
    cen = centroids(torch.from_numpy(tris))
    assert np.array_equal(morton_codes(cen).numpy(), u32(morton_codes_py(cen.numpy())))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 17, 64, 211])
def test_build_lbvh2_matches_jax_and_the_oracle(n):
    tris = random_tris(n)
    ours = build_lbvh2(torch.from_numpy(tris))
    assert_tree_equal(ours, jax_build_lbvh2(jnp.asarray(tris)))
    want = build_lbvh2_oracle(tris)
    for name in ("left", "right", "meta", "parent", "bounds_u32"):
        assert np.array_equal(getattr(ours, name).numpy(), u32(want[name])), name


def test_build_lbvh2_duplicate_centroids():
    """33 copies of one triangle: every code equal, the index tie-break of
    δ decides the tree."""
    tris = np.repeat(random_tris(1), 33, axis=0)
    ours = build_lbvh2(torch.from_numpy(tris))
    assert_tree_equal(ours, jax_build_lbvh2(jnp.asarray(tris)))
    want = build_lbvh2_oracle(tris)
    assert np.array_equal(ours.left.numpy(), u32(want["left"]))
    assert np.array_equal(ours.bounds_u32.numpy(), u32(want["bounds_u32"]))


def test_refit_lbvh2_matches_jax():
    tris = seeded_scene(2)
    moved = (tris * np.float32(1.07) + np.float32([0.01, -0.02, 0.0])).astype(np.float32)
    ours = refit_lbvh2(build_lbvh2(torch.from_numpy(tris)), torch.from_numpy(moved))
    ref = jax_refit_lbvh2(jax_build_lbvh2(jnp.asarray(tris)), jnp.asarray(moved))
    assert_tree_equal(ours, ref)


@pytest.mark.parametrize("n,k", [(300, 4), (512, 8), (301, 8)])
def test_build_lbvh2_clustered_matches_jax(n, k):
    tris = random_tris(n)
    ours = build_lbvh2_clustered(torch.from_numpy(tris), k)
    ref = jax_build_clustered(jnp.asarray(tris), k)
    assert_tree_equal(ours.bvh2, ref.bvh2)
    assert np.array_equal(ours.tri_order.numpy(), u32(ref.tri_order))
    assert np.array_equal(ours.tris_sorted.numpy(), np.asarray(ref.tris_sorted))
    assert ours.leaf_size == k


@pytest.mark.parametrize("tree", ["lbvh", "clustered"])
def test_device_collapse_matches_jax_and_the_oracle(tree):
    tris = random_tris(211)
    if tree == "lbvh":
        ours2, ref2 = build_lbvh2(torch.from_numpy(tris)), jax_build_lbvh2(jnp.asarray(tris))
    else:
        ours2 = build_lbvh2_clustered(torch.from_numpy(tris), 4).bvh2
        ref2 = jax_build_clustered(jnp.asarray(tris), 4).bvh2
    ours, ref = collapse_lbvh2_to_bvh4(ours2), jax_collapse(ref2)
    for a, b in zip(ours[:3], ref[:3]):
        assert np.array_equal(a.numpy(), u32(b))
    assert ours.num_nodes == int(ref.num_nodes)
    want_b, want_c, want_m = collapse_oracle(*(np.asarray(a) for a in ref2[:4]))
    n4 = ours.num_nodes
    assert n4 == len(want_m)
    assert np.array_equal(ours.bounds_u32[:n4].numpy(), u32(want_b))
    assert np.array_equal(ours.children[:n4].numpy(), u32(want_c))
    assert np.array_equal(ours.meta[:n4].numpy(), u32(want_m))


def test_device_collapse_equals_native_on_sah_clusters():
    """On the SAH cluster tree of the main path the device collapse equals
    the native C++ collapse word for word."""
    cs, height = build_sah2_clustered(seeded_scene(3), 8, "cpu")
    ours, native = collapse_lbvh2_to_bvh4(cs.bvh2, sweeps=height + 2), collapse4_native_padded(cs.bvh2)
    assert ours.num_nodes == native.num_nodes
    assert all(torch.equal(a, b) for a, b in zip(ours[:3], native[:3]))


def frame_planes(pt) -> tuple[np.ndarray, np.ndarray]:
    _, t, tri = pt._render_planes()
    return np.asarray(t).reshape(-1), np.asarray(tri).reshape(-1)


K1_SIZE = (96, 64)


@pytest.fixture(scope="module")
def jax_k1():
    """The JAX PathTracer() (K = 1 through its XLA traversal on the CPU) on
    seeded_scene(3), set up once for the two tests that compare with it →
    (tracer, triangles, its records, its image, its t and tri planes)."""
    w, h = K1_SIZE
    tris = seeded_scene(3)
    jpt = JaxPathTracer(w, h)
    jpt.build_bvh(tris)
    jpt.set_camera_position(*CAM_POS)
    jpt.set_camera_quaternion(*CAM_QUAT)
    jpt.fov_degrees = FOV
    ref_qn = np.asarray(jpt._qnodes)
    return (jpt, tris, ref_qn.reshape(ref_qn.shape[0], -1).view(np.uint32),
            np.asarray(jpt.render()), *frame_planes(jpt))


def aimed(pt):
    pt.set_camera_position(*CAM_POS)
    pt.set_camera_quaternion(*CAM_QUAT)
    pt.fov_degrees = FOV
    return pt


def test_pathtracer_defaults_render_as_the_jax_pathtracer(jax_k1):
    """PathTracer() on the CPU is the Morton LBVH of single triangles (the
    JAX package's defaults): its image against the JAX PathTracer()'s (which
    traces K = 1 through the XLA traversal), byte-equal but at proven
    ties."""
    jpt, tris, ref_qn, ref, rt, rtri = jax_k1
    w, h = K1_SIZE
    pt = PathTracer(w, h, device="cpu")
    assert (pt.builder, pt.leaf_size) == ("lbvh", 1)
    aimed(pt).build_bvh(tris)
    assert {"lbvh2_ms", "collapse_ms", "widen_ms", "num_nodes4", "total_ms"} <= set(pt.build_stats)
    assert pt.build_stats["num_nodes4"] == int(jpt._bvh4.num_nodes)
    assert np.array_equal(pt._qnodes.numpy().view(np.uint32), ref_qn)
    ours = pt.render().numpy()
    t, tri = frame_planes(pt)
    assert_hits_parity(t, tri, rt, rtri, tris, image_dirs(w, h))
    same_tri = (tri == rtri).reshape(h, w)
    assert np.array_equal(ours[same_tri], ref[same_tri])
    assert same_tri.mean() > 0.999


def test_morton_k8_records_and_frame():
    """PathTracer(builder="lbvh", leaf_size=8): records byte-equal to the JAX
    package's, the frame against brute force; a refit keeps the tree (its
    height, which the refit's sweeps need, taken at the first refit) and
    gives the JAX refit's records."""
    w, h = 64, 48
    tris = seeded_scene(3)
    pt = PathTracer(w, h, builder="lbvh", leaf_size=8, device="cpu")
    pt.build_bvh(tris)
    jpt = JaxPathTracer(w, h, builder="lbvh", leaf_size=8)
    jpt.build_bvh(tris)
    ref_qn = np.asarray(jpt._qnodes)
    assert np.array_equal(pt._qnodes.numpy().view(np.uint32),
                          ref_qn.reshape(ref_qn.shape[0], -1).view(np.uint32))
    t, tri = frame_planes(aimed(pt))
    dirs = image_dirs(w, h)
    bt, btri = trace_rays_brute(torch.from_numpy(tris),
                                torch.tensor(CAM_POS, dtype=torch.float32).expand(w * h, 3),
                                dirs)
    assert_hits_parity(t, tri, bt.numpy(), btri.numpy(), tris, dirs)
    assert pt._bvh2_height is None  # the Morton build knows no height
    moved = tris * np.float32(1.05)
    pt.refit_bvh(moved)
    jpt.refit_bvh(moved)
    assert "plan_ms" in pt.build_stats and pt._bvh2_height == tree_height(pt._bvh2)
    ref_qn = np.asarray(jpt._qnodes)
    assert np.array_equal(pt._qnodes.numpy().view(np.uint32),
                          ref_qn.reshape(ref_qn.shape[0], -1).view(np.uint32))


def test_k1_checkpoint_from_the_jax_package(tmp_path, jax_k1):
    """A K = 1 checkpoint written by the JAX package (no tri_order) loads,
    sets leaf_size = 1 and renders its image; a refit of that tree
    rebuilds, as the reference does."""
    jpt, tris, ref_qn, _, rt, rtri = jax_k1
    w, h = K1_SIZE
    ckpt = tmp_path / "k1.npz"
    jpt.save_checkpoint(ckpt)
    pt = PathTracer(w, h, builder="sah", leaf_size=32, device="cpu")
    pt.load_checkpoint(ckpt)
    assert pt.leaf_size == 1 and pt._cluster is None and pt._bvh2_height is None
    assert np.array_equal(pt._qnodes.numpy().view(np.uint32), ref_qn)
    t, tri = frame_planes(aimed(pt))
    assert_hits_parity(t, tri, rt, rtri, tris, image_dirs(w, h))
    pt.builder = "lbvh"
    pt.refit_bvh(tris)
    assert pt._collapse_plan is None and pt._qnodes is not None
