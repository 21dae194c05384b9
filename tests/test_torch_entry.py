"""The PyTorch port's tile entry nodes, its tree-based frame functions
(``render_ldr``, ``render_ldr_brute``, ``render_frame_u8``), ``downscale_rgb8``
and ``PathTracer.use_tile_entries`` / ``render_stream`` against the JAX package
on the same inputs, made from a numpy seed.

Tolerances: ``compute_tile_entries`` integer-equal to the JAX function's on
the same tree (both are plain tensor code; no Pallas call here); entry-seeded
traversal bit-identical to root-seeded traversal; ``tri`` exact and ``t``
within rtol 1e-5 for the frame functions; rgba8 and the box-filtered rgb8
byte-equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu import PathTracer as JaxPathTracer
from raytracer_tpu import render as jax_render
from raytracer_tpu.ops.collapse import collapse_lbvh2_to_bvh4 as jax_collapse
from raytracer_tpu.ops.cluster import build_sah2_clustered as jax_build_sah2_clustered
from raytracer_tpu.ops.lbvh import build_lbvh2 as jax_build_lbvh2
from raytracer_tpu.ops.pallas.entry import compute_tile_entries as jax_compute_tile_entries
from raytracer_tpu.ops.shade import downscale_rgb8 as jax_downscale_rgb8
from raytracer_tpu.ops.trace import make_wide_bvh as jax_make_wide_bvh
from raytracer_tpu_torch import PathTracer, render
from raytracer_tpu_torch.ops.cluster import build_sah2_clustered, records_pipeline, wide_pipeline
from raytracer_tpu_torch.ops.cuda import traverse
from raytracer_tpu_torch.ops.cuda.entry import compute_tile_entries
from raytracer_tpu_torch.ops.shade import downscale_rgb8
from torch_parity import (CAM_QUAT, FOV, T_RTOL, one_torch_thread,  # noqa: F401
                          seeded_scene, wide_from_numpy)

SIZE = 128  # 4 × 4 tiles
FAR = (0.3, -0.2, 6.0)  # from afar most tiles see one child of the root: entries descend


def random_scene(trial: int):
    """257 random triangles and a random camera, from a seed (the kind of
    scene of the JAX package's entry property test)."""
    rng = np.random.RandomState(5 + trial)
    tris = (rng.randn(257, 3, 3) * 0.4).astype(np.float32)
    pos = (rng.randn(3) * 2.0).astype(np.float32)
    q = rng.randn(4).astype(np.float32)
    return tris, tuple(pos.tolist()), tuple((q / np.linalg.norm(q)).tolist())


def lbvh_wide(tris: np.ndarray):
    """The JAX package's 4-wide tree with single-triangle leaves (LBVH →
    collapse → wide nodes) → (its WideBVH, the same tree in the port)."""
    jw = jax_make_wide_bvh(jax_collapse(jax_build_lbvh2(jnp.asarray(tris))))
    return jw, wide_from_numpy(jw)


def sah_wide(tris: np.ndarray, k: int = 8):
    """The JAX package's 4-wide SAH cluster tree → (its WideBVH, the same in
    the port)."""
    cs, height = jax_build_sah2_clustered(jnp.asarray(tris), k)
    jw = jax_make_wide_bvh(jax_collapse(cs.bvh2, sweeps=height + 2))
    return jw, wide_from_numpy(jw)


def jax_entries(jw, pos, quat, w, h):
    return np.asarray(jax_compute_tile_entries(jw, jnp.asarray(pos, jnp.float32),
                                               jnp.asarray(quat, jnp.float32), w, h,
                                               fov_degrees=FOV))


# of the seeded random cameras most look away from the scene: trials 4 and 6
# see it (thousands of hits), trial 8 has tiles that descend below the root
SCENES = ["icosphere", "random4", "random6", "random8"]


def scene_of(name: str):
    """(triangles, camera position, quaternion, (JAX wide tree, the port's))."""
    if name == "icosphere":
        tris = seeded_scene(2)
        return tris, FAR, CAM_QUAT, sah_wide(tris)
    tris, pos, quat = random_scene(int(name[-1]))
    return tris, pos, quat, lbvh_wide(tris)


@pytest.mark.parametrize("name", SCENES)
def test_entries_equal_the_jax_function(name):
    """Integer-equal entries on the same 4-wide tree; a partial last row of
    tiles (height 112) is left out by both."""
    tris, pos, quat, (jw, wide) = scene_of(name)
    for w, h in ((SIZE, SIZE), (SIZE, 112)):
        ours = compute_tile_entries(wide, pos, quat, w, h, fov_degrees=FOV)
        assert ours.dtype == torch.int32 and ours.shape == (h // 32, w // 32)
        np.testing.assert_array_equal(ours.numpy(), jax_entries(jw, pos, quat, w, h))
    if name == "icosphere":
        assert int((ours != 0).sum()) > 0, "setup: some tile must descend below the root"


@pytest.mark.parametrize("name", SCENES)
def test_entries_leave_the_planes_bit_identical(name):
    """Entry-seeded traversal finds exactly what root-seeded traversal finds:
    all five planes bit-identical (the plain version of K1d against that of
    K1a, on single-triangle-leaf records of the tree the entries came from)."""
    tris, pos, quat, (_, wide) = scene_of(name)
    qn = traverse.make_qnodes(wide, torch.from_numpy(tris))
    entries = compute_tile_entries(wide, pos, quat, SIZE, SIZE, fov_degrees=FOV)
    a = traverse.trace_tiles(qn, pos, quat, SIZE, SIZE, FOV, leaf_k=1)
    b = traverse.trace_tiles(qn, pos, quat, SIZE, SIZE, FOV, leaf_k=1, entries=entries)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    hits = int((a[4] >= 0).sum())
    assert hits < SIZE * SIZE and (hits > 0 or int((entries != 0).sum()) > 0)


@pytest.mark.parametrize("width", [4, 8])
def test_entries_are_conservative_on_the_ports_trees(width):
    """On the port's own K = 8 trees at 4 and at 8 slots: entries descend
    from afar, and leave the image bit-identical from three cameras."""
    tris = seeded_scene(3)
    cs, height = build_sah2_clustered(tris, 8, "cpu")
    wide = wide_pipeline(cs, height=height, width=width)
    assert wide.cref.shape[1] == width
    qn = records_pipeline(cs, height=height, width=width)
    descended = 0
    for pos in (FAR, (0.15, -0.1, 2.5), (2.0, 1.5, 3.0)):
        entries = compute_tile_entries(wide, pos, CAM_QUAT, SIZE, SIZE, fov_degrees=FOV)
        descended += int((entries != 0).sum())
        a = traverse.trace_tiles(qn, pos, CAM_QUAT, SIZE, SIZE, FOV, leaf_k=8)
        b = traverse.trace_tiles(qn, pos, CAM_QUAT, SIZE, SIZE, FOV, leaf_k=8, entries=entries)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert descended > 0


def test_frame_functions_match_jax():
    """render_ldr, render_ldr_brute and render_frame_u8 on a build_lbvh2 tree
    carried across: tri exact, t rtol 1e-5 on hits and 1e30 on misses, the
    rgba8 frame byte-equal."""
    tris = seeded_scene(2)
    jw, wide = lbvh_wide(tris)
    w, h = 96, 64
    pos, quat = (0.15, -0.1, 2.5), CAM_QUAT
    jpos, jquat = jnp.asarray(pos, jnp.float32), jnp.asarray(quat, jnp.float32)
    tt = torch.from_numpy(tris)
    ours = {"ldr": render.render_ldr(wide, tt, pos, quat, w, h, FOV),
            "brute": render.render_ldr_brute(tt, pos, quat, w, h, FOV)}
    ref = {"ldr": jax_render.render_ldr(jw, jnp.asarray(tris), jpos, jquat, w, h, FOV),
           "brute": jax_render.render_ldr_brute(jnp.asarray(tris), jpos, jquat, w, h, FOV)}
    for name in ours:
        (rgb, t, tri), (_, rt, rtri) = ours[name], ref[name]
        assert rgb.shape == (h, w, 3) and tri.dtype == torch.int32
        np.testing.assert_array_equal(tri.numpy(), np.asarray(rtri), err_msg=name)
        hit = tri.numpy() >= 0
        assert 0.1 < hit.mean() < 0.9
        np.testing.assert_allclose(t.numpy()[hit], np.asarray(rt)[hit], rtol=T_RTOL, atol=0)
        assert (t.numpy()[~hit] == np.float32(1e30)).all()
    u8 = render.render_frame_u8(wide, tt, pos, quat, w, h, FOV)
    ref_u8 = np.asarray(jax_render.render_frame_u8(jw, jnp.asarray(tris), jpos, jquat, w, h, FOV))
    assert u8.dtype == torch.uint8 and u8.shape == (h, w, 4)
    np.testing.assert_array_equal(u8.numpy(), ref_u8)


@pytest.mark.parametrize("shape,scale", [((64, 96), 2), ((50, 75), 4), ((33, 31), 3)])
def test_downscale_rgb8_matches_jax(shape, scale):
    """Byte-equal box filter, also where the scale does not divide the size
    (trailing rows and columns are dropped) and outside [0, 1]."""
    rgb = np.random.default_rng(3).uniform(-0.1, 1.1, size=(*shape, 3)).astype(np.float32)
    ours = downscale_rgb8(torch.from_numpy(rgb), scale)
    ref = np.asarray(jax_downscale_rgb8(jnp.asarray(rgb), scale))
    assert ours.dtype == torch.uint8 and ours.shape == (shape[0] // scale, shape[1] // scale, 3)
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("widener", ["collapse", "collapse8", "promote"])
def test_pathtracer_tile_entries_leave_the_frame_unchanged(widener):
    """render() with use_tile_entries byte-equal to without, from afar (where
    the entries descend) and from near; the wide tree is made only when the
    entries are asked for, and again after a rebuild."""
    tris = seeded_scene(3)
    pt = PathTracer(SIZE, SIZE, widener=widener, builder="sah", leaf_size=8, device="cpu")
    pt.build_bvh(tris)
    pt.set_camera_quaternion(*CAM_QUAT)
    assert pt.use_tile_entries is False
    for pos in (FAR, (0.15, -0.1, 2.5)):
        pt.set_camera_position(*pos)
        pt.use_tile_entries = False
        plain = pt.render()
        assert pt._wide is None
        pt.use_tile_entries = True
        assert torch.equal(pt.render(), plain)
        assert pt._wide is not None and pt._wide.cref.shape[0] == pt._qnodes.shape[0]
        pt.build_bvh(tris)
        assert pt._wide is None


def test_render_stream_matches_jax():
    """render_stream against the JAX PathTracer's (K = 1 through its XLA
    traversal, as on any CPU backend): byte-equal at scale 2 and 3."""
    tris = seeded_scene(3)
    pos, quat = (0.2, 0.1, 2.4), (0.05, -0.1, 0.0, 0.9937303)
    pt = PathTracer(96, 64, builder="sah", leaf_size=8, device="cpu")
    jpt = JaxPathTracer(96, 64, builder="sah", leaf_size=1)
    for p in (pt, jpt):
        p.build_bvh(tris)
        p.set_camera_position(*pos)
        p.set_camera_quaternion(*quat)
    for scale in (2, 3):
        ours = pt.render_stream(scale)
        assert ours.dtype == torch.uint8 and ours.shape == (64 // scale, 96 // scale, 3)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(jpt.render_stream(scale)))
    assert len(np.unique(ours.numpy())) > 8
