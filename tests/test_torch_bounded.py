"""The PyTorch port's bounded primary-ray traces — K1d's function
(``trace_tiles(entries=, tbounds=)``), ``render.trace_tiles_bounded`` and
``render.trace_tiles_temporal`` — against the JAX package (the Pallas kernels
in interpret mode: four calls in this file) and against the port's own
unbounded trace. On the CPU the port runs each kernel's plain version.

Tolerances. Against the JAX package: ``tri`` exact, ``t`` within rtol 1e-5 on
hits, normals unit within 1e-4 on hits and within atol 1e-5 of the
reference's; on a lane with no hit, ``t`` equal to its tile's bound (K1d) or
1e30 (the repaired traces) exactly, and a zero normal; ``n_repair`` equal.
Against the port's own unbounded trace: all five planes bit-identical.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu import render as jax_render
from raytracer_tpu.ops.cluster import build_sah2_clustered as jax_build_sah2_clustered
from raytracer_tpu.ops.collapse import collapse_lbvh2_to_bvh4 as jax_collapse
from raytracer_tpu.ops.lbvh import build_lbvh2 as jax_build_lbvh2
from raytracer_tpu.ops.pallas.traverse import make_qnodes as jax_make_qnodes
from raytracer_tpu.ops.pallas.traverse import trace_tiles_pallas
from raytracer_tpu.ops.trace import make_wide_bvh as jax_make_wide_bvh
from raytracer_tpu_torch import render
from raytracer_tpu_torch.ops.cluster import build_sah2_clustered, records_pipeline
from raytracer_tpu_torch.ops.cuda import traverse
from raytracer_tpu_torch.ops.cuda.entry import compute_tile_entries
from torch_parity import (BOUND_KINDS, CAM_POS, CAM_QUAT, FOV, NORMAL_ATOL, T_RTOL, UNIT_ATOL,
                          expected_under_bounds, seeded_scene, tile_bounds, wide_from_numpy)

NEAR = (0.0, 0.0, 1.2)   # the sphere fills the frame: every ray hits
UPRIGHT = (0.0, 0.0, 0.0, 1.0)


def flat_records(qn) -> np.ndarray:
    """The JAX package's (M, recw / 128, 128) records as (M, recw) numpy."""
    a = np.array(qn)
    return a.reshape(a.shape[0], -1)


def test_k1d_function_matches_pallas_interpret():
    """trace_tiles(entries=E, tbounds=B) on the CPU against the TPU kernel in
    interpret mode with the same E and B, on a K = 8 SAH tree at 96×64 (3 × 2
    tiles): B mixes tiles without a bound, generous bounds and underestimates,
    E comes from compute_tile_entries (two tiles start below the root)."""
    tris = seeded_scene(3)
    cs, height = jax_build_sah2_clustered(jnp.asarray(tris), 8)
    jw = jax_make_wide_bvh(jax_collapse(cs.bvh2, sweeps=height + 2))
    jqn = jax_make_qnodes(jw, cs.tris_sorted, tri_ids=cs.tri_order, leaf_size=8)
    qn = torch.from_numpy(flat_records(jqn))
    w, h = 96, 64
    free = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=8)
    bounds, kinds = tile_bounds(free[0].numpy(), free[4].numpy())
    assert set(kinds.reshape(-1).tolist()) == {0, 1, 2}, BOUND_KINDS
    entries = compute_tile_entries(wide_from_numpy(jw), CAM_POS, CAM_QUAT, w, h,
                                   fov_degrees=FOV)
    assert int((entries != 0).sum()) > 0, "setup: an entry below the root"

    ours = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=8, entries=entries,
                                tbounds=torch.from_numpy(bounds))
    ref = trace_tiles_pallas(jqn, jnp.asarray(CAM_POS, jnp.float32),
                             jnp.asarray(CAM_QUAT, jnp.float32), w, h, FOV, interpret=True,
                             leaf_k=8, entries=jnp.asarray(entries.numpy()),
                             tbounds=jnp.asarray(bounds))
    t, nx, ny, nz, tri = (p.numpy() for p in ours)
    rt, rnx, rny, rnz, rtri = (np.asarray(p) for p in ref)
    np.testing.assert_array_equal(tri, rtri)
    hit = tri >= 0
    np.testing.assert_allclose(t[hit], rt[hit], rtol=T_RTOL, atol=0)
    bpix = np.repeat(np.repeat(bounds, 32, 0), 32, 1)[:h, :w]
    np.testing.assert_array_equal(t[~hit], bpix[~hit])
    np.testing.assert_array_equal(rt[~hit], bpix[~hit])
    n, rn = np.stack([nx, ny, nz], -1), np.stack([rnx, rny, rnz], -1)
    np.testing.assert_allclose(np.linalg.norm(n[hit], axis=-1), 1.0, atol=UNIT_ATOL)
    np.testing.assert_allclose(n[hit], rn[hit], atol=NORMAL_ATOL, rtol=0)
    assert (n[~hit] == 0).all()
    # the bounds cut hits that the unbounded trace finds, and only in "under" tiles
    cut = (free[4].numpy() >= 0) & ~hit
    under = np.repeat(np.repeat(kinds == 2, 32, 0), 32, 1)[:h, :w]
    assert cut.sum() > 0 and not (cut & ~under).any()


def test_bounded_matches_jax_with_sabotaged_bounds():
    """trace_tiles_bounded against the JAX package's (interpret mode) on the
    frame of its own sabotage test: icosphere(2), single-triangle leaves, the
    camera so near that every ray hits, 160×160 (5 × 5 tiles, so that interior
    tiles get a finite bound), bounds halved. n_repair is equal only if the
    bounds are."""
    from raytracer_tpu.models.scene import Scene
    from raytracer_tpu.utils import procgen

    sc = Scene().set_triangles(procgen.make_icosphere(2))
    sc._normalize_enabled, sc._normalize_mode = True, "cube"
    sc.normalize_mesh()
    jtris = jnp.asarray(sc.triangles)
    jqn = jax_make_qnodes(jax_make_wide_bvh(jax_collapse(jax_build_lbvh2(jtris))), jtris)
    w = h = 160
    ref = jax_render.trace_tiles_bounded(
        jqn, jnp.asarray(NEAR, jnp.float32), jnp.asarray(UPRIGHT, jnp.float32), w, h,
        interpret=True, repair_cap=w * h, _bound_scale=0.5, _bound_pad=0.0)
    ours = render.trace_tiles_bounded(torch.from_numpy(flat_records(jqn)), NEAR, UPRIGHT, w, h,
                                      _bound_scale=0.5, _bound_pad=0.0)
    assert int(ours[5]) == int(ref[5]) > 0
    tri, rtri = ours[4].numpy(), np.asarray(ref[4])
    np.testing.assert_array_equal(tri, rtri)
    hit = tri >= 0
    assert hit.all(), "setup: every ray hits"
    np.testing.assert_allclose(ours[0].numpy()[hit], np.asarray(ref[0])[hit], rtol=T_RTOL, atol=0)
    n = np.stack([p.numpy() for p in ours[1:4]], -1)
    rn = np.stack([np.asarray(p) for p in ref[1:4]], -1)
    np.testing.assert_allclose(n, rn, atol=NORMAL_ATOL, rtol=0)


@pytest.fixture(scope="module", params=[("k8", 4), ("k8", 8), ("k1", 4)],
                ids=["k8-4wide", "k8-8wide", "k1-4wide"])
def records(request):
    """(records, leaf_k) of the cube-normalized icosphere(2): the port's K = 8
    SAH tree at 4 and at 8 slots, and the JAX package's K = 1 LBVH tree."""
    kind, width = request.param
    tris = seeded_scene(2)
    if kind == "k1":
        jtris = jnp.asarray(tris)
        jqn = jax_make_qnodes(jax_make_wide_bvh(jax_collapse(jax_build_lbvh2(jtris))), jtris)
        return torch.from_numpy(flat_records(jqn)), 1
    cs, height = build_sah2_clustered(tris, 8, "cpu")
    return records_pipeline(cs, height=height, width=width), 8


def same_planes(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a[:5], b[:5]))


@pytest.mark.parametrize("sabotage", [False, True], ids=["default", "sabotaged"])
def test_bounded_equals_unbounded(records, sabotage):
    """The bounded trace returns the unbounded trace's five planes bit for
    bit, with the default slack and with halved bounds (which the repair must
    fix: n_repair > 0), whatever the repair cap, also one below n_repair."""
    qn, k = records
    w = h = 160
    free = traverse.trace_tiles(qn, NEAR, UPRIGHT, w, h, FOV, leaf_k=k)
    knobs = dict(_bound_scale=0.5, _bound_pad=0.0) if sabotage else {}
    outs = [render.trace_tiles_bounded(qn, NEAR, UPRIGHT, w, h, FOV, leaf_k=k, repair_cap=cap,
                                       **knobs) for cap in (16384, 64, 1)]
    for out in outs:
        assert len(out) == 6 and same_planes(out, free)
        assert bool((out[0][out[4] < 0] == 1e30).all())
    n_repair = [int(out[5]) for out in outs]
    assert len(set(n_repair)) == 1
    assert (n_repair[0] > 64) if sabotage else (n_repair[0] >= 0)


@pytest.mark.parametrize("size", [(96, 64), (100, 70)], ids=["tiles", "partial-tiles"])
def test_bounded_equals_unbounded_with_background(records, size):
    """The same from the camera that sees the sphere's silhouette (tiles with
    and without a bound), with entries, at a size 32 does not divide."""
    qn, k = records
    w, h = size
    free = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=k)
    out = render.trace_tiles_bounded(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=k,
                                     coarse_stride=4, _bound_scale=0.9, _bound_pad=0.0)
    assert same_planes(out, free)
    assert 0.1 < float((out[4] >= 0).float().mean()) < 0.9


def test_temporal_equals_the_jittered_trace(records):
    """trace_tiles_temporal returns the plain jittered trace of each seed, the
    bounds taken from the previous seed's result, over successive seeds."""
    qn, k = records
    w, h = 96, 70
    for pos in (NEAR, CAM_POS):
        prev = traverse.trace_tiles(qn, pos, UPRIGHT, w, h, FOV, leaf_k=k, jitter=True,
                                    jitter_seed=1)
        repaired = 0
        for seed in (2, 3, 4):
            free = traverse.trace_tiles(qn, pos, UPRIGHT, w, h, FOV, leaf_k=k, jitter=True,
                                        jitter_seed=seed)
            out = render.trace_tiles_temporal(qn, pos, UPRIGHT, w, h, prev[0], prev[4], seed,
                                              FOV, leaf_k=k)
            assert len(out) == 6 and same_planes(out, free), f"seed {seed}"
            repaired += int(out[5])
            prev = out
        assert repaired >= 0


def test_no_bounds_and_root_entries_change_nothing(records):
    """All-1e30 bounds and all-0 entries, whole or as smaller tables that the
    wrapper pads, leave trace_tiles bit-identical, jittered or not; and the
    tables a pixel reads are those of its window's tiles."""
    qn, k = records
    w, h = 100, 70
    for jitter in (False, True):
        kw = dict(leaf_k=k, jitter=jitter, jitter_seed=5)
        free = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, **kw)
        for shape in ((3, 4), (1, 2)):
            out = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, **kw,
                                       entries=torch.zeros(shape, dtype=torch.int32),
                                       tbounds=torch.full(shape, 1e30))
            assert same_planes(out, free)
    # a window of a larger frame indexes its tiles from its own corner
    bounds, _ = tile_bounds(free[0].numpy(), free[4].numpy())
    whole = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, **kw,
                                 tbounds=torch.from_numpy(bounds))
    window = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, 36, 38, FOV, **kw, raygen_size=(w, h),
                                  row_offset=32, col_offset=64,
                                  tbounds=torch.from_numpy(bounds[1:, 2:].copy()))
    assert all(torch.equal(a[32:, 64:], b) for a, b in zip(whole, window))


def test_bounds_cut_exactly_the_hits_beyond_them(records):
    """Under seeded per-tile bounds the plain version of K1d returns the
    unbounded image with every hit at or beyond its tile's bound replaced by
    (t = bound, zero normal, tri = −1), and it visits fewer records."""
    qn, k = records
    w, h = 96, 64
    free = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=k, stats=True)
    bounds, kinds = tile_bounds(free[0].numpy(), free[4].numpy())
    out = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=k, stats=True,
                               tbounds=torch.from_numpy(bounds))
    want = expected_under_bounds(free[:5], bounds)
    for got, exp in zip(out[:5], want):
        np.testing.assert_array_equal(got.numpy(), exp)
    assert int((out[4] != free[4]).sum()) > 0
    assert bool((out[5] <= free[5]).all()) and float(out[5].sum()) < float(free[5].sum())


def test_bad_arguments_raise(records):
    qn, k = records
    with pytest.raises(ValueError, match="repair_cap"):
        render.trace_tiles_bounded(qn, CAM_POS, CAM_QUAT, 64, 64, FOV, leaf_k=k, repair_cap=0)
    prev = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, 64, 64, FOV, leaf_k=k)
    with pytest.raises(ValueError, match="repair_cap"):
        render.trace_tiles_temporal(qn, CAM_POS, CAM_QUAT, 64, 64, prev[0], prev[4], 1, FOV,
                                    leaf_k=k, repair_cap=-1)
    with pytest.raises(ValueError, match="exceeds"):
        traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, 64, 64, FOV, leaf_k=k,
                             tbounds=torch.full((3, 2), 1e30))
    with pytest.raises(ValueError, match="2-D"):
        traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, 64, 64, FOV, leaf_k=k,
                             entries=torch.zeros(4, dtype=torch.int32))
