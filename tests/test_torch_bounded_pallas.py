"""The PyTorch port's bounded primary-ray traces against the JAX package's
Pallas kernels in interpret mode (four calls in this file): K1d's function
(``trace_tiles(entries=, tbounds=)``) and ``render.trace_tiles_bounded``.
On the CPU the port runs each kernel's plain version. Kept apart from
``test_torch_bounded.py`` so that the test run can give the two files to
two workers.

Tolerances: ``tri`` exact, ``t`` within rtol 1e-5 on hits, normals unit
within 1e-4 on hits and within atol 1e-5 of the reference's; on a lane with
no hit, ``t`` equal to its tile's bound (K1d) or 1e30 (the repaired traces)
exactly, and a zero normal; ``n_repair`` equal.
"""

import numpy as np
import jax.numpy as jnp
import torch

from raytracer_tpu import render as jax_render
from raytracer_tpu.ops.cluster import build_sah2_clustered as jax_build_sah2_clustered
from raytracer_tpu.ops.collapse import collapse_lbvh2_to_bvh4 as jax_collapse
from raytracer_tpu.ops.lbvh import build_lbvh2 as jax_build_lbvh2
from raytracer_tpu.ops.pallas.traverse import make_qnodes as jax_make_qnodes
from raytracer_tpu.ops.pallas.traverse import trace_tiles_pallas
from raytracer_tpu.ops.trace import make_wide_bvh as jax_make_wide_bvh
from raytracer_tpu_torch import render
from raytracer_tpu_torch.ops.cuda import traverse
from raytracer_tpu_torch.ops.cuda.entry import compute_tile_entries
from torch_parity import (BOUND_KINDS, CAM_POS, CAM_QUAT, FOV, NEAR, NORMAL_ATOL, T_RTOL,
                          UNIT_ATOL, UPRIGHT, flat_records, seeded_scene, tile_bounds,
                          wide_from_numpy)


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
