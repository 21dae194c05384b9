"""The cases of the bounded-trace tests, shared by ``test_torch_bounded.py``,
``test_torch_bounded_8wide.py`` and ``test_torch_bounded_k1.py``: each of
those files imports them and sets the ``records`` fixture to one tree, so
that ``--dist loadfile`` runs the three trees on three workers. The cases
hold the PyTorch port's bounded primary-ray traces — K1d's function
(``trace_tiles(entries=, tbounds=)``), ``render.trace_tiles_bounded`` and
``render.trace_tiles_temporal`` — against the port's own unbounded trace
(the comparisons with the JAX package's Pallas kernels in interpret mode are
in ``test_torch_bounded_pallas.py``). On the CPU the port runs each kernel's
plain version.

Tolerance: all five planes bit-identical to the unbounded trace's; on a lane
with no hit under a bound, ``t`` equal to its tile's bound exactly and a
zero normal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu.ops.collapse import collapse_lbvh2_to_bvh4 as jax_collapse
from raytracer_tpu.ops.lbvh import build_lbvh2 as jax_build_lbvh2
from raytracer_tpu.ops.pallas.traverse import make_qnodes as jax_make_qnodes
from raytracer_tpu.ops.trace import make_wide_bvh as jax_make_wide_bvh
from raytracer_tpu_torch import render
from raytracer_tpu_torch.ops.cluster import build_sah2_clustered, records_pipeline
from raytracer_tpu_torch.ops.cuda import traverse
from torch_parity import (CAM_POS, CAM_QUAT, FOV, NEAR, UPRIGHT, expected_under_bounds,
                          flat_records, seeded_scene, tile_bounds)


def records_fixture(kind: str, width: int):
    """A module-scoped ``records`` fixture → (records, leaf_k) of the
    cube-normalized icosphere(2): ``("k8", 4 | 8)`` the port's K = 8 SAH tree
    at 4 or 8 slots, ``("k1", 4)`` the JAX package's K = 1 LBVH tree. The
    test ids keep the tree's name, as in ``test_x[k8-4wide]``."""
    ident = f"{kind}-{width}wide"

    @pytest.fixture(scope="module", params=[(kind, width)], ids=[ident])
    def records(request):
        tris = seeded_scene(2)
        if kind == "k1":
            jtris = jnp.asarray(tris)
            jqn = jax_make_qnodes(jax_make_wide_bvh(jax_collapse(jax_build_lbvh2(jtris))), jtris)
            return torch.from_numpy(flat_records(jqn)), 1
        cs, height = build_sah2_clustered(tris, 8, "cpu")
        return records_pipeline(cs, height=height, width=width), 8

    return records


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
