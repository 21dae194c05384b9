"""The port's PLOC builder (``raytracer_tpu_torch/ops/ploc.py``) against the
JAX package's, and the invariants of ``tests/test_ploc.py``.

Tolerances: every word of bounds / left / right / meta / parent equal to the
JAX tree; the merge cost bit-equal to XLA's on the CPU; images byte-equal to
brute force's t plane; visits (plain version's counts) at most 1.05 × the
Morton LBVH's, the JAX test's margin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu.ops.ploc as jax_ploc
import raytracer_tpu_torch.ops.ploc as ploc
from raytracer_tpu_torch.ops.collapse import collapse_lbvh2_to_bvh4
from raytracer_tpu_torch.ops.cuda.traverse import (TraversalCounts, make_qnodes,
                                                   trace_tiles_reference)
from raytracer_tpu_torch.ops.lbvh import LEAF_FLAG, build_lbvh2
from raytracer_tpu_torch.ops.trace import make_wide_bvh
from raytracer_tpu_torch.render import render_ldr, render_ldr_brute
from raytracer_tpu_torch.utils import procgen
from raytracer_tpu_torch.utils.fp16 import unpack_bounds

SEED = 31
CAM_POS, CAM_QUAT = (0.0, 0.0, 3.5), (0.0, 0.0, 0.0, 1.0)


def soup(n: int, seed: int = SEED) -> np.ndarray:
    """The JAX package's test triangles: small, scattered, seeded."""
    rng = np.random.default_rng(seed + n)
    v0 = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    e = rng.uniform(-0.4, 0.4, (n, 2, 3)).astype(np.float32)
    return np.stack([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1)


def assert_words_equal(ours, ref) -> None:
    for name, a, b in zip(("bounds", "left", "right", "meta", "parent"), ours, ref):
        b = np.asarray(b).astype(np.int64)
        assert a.shape == b.shape and np.array_equal(a.numpy(), b), f"{name} differs"


CASES = {
    **{f"soup{n}": (lambda n=n: soup(n)) for n in (1, 2, 3, 37, 500)},
    "icosphere2": lambda: procgen.make_icosphere(2),
    # exact cost ties everywhere: each round merges the last pair only
    "duplicates": lambda: np.repeat(soup(5), 8, axis=0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_build_ploc2_matches_jax(case):
    tris = CASES[case]()
    assert_words_equal(ploc.build_ploc2(torch.from_numpy(tris)), jax_ploc.build_ploc2(tris))


def test_stuck_guard_matches_jax(monkeypatch):
    """The liveness guard merges the first two clusters of a round with no
    mutual pair. With finite costs below 3e38 there is always one (the
    closest pair in position among the cheapest: its left member takes its
    right candidate first, and the last of an equally spaced run takes its
    left one), so a round sticks only when every cost is >= 3e38 or NaN:
    a scene whose boxes' areas overflow f32. Both builders are run with
    every cost at 3e38, which takes the guard in each of the n − 1 rounds."""
    n = 29
    tris = soup(n)
    monkeypatch.setattr(jax_ploc, "_union_area",
                        lambda mn_a, *_: jnp.full(mn_a.shape[:-1], 3.0e38, jnp.float32))
    monkeypatch.setattr(ploc, "union_area",
                        lambda mn_a, *_: torch.full(mn_a.shape[:-1], 3.0e38))
    rounds = []
    real_nearest = ploc._nearest

    def nearest(cmn, cmx, radius):
        nn = real_nearest(cmn, cmx, radius)
        rounds.append(bool((nn == torch.arange(len(nn))).all()))
        return nn

    monkeypatch.setattr(ploc, "_nearest", nearest)
    jax.clear_caches()  # trace the JAX build anew under the patched cost
    try:
        ref = jax_ploc.build_ploc2(tris)
    finally:
        jax.clear_caches()
    ours = ploc.build_ploc2(torch.from_numpy(tris))
    assert rounds == [True] * (n - 1)
    assert_words_equal(ours, ref)
    assert int(ours.left[0]) == 1 and int(ours.right[0]) == 2 * n - 2  # the last merge


def test_union_area_matches_xla():
    """On 200,000 seeded box pairs the port's merge cost equals the jitted
    JAX ``_union_area`` bit for bit (0 differences), where the separately
    rounded d0·d1 + d1·d2 + d2·d0 differs on about a quarter."""
    rng = np.random.default_rng(SEED)
    p = rng.uniform(-2, 2, (4, 200_000, 3)).astype(np.float32)
    boxes = (np.minimum(p[0], p[1]), np.maximum(p[0], p[1]),
             np.minimum(p[2], p[3]), np.maximum(p[2], p[3]))
    ref = np.asarray(jax.jit(jax_ploc._union_area)(*map(jnp.asarray, boxes)))
    ours = ploc.union_area(*map(torch.from_numpy, boxes)).numpy()
    assert (ours.view(np.uint32) != ref.view(np.uint32)).sum() == 0
    d = np.maximum(boxes[1], boxes[3]) - np.minimum(boxes[0], boxes[2])
    plain = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
    assert (plain.view(np.uint32) != ref.view(np.uint32)).sum() > 10_000


def check_invariants(bvh, n: int) -> None:
    """2n − 1 rows, every triangle in one leaf, every node but the root a
    child once, every parent box containing its children's."""
    m, ni = bvh.num_nodes, bvh.num_internal
    assert m == 2 * n - 1
    meta, left, right = bvh.meta.numpy(), bvh.left.numpy(), bvh.right.numpy()
    mn, mx = (a.numpy() for a in unpack_bounds(bvh.bounds_u32))
    assert (meta[ni:] & LEAF_FLAG != 0).all()
    assert np.array_equal(np.sort(meta[ni:] & 0x7FFFFFFF), np.arange(n))
    if ni:
        assert np.array_equal(np.sort(np.concatenate([left[:ni], right[:ni]])), np.arange(1, m))
        for c in (left[:ni], right[:ni]):
            assert (mn[:ni] <= mn[c] + 1e-6).all() and (mx[:ni] >= mx[c] - 1e-6).all()
        parent = bvh.parent.numpy()
        assert parent[0] == 0xFFFFFFFF
        assert (parent[left[:ni]] == np.arange(ni)).all()
        assert (parent[right[:ni]] == np.arange(ni)).all()


@pytest.mark.parametrize("n", [1, 2, 3, 9, 64, 257])
def test_ploc_invariants_random(n):
    check_invariants(ploc.build_ploc2(torch.from_numpy(soup(n, SEED + 1))), n)


def test_ploc_invariants_icosphere():
    tris = procgen.make_icosphere(3)
    check_invariants(ploc.build_ploc2(torch.from_numpy(tris)), len(tris))


def test_ploc_renders_identically_to_brute():
    """The PLOC tree's frame (4-wide collapse, the tile kernel's plain
    version) has brute force's t plane, bit for bit."""
    tris = torch.from_numpy(procgen.make_icosphere(2))
    wide = make_wide_bvh(collapse_lbvh2_to_bvh4(ploc.build_ploc2(tris)))
    _, t, tri = render_ldr(wide, tris, CAM_POS, CAM_QUAT, 64, 48)
    _, bt, btri = render_ldr_brute(tris, CAM_POS, CAM_QUAT, 64, 48)
    assert torch.equal(t, bt) and torch.equal(tri, btri)


def test_ploc_traversal_not_worse_than_lbvh():
    """On an elongated scene (where Morton splits are weakest) the PLOC
    tree's records take at most 1.05 × the Morton LBVH's visits (the plain
    version's counts over a 32×32 frame)."""
    tris = torch.from_numpy(procgen.make_trefoil(nu=48, nv=24))

    def visits(build):
        qn = make_qnodes(make_wide_bvh(collapse_lbvh2_to_bvh4(build(tris))), tris)
        counts = TraversalCounts()
        trace_tiles_reference(qn, (0.0, 0.0, 8.0), CAM_QUAT, 32, 32, 40.0, counts=counts)
        return counts.visits

    assert visits(ploc.build_ploc2) <= visits(build_lbvh2) * 1.05
