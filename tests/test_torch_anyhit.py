"""Any hit over leaves of more than one triangle (K2b, and K2c's any hit):
the launch plan of ``ops/cuda/traverse.py::trace_rays`` and the warp's leaf
tests of ``csrc/traverse_core.cuh`` (``rt::warp_leaves``), on the CPU.

* ``traverse.launch_plan`` is a pure function of a call's arguments: which
  core it launches (``ANY_HIT_CORE`` or the render core, with the
  order and placement bits) and whether persistent warps run it; what it
  refuses; that its masks are the C++ ones; and that each C launcher
  instantiates exactly the masks its plan can return.
* On CPU records every launch runs the plain version and counts nothing.
* A plain torch model of the warp's leaf step — a visit's posted leaf
  slots tested in runs of 32 triangle positions, a lane each, the lowest
  accepted position of the first run that has one, with and without the
  slots packed end to end — picks the triangle that the plain version's
  sequential leaf loop (``traverse._traverse``, any hit) stops at: on
  records of one visit with counts below K, K = 33 and 64 (a slot spans
  runs), equal t, ``det == 0`` and NaN triangles, at 4 and 8 slots.

Needs no card and no Pallas call; the kernels themselves are held against
the plain version on the card (``tests/test_torch_kernel.py``, marker
``cuda``).
"""

import re

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.ops.cuda import build, traverse
from raytracer_tpu_torch.ops.trace import moller_trumbore

RUN = 32  # lanes of a warp: the triangle positions a run tests
KS = (2, 8, 32, 33, 64)


def core_masks() -> dict:
    """The feature bits of csrc/traverse_core.cuh by name, and its named
    cores (kRenderCore, kAnyHitCore, kTileCore) as the bits they join."""
    src = (build.CSRC / "traverse_core.cuh").read_text()
    bits = {name: int(value) for name, value in re.findall(r"\b(k\w+) = (\d+)u,", src)}
    for name, parts in re.findall(r"constexpr unsigned (k\w+Core) = ([\w| ]+);", src):
        bits[name] = sum(bits[p.strip()] for p in parts.split("|"))
    return bits


def built_masks(source: str, launcher: str) -> set:
    """The core masks that ``launcher`` of ``csrc/<source>`` instantiates in
    all the libraries built from it: the items of the RT_*_CORES lists its
    switch expands (in rt_trace_rays, the switch of the dispatch it calls),
    each evaluated with the header's bits."""
    src = (build.CSRC / source).read_text().replace("\\\n", " ")

    def body(fn):
        return re.search(r"\bint " + fn + r"\(.*?\n}\n", src, re.S).group(0)

    code = body(launcher)
    if "RT_CASE" not in code:
        assert "return dispatch(" in code, launcher
        code = body("dispatch")
    (macro,) = re.findall(r"\b(RT_\w+_CORES)\(RT_CASE\)", code)
    # every build's list: a source may build as parts (traverse.TILE_SOURCES)
    items = " ".join(re.findall(r"#define " + macro + r"\(X\)(.*)", src))
    names = {f"rt::{k}": str(v) for k, v in core_masks().items()}
    exprs = re.findall(r"X\(((?:[^()]|\([^()]*\))*)\)", items)
    return {eval(re.sub(r"rt::\w+", lambda m: names[m.group(0)], e), {"__builtins__": {}})
            for e in exprs}


def test_core_ids_are_the_kernels_masks():
    """ANY_HIT_CORE and TILE_CORE are rt::kAnyHitCore and rt::kTileCore, the
    render core the plans return is rt::kRenderCore, and the bits the plans
    add or drop are the header's."""
    bits = core_masks()
    assert traverse.ANY_HIT_CORE == bits["kAnyHitCore"]
    assert traverse.TILE_CORE == bits["kTileCore"]
    assert traverse.launch_plan(any_hit=True, leaf_k=1)[0] == bits["kRenderCore"]
    assert traverse.tile_plan(leaf_k=1) == bits["kRenderCore"]
    assert (traverse._UNORDERED, traverse._SHARED_TREE, traverse._PACK_SLOTS) == (
        bits["kUnordered"], bits["kSharedTree"], bits["kPackSlots"])


@pytest.mark.parametrize("slots", [4, 8])
@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("scattered", [False, True])
def test_launch_plan_picks_the_core_and_schedule(slots, ordered, scattered):
    """Any hit over leaves of K > 1 runs ANY_HIT_CORE, without its packed
    slots from K = 32 on, at every width and in both orders (persistent where
    the wave is scattered and K < 32, where that schedule won); closest hit
    there runs CLOSEST_HIT_CORE (test_torch_closesthit.py), and K = 1 the
    render core, persistent where scattered. ordered=False adds
    rt::kUnordered. The launch counts under its width's kernel."""
    plan = traverse.launch_plan
    order = 0 if ordered else traverse._UNORDERED
    for k in KS:
        core = (traverse.ANY_HIT_CORE if k < 32 else 33) | order
        assert plan(any_hit=True, leaf_k=k, ordered=ordered, scattered=scattered) == (
            core, scattered and k < traverse._ANY_HIT_PERSISTENT_K)
        assert plan(any_hit=False, leaf_k=k, ordered=ordered, scattered=scattered) == (
            core, scattered)
    assert plan(any_hit=True, leaf_k=1, ordered=ordered, scattered=scattered) == (
        1 | order, scattered)
    name = traverse._ray_launch_name(slots, True, ordered, "hbm")
    assert name in traverse.LAUNCHES
    assert name == ("trace_rays_k2c" if slots == 8 else "trace_rays_k2b") + (
        "" if ordered else "_unordered")


def test_launch_plan_bounds_the_persistent_schedule_by_k():
    """The schedule's bound on K: persistent warps below it, one thread per
    ray from it on, in both orders; closest hit and K = 1 take the caller's
    schedule."""
    assert traverse._ANY_HIT_PERSISTENT_K == 32
    plan = traverse.launch_plan
    assert plan(any_hit=True, leaf_k=32, scattered=True) == (33, False)
    assert plan(any_hit=True, leaf_k=8, scattered=True) == (97, True)
    assert plan(any_hit=True, leaf_k=8, ordered=False, scattered=True) == (105, True)
    assert plan(any_hit=True, leaf_k=31, scattered=True) == (97, True)
    assert plan(any_hit=True, leaf_k=64, scattered=True) == (33, False)
    assert plan(any_hit=True, leaf_k=1, scattered=True) == (1, True)
    assert plan(any_hit=False, leaf_k=32, scattered=True) == (33, True)


def test_launch_plan_refuses_what_is_not_built():
    """A placement that is not one of TREE_SPACES raises; "smem" adds
    rt::kSharedTree to the core, "vmem" (the same kernels) nothing."""
    plan = traverse.launch_plan
    for bad in ("l2", "HBM", "", "shared"):
        with pytest.raises(ValueError, match="tree_space must be"):
            plan(any_hit=True, leaf_k=32, tree_space=bad)
    assert plan(any_hit=True, leaf_k=32, tree_space="smem", ordered=False) == (57, False)
    assert plan(any_hit=True, leaf_k=8, tree_space="smem", scattered=True) == (113, True)
    assert plan(any_hit=True, leaf_k=32, tree_space="vmem") == (33, False)


LAUNCHERS = {"rt_trace_tiles": "traverse_tiles.cu", "rt_trace_tiles_batch": "traverse_tiles.cu",
             "rt_trace_tiles_batch_raw": "traverse_tiles.cu", "rt_trace_rays": "traverse_rays.cu"}


@pytest.mark.parametrize("launcher", sorted(LAUNCHERS))
def test_launchers_build_exactly_what_the_plans_return(launcher):
    """The masks each C launcher instantiates are exactly those its plan
    can return for any arguments: no core is built that no launch runs,
    and no launch asks for one that is not built."""
    ks = range(1, 70)
    if launcher == "rt_trace_rays":
        plans = {traverse.launch_plan(any_hit=a, leaf_k=k, ordered=o, scattered=s,
                                      tree_space=t)[0]
                 for a in (False, True) for k in ks for o in (False, True)
                 for s in (False, True) for t in traverse.TREE_SPACES}
    else:
        plans = {traverse.tile_plan(leaf_k=k) for k in ks}
    assert built_masks(LAUNCHERS[launcher], launcher) == plans


@pytest.mark.parametrize("launch", ["any_hit", "closest_hit", "tiles"])
def test_cores_run_the_plain_version_on_cpu(launch):
    """On CPU records every launch runs the plain version — rays in both
    orders, schedules and placements, tiles as frames and as the raw
    layout — and counts no launch."""
    before = dict(traverse.LAUNCHES)
    if launch == "tiles":
        _, rec, _, _ = one_record_cases(4, 8, 64, seed=2)
        qn = rec.contiguous()
        cam, quat = (0.0, 0.0, 3.0), (0.0, 0.0, 0.0, 1.0)
        out = traverse.trace_tiles(qn, cam, quat, 24, 16, leaf_k=8)
        ref = traverse.trace_tiles_reference(qn, cam, quat, 24, 16, leaf_k=8)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
        raw = traverse.trace_tiles_batch(qn, [cam], [quat], 32, 32, leaf_k=8, raw=True)
        assert torch.equal(raw, traverse.tiles_layout(traverse.trace_tiles_batch_reference(
            qn, [cam], [quat], 32, 32, leaf_k=8)))
    else:
        any_hit = launch == "any_hit"
        _, qn, o, d = one_record_cases(4, 8, 256, seed=3 if any_hit else 5)
        for ordered in (True, False):
            ref = traverse.trace_rays_reference(qn, o, d, any_hit=any_hit, leaf_k=8,
                                                ordered=ordered)
            for scattered in (False, True):
                for space in traverse.TREE_SPACES:
                    out = traverse.trace_rays(qn, o, d, any_hit=any_hit, leaf_k=8,
                                              ordered=ordered, scattered=scattered,
                                              tree_space=space)
                    assert all(torch.equal(a, b) for a, b in zip(out, ref)), (ordered, space)
    assert dict(traverse.LAUNCHES) == before


def warp_leaf_position(rec: torch.Tensor, posted: torch.Tensor, o: torch.Tensor,
                       d: torch.Tensor, leaf_k: int, pack: bool) -> torch.Tensor:
    """The warp's leaf step as rt::warp_leaves takes it, for one visit of
    each ray: ``rec`` (R, recw) the visited records, ``posted`` (R, w) the
    leaf slots whose slab test passed → (R,) the lowest accepted position
    k·K + j of the first run of 32 positions that has one, or -1.

    A run is what the 32 lanes test at once: lane l takes position run + l,
    the triangle j = p mod K of slot k = p / K, tested where slot k is
    posted, j < the slot's count (a float word of the header) and the
    triangle is accepted (Möller–Trumbore, kMtEps < t < best = 1e30); the
    ballot's lowest set bit is the answer and later runs are not tested.
    Each posted slot, in slot order, has its own runs from its first
    triangle; with ``pack`` and K < 32 the runs go end to end instead, from
    the first posted slot's first position to the last posted slot's
    end."""
    r = rec.shape[0]
    w = posted.shape[1]
    vbase = 8 * w
    tri = rec[:, vbase:vbase + 12 * w * leaf_k].reshape(r, w * leaf_k, 12)
    cnt = rec[:, 7 * w:8 * w]
    lanes = torch.arange(RUN)
    rows = torch.arange(r)[:, None]
    best = torch.full((r,), -1, dtype=torch.int64)

    def test_run(start: torch.Tensor, end: torch.Tensor, todo: torch.Tensor) -> None:
        p = start[:, None] + lanes                              # (R, 32)
        k = torch.div(p, leaf_k, rounding_mode="floor").clamp(max=w - 1)
        j = p - k * leaf_k
        want = todo[:, None] & (p < end[:, None]) & posted[rows, k]
        want &= j.float() < cnt[rows, k]
        rec_p = tri[rows, p.clamp(max=w * leaf_k - 1)]          # (R, 32, 12)
        tt, ok = moller_trumbore(o[:, None, :], d[:, None, :], rec_p[..., 0:3],
                                 rec_p[..., 3:6], rec_p[..., 6:9])
        ok = want & ok & (tt < 1e30)
        found = ok.any(dim=1) & (best < 0)
        best[found] = (start[:, None] + torch.argmax(ok.to(torch.uint8), dim=1,
                                                     keepdim=True))[found, 0]

    if pack and leaf_k < RUN:
        any_posted = posted.any(dim=1)
        first = torch.argmax(posted.to(torch.uint8), dim=1)
        last = w - 1 - torch.argmax(posted.flip(1).to(torch.uint8), dim=1)
        start, end = first * leaf_k, (last + 1) * leaf_k
        for run in range(0, w * leaf_k, RUN):
            test_run(start + run, end, any_posted & (start + run < end))
    else:
        for k in range(w):
            for run in range(0, leaf_k, RUN):
                start = torch.full((r,), k * leaf_k + run, dtype=torch.int64)
                test_run(start, torch.full((r,), (k + 1) * leaf_k), posted[:, k])
    return best


def one_record_cases(w: int, leaf_k: int, n: int, seed: int):
    """Records of one visit — a root of ``w`` slots, each a leaf (child box
    around everything, ref −1, a seeded count in [0, K]) or empty — whose
    triangle ids are their positions k·K + j, and ``n`` rays through them →
    (the (R, w·K, 12) triangles, the records (R, recw), origins, dirs).
    Ray i traverses record i. Triangles of a record: seeded large ones (most
    rays hit several), exact copies of earlier positions (equal t), ones
    with e2 = 2·e1 along x (det == 0 exactly), NaN vertices, and past each
    slot's count a triangle across many rays (to be ignored). Ray i aims at
    the centroid of a seeded triangle of record i."""
    rng = np.random.default_rng(seed + 100 * w + leaf_k)
    vbase, ibase, recw = traverse.rec_layout(leaf_k, w)
    m = w * leaf_k
    v0 = rng.uniform(-1.0, 1.0, size=(n, m, 3))
    e1 = rng.uniform(-1.5, 1.5, size=(n, m, 3))
    e2 = rng.uniform(-1.5, 1.5, size=(n, m, 3))
    kind = rng.random(size=(n, m))
    src = (rng.random(size=(n, m)) * np.arange(m)).astype(np.int64)  # an earlier position
    dup = (kind < 0.15) & (np.arange(m) > 0)
    rows = np.arange(n)[:, None]
    v0 = np.where(dup[..., None], v0[rows, src], v0)
    e1 = np.where(dup[..., None], e1[rows, src], e1)
    e2 = np.where(dup[..., None], e2[rows, src], e2)
    flat = (kind >= 0.15) & (kind < 0.25)
    e1[flat] = np.stack([rng.uniform(0.5, 2.0, size=flat.sum()), np.zeros(flat.sum()),
                         np.zeros(flat.sum())], -1)
    e2[flat] = 2.0 * e1[flat]
    v0[(kind >= 0.25) & (kind < 0.3), 0] = np.nan
    count = rng.integers(0, leaf_k + 1, size=(n, w))
    count[:, 0] = np.where(rng.random(n) < 0.5, leaf_k, count[:, 0])
    leaf = rng.random(size=(n, w)) < 0.7
    past = np.arange(m)[None, :] % leaf_k >= np.repeat(count, leaf_k, axis=1)
    v0[past] = [-50.0, -50.0, 0.0]
    e1[past] = [100.0, 0.0, 0.0]
    e2[past] = [0.0, 100.0, 0.0]
    tris = np.concatenate([v0, e1, e2, np.cross(e1, e2)], -1).astype(np.float32)
    rec = np.zeros((n, recw), np.float32)
    for k in range(w):
        rec[:, 6 * k:6 * k + 6] = [-60.0, -60.0, -60.0, 60.0, 60.0, 60.0]
        rec[:, 6 * w + k] = np.where(leaf[:, k], -1.0, traverse.EMPTY_REF)
        rec[:, 7 * w + k] = count[:, k]
    rec[:, vbase:vbase + 12 * m] = tris.reshape(n, 12 * m)
    rec[:, ibase:ibase + m] = np.arange(m, dtype=np.float32)
    # each ray toward the centroid of a seeded position of its record
    aim = rng.integers(0, m, size=n)
    target = np.nan_to_num(v0[np.arange(n), aim] + (e1 + e2)[np.arange(n), aim] / 3.0)
    o = rng.uniform(-0.5, 0.5, size=(n, 3)) + [0.0, 0.0, 3.0]
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    as_t = torch.from_numpy
    return (as_t(tris), as_t(rec), as_t(o.astype(np.float32)), as_t(d.astype(np.float32)))


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("leaf_k", KS)
def test_warp_leaf_step_stops_where_the_sequential_loop_does(w, leaf_k):
    """On one visit per ray, the lowest accepted position over runs of 32
    (packed and per slot) is the triangle at which the plain version's
    any-hit leaf loop (slot then triangle order) stops, on every ray: the
    ids of the records are the positions, so ``_traverse``'s tri plane is
    the position, or -1 where no triangle is accepted."""
    n = 512
    tris, rec, o, d = one_record_cases(w, leaf_k, n, seed=leaf_k)
    posted = rec[:, 6 * w:7 * w] == -1.0
    # ray i starts its stack at record i, a tree of one record
    _, _, tri, visits = traverse._traverse(rec, o, d, leaf_k, any_hit=True,
                                           entry=torch.arange(n))
    assert bool((visits == 1).all())
    want = tri.long()
    assert int((want >= 0).sum()) > n // 4
    for pack in (True, False):
        got = warp_leaf_position(rec, posted, o, d, leaf_k, pack)
        assert torch.equal(got, want), (pack, int((got != want).sum()))


def test_warp_leaf_cases_hold_ties_flat_and_nan_triangles():
    """The one-visit records do exercise what the leaf step must get right:
    accepted triangles in more than one run of a slot (K = 64), exact
    copies accepted at the same t in one visit, det == 0 and NaN triangles
    where a ray passes, and counts below K with an accepting triangle past
    the count."""
    w, leaf_k = 4, 64
    tris, rec, o, d = one_record_cases(w, leaf_k, 512, seed=leaf_k)
    n, m = tris.shape[:2]
    tt, ok = moller_trumbore(o[:, None, :], d[:, None, :], tris[..., 0:3], tris[..., 3:6],
                             tris[..., 6:9])
    pos = torch.arange(m)
    slot, j = pos // leaf_k, pos % leaf_k
    cnt = rec[:, 7 * w:8 * w][:, slot]
    live = (rec[:, 6 * w:7 * w] == -1.0)[:, slot] & (j.float() < cnt)
    accepted = ok & (tt < 1e30) & live
    assert bool((accepted & (j >= RUN)).any())                      # a slot's second run
    t_acc = torch.where(accepted, tt, torch.full_like(tt, torch.nan))
    same_t = (t_acc[:, :, None] == t_acc[:, None, :]) & ~torch.eye(m, dtype=torch.bool)
    assert bool(same_t.any())                                       # equal t in one visit
    e1, e2 = tris[..., 3:6], tris[..., 6:9]
    flat = (e1[..., 1:] == 0).all(-1) & (e2 == 2 * e1).all(-1)
    assert bool((flat & live).any()) and not bool((flat & accepted).any())
    nan = torch.isnan(tris[..., 0])
    assert bool((nan & live).any()) and not bool((nan & accepted).any())
    assert bool((ok & (tt < 1e30) & ~live & (j.float() >= cnt)).any())  # past the count
