"""Closest hit over leaves of more than one triangle (K2a, and K2c's closest
hit): the launch plan of ``ops/cuda/traverse.py::trace_rays`` and the warp's
closest-hit leaf tests of ``csrc/traverse_core.cuh`` (``rt::warp_nearest``),
on the CPU.

* ``traverse.launch_plan`` routes closest hit over leaves of K > 1 to
  ``CLOSEST_HIT_CORE``, K = 1 to the render core, and any hit as before,
  in both orders, schedules and placements; the core's mask is the C++
  one, and the launcher builds every core for closest hit too.
* A plain torch model of the warp's closest-hit step — a visit's posted
  leaf slots tested in runs of 32 triangle positions, a lane each, against
  the ray's running best t; per run the least t (its bits as unsigned) and
  the lowest lane at that t; a run's result kept only strictly below the
  running best; with and without the slots packed end to end — keeps the
  triangle and t that the plain version's sequential leaf loop
  (``traverse._traverse``, closest hit) keeps: on records of one visit with
  counts below K, K up to 64 (a slot spans runs), exact duplicates at equal
  t, ``det == 0`` and NaN triangles, at 4 and 8 slots.

Needs no card and no Pallas call; the kernels themselves are held against
the plain version on the card (``tests/test_torch_kernel.py``, marker
``cuda``).
"""

import re

import pytest
import torch

from raytracer_tpu_torch.ops.cuda import build, traverse
from raytracer_tpu_torch.ops.trace import moller_trumbore
from test_torch_anyhit import RUN, core_masks, one_record_cases
from torch_parity import one_torch_thread  # noqa: F401

KS = (2, 5, 8, 16, 31, 32, 33, 64)
NO_HIT = (1 << 32) - 1  # a lane without a candidate: above every accepted t's bits


def warp_nearest_position(rec: torch.Tensor, posted: torch.Tensor, o: torch.Tensor,
                          d: torch.Tensor, leaf_k: int, pack: bool):
    """The warp's closest-hit leaf step as rt::warp_nearest takes it, for one
    visit of each ray from best t 1e30: ``rec`` (R, recw) the visited
    records, ``posted`` (R, w) the leaf slots whose slab test passed →
    ((R,) the position k·K + j of the nearest accepted triangle or -1,
    (R,) its t or 1e30).

    A run is what the 32 lanes test at once: lane l takes position run + l,
    the triangle j = p mod K of slot k = p / K, tested where slot k is
    posted, j < the slot's count and the triangle is accepted
    (Möller–Trumbore, kMtEps < t < the running best). The warp reduces the
    accepted t's bits (positive finite floats order as unsigned integers)
    to their least, and a ballot of the lanes at that t gives the lowest;
    the run's result is kept, and the running best lowered to it, where a
    lane accepted one, which lies below the best by the test itself. Every
    run is tested. Each posted slot, in slot order, has its own runs from
    its first triangle; with ``pack`` the runs go end to end instead, from
    the first posted slot's first position to the last posted slot's end
    (the kernels pack below K = 32 only; both forms are right at any K)."""
    r = rec.shape[0]
    w = posted.shape[1]
    vbase = 8 * w
    tri = rec[:, vbase:vbase + 12 * w * leaf_k].reshape(r, w * leaf_k, 12)
    cnt = rec[:, 7 * w:8 * w]
    lanes = torch.arange(RUN)
    rows = torch.arange(r)[:, None]
    best = torch.full((r,), 1e30, dtype=torch.float32)
    at = torch.full((r,), -1, dtype=torch.int64)

    def test_run(start: torch.Tensor, end: torch.Tensor, todo: torch.Tensor) -> None:
        nonlocal best, at
        p = start[:, None] + lanes                              # (R, 32)
        k = torch.div(p, leaf_k, rounding_mode="floor").clamp(max=w - 1)
        j = p - k * leaf_k
        want = todo[:, None] & (p < end[:, None]) & posted[rows, k]
        want &= j.float() < cnt[rows, k]
        rec_p = tri[rows, p.clamp(max=w * leaf_k - 1)]          # (R, 32, 12)
        tt, ok = moller_trumbore(o[:, None, :], d[:, None, :], rec_p[..., 0:3],
                                 rec_p[..., 3:6], rec_p[..., 6:9])
        ok = want & ok & (tt < best[:, None])
        bits = torch.where(ok, tt.view(torch.int32).to(torch.int64), NO_HIT)
        m = bits.min(dim=1).values
        found = m != NO_HIT
        lane = torch.argmax((ok & (bits == m[:, None])).to(torch.uint8), dim=1)
        best = torch.where(found, m.to(torch.int32).view(torch.float32), best)
        at = torch.where(found, start + lane, at)

    if pack:
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
    return at, best


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("leaf_k", KS)
def test_warp_nearest_keeps_what_the_sequential_loop_keeps(w, leaf_k):
    """On one visit per ray, the runs of 32 (packed and per slot) keep the
    triangle and t of the plain version's closest-hit leaf loop (slot then
    triangle order, strict t < best) on every ray: the ids of the records
    are the positions, so ``_traverse``'s tri plane is the position, or -1
    where no triangle is accepted, and its t the nearest accepted t, or
    1e30."""
    n = 512
    tris, rec, o, d = one_record_cases(w, leaf_k, n, seed=leaf_k)
    posted = rec[:, 6 * w:7 * w] == -1.0
    t, _, tri, visits = traverse._traverse(rec, o, d, leaf_k, entry=torch.arange(n))
    assert bool((visits == 1).all())
    assert int((tri >= 0).sum()) > n // 4
    for pack in (True, False):
        at, best = warp_nearest_position(rec, posted, o, d, leaf_k, pack)
        assert torch.equal(at, tri.long()), (pack, int((at != tri.long()).sum()))
        assert torch.equal(best.view(torch.int32), t.view(torch.int32)), pack


def test_warp_nearest_cases_hold_ties_and_later_runs():
    """The one-visit records do exercise what the closest-hit step must get
    right: rays whose nearest t is shared by two accepted positions (the
    first must win), nearest triangles in a slot's second run (K = 64) and
    in a later run than another accepted triangle (the running best), and
    accepted triangles past a slot's count (to be ignored)."""
    w, leaf_k = 4, 64
    tris, rec, o, d = one_record_cases(w, leaf_k, 512, seed=leaf_k)
    m = tris.shape[1]
    tt, ok = moller_trumbore(o[:, None, :], d[:, None, :], tris[..., 0:3], tris[..., 3:6],
                             tris[..., 6:9])
    pos = torch.arange(m)
    slot, j = pos // leaf_k, pos % leaf_k
    live = (rec[:, 6 * w:7 * w] == -1.0)[:, slot] & (j.float() < rec[:, 7 * w:8 * w][:, slot])
    accepted = ok & (tt < 1e30) & live
    t_acc = torch.where(accepted, tt, torch.full_like(tt, torch.inf))
    nearest = t_acc.min(dim=1, keepdim=True).values
    at_min = accepted & (t_acc == nearest)
    assert bool((at_min.sum(dim=1) >= 2).any())                   # a tie at the nearest t
    first = torch.argmax(accepted.to(torch.uint8), dim=1)
    winner = torch.argmax(at_min.to(torch.uint8), dim=1)
    hit = accepted.any(dim=1)
    assert bool((hit & (winner % leaf_k >= RUN)).any())          # in a slot's second run
    assert bool((hit & (winner // RUN > first // RUN)).any())    # after an earlier run's hit
    assert bool((ok & (tt < 1e30) & ~live & (j.float() >= rec[:, 7 * w:8 * w][:, slot])).any())


@pytest.mark.parametrize("slots", [4, 8])
@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("scattered", [False, True])
def test_launch_plan_routes_closest_hit(slots, ordered, scattered):
    """Closest hit over leaves of K > 1 runs CLOSEST_HIT_CORE at both widths
    and in both orders, persistent where the wave is scattered, without its
    packed slots from K = 32 on; K = 1 runs the render core; any hit keeps
    its routing. The launch counts under its width's kernel."""
    plan = traverse.launch_plan
    order = 0 if ordered else traverse._UNORDERED
    kw = dict(ordered=ordered, scattered=scattered)
    for k in (2, 8, 31, 32, 33, 64):
        core = (traverse.CLOSEST_HIT_CORE if k < 32 else 33) | order
        assert plan(any_hit=False, leaf_k=k, **kw) == (core, scattered)
        assert plan(any_hit=True, leaf_k=k, **kw) == (
            core, scattered and k < traverse._ANY_HIT_PERSISTENT_K)
    for ah in (False, True):
        assert plan(any_hit=ah, leaf_k=1, **kw) == (1 | order, scattered)
    name = traverse._ray_launch_name(slots, False, ordered, "hbm")
    assert name in traverse.LAUNCHES
    assert name == ("trace_rays_k2c" if slots == 8 else "trace_rays_k2a") + (
        "" if ordered else "_unordered")


def test_closest_hit_core_is_the_kernels_mask():
    """CLOSEST_HIT_CORE is rt::kAnyHitCore's mask (the kernels' kAnyHit =
    false form), the render core is rt::kRenderCore, and the ray launcher
    builds every core for closest hit as for any hit, in both schedules."""
    bits = core_masks()
    assert traverse.CLOSEST_HIT_CORE == bits["kAnyHitCore"]
    src = (build.CSRC / "traverse_core.cuh").read_text()
    render = re.search(r"kRenderCore = ([\w| ]+);", src).group(1).split("|")
    assert traverse.launch_plan(any_hit=False, leaf_k=1)[0] == sum(
        bits[p.strip()] for p in render)
    rays = (build.CSRC / "traverse_rays.cu").read_text()
    for any_hit in ("true", "false"):
        for launch in ("launch_per_ray", "launch_persistent"):
            assert f"{launch}<S, {any_hit}, CORE>" in rays, (launch, any_hit)


def test_launch_plan_takes_closest_hit_cores_everywhere_they_are_built():
    """The warp's closest-hit core, in both packing forms, and the render
    core take every order, placement and schedule: the plan adds
    rt::kUnordered and rt::kSharedTree to the core and keeps the caller's
    schedule."""
    plan = traverse.launch_plan
    for k, core in ((8, traverse.CLOSEST_HIT_CORE), (32, 33), (1, 1)):
        for ordered in (True, False):
            for space in traverse.TREE_SPACES:
                for scattered in (False, True):
                    want = (core | (0 if ordered else traverse._UNORDERED)
                            | (traverse._SHARED_TREE if space == "smem" else 0))
                    assert plan(any_hit=False, leaf_k=k, ordered=ordered, scattered=scattered,
                                tree_space=space) == (want, scattered)
