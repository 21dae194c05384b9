"""K1 over leaves of more than one triangle (K1a … K1f, K1c raw): the
per-step choice of leaf stage of ``csrc/traverse_core.cuh``
(``rt::Ray::tile_step``, ``traverse.TILE_CORE``) and the tile plan of
``ops/cuda/traverse.py``, on the CPU.

* A plain torch model of a warp's tile step: 32 lanes, each with its own
  ray and a record (lanes may share one, as the 8×4 pixels of a K1 warp
  do), some lanes outside the window (``mine`` false: they post nothing).
  The warp prices the two leaf stages from the posted slots' triangle
  counts n_k: the lanes' own loops m = Σ_k max over lanes of n_k, the
  warp's tests w = the posting lanes' runs of 32; where c·w < m the warp
  serves each posting lane with the warp's closest-hit tests
  (``test_torch_closesthit.warp_nearest_position``), else each posting lane
  runs its own sequential loop. Both stages, and the mix that the rule
  picks at several costs c, keep the triangle and t of the plain version's
  sequential leaf loop (``traverse._traverse``) on one-visit records with
  counts below K, K = 2 … 64, exact duplicates at equal t, ``det == 0`` and
  NaN triangles, at 4 and 8 slots; and ``TraversalCounts.warp_census``
  prices those warps as the model does.
* ``traverse.tile_plan`` routes K = 1 to the render core and K > 1 to
  ``TILE_CORE``, the rule the card measured.
* ``TILE_CORE``'s mask, its cost c and the launchers' cores are the C++
  ones, read with a regex.

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
from test_torch_anyhit import RUN, core_masks, one_record_cases
from test_torch_closesthit import warp_nearest_position
from torch_parity import one_torch_thread  # noqa: F401

KS = (2, 5, 8, 16, 31, 32, 33, 64)
COSTS = (0.0, 0.5, 1.0, 2.0, 4.0, 1e9)  # 0: the warp's tests whenever a lane posts; 1e9: never


def lane_nearest(rec: torch.Tensor, posted: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                 leaf_k: int):
    """Each lane's own leaf loop (rt::Ray::lane_nearest) over its posted
    slots, slot then triangle order, j below the slot's count, keeping a
    triangle where it is accepted strictly below the running best → ((R,)
    position or -1, (R,) t or 1e30)."""
    r, w = posted.shape
    tri = rec[:, 8 * w:8 * w + 12 * w * leaf_k].reshape(r, w * leaf_k, 12)
    cnt = rec[:, 7 * w:8 * w]
    best = torch.full((r,), 1e30, dtype=torch.float32)
    at = torch.full((r,), -1, dtype=torch.int64)
    for k in range(w):
        for j in range(leaf_k):
            p = k * leaf_k + j
            live = posted[:, k] & (float(j) < cnt[:, k])
            tt, ok = moller_trumbore(o, d, tri[:, p, 0:3], tri[:, p, 3:6], tri[:, p, 6:9])
            take = live & ok & (tt < best)
            best = torch.where(take, tt, best)
            at = torch.where(take, p, at)
    return at, best


def price(posted: torch.Tensor, cnt: torch.Tensor, leaf_k: int) -> tuple[int, int]:
    """(m, w) of one warp step: the lanes' loop iterations Σ_k max over
    lanes of n_k (n_k = min(count, K) of a posted slot, else 0) and the
    warp's runs of 32 over the posting lanes (packed below K = 32: the span
    of a lane's posted slots; else ⌈n_k / 32⌉ a slot)."""
    n = torch.where(posted, cnt.clamp(0, leaf_k).long(), 0)
    m = int(n.amax(dim=0).sum())
    if leaf_k < RUN:
        slot = torch.arange(posted.shape[1])
        first = torch.where(posted, slot, posted.shape[1]).amin(dim=1)
        last = torch.where(posted, slot, -1).amax(dim=1)
        runs = torch.where(posted.any(dim=1), ((last - first + 1) * leaf_k + RUN - 1) // RUN, 0)
    else:
        runs = ((n + RUN - 1) // RUN).sum(dim=1)
    return m, int(runs.sum())


def tile_step(rec: torch.Tensor, o: torch.Tensor, d: torch.Tensor, mine: torch.Tensor,
              leaf_k: int, cost: float):
    """One warp step of rt::Ray::tile_step on one-visit records: lane l
    visits ``rec[l]`` if ``mine[l]`` → ((32,) position or -1, (32,) t,
    the stage the warp took: "warp", "lanes" or None where no lane posts a
    triangle, (m, w))."""
    w = traverse.infer_rec_width(leaf_k, rec.shape[1])
    posted = (rec[:, 6 * w:7 * w] == -1.0) & mine[:, None]
    cnt = rec[:, 7 * w:8 * w]
    m, runs = price(posted, cnt, leaf_k)
    at = torch.full((RUN,), -1, dtype=torch.int64)
    best = torch.full((RUN,), 1e30, dtype=torch.float32)
    if m == 0:
        return at, best, None, (m, runs)
    if cost * runs < m:
        for lane in torch.nonzero(posted.any(dim=1)).squeeze(1).tolist():
            a, b = warp_nearest_position(rec[lane:lane + 1], posted[lane:lane + 1],
                                         o[lane:lane + 1], d[lane:lane + 1], leaf_k,
                                         pack=leaf_k < RUN)
            at[lane], best[lane] = a[0], b[0]
        return at, best, "warp", (m, runs)
    a, b = lane_nearest(rec, posted, o, d, leaf_k)
    return a, b, "lanes", (m, runs)


def warps_of(n_rec: int, seed: int):
    """Warps of 32 lanes over ``n_rec`` one-visit records: (the record of
    each lane (W, 32), whether the lane is in the window (W, 32)). Lanes of
    a warp share one record, or four, or each has its own; all lanes are in
    the window, or a seeded half, or one."""
    rng = np.random.default_rng(seed)
    recs, mine = [], []
    for share in (1, 4, 32):
        for window in ("all", "half", "one"):
            for _ in range(2):
                pick = rng.integers(0, n_rec, size=share)
                recs.append(pick[np.arange(RUN) % share])
                if window == "all":
                    mine.append(np.ones(RUN, bool))
                elif window == "half":
                    mine.append(rng.random(RUN) < 0.5)
                else:
                    mine.append(np.arange(RUN) == rng.integers(0, RUN))
    return torch.from_numpy(np.stack(recs)), torch.from_numpy(np.stack(mine))


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("leaf_k", KS)
def test_tile_step_keeps_what_the_sequential_loop_keeps(w, leaf_k):
    """Every lane in the window gets the triangle and t of the plain
    version's closest-hit leaf loop on its record, whichever stage the
    warp's rule takes at each cost c (0: always the warp's tests where a
    lane posts, 1e9: always the lanes' loops), both stages are taken at some
    c, and every lane outside the window returns the miss values."""
    n = 256
    _, rec, o, d = one_record_cases(w, leaf_k, n, seed=leaf_k)
    recs, mine = warps_of(n, seed=leaf_k + w)
    # the ray of lane l of a warp: its record's ray, shifted a little so that
    # lanes sharing a record trace different rays, as neighbouring pixels do
    shift = torch.linspace(-0.02, 0.02, RUN)[:, None] * torch.tensor([1.0, -0.5, 0.0])
    taken = set()
    for lanes, inside in zip(recs, mine):
        lo, ld = o[lanes] + shift, d[lanes]
        lrec = rec[lanes]
        t, _, tri, _ = traverse._traverse(rec, lo, ld, leaf_k, entry=lanes)
        for cost in COSTS:
            at, best, stage, _ = tile_step(lrec, lo, ld, inside, leaf_k, cost)
            taken.add(stage)
            assert torch.equal(at[inside], tri.long()[inside]), (cost, stage)
            assert torch.equal(best[inside].view(torch.int32), t[inside].view(torch.int32))
            assert bool((at[~inside] == -1).all() & (best[~inside] == 1e30).all())
    assert {"warp", "lanes"} <= taken


def test_tile_step_cases_share_records_and_hold_ties():
    """The warps exercise what the choice must get right: lanes sharing a
    record (the K1 case) and lanes of their own, rays with two accepted
    positions at the nearest t, and warps where the rule flips between the
    stages as c grows."""
    w, leaf_k = 4, 32
    n = 256
    tris, rec, o, d = one_record_cases(w, leaf_k, n, seed=leaf_k)
    tt, ok = moller_trumbore(o[:, None, :], d[:, None, :], tris[..., 0:3], tris[..., 3:6],
                             tris[..., 6:9])
    t_acc = torch.where(ok, tt, torch.full_like(tt, torch.inf))
    assert bool(((t_acc == t_acc.min(dim=1, keepdim=True).values) & ok).sum(dim=1).ge(2).any())
    recs, mine = warps_of(n, seed=leaf_k + w)
    assert bool((recs == recs[:, :1]).all(dim=1).any()) and bool(
        (recs.sort(dim=1).values.diff(dim=1) != 0).all(dim=1).any())
    flips = 0
    for lanes, inside in zip(recs, mine):
        stages = [tile_step(rec[lanes], o[lanes], d[lanes], inside, leaf_k, c)[2]
                  for c in COSTS[1:-1]]
        flips += "warp" in stages and "lanes" in stages
    assert flips > 0


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("leaf_k", [8, 32, 64])
def test_warp_census_prices_like_the_model(w, leaf_k):
    """TraversalCounts.warp_census, on warps of one-visit rays logged by the
    plain version, counts the model's m and w (Σ over the warps), the
    posting steps, and takes the warp's tests where c·w < m."""
    n = 256
    _, rec, o, d = one_record_cases(w, leaf_k, n, seed=leaf_k + 1)
    recs, _ = warps_of(n, seed=leaf_k)
    lanes = recs.reshape(-1)
    counts = traverse.TraversalCounts(leaf_log=True)
    _, _, _, visits = traverse._traverse(rec, o[lanes], d[lanes], leaf_k, counts=counts,
                                         entry=lanes)
    warps = torch.arange(lanes.numel()) // RUN
    census = counts.warp_census(warps, visits, leaf_k, costs=(2.0,))
    posted = [rec[r][:, 6 * w:7 * w] == -1.0 for r in recs]
    prices = [price(p, rec[r][:, 7 * w:8 * w], leaf_k) for p, r in zip(posted, recs)]
    posting = [mw for mw, p in zip(prices, posted) if bool(p.any())]
    assert census["warp_steps"] == recs.shape[0]
    assert census["posting_steps"] == len(posting)
    assert census["lane_iterations"] == sum(m for m, _ in prices)
    assert census["warp_runs"] == sum(runs for _, runs in prices)
    assert census["c=2"]["cost"] == sum(2.0 * runs if 2.0 * runs < m else m
                                        for m, runs in posting)


@pytest.mark.parametrize("slots", [4, 8])
def test_tile_plan_routes_by_leaf_size(slots):
    """K = 1 runs the render core and K > 1 TILE_CORE, without its packed
    slots from K = 32 on; the plan reads nothing else, so every variant at
    either width runs it, each launch counted under its kernel."""
    plan = traverse.tile_plan
    assert plan(leaf_k=1) == 1
    for k in (2, 8, 31):
        assert plan(leaf_k=k) == traverse.TILE_CORE
    for k in (32, 33, 64):
        assert plan(leaf_k=k) == traverse.TILE_CORE & ~traverse._PACK_SLOTS == 161
    for stats in (False, True):
        for bounded in (False, True):
            name = traverse._tile_launch_name(slots, stats, "trace_tiles_k1a", bounded)
            assert name in traverse.LAUNCHES
            assert name == ("trace_tiles_k1f" if stats else "trace_tiles_k1d" if bounded
                            else "trace_tiles_k1e" if slots == 8 else "trace_tiles_k1a")


def test_tile_core_is_the_kernels_mask():
    """TILE_CORE is rt::kTileCore (rt::kAnyHitCore | rt::kTileLeaves), whose
    rule runs at one cost c (rt::kTileLeafCost, a constant); every launcher
    takes the tile launchers' list of cores, which holds the new core and
    not rt::kAnyHitCore, and the wrapper's argument lists are the
    launchers'."""
    bits = core_masks()
    assert traverse.TILE_CORE == bits["kTileCore"] == (bits["kAnyHitCore"] | bits["kTileLeaves"])
    src = (build.CSRC / "traverse_core.cuh").read_text()
    cost = float(re.search(r"constexpr float kTileLeafCost = ([\d.]+)f;", src).group(1))
    assert 0.0 < cost < 32.0
    assert "kTileLeafCost * (float)__reduce_add_sync" in src
    tiles = (build.CSRC / "traverse_tiles.cu").read_text()
    listed = re.findall(r"#define RT_TILE_CORES\(X\)(.*)", tiles)
    assert len(listed) == len(traverse.TILE_SOURCES) == 2
    assert "rt::kTileCore" in listed[0] and "kAnyHitCore" not in "".join(listed)
    assert traverse._tile_source(traverse.tile_plan(leaf_k=1)) == "traverse_tiles.cu"
    for k in (2, 32):
        assert traverse._tile_source(traverse.tile_plan(leaf_k=k)) == "traverse_tiles.cu:warp"
    for fn in ("rt_trace_tiles", "rt_trace_tiles_batch", "rt_trace_tiles_batch_raw"):
        body = re.search(fn + r"\(.*?\n}\n", tiles, re.S).group(0)
        assert "RT_TILE_CORES(RT_CASE)" in body and "int core" in body, fn
        params = re.search(fn + r"\(([^)]*)\)", tiles).group(1).count(",") + 1
        assert len(traverse._ARGTYPES["traverse_tiles.cu"][fn]) == params, fn
