"""The redesigned traversal core (``csrc/traverse_core.cuh``) written out in
Python as its kernel writes it, against the plain version
(``ops/cuda/traverse.py::_traverse``), on the CPU:

* the child order in registers — each passing child k goes to stack index
  sp + 1 + pos(k), pos(k) = #{j passing : key_j > key_k} + #{j < k passing :
  key_j == key_k}, and is dropped when that index passes 63 — is the plain
  version's stable descending sort and drop, over random keys with ties, ±0,
  ±inf and NaN (on slots that do not pass) at 4 and 8 slots;
* a one-ray walk with that order, a 64-entry array stack and the pushes
  moved before the leaf tests (as the warp's leaf steps push them,
  ``Ray::warp_step`` / ``tile_step``) gives the plain version's triangle, t
  and visit count on every ray;
* the walk's deepest stack equals the plain version's ``max_depth`` count;
  on the synthetic overflow records of ``torch_parity.deep_records`` it
  passes the 16 entries the render paths' stacks stay within and the
  64-entry limit, where pushes are dropped.

Needs no card and no Pallas call: the CUDA kernels themselves are held
against these rules on the card (``tests/test_torch_kernel.py``, marker
``cuda``).
"""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.ops.cluster import build_sah2_clustered, records_pipeline
from raytracer_tpu_torch.ops.cuda import traverse
from raytracer_tpu_torch.ops.trace import STACK_MAX, moller_trumbore
from torch_parity import CAM_POS, CAM_QUAT, FOV, deep_records, image_dirs, seeded_scene

# the deepest stack measured on the render paths' rays (PERF.md §6), which
# sized the shared-memory stack that the card measured and the port retired
SHARED_ENTRIES = 16


def rank_positions(keys: torch.Tensor, passing: torch.Tensor) -> torch.Tensor:
    """pos(k) as the kernel counts it, over the pairs j < k of slots:
    ``key_j >= key_k`` adds j to k's rank, its negation k to j's (passing
    keys are never NaN)."""
    w = keys.shape[1]
    pos = torch.zeros(keys.shape, dtype=torch.int64)
    for k in range(1, w):
        for j in range(k):
            ge = keys[:, j] >= keys[:, k]
            pos[:, k] += (passing[:, j] & ge).long()
            pos[:, j] += (passing[:, k] & ~ge).long()
    return pos


def push_by_rank(keys, passing, sp):
    """The kernel's push: (stack slot index → child slot, -1 empty; new sp)."""
    r, w = keys.shape
    pos = rank_positions(keys, passing)
    stack = torch.full((r, STACK_MAX), -1, dtype=torch.int64)
    for k in range(w):
        at = sp + 1 + pos[:, k]
        ok = passing[:, k] & (at < STACK_MAX)
        stack[ok, at[ok]] = k
    return stack, torch.clamp(sp + passing.sum(dim=1), max=STACK_MAX - 1)


def push_by_sort(keys, passing, sp):
    """The plain version's push (``_traverse``): a stable descending sort of
    the keys (−inf where a slot does not pass), then the children in that
    order while the stack has room."""
    r, w = keys.shape
    skey = torch.where(passing, keys, torch.full_like(keys, -torch.inf))
    _, order = torch.sort(skey, dim=1, descending=True, stable=True)
    stack = torch.full((r, STACK_MAX), -1, dtype=torch.int64)
    sp = sp.clone()
    rows = torch.arange(r)
    for i in range(w):
        slot = order[:, i]
        can = passing[rows, slot] & (sp < STACK_MAX - 1)
        sp[can] += 1
        stack[rows[can], sp[can]] = slot[can]
    return stack, sp


@pytest.mark.parametrize("width", [4, 8])
def test_rank_order_equals_the_stable_sort_and_drop(width):
    """Random key sets: a few distinct values (so that keys tie), ±0, ±inf,
    NaN on slots that do not pass, every pass mask, and stack tops from
    empty to full, so that some pushes are dropped."""
    rng = np.random.default_rng(width)
    r = 20000
    pool = np.float32([0.0, -0.0, np.inf, -np.inf, 1.5, 1.5, -2.25, 7.0, 3.0])
    keys = np.where(rng.random((r, width)) < 0.5, rng.choice(pool, size=(r, width)),
                    rng.integers(-3, 4, size=(r, width)).astype(np.float32))
    passing = rng.random((r, width)) < rng.uniform(0.2, 1.0, size=(r, 1))
    keys = np.where(~passing & (rng.random((r, width)) < 0.3), np.float32(np.nan), keys)
    sp = rng.integers(-1, STACK_MAX, size=r)
    keys, passing, sp = torch.from_numpy(keys), torch.from_numpy(passing), torch.from_numpy(sp)
    assert bool((keys == 0).any()) and bool(torch.signbit(keys[keys == 0]).any())
    by_rank, sp_rank = push_by_rank(keys, passing, sp)
    by_sort, sp_sort = push_by_sort(keys, passing, sp)
    assert torch.equal(sp_rank, sp_sort)
    assert torch.equal(by_rank, by_sort)
    dropped = (sp + passing.sum(dim=1) > STACK_MAX - 1) & passing.any(dim=1)
    assert 0 < int(dropped.sum()) < r


def walk_hopper(qn, o, d, leaf_k: int, any_hit: bool):
    """One ray as the redesigned kernel walks it: a 64-entry array stack,
    the order by rank, the pushes before the leaf tests → (tri, t, visits,
    deepest stack)."""
    w = traverse.infer_rec_width(leaf_k, qn.shape[1])
    vbase, ibase, _ = traverse.rec_layout(leaf_k, w)
    inv = torch.where(d.abs() > 1e-8, d.reciprocal(), torch.full_like(d, 1e30))
    best, tri, visits = torch.tensor(1e30), -1, 0
    stack_n, stack_d = [0] * STACK_MAX, [torch.tensor(0.0)] * STACK_MAX
    sp, deepest = 0, 1
    while sp >= 0:
        node, key = stack_n[sp], stack_d[sp]
        sp -= 1
        if not bool(key < best):
            continue
        visits += 1
        boxes = qn[node, 0:6 * w].reshape(w, 6)
        t1, t2 = (boxes[:, 0:3] - o) * inv, (boxes[:, 3:6] - o) * inv
        tmin = torch.minimum(t1, t2).amax(-1)
        tmax = torch.maximum(t1, t2).amin(-1)
        hit = (tmax >= tmin.clamp_min(0.0)) & (tmin < best)
        refs, cnt = qn[node, 6 * w:7 * w], qn[node, 7 * w:8 * w]
        passing = hit & (refs >= 0.0)
        pos = rank_positions(tmin[None], passing[None])[0]
        for k in range(w):
            at = sp + 1 + int(pos[k])
            if bool(passing[k]) and at < STACK_MAX:
                stack_n[at], stack_d[at] = int(refs[k]), tmin[k]
        sp = min(sp + int(passing.sum()), STACK_MAX - 1)
        deepest = max(deepest, sp + 1)
        for k in range(w):
            if not bool(hit[k] & (refs[k] < 0.0) & (refs[k] > traverse.EMPTY_REF)):
                continue
            recs = qn[node, vbase + 12 * leaf_k * k:vbase + 12 * leaf_k * (k + 1)]
            recs = recs.reshape(leaf_k, 12)
            tt, ok = moller_trumbore(o, d, recs[:, 0:3], recs[:, 3:6], recs[:, 6:9])
            for j in range(leaf_k):
                if not j < float(cnt[k]):
                    break
                if bool(ok[j]) and bool(tt[j] < best):
                    best, tri = tt[j], int(qn[node, ibase + k * leaf_k + j])
                    if any_hit:
                        return tri, torch.tensor(0.0), visits, deepest
    return tri, best, visits, deepest


def check_walk(qn, o, d, leaf_k: int, any_hit: bool) -> int:
    """The walk against the plain version on every ray → the deepest stack."""
    counts = traverse.TraversalCounts()
    t, _, tri, visits = traverse._traverse(qn, o, d, leaf_k, any_hit, counts)
    walked = [walk_hopper(qn, o[i], d[i], leaf_k, any_hit) for i in range(o.shape[0])]
    assert [w[0] for w in walked] == tri.tolist()
    assert torch.equal(torch.stack([w[1] for w in walked]), t)
    assert [w[2] for w in walked] == visits.tolist()
    assert max(w[3] for w in walked) == counts.max_depth
    return counts.max_depth


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_with_pushes_first_matches_the_plain_version(width, any_hit):
    """Camera rays through a seeded icosphere (SAH clusters of 8), with
    pushes before the leaf tests: the same triangle, t and visits."""
    tris = seeded_scene(2)
    cs, height = build_sah2_clustered(tris, 8, "cpu")
    qn = records_pipeline(cs, height=height, width=width)
    d = image_dirs(10, 8).reshape(-1, 3).contiguous()
    o = torch.tensor(CAM_POS, dtype=torch.float32).expand_as(d).contiguous()
    assert 0 < check_walk(qn, o, d, 8, any_hit) <= SHARED_ENTRIES


@pytest.mark.parametrize("width", [4, 8])
def test_overflow_records_pass_the_shared_stack_and_the_limit(width):
    """On the deep synthetic records the walk equals the plain version where
    stacks spill past the shared entries and pushes are dropped at 64."""
    qn, o, d = deep_records(width, n=48)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    assert check_walk(qn, o, d, 1, any_hit=False) == STACK_MAX > SHARED_ENTRIES
    counts = traverse.TraversalCounts()
    traverse.trace_rays_reference(qn, o, d, leaf_k=1, counts=counts)
    assert counts.dropped > 0 and counts.max_depth == STACK_MAX
