"""The traversal kernels' wrappers (K1a/K1b ``trace_tiles``, K1c
``trace_tiles_batch``, K2a/K2b ``trace_rays``; K1d with ``entries`` /
``tbounds``, K1e and K2c on 8-wide records, K1f with ``stats``), their build, each kernel against its plain
torch version, on SAH cluster trees and on the Morton LBVH of single
triangles (``leaf_k = 1``); the LBVH build chain and the refit chain on the
card against the same chains on the CPU; and the microbenchmark kernels
MB1–MB4 against their plain versions.

Needs neither JAX nor the JAX package, so the tests marked ``cuda`` run on
a machine with a card and only the port:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel.py

(``--noconftest``: the suite's conftest.py configures JAX). Without a card
they skip; the wrapper's CPU path and checks are tested everywhere.
Tolerances: the traversal rule of ``torch_parity`` for closest hit (K1a,
K1b, K1c, K1e, K2a, K2c); the occlusion mask equal on every ray for any hit
(K2b, K2c); K1c's frames bit-equal to K1a's (K1b's); K1f's visits plane
equal to the plain version's on every ray whose triangle agrees, and its
five other planes bit-equal to the kernel's without ``stats``; K1d by the
closest-hit rule on its hits, with t = its tile's bound exactly where it finds
none, and the bounded and temporal traces bit-equal to the unbounded kernel;
the refit chain's records byte-equal; the core each launch plan runs (the
render core at K = 1) word for word equal to the plain version run on the
card, in every launch shape and K2 schedule; any hit over leaves of K > 1
with the leaf tests spread over the warp (``traverse.ANY_HIT_CORE``) word
for word equal to the plain version at K = 2 to 64, both orders and
schedules, on stacks past 64 entries and under every placement; closest
hit with the warp's leaf tests (``traverse.CLOSEST_HIT_CORE``) the same,
and on duplicate triangles at equal t; K1 over leaves of K > 1
(``traverse.TILE_CORE``) word for word equal to the plain version in every
variant; the raw
tile layout of a batch (``raw=True``) bit-equal to the layout of its image
planes on every word, and each record placement of K2 (``tree_space``
"vmem", "smem") word for word equal to "hbm", leaving no access-policy
window or L2 carve-out behind.
"""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.ops.camera import generate_rays_jittered
from raytracer_tpu_torch import render
from raytracer_tpu_torch.ops.cluster import (build_lbvh2_clustered, build_sah2_clustered,
                                             records_pipeline, refit_lbvh2_clustered,
                                             wide_pipeline)
from raytracer_tpu_torch.ops.collapse import (LBVH2, collapse_apply_refit, collapse_lbvh2_to_bvh4,
                                              collapse_lbvh2_to_bvh8, collapse_plan)
from raytracer_tpu_torch.ops.cuda import build, microbench, traverse
from raytracer_tpu_torch.ops.lbvh import build_lbvh2
from raytracer_tpu_torch.ops.cuda.entry import compute_tile_entries
from raytracer_tpu_torch.ops.trace import make_wide_bvh
from raytracer_tpu_torch.ops.trace import moller_trumbore
from raytracer_tpu_torch.models.scene import Scene
from raytracer_tpu_torch.utils import procgen
from torch_parity import (CAM_POS, CAM_QUAT, FOV, assert_trace_parity, deep_records, image_dirs,
                          ray_buffer, room_scene, seeded_scene, tile_bounds)

SUN = (np.float32([1.0, 1.5, 1.0]) / np.linalg.norm([1.0, 1.5, 1.0])).astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the traversal kernels have no CPU mode")
    return torch.device("cuda")


def room(device, k: int = 8, n: int = 4096, width: int = 4):
    """Records (of ``width`` child slots) of the room scene on ``device``
    and a seeded ray buffer."""
    tris = room_scene()
    cs, height = build_sah2_clustered(tris, k, device)
    qn = records_pipeline(cs, height=height, width=width)
    o, d = ray_buffer(qn, k, n)
    return tris, qn, torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)


def test_cpu_records_run_the_plain_version():
    """On the CPU the wrappers return the plain versions' planes and launch
    nothing."""
    tris = seeded_scene(2)
    qn = records_pipeline(build_sah2_clustered(tris, 8, "cpu")[0])
    before = dict(traverse.LAUNCHES)
    for jitter in (False, True):
        planes = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, 48, 32, FOV, leaf_k=8,
                                      jitter=jitter, jitter_seed=5)
        ref = traverse.trace_tiles_reference(qn, CAM_POS, CAM_QUAT, 48, 32, FOV, leaf_k=8,
                                             jitter=jitter, jitter_seed=5)
        assert all(torch.equal(a, b) for a, b in zip(planes, ref))
    _, qn, o, d = room("cpu", n=512)
    for any_hit in (False, True):
        rays = traverse.trace_rays(qn, o, d, any_hit=any_hit, leaf_k=8)
        ref = traverse.trace_rays_reference(qn, o, d, any_hit=any_hit, leaf_k=8)
        assert all(torch.equal(a, b) for a, b in zip(rays, ref))
    assert traverse.LAUNCHES == before


def test_jittered_tiles_differ_by_seed_and_match_the_jittered_rays():
    """K1b's plain version traces the rays of generate_rays_jittered (the
    same seed gives the same planes, another seed other ones), and K1a's is
    the same function at the pixel centres."""
    tris = seeded_scene(2)
    qn = records_pipeline(build_sah2_clustered(tris, 8, "cpu")[0])
    w, h = 40, 24
    a = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=8, jitter=True,
                             jitter_seed=9)
    b = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=8, jitter=True,
                             jitter_seed=10)
    centre = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=8)
    assert not torch.equal(a[0], b[0]) and not torch.equal(a[0], centre[0])
    o, d = generate_rays_jittered(w, h, CAM_POS, CAM_QUAT, 9, FOV, device="cpu")
    rays = traverse.trace_rays(qn, o.reshape(-1, 3).contiguous(), d.reshape(-1, 3), leaf_k=8)
    assert all(torch.equal(x.reshape(-1), y) for x, y in zip(a, rays))


def test_active_mask_skips_nan_rays_on_cpu():
    """Inactive rays are never read: NaN there changes nothing, and they
    return t = 1e30, a zero normal and tri = -1."""
    _, qn, o, d = room("cpu", n=1024)
    active = torch.from_numpy(np.random.default_rng(1).random(1024) < 0.6)
    o_nan, d_nan = o.clone(), d.clone()
    o_nan[~active], d_nan[~active] = float("nan"), float("inf")
    for any_hit in (False, True):
        full = traverse.trace_rays(qn, o, d, any_hit=any_hit, leaf_k=8)
        masked = traverse.trace_rays(qn, o_nan, d_nan, any_hit=any_hit, leaf_k=8,
                                     active=active)
        assert all(torch.equal(m[active], f[active]) for m, f in zip(masked, full))
        assert (masked[0][~active] == 1e30).all() and (masked[4][~active] == -1).all()
        assert all((p[~active] == 0).all() for p in masked[1:4])


def test_trace_rays_rejects_bad_inputs():
    qn = torch.zeros((4, traverse.rec_layout(8, 4)[2]), dtype=torch.float32)
    o = torch.zeros((16, 3))
    with pytest.raises(TypeError):
        traverse.trace_rays(qn, o.double(), o, leaf_k=8)
    with pytest.raises(ValueError):
        traverse.trace_rays(qn, torch.zeros((16, 4)), torch.zeros((16, 4)), leaf_k=8)
    with pytest.raises(ValueError):
        traverse.trace_rays(qn, torch.zeros((3, 16)).t(), o, leaf_k=8)
    with pytest.raises(ValueError):
        traverse.trace_rays(qn, o, torch.zeros((8, 3)), leaf_k=8)
    with pytest.raises(TypeError):
        traverse.trace_rays(qn, o, o, leaf_k=8, active=torch.ones(16, dtype=torch.uint8))
    with pytest.raises(ValueError):
        traverse.trace_rays(qn, o, o, leaf_k=8, active=torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError):
        traverse.trace_rays(qn, o, o, leaf_k=8, active=torch.ones(32, dtype=torch.bool)[::2])
    with pytest.raises(ValueError):
        traverse.trace_rays(qn.to("meta"), o, o, leaf_k=8)
    with pytest.raises(ValueError):
        traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, 8, 8, leaf_k=8, jitter=True,
                             jitter_seed=1 << 24)


def test_build_hash_covers_included_headers(tmp_path):
    """A change to a header (and only to it) changes the library's hash, so
    the next build compiles anew; every CUDA build hashes every csrc/*.cuh.
    Needs no nvcc."""
    src, hdr = tmp_path / "k.cu", tmp_path / "core.cuh"
    src.write_text('#include <stdint.h>\n#include "core.cuh"\nint f() { return g(); }\n')
    hdr.write_text("inline int g() { return 1; }\n")
    before = build.content_hash([src], build.NVCC_FLAGS, headers=[hdr])
    assert build.content_hash([src], build.NVCC_FLAGS, headers=[hdr]) == before
    hdr.write_text("inline int g() { return 2; }\n")
    assert build.content_hash([src], build.NVCC_FLAGS, headers=[hdr]) != before
    assert [p.name for p in build.cuda_headers()] == [
        "lanes.cuh", "raygen.cuh", "traverse_core.cuh"]


def walk(qn: torch.Tensor, o: torch.Tensor, d: torch.Tensor, leaf_k: int, any_hit: bool):
    """One ray walked one stack pop at a time, as the kernels' loop
    (csrc/traverse_core.cuh) walks it → (tri, node visits, MT tests)."""
    w = traverse.infer_rec_width(leaf_k, qn.shape[1])
    vbase, ibase, _ = traverse.rec_layout(leaf_k, w)
    inv = torch.where(d.abs() > 1e-8, d.reciprocal(), torch.full_like(d, 1e30))
    best, tri, visits, tests = 1e30, -1, 0, 0
    stack = [(0, 0.0)]
    while stack:
        node, key = stack.pop()
        if not key < best:
            continue
        visits += 1
        boxes = qn[node, 0:6 * w].reshape(w, 6)
        t1, t2 = (boxes[:, 0:3] - o) * inv, (boxes[:, 3:6] - o) * inv
        tmin = torch.minimum(t1, t2).amax(-1)
        tmax = torch.maximum(t1, t2).amin(-1)
        hit = ((tmax >= tmin.clamp_min(0.0)) & (tmin < best)).tolist()
        refs, cnt = qn[node, 6 * w:7 * w].tolist(), qn[node, 7 * w:8 * w].tolist()
        for k in range(w):
            if not (hit[k] and traverse.EMPTY_REF < refs[k] < 0.0):
                continue
            recs = qn[node, vbase + 12 * leaf_k * k:vbase + 12 * leaf_k * (k + 1)]
            recs = recs.reshape(leaf_k, 12)
            tt, ok = moller_trumbore(o, d, recs[:, 0:3], recs[:, 3:6], recs[:, 6:9])
            for j in range(leaf_k):
                if not j < cnt[k]:
                    break
                tests += 1
                if bool(ok[j]) and float(tt[j]) < best:
                    best, tri = float(tt[j]), int(qn[node, ibase + k * leaf_k + j])
                    if any_hit:
                        return tri, visits, tests
        order = sorted((k for k in range(w) if hit[k] and refs[k] >= 0.0),
                       key=lambda k: -float(tmin[k]))
        for k in order:
            if len(stack) < traverse.STACK_MAX:
                stack.append((int(refs[k]), float(tmin[k])))
    return tri, visits, tests


def check_counts_against_walk(any_hit: bool, width: int) -> None:
    tris, qn, o, d = room("cpu", n=96, width=width)
    sun = torch.from_numpy(SUN).expand_as(o).contiguous()
    dirs = sun if any_hit else d
    counts = traverse.TraversalCounts()
    ref = traverse.trace_rays_reference(qn, o, dirs, any_hit=any_hit, leaf_k=8, counts=counts)
    walked = [walk(qn, o[i], dirs[i], 8, any_hit) for i in range(o.shape[0])]
    assert counts.rays == o.shape[0] and counts.width == width
    assert counts.visits == sum(w[1] for w in walked)
    assert counts.mt_tests == sum(w[2] for w in walked)
    assert [w[0] for w in walked] == ref[4].tolist()
    assert 0 < sum(w[0] >= 0 for w in walked) < o.shape[0]


@pytest.mark.parametrize("any_hit", [False, True])
def test_traversal_counts_match_a_per_ray_walk(any_hit):
    """The plain version counts the node visits and Möller–Trumbore tests
    that the kernel's sequential loop does: an any-hit ray stops testing at
    its first accepted triangle. These counts set the kernels' bounds."""
    check_counts_against_walk(any_hit, 4)


@pytest.mark.parametrize("any_hit", [False, True])
def test_traversal_counts_match_a_per_ray_walk_on_wide8(any_hit):
    """The same on 8-wide records: up to 8 slab tests and 8 pushes a visit."""
    check_counts_against_walk(any_hit, 8)


def test_trace_tiles_window_matches_full_frame():
    """A window (raygen_size + offsets) traces the same pixels of the frame."""
    tris = seeded_scene(2)
    qn = records_pipeline(build_sah2_clustered(tris, 8, "cpu")[0])
    full = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, 96, 64, FOV, leaf_k=8)
    win = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, 40, 24, FOV, leaf_k=8,
                               raygen_size=(96, 64), row_offset=30, col_offset=17)
    for a, b in zip(win, full):
        assert torch.equal(a, b[30:54, 17:57])
    with pytest.raises(ValueError):
        traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, 40, 24, FOV, leaf_k=8,
                             raygen_size=(96, 64), row_offset=50)


def test_trace_tiles_rejects_bad_records():
    qn = torch.zeros((4, traverse.rec_layout(8, 4)[2]), dtype=torch.float32)
    with pytest.raises(TypeError):
        traverse.trace_tiles(qn.double(), CAM_POS, CAM_QUAT, 8, 8, leaf_k=8)
    with pytest.raises(ValueError):
        traverse.trace_tiles(qn[:, ::2], CAM_POS, CAM_QUAT, 8, 8, leaf_k=8)
    with pytest.raises(ValueError):
        traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, 8, 8, leaf_k=2)
    with pytest.raises(ValueError, match="matches no supported child count"):
        traverse.trace_tiles(torch.zeros((4, traverse.rec_layout(8, 8)[2] + 128)),
                             CAM_POS, CAM_QUAT, 8, 8, leaf_k=8)


def test_cpu_records8_run_the_plain_version():
    """8-wide records on the CPU: the wrappers return the plain versions'
    planes (with and without stats) and launch nothing."""
    _, qn, o, d = room("cpu", n=256, width=8)
    assert qn.shape[1] == traverse.rec_layout(8, 8)[2]
    before = dict(traverse.LAUNCHES)
    for stats in (False, True):
        planes = traverse.trace_tiles(qn, (0.0, 0.1, 2.2), CAM_QUAT, 32, 24, FOV, leaf_k=8,
                                      stats=stats)
        ref = traverse.trace_tiles_reference(qn, (0.0, 0.1, 2.2), CAM_QUAT, 32, 24, FOV,
                                             leaf_k=8, stats=stats)
        assert len(planes) == (6 if stats else 5)
        assert all(torch.equal(a, b) for a, b in zip(planes, ref))
    bounded = traverse.trace_tiles(qn, (0.0, 0.1, 2.2), CAM_QUAT, 32, 24, FOV, leaf_k=8,
                                   tbounds=torch.full((1, 1), 2.0))
    ref = traverse.trace_tiles_reference(qn, (0.0, 0.1, 2.2), CAM_QUAT, 32, 24, FOV, leaf_k=8,
                                         tbounds=torch.full((1, 1), 2.0))
    assert all(torch.equal(a, b) for a, b in zip(bounded, ref))
    assert bool((bounded[0] <= 2.0).all()) and bool((bounded[0][bounded[4] < 0] == 2.0).all())
    for any_hit in (False, True):
        rays = traverse.trace_rays(qn, o, d, any_hit=any_hit, leaf_k=8)
        ref = traverse.trace_rays_reference(qn, o, d, any_hit=any_hit, leaf_k=8)
        assert all(torch.equal(a, b) for a, b in zip(rays, ref))
    assert traverse.LAUNCHES == before
    rays = {f"trace_rays_{k}{order}{space}" for k in ("k2a", "k2b", "k2c")
            for order in ("", "_unordered") for space in ("", "_vmem", "_smem")}
    assert set(before) == {"trace_tiles_k1a", "trace_tiles_k1b", "trace_tiles_k1c",
                           "trace_tiles_k1d", "trace_tiles_k1e", "trace_tiles_k1f",
                           "trace_tiles_k1c_raw", "trace_tiles_k1e_raw", "trace_tiles_k1f_raw",
                           *rays, "camera_lanes", "wave_hit", "wave_bounce",
                           "sample_graph_replay", "sample_graph_capture"}
    assert len(rays) == 18 and "trace_rays_k2b_unordered_smem" in rays


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 32])
def test_kernel_matches_reference_on_card(cuda_device, k):
    """K1a vs its plain torch version on the card, whole frame and a window."""
    tris = seeded_scene(4)
    w, h = 192, 128
    qn = records_pipeline(build_sah2_clustered(tris, k, cuda_device)[0])
    before = traverse.LAUNCHES["trace_tiles_k1a"]
    ours = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=k)
    torch.cuda.synchronize()
    assert traverse.LAUNCHES["trace_tiles_k1a"] == before + 1
    ref = traverse.trace_tiles_reference(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=k)
    ours, ref = [p.cpu() for p in ours], [p.cpu() for p in ref]
    assert_trace_parity(ours, ref[0], ref[4], torch.stack(ref[1:4], -1).numpy(),
                        tris, image_dirs(w, h))
    win = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, 50, 40, FOV, leaf_k=k,
                               raygen_size=(w, h), row_offset=70, col_offset=33)
    for a, b in zip(win, ours):
        assert torch.equal(a.cpu(), b[70:110, 33:83])


@pytest.mark.cuda
def test_kernel_refuses_strided_records(cuda_device):
    """The wrapper checks the records' layout on the card too."""
    qn = torch.zeros((4, traverse.rec_layout(8, 4)[2]), device=cuda_device)
    with pytest.raises(ValueError):
        traverse.trace_tiles(qn[:, ::2], CAM_POS, CAM_QUAT, 8, 8, leaf_k=8)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 32])
def test_jittered_kernel_matches_reference_on_card(cuda_device, k):
    """K1b vs its plain torch version on the card, with a 22-bit seed."""
    tris = seeded_scene(4)
    w, h, seed = 192, 128, (1 << 22) - 7
    qn = records_pipeline(build_sah2_clustered(tris, k, cuda_device)[0])
    before = dict(traverse.LAUNCHES)
    ours = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=k, jitter=True,
                                jitter_seed=seed)
    torch.cuda.synchronize()
    assert traverse.LAUNCHES["trace_tiles_k1b"] == before["trace_tiles_k1b"] + 1
    assert traverse.LAUNCHES["trace_tiles_k1a"] == before["trace_tiles_k1a"]
    ref = traverse.trace_tiles_reference(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=k,
                                         jitter=True, jitter_seed=seed)
    ours, ref = [p.cpu() for p in ours], [p.cpu() for p in ref]
    dirs = generate_rays_jittered(w, h, CAM_POS, CAM_QUAT, seed, FOV, device="cpu")[1]
    assert_trace_parity(ours, ref[0], ref[4], torch.stack(ref[1:4], -1).numpy(), tris,
                        dirs.reshape(-1, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 32])
def test_ray_kernels_match_reference_on_card(cuda_device, k):
    """K2a by the traversal rule with per-ray origins and K2b's occlusion
    mask against their plain versions on the card, with and without an
    active mask (inactive rays hold NaN); each wrapper counts one launch."""
    tris, qn, o, d = room(cuda_device, k)
    sun = torch.from_numpy(SUN).to(cuda_device).expand_as(o).contiguous()
    active = torch.from_numpy(np.random.default_rng(2).random(o.shape[0]) < 0.7).to(cuda_device)
    o_nan = torch.where(active[:, None], o, torch.full_like(o, float("nan")))
    before = dict(traverse.LAUNCHES)
    k2a = traverse.trace_rays(qn, o, d, leaf_k=k)
    k2a_masked = traverse.trace_rays(qn, o_nan, d, leaf_k=k, active=active)
    k2b = traverse.trace_rays(qn, o, sun, any_hit=True, leaf_k=k)
    k2b_masked = traverse.trace_rays(qn, o_nan, sun, any_hit=True, leaf_k=k, active=active)
    torch.cuda.synchronize()
    assert traverse.LAUNCHES["trace_rays_k2a"] == before["trace_rays_k2a"] + 2
    assert traverse.LAUNCHES["trace_rays_k2b"] == before["trace_rays_k2b"] + 2
    assert traverse.LAUNCHES["trace_tiles_k1a"] == before["trace_tiles_k1a"]

    ref = [p.cpu() for p in traverse.trace_rays_reference(qn, o, d, leaf_k=k)]
    k2a = [p.cpu() for p in k2a]
    assert_trace_parity(k2a, ref[0], ref[4], torch.stack(ref[1:4], -1).numpy(), tris,
                        d.cpu(), o.cpu().numpy())
    act = active.cpu()
    for m, f in zip(k2a_masked, k2a):
        assert torch.equal(m.cpu()[act], f[act])
    assert (k2a_masked[4].cpu()[~act] == -1).all() and (k2a_masked[0].cpu()[~act] == 1e30).all()

    ref_b = traverse.trace_rays_reference(qn, o, sun, any_hit=True, leaf_k=k)
    occ = (k2b[4] >= 0).cpu()
    assert torch.equal(occ, (ref_b[4] >= 0).cpu())
    assert 0.05 < float(occ.float().mean()) < 0.95
    assert (k2b[0].cpu()[occ] == 0).all() and (k2b[0].cpu()[~occ] == 1e30).all()
    assert torch.equal((k2b_masked[4] >= 0).cpu(), occ & act)


@pytest.mark.cuda
def test_ray_kernel_refuses_inputs_on_card(cuda_device):
    """The wrapper checks device, type, shape and contiguity on the card."""
    qn = torch.zeros((4, traverse.rec_layout(8, 4)[2]), device=cuda_device)
    o = torch.zeros((16, 3), device=cuda_device)
    with pytest.raises(ValueError):
        traverse.trace_rays(qn, o.cpu(), o, leaf_k=8)
    with pytest.raises(ValueError):
        traverse.trace_rays(qn, o, o, leaf_k=8, active=torch.ones(16, dtype=torch.bool))
    with pytest.raises(TypeError):
        traverse.trace_rays(qn, o.half(), o, leaf_k=8)
    with pytest.raises(ValueError):
        traverse.trace_rays(qn, torch.zeros((3, 16), device=cuda_device).t(), o, leaf_k=8)


BATCH_POS = np.float32([CAM_POS, [0.4, 0.1, 2.2], [-0.3, -0.2, 2.9], [0.0, 0.0, 3.2]])
BATCH_QUAT = np.float32([CAM_QUAT, [0, 0, 0, 1], [0.05, -0.1, 0.02, 0.9934], [0, 0.2, 0, 0.9798]])
BATCH_SEEDS = [(1 << 22) - 7, 3, 123457, 99]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 32])
def test_batch_kernel_equals_single_frame_kernels_on_card(cuda_device, k):
    """Each K1c frame is bit-identical to K1a for its camera, and with
    jitter to K1b with its seed; each batch is one K1c launch."""
    tris = seeded_scene(4)
    w, h = 150, 98
    qn = records_pipeline(build_sah2_clustered(tris, k, cuda_device)[0])
    for jitter in (False, True):
        seeds = BATCH_SEEDS if jitter else None
        before = dict(traverse.LAUNCHES)
        batch = traverse.trace_tiles_batch(qn, BATCH_POS, BATCH_QUAT, w, h, FOV, leaf_k=k,
                                           jitter=jitter, jitter_seeds=seeds)
        torch.cuda.synchronize()
        assert traverse.LAUNCHES["trace_tiles_k1c"] == before["trace_tiles_k1c"] + 1
        assert all(traverse.LAUNCHES[n] == before[n] for n in before if n != "trace_tiles_k1c")
        for f in range(len(BATCH_POS)):
            single = traverse.trace_tiles(qn, BATCH_POS[f], BATCH_QUAT[f], w, h, FOV, leaf_k=k,
                                          jitter=jitter, jitter_seed=seeds[f] if jitter else 0)
            assert all(torch.equal(b[f], s) for b, s in zip(batch, single))


@pytest.mark.cuda
def test_batch_kernel_matches_reference_on_card(cuda_device):
    """K1c against trace_tiles_batch_reference by the traversal rule."""
    tris = seeded_scene(4)
    w, h, k = 128, 96, 32
    qn = records_pipeline(build_sah2_clustered(tris, k, cuda_device)[0])
    ours = traverse.trace_tiles_batch(qn, BATCH_POS, BATCH_QUAT, w, h, FOV, leaf_k=k,
                                      jitter=True, jitter_seeds=BATCH_SEEDS)
    ref = traverse.trace_tiles_batch_reference(qn, BATCH_POS, BATCH_QUAT, w, h, FOV, leaf_k=k,
                                               jitter=True, jitter_seeds=BATCH_SEEDS)
    for f in range(len(BATCH_POS)):
        o, r = [p[f].cpu() for p in ours], [p[f].cpu() for p in ref]
        dirs = generate_rays_jittered(w, h, BATCH_POS[f], BATCH_QUAT[f], BATCH_SEEDS[f], FOV,
                                      device="cpu")[1]
        assert_trace_parity(o, r[0], r[4], torch.stack(r[1:4], -1).numpy(), tris,
                            dirs.reshape(-1, 3), BATCH_POS[f])


def launched(before: dict) -> dict:
    """The launches since ``before``, by kernel (those that rose)."""
    return {n: traverse.LAUNCHES[n] - before[n] for n in before
            if traverse.LAUNCHES[n] != before[n]}


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 32])
def test_wide8_tile_kernel_matches_reference_on_card(cuda_device, k):
    """K1e (8-wide records) vs its plain version on the card: one frame with
    and without jitter, and a jittered batch whose frames are bit-identical
    to the single-frame launches; each counts as one K1e launch."""
    tris = seeded_scene(4)
    w, h, seed = 160, 96, (1 << 22) - 7
    cs, height = build_sah2_clustered(tris, k, cuda_device)
    qn = records_pipeline(cs, height=height, width=8)
    for jitter in (False, True):
        before = dict(traverse.LAUNCHES)
        ours = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=k, jitter=jitter,
                                    jitter_seed=seed)
        torch.cuda.synchronize()
        assert launched(before) == {"trace_tiles_k1e": 1}
        ref = traverse.trace_tiles_reference(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=k,
                                             jitter=jitter, jitter_seed=seed)
        dirs = (generate_rays_jittered(w, h, CAM_POS, CAM_QUAT, seed, FOV, device="cpu")[1]
                .reshape(-1, 3) if jitter else image_dirs(w, h))
        ref = [p.cpu() for p in ref]
        assert_trace_parity([p.cpu() for p in ours], ref[0], ref[4],
                            torch.stack(ref[1:4], -1).numpy(), tris, dirs)
    before = dict(traverse.LAUNCHES)
    batch = traverse.trace_tiles_batch(qn, BATCH_POS, BATCH_QUAT, w, h, FOV, leaf_k=k,
                                       jitter=True, jitter_seeds=BATCH_SEEDS)
    torch.cuda.synchronize()
    assert launched(before) == {"trace_tiles_k1e": 1}
    for f in range(len(BATCH_POS)):
        single = traverse.trace_tiles(qn, BATCH_POS[f], BATCH_QUAT[f], w, h, FOV, leaf_k=k,
                                      jitter=True, jitter_seed=BATCH_SEEDS[f])
        assert all(torch.equal(b[f], s) for b, s in zip(batch, single))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 32])
def test_wide8_ray_kernel_matches_reference_on_card(cuda_device, k):
    """K2c (8-wide records) vs its plain version on the card: closest hit by
    the traversal rule, the any-hit occlusion mask, and an active mask over
    NaN rays; every launch counts as K2c."""
    tris, qn, o, d = room(cuda_device, k, width=8)
    sun = torch.from_numpy(SUN).to(cuda_device).expand_as(o).contiguous()
    active = torch.from_numpy(np.random.default_rng(2).random(o.shape[0]) < 0.7).to(cuda_device)
    o_nan = torch.where(active[:, None], o, torch.full_like(o, float("nan")))
    before = dict(traverse.LAUNCHES)
    closest = traverse.trace_rays(qn, o, d, leaf_k=k)
    masked = traverse.trace_rays(qn, o_nan, d, leaf_k=k, active=active)
    occluded = traverse.trace_rays(qn, o, sun, any_hit=True, leaf_k=k)
    torch.cuda.synchronize()
    assert launched(before) == {"trace_rays_k2c": 3}
    ref = [p.cpu() for p in traverse.trace_rays_reference(qn, o, d, leaf_k=k)]
    closest = [p.cpu() for p in closest]
    assert_trace_parity(closest, ref[0], ref[4], torch.stack(ref[1:4], -1).numpy(), tris,
                        d.cpu(), o.cpu().numpy())
    act = active.cpu()
    for m, f in zip(masked, closest):
        assert torch.equal(m.cpu()[act], f[act])
    assert (masked[4].cpu()[~act] == -1).all() and (masked[0].cpu()[~act] == 1e30).all()
    ref_b = traverse.trace_rays_reference(qn, o, sun, any_hit=True, leaf_k=k)
    occ = (occluded[4] >= 0).cpu()
    assert torch.equal(occ, (ref_b[4] >= 0).cpu())
    assert 0.05 < float(occ.float().mean()) < 0.95
    assert (occluded[0].cpu()[occ] == 0).all() and (occluded[0].cpu()[~occ] == 1e30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
def test_visits_kernel_matches_reference_on_card(cuda_device, width):
    """K1f at either width: the visits plane equal to the plain version's on
    every ray whose triangle agrees, its sum equal to the counted visits
    there, the five other planes bit-equal to the kernel's without stats,
    for one frame and for a jittered batch; each counts as one K1f launch."""
    tris = seeded_scene(4)
    w, h, k = 160, 96, 32
    cs, height = build_sah2_clustered(tris, k, cuda_device)
    qn = records_pipeline(cs, height=height, width=width)
    plain_kernel = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=k)
    before = dict(traverse.LAUNCHES)
    out = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=k, stats=True)
    torch.cuda.synchronize()
    assert launched(before) == {"trace_tiles_k1f": 1}
    assert len(out) == 6 and out[5].dtype == torch.float32
    assert all(torch.equal(a, b) for a, b in zip(out[:5], plain_kernel))
    counts = traverse.TraversalCounts()
    ref = traverse.trace_tiles_reference(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=k,
                                         counts=counts, stats=True)
    same = out[4] == ref[4]
    assert float(same.float().mean()) >= 0.999
    assert torch.equal(out[5][same], ref[5][same])
    if bool(same.all()):
        assert int(out[5].sum()) == counts.visits
    before = dict(traverse.LAUNCHES)
    batch = traverse.trace_tiles_batch(qn, BATCH_POS, BATCH_QUAT, w, h, FOV, leaf_k=k,
                                       jitter=True, jitter_seeds=BATCH_SEEDS, stats=True)
    torch.cuda.synchronize()
    assert launched(before) == {"trace_tiles_k1f": 1}
    single = traverse.trace_tiles(qn, BATCH_POS[2], BATCH_QUAT[2], w, h, FOV, leaf_k=k,
                                  jitter=True, jitter_seed=BATCH_SEEDS[2], stats=True)
    assert all(torch.equal(b[2], s) for b, s in zip(batch, single))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("jitter", [False, True])
def test_bounded_kernel_matches_reference_on_card(cuda_device, width, jitter):
    """K1d against its plain version on the card, under seeded bounds (tiles
    without a bound, generous ones, underestimates) and the tree's entries, at
    a size 32 does not divide: the traversal rule on the rays both hit, t =
    the tile's bound and a zero normal where neither does; one K1d launch and
    no other; all-1e30 bounds and root entries give K1a's (K1b's) planes."""
    tris = seeded_scene(4)
    w, h, k, seed = 200, 150, 8, 77
    pos = CAM_POS
    cs, height = build_sah2_clustered(tris, k, cuda_device)
    qn = records_pipeline(cs, height=height, width=width)
    kw = dict(leaf_k=k, jitter=jitter, jitter_seed=seed)
    free = traverse.trace_tiles(qn, pos, CAM_QUAT, w, h, FOV, **kw)
    bounds, kinds = tile_bounds(free[0].cpu().numpy(), free[4].cpu().numpy())
    assert set(kinds.reshape(-1).tolist()) == {0, 1, 2}
    entries = compute_tile_entries(wide_pipeline(cs, height=height, width=width), pos, CAM_QUAT,
                                   w, h, fov_degrees=FOV)
    assert entries.device.type == "cuda" and int((entries != 0).sum()) > 0
    tb = torch.from_numpy(bounds).to(cuda_device)
    before = dict(traverse.LAUNCHES)
    ours = traverse.trace_tiles(qn, pos, CAM_QUAT, w, h, FOV, **kw, entries=entries, tbounds=tb)
    torch.cuda.synchronize()
    assert launched(before) == {"trace_tiles_k1d": 1}
    ref = traverse.trace_tiles_reference(qn, pos, CAM_QUAT, w, h, FOV, **kw, entries=entries,
                                         tbounds=tb)
    ours, ref = [p.cpu() for p in ours], [p.cpu() for p in ref]
    assert torch.equal(ours[4] >= 0, ref[4] >= 0)
    miss = ours[4] < 0
    bpix = torch.from_numpy(np.repeat(np.repeat(bounds, 32, 0), 32, 1)[:h, :w])
    assert torch.equal(ours[0][miss], bpix[miss]) and torch.equal(ref[0][miss], bpix[miss])
    cut = int(((free[4].cpu() >= 0) & miss).sum())
    assert cut > 0, "setup: an underestimate must cut some hits"
    # the rule on the hits; on the others t is the bound, checked above
    for planes in (ours, ref):
        planes[0] = torch.where(miss, torch.full_like(planes[0], 1e30), planes[0])
    if jitter:
        dirs = generate_rays_jittered(w, h, pos, CAM_QUAT, seed, FOV, device="cpu")[1]
    else:
        dirs = image_dirs(w, h)
    assert_trace_parity(ours, ref[0], ref[4], torch.stack(ref[1:4], -1).numpy(), tris,
                        dirs.reshape(-1, 3), origins=pos)
    same = traverse.trace_tiles(qn, pos, CAM_QUAT, w, h, FOV, **kw,
                                entries=torch.zeros_like(entries),
                                tbounds=torch.full_like(tb, 1e30))
    assert all(torch.equal(a, b) for a, b in zip(same, free))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
def test_bounded_and_temporal_traces_equal_the_kernel_on_card(cuda_device, width):
    """trace_tiles_bounded (default and halved bounds, with entries) and
    trace_tiles_temporal over successive seeds on the card: all five planes
    bit-equal to the unbounded kernel's, which holds only if the repair's rays
    are the kernel's rays bit for bit; launches 1 probe + 1 K1d + 1 repair;
    no host-device synchronisation."""
    tris = seeded_scene(4)
    w, h, k = 320, 200, 8
    near = (0.0, 0.0, 1.3)
    cs, height = build_sah2_clustered(tris, k, cuda_device)
    qn = records_pipeline(cs, height=height, width=width)
    entries = compute_tile_entries(wide_pipeline(cs, height=height, width=width), near,
                                   CAM_QUAT, w, h, fov_degrees=FOV)
    probe, repair = (("trace_tiles_k1e", "trace_rays_k2c") if width == 8
                     else ("trace_tiles_k1a", "trace_rays_k2a"))
    free = traverse.trace_tiles(qn, near, CAM_QUAT, w, h, FOV, leaf_k=k)
    for knobs in ({}, dict(_bound_scale=0.5, _bound_pad=0.0)):
        before = dict(traverse.LAUNCHES)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = render.trace_tiles_bounded(qn, near, CAM_QUAT, w, h, FOV, leaf_k=k,
                                             entries=entries, **knobs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert launched(before) == {probe: 1, "trace_tiles_k1d": 1, repair: 1}
        assert all(torch.equal(a, b) for a, b in zip(out[:5], free))
        assert int(out[5]) > 0 or not knobs, "halved bounds must force repairs"
    prev = traverse.trace_tiles(qn, near, CAM_QUAT, w, h, FOV, leaf_k=k, jitter=True,
                                jitter_seed=1)
    for seed in (2, 3, 4):
        want = traverse.trace_tiles(qn, near, CAM_QUAT, w, h, FOV, leaf_k=k, jitter=True,
                                    jitter_seed=seed)
        before = dict(traverse.LAUNCHES)
        out = render.trace_tiles_temporal(qn, near, CAM_QUAT, w, h, prev[0], prev[4], seed, FOV,
                                          leaf_k=k)
        torch.cuda.synchronize()
        assert launched(before) == {"trace_tiles_k1d": 1, repair: 1}
        assert all(torch.equal(a, b) for a, b in zip(out[:5], want)), f"seed {seed}"
        prev = out


def refit_chain_records(tris: np.ndarray, device, k: int = 8) -> list[torch.Tensor]:
    """Build on ``device``, then per deformation: refit → collapse plan
    gather → wide nodes → records, on ``device``."""
    cs, height = build_sah2_clustered(tris, k, device)
    cs = cs._replace(bvh2=LBVH2(*(a.to(device) for a in cs.bvh2)))
    plan = collapse_plan(cs.bvh2, sweeps=height + 2)
    base = torch.from_numpy(tris).to(device)
    out = []
    for phase in (0.4, 1.9):
        r = refit_lbvh2_clustered(cs, base * (1.0 + 0.1 * np.sin(phase)), num_sweeps=height + 2)
        bvh4 = collapse_apply_refit(plan, r.bvh2.bounds_u32)
        out.append(traverse.make_qnodes(make_wide_bvh(bvh4), r.tris_sorted, tri_ids=r.tri_order,
                                        leaf_size=k))
    return out


@pytest.mark.cuda
def test_refit_chain_on_card_equals_cpu(cuda_device):
    """The refit chain's records on the card byte-equal the same chain's on
    the CPU."""
    tris = room_scene()
    for card, cpu in zip(refit_chain_records(tris, cuda_device), refit_chain_records(tris, "cpu")):
        assert torch.equal(card.cpu().view(torch.int32), cpu.view(torch.int32))


def test_refit_chain_runs_on_cpu():
    """The chain the card test runs, on the CPU: the refitted records equal
    the records pipeline's (the full device collapse) of the refitted
    scene."""
    tris = room_scene()
    qn = refit_chain_records(tris, "cpu")[1]
    cs, height = build_sah2_clustered(tris, 8, "cpu")
    r = refit_lbvh2_clustered(cs, torch.from_numpy(tris) * (1.0 + 0.1 * np.sin(1.9)),
                              num_sweeps=height + 2)
    assert torch.equal(qn.view(torch.int32), records_pipeline(r).view(torch.int32))


def lbvh_records(tris: np.ndarray, device) -> torch.Tensor:
    """K = 1 records of the Morton LBVH of ``tris`` on ``device``, as
    PathTracer(builder="lbvh", leaf_size=1) makes them."""
    t = torch.from_numpy(tris).to(device)
    wide = make_wide_bvh(collapse_lbvh2_to_bvh4(build_lbvh2(t)))
    return traverse.make_qnodes(wide, t)


@pytest.mark.cuda
def test_lbvh_chain_on_card_equals_cpu(cuda_device):
    """Morton LBVH (K = 1 and Morton clusters of 8), the device 4-wide
    collapse and the K = 1 records: the card's words equal the CPU's."""
    tris = seeded_scene(4)
    t_card, t_cpu = torch.from_numpy(tris).to(cuda_device), torch.from_numpy(tris)
    for a, b in zip(build_lbvh2(t_card), build_lbvh2(t_cpu)):
        assert torch.equal(a.cpu(), b)
    cs_card, cs_cpu = build_lbvh2_clustered(t_card, 8), build_lbvh2_clustered(t_cpu, 8)
    for a, b in zip(cs_card.bvh2, cs_cpu.bvh2):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(cs_card.tri_order.cpu(), cs_cpu.tri_order)
    for a, b in zip(collapse_lbvh2_to_bvh4(cs_card.bvh2)[:3], collapse_lbvh2_to_bvh4(cs_cpu.bvh2)[:3]):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(lbvh_records(tris, cuda_device).cpu().view(torch.int32),
                       lbvh_records(tris, "cpu").view(torch.int32))


@pytest.mark.cuda
def test_leaf_k1_kernels_match_reference_on_card(cuda_device):
    """K1a and K2a / K2b on the K = 1 records of the Morton LBVH against
    their plain versions on the card."""
    tris = seeded_scene(4)
    w, h = 192, 128
    qn = lbvh_records(tris, cuda_device)
    before = dict(traverse.LAUNCHES)
    ours = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=1)
    torch.cuda.synchronize()
    assert traverse.LAUNCHES["trace_tiles_k1a"] == before["trace_tiles_k1a"] + 1
    ref = traverse.trace_tiles_reference(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=1)
    ours, ref = [p.cpu() for p in ours], [p.cpu() for p in ref]
    assert_trace_parity(ours, ref[0], ref[4], torch.stack(ref[1:4], -1).numpy(),
                        tris, image_dirs(w, h))
    o, d = ray_buffer(qn, 1, 2048)
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    k2a = [p.cpu() for p in traverse.trace_rays(qn, o, d, leaf_k=1)]
    ref = [p.cpu() for p in traverse.trace_rays_reference(qn, o, d, leaf_k=1)]
    assert_trace_parity(k2a, ref[0], ref[4], torch.stack(ref[1:4], -1).numpy(), tris,
                        d.cpu(), o.cpu().numpy())
    k2b = traverse.trace_rays(qn, o, d, any_hit=True, leaf_k=1)
    ref_b = traverse.trace_rays_reference(qn, o, d, any_hit=True, leaf_k=1)
    assert torch.equal((k2b[4] >= 0).cpu(), (ref_b[4] >= 0).cpu())


@pytest.mark.cuda
def test_microbench_kernels_match_plain_on_card(cuda_device):
    """MB1–MB4 at small n against their plain versions, exactly; each launch
    counts once."""
    mb = microbench
    before = dict(mb.LAUNCHES)
    n = 300
    variants = 0
    for v in mb.sweep(cuda_device, levels=("L1",)):
        v.prepare()
        assert v.run(n) == v.plain(n), (v.kernel, v.label)
        assert int(v.launch(n)[-1][0]) > 0, (v.kernel, v.label)
        variants += 1
    assert variants == len(mb.WALK_VARIANTS) + len(mb.SCALAR_VARIANTS) + 4 * len(mb.VISIT_PARTS)
    cap = mb.smem_capacity(torch.arange(64 * 1024, dtype=torch.float32, device=cuda_device))
    assert cap["checked"] and 48 * 1024 < cap["max_bytes"] <= 256 * 1024
    assert mb.mb_smem_probe(torch.zeros(300 * 256, device=cuda_device), 300 * 1024) is None
    launched = {k: mb.LAUNCHES[k] - before[k] for k in before}
    assert launched == {"mb_walk": 2 * len(mb.WALK_VARIANTS),
                        "mb_scalar": 2 * len(mb.SCALAR_VARIANTS),
                        "mb_visit": 2 * 4 * len(mb.VISIT_PARTS),
                        "mb_smem_probe": (cap["max_bytes"] - 48 * 1024) // 1024 + 1}


def records_of(tris: np.ndarray, k: int, width: int, device) -> torch.Tensor:
    """Records of ``width`` child slots: the Morton LBVH of single triangles
    at K = 1 (the records of lbvh_records, at either width), SAH clusters of K
    otherwise."""
    if k == 1:
        t = torch.from_numpy(tris).to(device)
        collapse = collapse_lbvh2_to_bvh4 if width == 4 else collapse_lbvh2_to_bvh8
        return traverse.make_qnodes(make_wide_bvh(collapse(build_lbvh2(t))), t)
    cs, height = build_sah2_clustered(tris, k, device)
    return records_pipeline(cs, height=height, width=width)


def words_equal(a, b) -> bool:
    """Every plane of two kernel results equal word for word."""
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


def ray_cases(o: torch.Tensor, d: torch.Tensor, seed: int):
    """(origins, dirs, active) of R = 1, 31, 33, 100,003 and 0 rays, with the
    active mask all (None), none and 30% (inactive rays hold NaN)."""
    rng = np.random.default_rng(seed)
    for r in (1, 31, 33, 100_003, 0):
        idx = torch.from_numpy(rng.integers(0, o.shape[0], size=r)).to(o.device)
        ro, rd = o[idx].contiguous(), d[idx].contiguous()
        for share in (None, 0.0, 0.3):
            if share is None:
                yield ro, rd, None
                continue
            act = torch.from_numpy(rng.random(r) < share).to(o.device)
            nan = torch.full_like(ro, float("nan"))
            yield torch.where(act[:, None], ro, nan).contiguous(), rd, act


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("k", [1, 8, 32])
def test_hopper_rays_equal_baseline_and_plain_on_card(cuda_device, k, width):
    """K2a / K2b / K2c with the core the launch plan runs, one thread per
    ray and as persistent warps with dynamic fetch (``scattered``), write
    the plain version's words (run on the card) on every ray (closest and
    any hit: the any-hit order is kept, so all planes agree), for every R
    and active share; each launch counts once, under its kernel."""
    tris = room_scene()
    qn = records_of(tris, k, width, cuda_device)
    o, d = ray_buffer(qn, k, 4096)
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    sun = torch.from_numpy(SUN).to(cuda_device).expand_as(d).contiguous()
    for any_hit, dirs in ((False, d), (True, sun)):
        for ro, rd, act in ray_cases(o, dirs, k + width):
            kw = dict(any_hit=any_hit, leaf_k=k, active=act)
            plain = traverse.trace_rays_reference(qn, ro, rd, **kw)
            before = dict(traverse.LAUNCHES)
            ours = traverse.trace_rays(qn, ro, rd, **kw)
            persistent = traverse.trace_rays(qn, ro, rd, scattered=True, **kw)
            torch.cuda.synchronize()
            name = "trace_rays_k2c" if width == 8 else (
                "trace_rays_k2b" if any_hit else "trace_rays_k2a")
            assert launched(before) == {name: 2}
            assert words_equal(ours, plain), (any_hit, ro.shape[0])
            assert words_equal(persistent, plain), (any_hit, ro.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("k", [1, 8, 32])
def test_hopper_tiles_equal_baseline_on_card(cuda_device, k, width):
    """K1a, K1b, K1c, K1d, K1e and K1f with the core the tile plan runs
    write the plain version's words (run on the card) on every pixel."""
    tris = seeded_scene(4)
    qn = records_of(tris, k, width, cuda_device)
    calls = tile_variants(qn, k)
    del calls["k1c_raw"]
    assert_tiles_match_plain(calls)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
def test_hopper_drops_like_baseline_and_plain_on_card(cuda_device, width):
    """Synthetic records whose stacks pass 64 entries: the kernels at
    K = 1, one thread per ray and persistent, drop the same pushes as the
    plain version (the same words, closest and any hit)."""
    qn, o, d = deep_records(width)
    qn = qn.to(cuda_device)
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    counts = traverse.TraversalCounts()
    traverse.trace_rays_reference(qn, o, d, leaf_k=1, counts=counts)
    assert counts.dropped > 0 and counts.max_depth == 64
    for any_hit in (False, True):
        kw = dict(any_hit=any_hit, leaf_k=1)
        plain = traverse.trace_rays_reference(qn, o, d, **kw)
        assert words_equal(traverse.trace_rays(qn, o, d, **kw), plain)
        assert words_equal(traverse.trace_rays(qn, o, d, scattered=True, **kw), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("k", [1, 8, 32])
def test_unordered_rays_match_plain_on_card(cuda_device, k, width):
    """K2a / K2b / K2c with ``ordered=False`` (one thread per ray and the
    persistent warps) write the plain version's words (ordered=False there
    too, run on the card) on every ray; their closest-hit planes are the ordered
    kernel's and their occlusion masks its masks; each launch counts once,
    under its ``_unordered`` name. On records whose stacks pass 64 entries
    in slot order, the same pushes are dropped as by the plain version."""
    tris = room_scene()
    qn = records_of(tris, k, width, cuda_device)
    o, d = ray_buffer(qn, k, 4096)
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    sun = torch.from_numpy(SUN).to(cuda_device).expand_as(d).contiguous()
    for any_hit, dirs in ((False, d), (True, sun)):
        for ro, rd, act in ray_cases(o, dirs, k + width):
            kw = dict(any_hit=any_hit, leaf_k=k, active=act)
            before = dict(traverse.LAUNCHES)
            ours = traverse.trace_rays(qn, ro, rd, ordered=False, **kw)
            persistent = traverse.trace_rays(qn, ro, rd, ordered=False, scattered=True, **kw)
            plain = traverse.trace_rays_reference(qn, ro, rd, ordered=False, **kw)
            ordered = traverse.trace_rays(qn, ro, rd, **kw)
            torch.cuda.synchronize()
            name = ("trace_rays_k2c" if width == 8 else
                    "trace_rays_k2b" if any_hit else "trace_rays_k2a")
            assert launched(before) == {name + "_unordered": 2, name: 1}
            assert words_equal(ours, plain) and words_equal(persistent, plain), (any_hit, k)
            if any_hit:
                assert torch.equal(ours[4] >= 0, ordered[4] >= 0)
            else:
                assert words_equal(ours, ordered)
    qn, o, d = deep_records(width, chain_slot=width - 1)
    qn = qn.to(cuda_device)
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    counts = traverse.TraversalCounts()
    for any_hit in (False, True):
        plain = traverse.trace_rays_reference(qn, o, d, any_hit=any_hit, leaf_k=1,
                                              ordered=False, counts=counts)
        assert words_equal(traverse.trace_rays(qn, o, d, any_hit=any_hit, leaf_k=1,
                                               ordered=False), plain), any_hit
    assert counts.dropped > 0


def edge_rays(tris: np.ndarray, n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(origins, dirs) (n, 3) f32 of rays that graze the scene's edges: from
    seeded points on a sphere of radius 3 toward the midpoints of seeded
    triangles' edges, which the neighbouring triangle shares (their t tie,
    or nearly)."""
    rng = np.random.default_rng(seed)
    pick, e = rng.integers(0, tris.shape[0], size=n), rng.integers(0, 3, size=n)
    target = (tris[pick, e] + tris[pick, (e + 1) % 3]) * np.float32(0.5)
    o = rng.normal(size=(n, 3))
    o = (o / np.linalg.norm(o, axis=1, keepdims=True) * 3.0).astype(np.float32)
    d = target - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("k", [2, 8, 32, 33, 64])
def test_any_hit_core_equals_baseline_and_plain_on_card(cuda_device, k, width):
    """Any hit over leaves of K > 1 with the leaf tests spread over the warp
    (``traverse.ANY_HIT_CORE``, what the launch plan runs there), one thread
    per ray and as persistent warps, in both orders, writes the plain
    version's words (run on the card, the same order) on every ray: for
    every R and active share, on rays toward the sun and on rays that graze
    shared edges, at K up to 64 (slots served in runs of 32). Each call
    launches once, counted under the kernel's name."""
    tris = room_scene()
    qn = records_of(tris, k, width, cuda_device)
    o, d = ray_buffer(qn, k, 4096)
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    sun = torch.from_numpy(SUN).to(cuda_device).expand_as(d).contiguous()
    eo, ed = (torch.from_numpy(a).to(cuda_device) for a in edge_rays(tris, 4096, k + width))
    name = "trace_rays_k2c" if width == 8 else "trace_rays_k2b"
    for origins, dirs in ((o, sun), (eo, ed)):
        for ro, rd, act in ray_cases(origins, dirs, k + width):
            for ordered in (True, False):
                kw = dict(any_hit=True, leaf_k=k, active=act, ordered=ordered)
                plain = traverse.trace_rays_reference(qn, ro, rd, **kw)
                for scattered in (False, True):
                    before = dict(traverse.LAUNCHES)
                    ours = traverse.trace_rays(qn, ro, rd, scattered=scattered, **kw)
                    torch.cuda.synchronize()
                    assert launched(before) == {name + ("" if ordered else "_unordered"): 1}
                    assert words_equal(ours, plain), (ordered, scattered, ro.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
def test_any_hit_core_drops_like_baseline_on_card(cuda_device, width):
    """On records whose stacks pass 64 entries (``deep_records`` laid out
    for K = 2, one triangle a leaf, so that the launch plan runs the warp's
    leaf tests; the chain child in a seeded slot, and in the last slot,
    where the stacks of slot order overflow too), any hit with the leaf
    tests spread over the warp, both orders and schedules, drops the plain
    version's pushes: the same words."""
    for chain_slot, ordered in ((None, True), (width - 1, True), (width - 1, False)):
        qn, o, d = deep_records(width, chain_slot=chain_slot, leaf_k=2)
        qn = qn.to(cuda_device)
        o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
        kw = dict(any_hit=True, leaf_k=2, ordered=ordered)
        assert traverse.launch_plan(**kw)[0] & ~traverse._UNORDERED == traverse.ANY_HIT_CORE
        counts = traverse.TraversalCounts()
        plain = traverse.trace_rays_reference(qn, o, d, counts=counts, **kw)
        assert counts.dropped > 0
        for scattered in (False, True):
            assert words_equal(traverse.trace_rays(qn, o, d, scattered=scattered, **kw),
                               plain), (chain_slot, ordered, scattered)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("k", [8, 32])
def test_any_hit_core_tree_spaces_equal_hbm_on_card(cuda_device, k, width):
    """Any hit with the leaf tests spread over the warp writes the words of
    "hbm" with the records pinned in L2 ("vmem") and in each block's shared
    memory ("smem", 512 threads a block; the records of the room's walls
    and part of its ball fit at both widths), in both orders and schedules,
    with and without an active mask."""
    tris = room_scene()[:120]
    qn = records_of(tris, k, width, cuda_device)
    assert qn.numel() * 4 <= traverse.tree_space_limits(cuda_device)["smem_optin"]
    o, d = ray_buffer(qn, k, 4096)
    o = torch.from_numpy(o).to(cuda_device)
    sun = torch.from_numpy(SUN).to(cuda_device).expand_as(o).contiguous()
    for ro, rd, act in list(ray_cases(o, sun, k + width))[6:12]:
        for ordered in (True, False):
            for scattered in (False, True):
                kw = dict(any_hit=True, leaf_k=k, active=act, ordered=ordered,
                          scattered=scattered)
                ref = traverse.trace_rays(qn, ro, rd, **kw)
                assert words_equal(traverse.trace_rays(qn, ro, rd, tree_space="vmem", **kw), ref)
                assert words_equal(traverse.trace_rays(qn, ro, rd, tree_space="smem", **kw), ref)


def dup_scene() -> np.ndarray:
    """The room with every fifth triangle twice: exact copies, accepted at
    the same t, in the same leaf or in another one (the first in visit
    order must win)."""
    tris = room_scene()
    return np.concatenate([tris, tris[::5]])


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("k", [2, 8, 32, 33, 64])
def test_closest_hit_core_equals_render_core_and_baseline_on_card(cuda_device, k, width):
    """Closest hit over leaves of K > 1 with the leaf tests spread over the
    warp (``traverse.CLOSEST_HIT_CORE``, what the launch plan runs there:
    every run of 32 served, the least t and its lowest lane), one thread per
    ray and as persistent warps, in both orders, writes the plain version's
    words (run on the card) on every ray: for every R and active share, on
    bounce-like rays, on rays that graze shared edges, on a scene of
    duplicate triangles at equal t, at K up to 64 (slots served in runs of
    32). Each call launches once, counted under the kernel's name."""
    name = "trace_rays_k2c" if width == 8 else "trace_rays_k2a"
    for tris, edges in ((room_scene(), True), (dup_scene(), False)):
        qn = records_of(tris, k, width, cuda_device)
        o, d = ray_buffer(qn, k, 4096)
        rays = [(torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device))]
        if edges:
            rays.append(tuple(torch.from_numpy(a).to(cuda_device)
                              for a in edge_rays(tris, 4096, k + width)))
        for origins, dirs in rays:
            for ro, rd, act in ray_cases(origins, dirs, k + width):
                for ordered in (True, False):
                    kw = dict(leaf_k=k, active=act, ordered=ordered)
                    plain = traverse.trace_rays_reference(qn, ro, rd, **kw)
                    for scattered in (False, True):
                        before = dict(traverse.LAUNCHES)
                        ours = traverse.trace_rays(qn, ro, rd, scattered=scattered, **kw)
                        torch.cuda.synchronize()
                        assert launched(before) == {name + ("" if ordered else "_unordered"): 1}
                        assert words_equal(ours, plain), (ordered, scattered, ro.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
def test_closest_hit_core_drops_like_baseline_on_card(cuda_device, width):
    """On records whose stacks pass 64 entries (``deep_records`` laid out
    for K = 2, one triangle a leaf, so that the launch plan runs the warp's
    leaf tests; the chain child in a seeded slot and in the last slot),
    closest hit with the warp's leaf tests, both orders and schedules, drops
    the plain version's pushes: the same words."""
    for chain_slot, ordered in ((None, True), (width - 1, True), (width - 1, False)):
        qn, o, d = deep_records(width, chain_slot=chain_slot, leaf_k=2)
        qn = qn.to(cuda_device)
        o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
        kw = dict(leaf_k=2, ordered=ordered)
        assert (traverse.launch_plan(any_hit=False, **kw)[0] & ~traverse._UNORDERED
                == traverse.CLOSEST_HIT_CORE)
        counts = traverse.TraversalCounts()
        plain = traverse.trace_rays_reference(qn, o, d, counts=counts, **kw)
        assert counts.dropped > 0
        for scattered in (False, True):
            assert words_equal(traverse.trace_rays(qn, o, d, scattered=scattered, **kw),
                               plain), (chain_slot, ordered, scattered)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("k", [8, 32])
def test_closest_hit_core_tree_spaces_equal_hbm_on_card(cuda_device, k, width):
    """Closest hit with the warp's leaf tests writes the plain version's
    words in device memory ("hbm"), with the records pinned in L2 ("vmem")
    and in each block's shared memory ("smem", 512 threads a block), in
    both orders and schedules, with and without an active mask."""
    tris = room_scene()[:120]
    qn = records_of(tris, k, width, cuda_device)
    assert qn.numel() * 4 <= traverse.tree_space_limits(cuda_device)["smem_optin"]
    o, d = (torch.from_numpy(a).to(cuda_device) for a in ray_buffer(qn, k, 4096))
    for ro, rd, act in list(ray_cases(o, d, k + width))[6:12]:
        for ordered in (True, False):
            ref = traverse.trace_rays_reference(qn, ro, rd, leaf_k=k, active=act,
                                                ordered=ordered)
            for scattered in (False, True):
                kw = dict(leaf_k=k, active=act, ordered=ordered, scattered=scattered)
                for space in traverse.TREE_SPACES:
                    assert words_equal(traverse.trace_rays(qn, ro, rd, tree_space=space, **kw),
                                       ref), (space, ordered, scattered)








@pytest.mark.cuda
def test_ray_counter_resets_per_launch_on_card(cuda_device):
    """Persistent K2 launches back to back on one stream, and on two streams
    at once, each with its own counter: every result equals its ray
    buffer's plain version (run on the card)."""
    tris = room_scene()
    qn = records_of(tris, 8, 4, cuda_device)
    o, d = (torch.from_numpy(a).to(cuda_device) for a in ray_buffer(qn, 8, 8192))
    halves = [(o[:5000].contiguous(), d[:5000].contiguous()),
              (o[3000:].contiguous(), d[3000:].contiguous())]
    base = [traverse.trace_rays_reference(qn, a, b, leaf_k=8) for a, b in halves]
    one = [traverse.trace_rays(qn, a, b, leaf_k=8, scattered=True) for a, b in halves]
    streams = [torch.cuda.Stream(cuda_device) for _ in halves]
    torch.cuda.synchronize()
    two = []
    for (a, b), s in zip(halves, streams):
        with torch.cuda.stream(s):
            two.append(traverse.trace_rays(qn, a, b, leaf_k=8, scattered=True))
    torch.cuda.synchronize()
    for x, y, z in zip(base, one, two):
        assert words_equal(y, x) and words_equal(z, x)


def tile_records(tris: np.ndarray, k: int, width: int, builder: str, device) -> torch.Tensor:
    """Records of ``width`` slots over leaves of K: SAH clusters, or the
    Morton runs of K (the JAX package's default build at K = 8)."""
    if builder == "sah":
        return records_of(tris, k, width, device)
    cs = build_lbvh2_clustered(torch.from_numpy(tris).to(device), k)
    return records_pipeline(cs, width=width)


def tile_variants(qn: torch.Tensor, k: int, w: int = 150, h: int = 98, **window) -> dict:
    """Every K1 variant → (its call, its plain version's call on the
    records' device): K1a, K1b, K1d (bounds and entries), K1f (visits), K1c
    (a jittered batch) and K1c raw (whole frames of 96x64); on 8-wide
    records the first five are K1e's forms."""
    dev = qn.device
    bounds = torch.full((-(-h // 32), -(-w // 32)), 2.6, device=dev)
    entries = torch.zeros_like(bounds, dtype=torch.int32)
    rg_w, rg_h = window.get("raygen_size", (w, h))
    r0, c0 = window.get("row_offset", 0), window.get("col_offset", 0)
    pixels = traverse._window_pixels(w, h, rg_w, r0, c0).to(dev)

    def tiles(**kw):
        return (lambda: traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=k,
                                             **window, **kw),
                lambda: [p.reshape(h, w) for p in traverse.trace_tiles_reference(
                    qn, CAM_POS, CAM_QUAT, rg_w, rg_h, FOV, leaf_k=k, pixels=pixels,
                    tile_origin=(r0, c0), **kw)])

    batch = dict(jitter=True, jitter_seeds=BATCH_SEEDS)
    return {
        "k1a": tiles(), "k1b": tiles(jitter=True, jitter_seed=77),
        "k1d": tiles(entries=entries, tbounds=bounds), "k1f": tiles(stats=True),
        "k1c": (lambda: traverse.trace_tiles_batch(qn, BATCH_POS, BATCH_QUAT, w, h, FOV,
                                                   leaf_k=k, **batch, **window),
                lambda: [p.reshape(-1, h, w) for p in traverse.trace_tiles_batch_reference(
                    qn, BATCH_POS, BATCH_QUAT, rg_w, rg_h, FOV, k, pixels=pixels, **batch)]),
        "k1c_raw": (lambda: traverse.trace_tiles_batch(qn, BATCH_POS, BATCH_QUAT, 96, 64, FOV,
                                                       leaf_k=k, raw=True),
                    lambda: [traverse.tiles_layout(traverse.trace_tiles_batch_reference(
                        qn, BATCH_POS, BATCH_QUAT, 96, 64, FOV, k))]),
    }


def assert_tiles_match_plain(calls: dict) -> None:
    """Each call (tile_variants) writes its plain version's words and
    launches once, counted under the variant's name."""
    for name, (call, plain) in calls.items():
        want = plain()
        before = dict(traverse.LAUNCHES)
        out = call()
        torch.cuda.synchronize()
        assert len(launched(before)) == 1 and sum(launched(before).values()) == 1, name
        assert words_equal(out if isinstance(out, tuple) else [out], want), name


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("k,builder", [(32, "sah"), (8, "lbvh"), (2, "sah"), (64, "sah")])
def test_tile_core_equals_render_core_and_baseline_on_card(cuda_device, k, builder, width):
    """K1 over leaves of K > 1 with the per-step choice of leaf stage
    (``traverse.TILE_CORE``, what the tile plan runs there: the warp's
    tests where c·w < m, each lane's loop otherwise) writes the plain
    version's words (run on the card) in every K1 variant (K1a, K1b, K1c and
    its raw layout, K1d, K1e at 8 slots, K1f), on SAH clusters of K = 2, 32,
    64 and Morton runs of K = 8 (packed runs below K = 32), on a scene and
    on the same scene with every fifth triangle twice (duplicates at equal
    t)."""
    scene = seeded_scene(4)
    for tris in (scene, np.concatenate([scene, scene[::5]])):
        qn = tile_records(tris, k, width, builder, cuda_device)
        assert_tiles_match_plain(tile_variants(qn, k))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
def test_tile_core_window_off_the_block_grid_on_card(cuda_device, width):
    """A 1,000 x 600 window at (37, 53) of a 1920 x 1080 frame: its sides
    and offsets are no multiples of 8, so warps of the tile kernels hold
    lanes outside the window, which help the warp test leaves and store
    nothing. Every variant under TILE_CORE writes the plain version's
    words, the one-frame window the same pixels as the whole frame."""
    tris = seeded_scene(4)
    qn = tile_records(tris, 32, width, "sah", cuda_device)
    window = dict(raygen_size=(1920, 1080), row_offset=37, col_offset=53)
    calls = tile_variants(qn, 32, 1000, 600, **window)
    del calls["k1c_raw"]  # whole frames only
    assert_tiles_match_plain(calls)
    full = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, 1920, 1080, FOV, leaf_k=32)
    part = calls["k1a"][0]()
    assert all(torch.equal(a, b[37:637, 53:1053]) for a, b in zip(part, full))


@pytest.mark.cuda
def test_tile_core_on_the_cornell_box_on_card(cuda_device):
    """The Cornell box at SAH K = 32 (a tree of 3 records, where every lane
    of a warp posts the same leaf): TILE_CORE writes the plain version's
    words at 1920 x 1080 and in a jittered batch."""
    scene = Scene().set_triangles(procgen.make_cornell_box())
    scene._normalize_enabled, scene._normalize_mode = True, "cube"
    scene.normalize_mesh()
    qn = records_of(scene.triangles, 32, 4, cuda_device)
    cam, quat = (0.0, 0.0, 2.2), (0, 0, 0, 1.0)
    batch = dict(jitter=True, jitter_seeds=BATCH_SEEDS)
    calls = {
        "k1a": (lambda: traverse.trace_tiles(qn, cam, quat, 1920, 1080, FOV, leaf_k=32),
                lambda: traverse.trace_tiles_reference(qn, cam, quat, 1920, 1080, FOV,
                                                       leaf_k=32)),
        "k1c": (lambda: traverse.trace_tiles_batch(qn, BATCH_POS, BATCH_QUAT, 320, 200, FOV,
                                                   leaf_k=32, **batch),
                lambda: traverse.trace_tiles_batch_reference(qn, BATCH_POS, BATCH_QUAT, 320,
                                                             200, FOV, 32, **batch)),
    }
    assert_tiles_match_plain(calls)
    assert int((calls["k1a"][0]()[4] >= 0).sum()) > 1920 * 1080 // 4





@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
def test_raw_layout_equals_image_planes_on_card(cuda_device, width):
    """K1c raw (K1e raw on 8-wide records, K1f raw with ``stats``) writes
    every word of the (F, tiles, 6, 8, 128) layout — its output lands in a
    block that held NaN — and that word equals tiles_layout of the image
    planes of the same batch; each launch counts once, under its _raw
    name."""
    tris = seeded_scene(2)
    qn = records_of(tris, 8, width, cuda_device)
    poss = np.float32([CAM_POS, [0.3, 0.1, 2.4], [-0.2, 0.0, 2.0]])
    quats = np.float32([CAM_QUAT, [0.0, 0.0, 0.0, 1.0], [0.05, -0.1, 0.02, 0.9934]])
    w, h = 96, 64
    for jitter, stats in ((False, False), (True, False), (False, True)):
        kw = dict(leaf_k=8, jitter=jitter, jitter_seeds=[3, 17, 99] if jitter else None,
                  stats=stats)
        image = traverse.trace_tiles_batch(qn, poss, quats, w, h, FOV, **kw)
        probe = torch.full((3, (w // 32) * (h // 32), 6, 8, 128), float("nan"),
                           device=cuda_device)
        ptr = probe.data_ptr()
        del probe
        before = dict(traverse.LAUNCHES)
        raw = traverse.trace_tiles_batch(qn, poss, quats, w, h, FOV, raw=True, **kw)
        torch.cuda.synchronize()
        name = ("trace_tiles_k1f" if stats else "trace_tiles_k1e" if width == 8
                else "trace_tiles_k1c") + "_raw"
        assert launched(before) == {name: 1}
        assert raw.data_ptr() == ptr, "the NaN block was not reused: the probe proves nothing"
        assert torch.equal(raw, traverse.tiles_layout(image)), (jitter, stats)
        hits = (raw[:, :, 4] >= 0).sum(dim=(1, 2, 3))
        assert torch.equal(hits, (image[4] >= 0).sum(dim=(1, 2)))
    with pytest.raises(ValueError, match="multiples of 32"):
        traverse.trace_tiles_batch(qn, poss, quats, 80, 64, FOV, leaf_k=8, raw=True)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("k", [1, 8, 32])
def test_tree_spaces_equal_hbm_on_card(cuda_device, k, width):
    """K2a / K2b / K2c with the records pinned in L2 ("vmem") and in each
    block's shared memory ("smem", 512 threads a block) write the words of
    "hbm" on every ray, with and without near-first order, one thread per
    ray and persistent (over leaves of K > 1 through the core that
    ``traverse.launch_plan`` picks), with and without an active mask; each
    launch counts once, under its _vmem / _smem name. Records larger than a
    block's shared memory (the room's at K = 1 and 4 slots) raise for
    "smem" instead, and launch nothing."""
    tris = room_scene()
    qn = records_of(tris, k, width, cuda_device)
    fits = qn.numel() * 4 <= traverse.tree_space_limits(cuda_device)["smem_optin"]

    o, d = ray_buffer(qn, k, 4096)
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    sun = torch.from_numpy(SUN).to(cuda_device).expand_as(d).contiguous()
    base_name = "trace_rays_k2c" if width == 8 else None
    for any_hit, dirs in ((False, d), (True, sun)):
        for ro, rd, act in list(ray_cases(o, dirs, k + width))[6:12]:
            for ordered in (True, False):
                kw = dict(any_hit=any_hit, leaf_k=k, active=act, ordered=ordered)
                ref = traverse.trace_rays(qn, ro, rd, **kw)
                name = (base_name or ("trace_rays_k2b" if any_hit else "trace_rays_k2a")) + (
                    "" if ordered else "_unordered")
                for scattered in (False, True):
                    before = dict(traverse.LAUNCHES)
                    vmem = traverse.trace_rays(qn, ro, rd, scattered=scattered,
                                               tree_space="vmem", **kw)
                    smem = [traverse.trace_rays(qn, ro, rd, scattered=scattered,
                                                tree_space="smem", **kw)] if fits else []
                    if not fits:
                        with pytest.raises(ValueError, match="shared memory"):
                            traverse.trace_rays(qn, ro, rd, tree_space="smem", **kw)
                    torch.cuda.synchronize()
                    want = {name + "_vmem": 1, name + "_smem": len(smem)}
                    assert launched(before) == {n: c for n, c in want.items() if c}
                    assert words_equal(vmem, ref), ("vmem", any_hit, ordered, scattered)
                    for out in smem:
                        assert words_equal(out, ref), ("smem", any_hit, ordered, scattered)
    if k == 1:
        deep, do, dd = deep_records(width, depth=24)  # fits a block at 8 slots
        deep = deep.to(cuda_device)
        do, dd = torch.from_numpy(do).to(cuda_device), torch.from_numpy(dd).to(cuda_device)
        for any_hit in (False, True):
            ref = traverse.trace_rays(deep, do, dd, any_hit=any_hit, leaf_k=1)
            for space in ("vmem", "smem"):
                assert words_equal(traverse.trace_rays(deep, do, dd, any_hit=any_hit, leaf_k=1,
                                                       tree_space=space), ref), space


@pytest.mark.cuda
def test_vmem_leaves_no_window_or_carveout_on_card(cuda_device):
    """After "vmem" calls on PyTorch's stream and on a side stream neither
    stream holds an access-policy window and the persisting L2 carve-out is
    what it was; records beyond a placement's limit raise ValueError before
    anything is launched."""
    tris = room_scene()
    qn = records_of(tris, 8, 4, cuda_device)
    o, d = (torch.from_numpy(a).to(cuda_device) for a in ray_buffer(qn, 8, 4096))
    before = traverse.l2_window(cuda_device)
    traverse.trace_rays(qn, o, d, leaf_k=8, tree_space="vmem")
    side = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        traverse.trace_rays(qn, o, d, leaf_k=8, tree_space="vmem", scattered=True)
    torch.cuda.synchronize()
    for stream in (None, side):
        after = traverse.l2_window(cuda_device, stream)
        assert after["num_bytes"] == 0 and after["base"] == 0, after
        assert after["persisting_l2"] == before["persisting_l2"]
    limits = traverse.tree_space_limits(cuda_device)
    assert limits["smem_optin"] >= 48 * 1024 and limits["persisting_l2"] > 0
    recw = qn.shape[1]
    big = torch.zeros((limits["smem_optin"] // (4 * recw) + 1, recw), device=cuda_device)
    counts = dict(traverse.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        traverse.trace_rays(big, o, d, leaf_k=8, tree_space="smem")
    room_bytes = min(limits["persisting_l2"], limits["access_window"])
    huge = torch.zeros((room_bytes // (4 * recw) + 1, recw), device=cuda_device)
    with pytest.raises(ValueError, match="persisting L2"):
        traverse.trace_rays(huge, o, d, leaf_k=8, tree_space="vmem")
    assert traverse.LAUNCHES == counts

