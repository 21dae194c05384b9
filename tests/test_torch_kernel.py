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
the refit chain's records byte-equal.
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
                                              collapse_plan)
from raytracer_tpu_torch.ops.cuda import build, microbench, traverse
from raytracer_tpu_torch.ops.lbvh import build_lbvh2
from raytracer_tpu_torch.ops.cuda.entry import compute_tile_entries
from raytracer_tpu_torch.ops.trace import make_wide_bvh
from raytracer_tpu_torch.ops.trace import moller_trumbore
from torch_parity import (CAM_POS, CAM_QUAT, FOV, assert_trace_parity, image_dirs, ray_buffer,
                          room_scene, seeded_scene, tile_bounds)

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
    assert [p.name for p in build.cuda_headers()] == ["traverse_core.cuh"]


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
    assert set(before) == {"trace_tiles_k1a", "trace_tiles_k1b", "trace_tiles_k1c",
                           "trace_tiles_k1d", "trace_tiles_k1e", "trace_tiles_k1f", "trace_rays_k2a",
                           "trace_rays_k2b", "trace_rays_k2c"}


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
