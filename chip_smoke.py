"""Drive the PyTorch port's main paths once on one CUDA card and check its kernels.

Run from the repository root, with one card:

    python3 chip_smoke.py

Phases, each printing what it measures; the first failure exits non-zero:

1. the device: a CUDA card is required (there is no CPU path), and its name
   and power limit as nvidia-smi reports them;
2. the builds, started together: the native BVH library, the primary-ray
   kernels K1a/K1b/K1c/K1d/K1e/K1f (csrc/traverse_tiles.cu), the
   ray-buffer kernels K2a/K2b/K2c (csrc/traverse_rays.cu) and the
   microbenchmark kernels MB1–MB4 (csrc/microbench.cu), with their seconds
   and the ptxas registers, stack frame and spills of every instantiation
   (child slots × jitter × visits × bounds, any hit; the microbenchmarks'
   rows × chains × vector rounds and slots × record source);
3. the primary-ray main path at full size: the 871,200-triangle dragon
   stand-in at 1920×1080 through Scene.load_glb → PathTracer.set_scene
   (SAH, K = 32) → render (framed and sparse view) → render_presented,
   counting K1a's launches; set_scene's records phase through the device
   4-wide collapse against the native C++ collapse, which set_scene ran
   before: both warm, in the order native-device-device-native, the records
   equal but for the sign of a zero;
4. K1a against its plain torch version on a 256×256 centre crop of the
   framed view (65,536 pixels), and the shaded image against the plain
   version's;
5. K1a against the brute-force tracer on 1,024 seeded framed-view pixels;
6. K1b (jittered rays) against its plain version on the centre crop of the
   jittered framed view, and against brute force on 1,024 seeded pixels;
7. the progressive main path at full size: render_progressive(bounces=3)
   four times and present_progressive, counting the launches (per sample 1
   K1b, bounces−1 K2a, bounces K2b), the frame count, a finite
   non-negative buffer and the reset on a camera move; then
   render_progressive(bounces=0) four times (4 K1b); and one sample of each
   kind under torch's sync debug mode, which fails on any host-device
   synchronisation;
8. K2a and K2b against their plain versions on every wave of one 1080p
   sample: the rays and active mask of each wave are captured, and 65,536
   seeded active rays of each are traced by the plain version;
9. one whole 256×256 sample of the dragon through the kernels and through
   the plain versions, from the same generator state;
10. times with CUDA events (each kernel and its plain version on the same
   checked rays, each kernel on its whole frame or wave, each progressive
   sample), one synchronised render_progressive on the host clock, peak
   device memory, and each kernel's bound;
11. where a progressive sample's time goes: torch.profiler over a few
   samples — device busy time per sample, its top kernels, and the
   device's idle share of the wall time;
12. the frame batch K1c on the dragon: 8 cameras at (x, 0, 1.15), x in
   linspace(-0.3, 0.3, 8), at 1920×1080 in one trace_tiles_batch call
   (exactly 1 K1c launch and nothing else); each frame bit-identical to K1a
   for its camera, and with jitter (seeds JITTER_SEED + f) to K1b; K1c
   against its plain version on the 256×256 centre crop of frames 0 and 7;
   K1c's 8 frames against 8 host-issued K1a calls (CUDA events), and, to
   split that difference, one camera as F = 1 against K1a and 8 copies of
   one camera against 8 K1a calls; its bound counted on seeded pixels of
   each frame;
13. the dynamic dragon at full size: each frame i deforms the 871,200
   triangles on the card by 1 + 0.1·sin(0.1·i), then refit →
   collapse_apply_refit → make_wide_bvh → make_qnodes → K1c over the 8
   cameras. Checks: (a) the chain's records equal byte for byte the records
   pipeline's (the device collapse) of the refitted tree, and the native C++
   collapse's but for the sign of a zero; (b) every
   refitted internal box contains its children's boxes and every leaf box
   its cluster's deformed triangles; (c) PathTracer.refit_bvh then render()
   agree with brute force on 1,024 seeded pixels; (d) 1 K1c launch per
   frame and nothing else; (e) a frame issues without a host-device
   synchronisation (sync debug mode). Prints CUDA-event times of the refit,
   apply + widen + records, K1c and the whole frame, Mrays/s =
   W·H·cameras / frame ms, the host's issue time against the device's busy
   time under torch.profiler, and peak device memory;
14. BASELINE config 5 as bench_suite.py defines it: icosphere(4) (5,120
   triangles), SAH K = 32, 8 cameras at (x, 0, 3.0) at 256×256, the same
   frame chain: times, per-camera hit counts and launches;
15. the 8-wide main path at full size: PathTracer(widener="collapse8") on
   the dragon: set_scene (build seconds, BVH8 rows, record bytes, peak
   memory), render framed and sparse (1 K1e each, images equal to the
   4-wide tree's but for ties), render_progressive(bounces=3) four times
   (per sample 1 K1e and 2·bounces−1 K2c, nothing else), and one sample
   under sync debug mode;
16. K1e against its plain version on the centre crop, with and without
   jitter, and against brute force on the 1,024 seeded pixels; K2c closest
   hit and any hit against the plain version on 65,536 seeded active rays
   of every captured wave of one 1080p sample; their times and bounds as
   in phases 8 and 10;
17. K1f at both widths: stats=True leaves the five planes of the whole
   frame bit-identical; on the crop the visits plane equals the plain
   version's on every ray whose triangle agrees, and its sum equals
   TraversalCounts.visits when every triangle agrees; every pixel counts
   at least the root;
18. the structure of the full-size BVH8 (collapsed once more on the card,
   timed): every emitted row reached once, every BVH2 leaf present once,
   every internal node 2–8 children, each box containing its children's
   within 2^-14 (the truncating re-pack flushes fp16 subnormals of internal
   rows; leaf rows keep theirs);
19. BVH4 against BVH8 in this one process, back to back in the order 4, 8,
   8, 4 (CUDA events): the framed and sparse 1080p frame (ms, Mrays/s,
   total visits from K1f, hit counts, which must be equal, and the cost of
   the visits plane), every captured wave of the 8-wide sample through
   K2a/K2b and through K2c, and one whole 3-bounce sample from the same
   generator state.

Phases 20–24 drive the bounded and entry-seeded paths (K1d); they run after
phase 11, while the 4-wide tracer still holds the undeformed dragon:

20. K1d against its plain version on a 256×256 crop whose corner is a
   multiple of 32 (tile indices are in window coordinates), with the framed
   frame's own bounds (render._coarse_bounds) and entries
   (compute_tile_entries), and with halved bounds that cut many hits: the
   closest-hit tolerances on the rays that hit, t = the tile's bound and a
   zero normal on those that do not, the crop window equal to the same
   pixels of the whole frame; all-1e30 bounds and all-0 entries leave the
   whole frame of K1a, K1b, K1e and K1f bit-identical (0 differing words);
21. render.trace_tiles_bounded at full size, framed and sparse, default and
   halved bounds: every plane bit-identical to trace_tiles' (t 1e30 on
   misses), exactly 1 K1a + 1 K1d + 1 K2a launched, n_repair, the share of
   tiles with a finite bound, one call under sync debug mode, and 1,024
   seeded pixels of the result against brute force;
22. the entries at full size: the share of whole tiles that start below the
   root and their mean depth; all five planes bit-identical with and without
   them; PathTracer.render() with use_tile_entries byte-equal to without (1
   K1d launch), render_stream the box filter of the same frame;
23. render.trace_tiles_temporal over four successive seeds, each bounded by
   the previous sample and each bit-identical to K1b for its seed (1 K1d + 1
   K2a a sample);
24. the measurement, in the order A-B-B-A with CUDA events: K1a against the
   bounded trace end to end (framed, sparse) and its passes apart; the repair
   as one masked launch against a compacting repair that reads the count
   back; K1a against entries + K1d with compute_tile_entries counted; K1b
   against the temporal sample. For each: ms, Mrays/s, total visits from K1f
   with and without the bounds / entries, Möller–Trumbore tests from the plain
   version's counts on the crop, kernels per call, host issue ms against
   device busy ms.

Phases 25–27 drive the JAX package's default build (Morton / Karras LBVH)
and the microbenchmark kernels; they run last, phase 28 between 26 and 27:

25. the LBVH dragon at full size through PathTracer(builder="lbvh") at
   leaf_size 1 and 8: set_scene's stages, BVH2 rows, record bytes and peak
   memory; the Morton codes and order and the BVH2 (bounds, left, right,
   meta, parent) built on the card equal word for word the same functions
   run on the CPU, and at K = 8 the 4-wide collapse too; render() framed and
   sparse (one K1a launch each), every pixel's triangle the SAH K = 32
   frame's but for proven ties, t bit-equal and the image equal where it
   agrees; K1a at leaf_k = 1 and 8 against its plain version on the crop (0
   ties, max |d| 0) and against brute force on the 1,024 seeded pixels; at
   K = 1 one render_progressive(bounces=3) sample (1 K1b, 2 K2a, 3 K2b) and
   its waves against the plain K2a / K2b;
26. K = 1, 8 and 32 in this one process, timed in the order 1-8-32-32-8-1:
   framed and sparse frame ms, visits a frame from K1f (hit counts equal),
   visits and Möller–Trumbore tests a ray on the crop from the plain
   version's counts, and one 3-bounce 1080p sample from the same generator
   state (radiance within 1e-5 of K = 32's on >= 99.9% of pixels);
27. MB1–MB4: every variant (MB1 over the 64 KB and 8 MiB tables) timed per
   iteration at n = 100 → 1,000 with its launches counted, MB4's largest
   block, then every variant at n = 1,000 against its plain version
   (exactly). The full sweep, with the 1 GiB table, is chip_microbench.py's.

Phase 28 holds the redesigned traversal core (csrc/traverse_core.cuh, the
wrappers' core="hopper", on the render paths) against the frozen baseline
core (csrc/traverse_core_baseline.cuh, core="baseline"); it runs after
phase 26, before 27:

28. ptxas registers, stack frame and spills of every redesigned
   instantiation beside its baseline twin; every plane of every pixel of the
   full-size frames (K1a framed and sparse at SAH K = 32 and LBVH K = 1, K1b,
   K1c's 8 frames, K1d under the frame's bounds and entries, K1e framed and
   sparse, K1f at both widths) and of every ray of the 15 captured waves
   (SAH K = 32, LBVH K = 1, 8-wide; closest and any hit, each with its own
   schedule) bit-identical between the two cores (0 differing words), and
   each wave's share of alive lanes; A-B-B-A CUDA-event times of each of
   those frames and waves, of one whole 3-bounce sample per tree (radiance
   equal) and of the dynamic dragon frame; each set of the design elements
   alone (ELEMENT_CORES on K1a at K = 32 and K = 1 and the first K2a and K2b
   waves; one thread per ray), K2's two schedules on every 4-wide wave
   that may choose (any hit over leaves of K > 1 runs one thread per ray);
   the deepest stack the plain version counts; and the
   baseline's times beside each kernels-line row's (``baseline_ms`` on the
   checked rays, ``baseline_path_ms`` on the path).

Phase 29 drives the headless apps and the rest of the build chain; it runs
after phase 28, before 27:

29. (a) PathTracer(builder="ploc") and PathTracer(builder="sah",
   leaf_size=1) on the dragon: set_scene's stages, BVH2 rows and height,
   PLOC's rounds (live clusters at each); the PLOC BVH2 built on the card
   equal word for word to the same build on the CPU; K1a at leaf_k = 1 on
   both trees against its plain version on the crop (0 ties, max |d| 0)
   and brute force on the 1,024 seeded pixels; (b) SAH K = 32, Morton LBVH
   K = 1, SAH K = 1 and PLOC K = 1 in this one process, render() and K1a
   alone timed A-B-C-D-D-C-B-A (CUDA events), framed and sparse, with
   visits a ray (K1f, hit counts equal) and MT tests a ray on the crop, and
   the tree fast_build_options returns beside the fastest framed render();
   (c) apps.main on the dragon at 1920x1080 with --builder lbvh, posting
   BVH2.bin to server.api running in a thread: 30 K1a launches and nothing
   else, the file byte-equal to bvh2_artifact(), the PNG decoding to a
   tracer's render() at the app's start camera; then 3,000 frames with
   --builder lbvh and with the default --builder auto and --orbit, and the
   FPS of each from the app's FrameStats; (d) save_checkpoint →
   load_checkpoint into a fresh tracer at SAH K = 32 and Morton K = 1: file
   sizes, seconds, frames byte-equal; (e) apps.debug at its defaults: the
   PNG's size and the JSON's node count against bvh2_artifact().

Tolerances (what the kernels must meet): for closest hit (K1a, K1b, K1c,
K1e, K2a, K2c), tri equal on >= 99.99% of the rays and every other ray a tie (both
triangles are accepted hits of that ray with t within rtol 1e-6), t within
rtol 1e-5 on hits and 1e30 on misses, normals within atol 1e-5 of the
reference and zero on misses; for any hit (K2b, K2c), the occlusion mask equal
on every ray, t 0 where occluded and 1e30 elsewhere, and normals within
atol 1e-5 where both report the same occluder; for the whole sample,
radiance within atol 1e-5 on >= 99.9% of the pixels; K1f's visits plane
equal to the plain version's on every ray whose triangle agrees.

Bounds: a kernel's least time on the card is the larger of its bytes over
3.35 TB/s and its f32 operations over 67 TFLOP/s (the H100 SXM's published
peaks). Bytes: each ray read once (24 bytes; K2 only), each output written
once (20 bytes a ray), and the distinct record headers and triangle
records that the rays read (a header is 32·w bytes, w the records' child
slots). Operations: 25·w per node visit (w slab tests: 100 at 4 slots, 200
at 8) and 54 per Möller–Trumbore test, as the plain version counts them
(an any-hit ray stops testing at its first accepted triangle). On the
checked rays the counts are exact; for a whole frame or wave they are
counted on a seeded subset and scaled to it (its distinct record bytes are
then a lower bound). No PyTorch call computes BVH traversal, so there is no
library yardstick (library_ms is null).

For MB1–MB4 the kernels line sums the variants of each kernel at n =
1,000 (``variants``): ``ms`` the CUDA-event time of one launch (best of 3),
``plain_ms`` the plain version's host time, ``bound_ms`` the distinct table
bytes over 3.35 TB/s or the f32 operations over 67 TFLOP/s, whichever is
larger (these kernels are bound by latency, which no such bound sees), and
``launches`` those of phase 27's timed run.

The kernels line: ``ms``, ``plain_ms`` and ``bound_ms`` are all on the
same ``rays`` — the 256×256 crop for K1a/K1b (of frames 0 and 7 for K1c),
the checked subset of each wave for K2a/K2b (summed over the waves of one
1080p sample; K2c: all five waves of the 8-wide sample), the un-jittered
crop for K1e (8-wide records), the crop at both widths for K1f, phase 20's
crop under the frame's bounds and entries for K1d — and
``path_ms``/``path_bound_ms`` on the main path's whole frame, batch or
waves (``path_rays`` rays, active lanes for K2; for K1f the framed frame
at both widths; for K1d the framed frame under its bounds and entries, the
kernel alone). ``launches``: K1d's are those of phases 21–23's calls, K1e's
are those of phase 15's render calls
and samples, K2c's of its samples, K1f's of phase 19's frames.

Every traversal row of the kernels line also carries ``baseline_ms`` and
``baseline_path_ms``: the same calls with the frozen baseline core, timed
A-B-B-A against the redesigned one in phase 28.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels as JSON, and the line before that the card.
"""

from __future__ import annotations

import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
WIDTH, HEIGHT, LEAF_K, FOV = 1920, 1080, 32, 70.0
DRAGON_TRIANGLES = 871_200
FRAMED, SPARSE, MOVED = (0.0, 0.0, 1.15), (0.0, 0.0, 2.5), (0.05, 0.0, 1.15)
QUAT = (0.0, 0.0, 0.0, 1.0)
CROP = 256
BRUTE_SAMPLES = 1024
WAVE_SAMPLES = 65536
SEED, JITTER_SEED, SAMPLE_SEED = 0, 123457, 7
BOUNCES, SAMPLES = 3, 4
T_RTOL, NORMAL_ATOL, TIE_RTOL, MIN_TRI_MATCH = 1e-5, 1e-5, 1e-6, 0.9999
RADIANCE_ATOL, MIN_RADIANCE_MATCH = 1e-5, 0.999
MIN_FRAMED_HIT_RATE = 0.4
FRAMES, REPEATS = 16, 5
N_CAMS, CAM_XS, CAM_Z, CONFIG5_Z, CONFIG5_SIZE = 8, (-0.3, 0.3), 1.15, 3.0, 256
DYN_FRAMES = 8
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
SLAB_OPS, MT_OPS = 25, 54  # per child slot of a visited record; per triangle test
OUT_BYTES, RAY_BYTES = 20, 24
KERNELS = {
    "trace_tiles_k1a": ("raytracer_tpu_torch/csrc/traverse_tiles.cu",
                        "raytracer_tpu/ops/pallas/traverse.py:666"),
    "trace_tiles_k1b": ("raytracer_tpu_torch/csrc/traverse_tiles.cu",
                        "raytracer_tpu/ops/pallas/traverse.py:666"),
    "trace_tiles_k1c": ("raytracer_tpu_torch/csrc/traverse_tiles.cu",
                        "raytracer_tpu/ops/pallas/traverse.py:666"),
    "trace_tiles_k1d": ("raytracer_tpu_torch/csrc/traverse_tiles.cu",
                        "raytracer_tpu/ops/pallas/traverse.py:666"),
    "trace_rays_k2a": ("raytracer_tpu_torch/csrc/traverse_rays.cu",
                       "raytracer_tpu/ops/pallas/traverse.py:914"),
    "trace_rays_k2b": ("raytracer_tpu_torch/csrc/traverse_rays.cu",
                       "raytracer_tpu/ops/pallas/traverse.py:914"),
    "trace_tiles_k1e": ("raytracer_tpu_torch/csrc/traverse_tiles.cu",
                        "raytracer_tpu/ops/pallas/traverse.py:666"),
    "trace_rays_k2c": ("raytracer_tpu_torch/csrc/traverse_rays.cu",
                       "raytracer_tpu/ops/pallas/traverse.py:914"),
    "trace_tiles_k1f": ("raytracer_tpu_torch/csrc/traverse_tiles.cu",
                        "raytracer_tpu/ops/pallas/traverse.py:666"),
}
# the microbenchmark kernels (their launches are counted apart, in
# ops.cuda.microbench.LAUNCHES) and the TPU kernels they replace
MB_SOURCE = "raytracer_tpu_torch/csrc/microbench.cu"
MB_KERNELS = {"mb_walk": (MB_SOURCE, "tools/mb_kernel.py:108"),
              "mb_scalar": (MB_SOURCE, "tools/mb_kernel.py:86"),
              "mb_visit": (MB_SOURCE, "tools/mb_kernel2.py:66"),
              "mb_smem_probe": (MB_SOURCE, "tools/mb_smem_probe.py:29")}
MB_N_LO, MB_N_HI = 100, 1000  # small n: the full sweep is chip_microbench.py's


def expected(**counts: int) -> dict:
    """The launch counts of a run that launched ``counts`` and nothing else."""
    return {name: counts.get(name, 0) for name in KERNELS}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def check_against(kernel, ref, tris, origins, dirs, what: str) -> dict:
    """Hold a closest-hit kernel's flat (t, nx, ny, nz, tri) planes against
    a reference's on the same rays (``origins``: one point (3,) or (R, 3));
    fail on any breach of the tolerances above."""
    from raytracer_tpu_torch.ops.camera import INF
    from raytracer_tpu_torch.ops.trace import moller_trumbore

    kt, ktri, rt, rtri = kernel[0], kernel[4], ref[0], ref[4]
    kn = torch.stack(kernel[1:4], dim=-1)
    rn = torch.stack(ref[1:4], dim=-1)
    same = ktri == rtri
    n = same.numel()
    diff = torch.nonzero(~same).squeeze(1)
    if diff.numel():
        a, b = ktri[diff].long(), rtri[diff].long()
        if bool((a < 0).any() | (b < 0).any()):
            fail(f"{what}: hit/miss disagreement on {int(((a < 0) | (b < 0)).sum())} rays")
        o = origins[diff] if origins.dim() == 2 else origins

        def hit_t(idx):
            v = tris[idx]
            return moller_trumbore(o, dirs[diff], v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])

        (ta, oka), (tb, okb) = hit_t(a), hit_t(b)
        tie = oka & okb & torch.isclose(ta, tb, rtol=TIE_RTOL, atol=0.0) \
            & torch.isclose(kt[diff], rt[diff], rtol=TIE_RTOL, atol=0.0)
        if not bool(tie.all()):
            fail(f"{what}: {int((~tie).sum())} tri mismatches are not ties")
    match = float(same.float().mean())
    if match < MIN_TRI_MATCH:
        fail(f"{what}: tri equal on {match:.6f} < {MIN_TRI_MATCH} of rays")
    hit, miss = same & (rtri >= 0), same & (rtri < 0)
    if not torch.allclose(kt[hit], rt[hit], rtol=T_RTOL, atol=0.0):
        fail(f"{what}: t beyond rtol {T_RTOL} on hits")
    if not bool((kt[miss] == INF).all() & (kn[miss] == 0).all()):
        fail(f"{what}: misses must carry t = 1e30 and a zero normal")
    n_err = (kn[hit] - rn[hit]).abs()
    if n_err.numel() and float(n_err.max()) > NORMAL_ATOL:
        fail(f"{what}: normals beyond atol {NORMAL_ATOL} (max {float(n_err.max())})")
    t_err = (kt[hit] - rt[hit]).abs()
    max_err = max([float(x.max()) for x in (t_err, n_err) if x.numel()] or [0.0])
    stats = {"rays": n, "tri_equal": match, "ties": int(diff.numel()),
             "hit_rate": float((rtri >= 0).float().mean()), "max_abs_err": max_err}
    log(f"[check] {what}: {json.dumps(stats)}")
    return stats


def check_occlusion(kernel, ref, what: str) -> dict:
    """K2b's contract: the occlusion mask (tri >= 0) equal on every ray, t
    = 0 where occluded and 1e30 elsewhere; and where both report the same
    occluder, its normal within the tolerance. The error is over t on
    every ray and the normals where tri agrees."""
    occ, ref_occ = kernel[4] >= 0, ref[4] >= 0
    if not torch.equal(occ, ref_occ):
        fail(f"{what}: occlusion mask differs on {int((occ != ref_occ).sum())} rays")
    if not bool((kernel[0][occ] == 0).all() & (kernel[0][~occ] == 1e30).all()):
        fail(f"{what}: t must be 0 on occluded rays and 1e30 elsewhere")
    same = kernel[4] == ref[4]
    n_err = (torch.stack(kernel[1:4], -1)[same] - torch.stack(ref[1:4], -1)[same]).abs()
    if n_err.numel() and float(n_err.max()) > NORMAL_ATOL:
        fail(f"{what}: normals of the same occluder beyond atol {NORMAL_ATOL}")
    max_err = max(float((kernel[0] - ref[0]).abs().max()),
                  float(n_err.max()) if n_err.numel() else 0.0)
    stats = {"rays": occ.numel(), "mask_equal": 1.0, "occluded": float(occ.float().mean()),
             "tri_equal": float(same.float().mean()), "max_abs_err": max_err}
    log(f"[check] {what}: {json.dumps(stats)}")
    return stats


def cuda_ms(fn, frames: int, repeats: int) -> list[float]:
    """ms per call of ``fn``: ``repeats`` runs of ``frames`` calls each,
    timed with CUDA events after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    reps = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(frames):
            fn()
        end.record()
        end.synchronize()
        reps.append(start.elapsed_time(end) / frames)
    return reps


def timed_once(fn):
    """(result, ms) of one call of ``fn``, with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def bound(counts, scale: float, fixed_bytes: int) -> tuple[float, str, dict]:
    """The least time of a traversal (module docstring): ``counts`` from the
    plain version on a subset, scaled by ``scale`` to the wave, plus
    ``fixed_bytes`` of rays read and outputs written."""
    nbytes = fixed_bytes + counts.unique_record_bytes()
    ops = (counts.visits * SLAB_OPS * (counts.width or 4) + counts.mt_tests * MT_OPS) * scale
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    detail = {"bytes": nbytes, "ops": ops, "bytes_ms": b_ms, "ops_ms": o_ms,
              "visits_per_ray": counts.visits / max(counts.rays, 1),
              "mt_per_ray": counts.mt_tests / max(counts.rays, 1)}
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations"), detail


def profile_calls(fn, what: str, card: str, n: int = 3) -> dict | None:
    """torch.profiler over ``n`` calls of ``fn`` after one warm-up: device
    busy ms per call (the sum of the CUDA kernels' own times), the top
    kernels, and the device's idle share of the wall time (inflated by the
    profiler's own host cost)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if busy_ms == 0:
        log(f"[profile] {what}: the profiler recorded no device time: device busy share "
            "not measured")
        return None
    log(f"[profile] {what} under torch.profiler: wall {wall_ms:.4f} ms/call, device busy "
        f"{busy_ms:.4f} ms/call, idle share {1 - busy_ms / wall_ms:.4f}, "
        f"{sum(e.count for e in kernels) / n:.0f} kernels/call on {card}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3 / n:9.4f} ms/call "
            f"x{e.count / n:6.1f}  {e.key[:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms}


def ptxas_rows(nvcc_log: str) -> list[tuple]:
    """(kernel<template arguments>, registers, stack frame bytes, spill store
    bytes, spill load bytes) of every entry function in an ``nvcc -Xptxas -v``
    log. The template arguments are <child slots, jitter, visits, core> for
    the batch tile kernel, <child slots, jitter, visits, bounds, core> for the
    one-frame tile kernel, <child slots, any hit, core> for the ray kernel and
    <child slots, any hit> for the persistent ray kernel (core: the feature
    mask of csrc/traverse_core.cuh, 256 for the frozen baseline)."""
    rows, name, frame = [], None, (0, 0, 0)
    for line in nvcc_log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            k = re.search(r"((?:trace|mb)_\w+?_kernel)(I(?:L[ibj]\d+E)+)?", m.group(1))
            name = m.group(1) if not k else k.group(1) if not k.group(2) else (
                f"{k.group(1)}<{','.join(re.findall(r'L[ibj](\d+)E', k.group(2)))}>")
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            frame = tuple(int(x) for x in m.groups())
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            rows.append((name, int(m.group(1)), *frame))
            name = None
    return rows


def build_all() -> None:
    """Build the native library and both kernel sources at once, and print
    what ptxas says of every kernel instantiation."""
    from raytracer_tpu_torch.native import bvhtool
    from raytracer_tpu_torch.ops.cuda import traverse

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0

    from raytracer_tpu_torch.ops.cuda import microbench

    with ThreadPoolExecutor(max_workers=4) as pool:
        jobs = {"native BVH library": pool.submit(timed, bvhtool.ensure_built),
                "microbench.cu (MB1, MB2, MB3, MB4)": pool.submit(
                    timed, microbench.load_microbench),
                "traverse_tiles.cu (K1a, K1b, K1c, K1d, K1e, K1f)": pool.submit(
                    timed, traverse.load_kernel, "traverse_tiles.cu"),
                "traverse_rays.cu (K2a, K2b, K2c)": pool.submit(
                    timed, traverse.load_kernel, "traverse_rays.cu")}
        results = {name: job.result() for name, job in jobs.items()}
    for name, (out, secs) in results.items():
        log(f"[build] {name} ready in {secs:.2f} s")
        if not isinstance(out, tuple):
            continue
        rows = ptxas_rows(out[1])
        if not rows:
            fail(f"no ptxas report in the build log of {name}")
        for kernel, regs, stack, st, ld in rows:
            log(f"[build] ptxas {kernel}: {regs} registers, {stack} bytes stack frame, "
                f"{st} bytes spill stores, {ld} bytes spill loads")


def frame_dirs(pix: torch.Tensor, jitter: bool = False) -> torch.Tensor:
    """Directions of the framed view's primary rays through the pixels
    ``pix`` (flat indices), at the pixel centres or at JITTER_SEED's
    subpixel offsets."""
    from raytracer_tpu_torch.ops.camera import primary_dirs, subpixel_hash01

    px, py = pix % WIDTH, pix // WIDTH
    if not jitter:
        return primary_dirs(px, py, WIDTH, HEIGHT, QUAT, FOV)
    return primary_dirs(px, py, WIDTH, HEIGHT, QUAT, FOV,
                        subpixel_hash01(px, py, 2 * JITTER_SEED),
                        subpixel_hash01(px, py, 2 * JITTER_SEED + 1))


def check_tiles(env: dict, qn: torch.Tensor, label: str, jitter: bool,
                leaf_k: int = LEAF_K) -> dict:
    """A tile kernel (K1a, K1b, or K1e on 8-wide ``qn``) on the framed 1080p
    view: against its plain version on the centre crop, and against brute
    force on the seeded pixels. Returns the frame's planes, the crop's
    kernel and plain planes, the crop check's numbers and the crop's
    traversal counts."""
    from raytracer_tpu_torch.ops.cuda import traverse

    tris, origin, crop_pix, sample = env["tris"], env["origin"], env["crop_pix"], env["sample"]
    kw = dict(leaf_k=leaf_k, jitter=jitter, jitter_seed=JITTER_SEED)
    planes = traverse.trace_tiles(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, **kw)
    counts = traverse.TraversalCounts()
    ref = traverse.trace_tiles_reference(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, pixels=crop_pix,
                                         counts=counts, **kw)
    ker = [p.reshape(-1)[crop_pix] for p in planes]
    view = "jittered 256x256 crop" if jitter else "256x256 crop"
    stats = check_against(ker, ref, tris, origin, frame_dirs(crop_pix, jitter),
                          f"{label} vs plain, {view}")
    s_dirs = frame_dirs(sample, jitter)
    check_against([p.reshape(-1)[sample] for p in planes], brute_planes(tris, origin, s_dirs),
                  tris, origin, s_dirs,
                  f"{label} vs brute force, {BRUTE_SAMPLES} {'jittered ' if jitter else ''}"
                  "framed pixels")
    return {"planes": planes, "ker": ker, "ref": ref, "stats": stats, "counts": counts}


def time_tiles(env: dict, qn: torch.Tensor, label: str, jitter: bool, checked: dict,
               launches: int) -> dict:
    """CUDA-event times of a tile kernel on the framed 1080p frame and on the
    crop window, its plain version on the crop, and the bounds of both →
    its kernels-line row."""
    from raytracer_tpu_torch.ops.cuda import traverse

    card, crop_pix, r0, c0 = env["card"], env["crop_pix"], env["r0"], env["c0"]
    kw = dict(leaf_k=LEAF_K, jitter=jitter, jitter_seed=JITTER_SEED)
    reps = cuda_ms(lambda: traverse.trace_tiles(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, **kw),
                   FRAMES, REPEATS)
    path_ms = statistics.median(reps)
    log(f"[time] {label} framed 1920x1080: {path_ms:.4f} ms/frame = "
        f"{WIDTH * HEIGHT / path_ms / 1e3:.2f} Mrays/s (median of {REPEATS} x {FRAMES} "
        f"frames; reps {[round(r, 4) for r in reps]}) on {card}")
    crop_ms = statistics.median(cuda_ms(lambda: traverse.trace_tiles(
        qn, FRAMED, QUAT, CROP, CROP, FOV, raygen_size=(WIDTH, HEIGHT), row_offset=r0,
        col_offset=c0, **kw), FRAMES, REPEATS))
    register_row(env, f"trace_tiles_{label.lower()}", lambda core: traverse.trace_tiles(
        qn, FRAMED, QUAT, CROP, CROP, FOV, raygen_size=(WIDTH, HEIGHT), row_offset=r0,
        col_offset=c0, core=core, **kw), lambda core: traverse.trace_tiles(
        qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, core=core, **kw))
    plain_ms = statistics.median(cuda_ms(lambda: traverse.trace_tiles_reference(
        qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, pixels=crop_pix, **kw), 1, 3))
    crop_bound = bound(checked["counts"], 1.0, crop_pix.numel() * OUT_BYTES)
    log(f"[time] {label} framed 256x256 crop: kernel {crop_ms:.4f} ms, plain torch "
        f"{plain_ms:.2f} ms (median of 3), bound {crop_bound[0]:.4f} ms by "
        f"{crop_bound[1]} {json.dumps(crop_bound[2])} on {card}")
    counts = traverse.TraversalCounts()
    traverse.trace_tiles_reference(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, pixels=env["bound_pix"],
                                   counts=counts, **kw)
    frame_bound = bound(counts, WIDTH * HEIGHT / WAVE_SAMPLES, WIDTH * HEIGHT * OUT_BYTES)
    env.setdefault("frame_counts", {})[label] = counts
    log(f"[bound] {label} framed 1080p frame: {frame_bound[0]:.4f} ms by "
        f"{frame_bound[1]} {json.dumps(frame_bound[2])}")
    return {"launches": launches, "max_abs_err": checked["stats"]["max_abs_err"],
            "rays": crop_pix.numel(), "ms": crop_ms, "plain_ms": plain_ms,
            "bound_ms": crop_bound[0], "bound_by": crop_bound[1],
            "path_rays": WIDTH * HEIGHT, "path_ms": path_ms,
            "path_bound_ms": frame_bound[0], "path_bound_by": frame_bound[1]}


def capture_waves(env: dict, qn: torch.Tensor, leaf_k: int = LEAF_K) -> tuple[list[dict], dict]:
    """One 1080p 3-bounce sample of the framed view through the kernels, from
    SAMPLE_SEED, with the rays, active mask and result of every ray-buffer
    wave captured → (waves, the sample's statistics)."""
    from raytracer_tpu_torch import render_pt

    waves = []
    real_trace_rays = render_pt.trace_rays

    def capturing(qnodes, origins, dirs, *, any_hit=False, leaf_k, active=None,
                  scattered=False):
        out = real_trace_rays(qnodes, origins, dirs, any_hit=any_hit, leaf_k=leaf_k,
                              active=active, scattered=scattered)
        waves.append({"any_hit": any_hit, "o": origins, "d": dirs, "active": active,
                      "scattered": scattered, "out": out})
        return out

    render_pt.trace_rays = capturing
    try:
        _, sample_stats = render_pt.pt_sample_frame(
            qn, env["tris"], FRAMED, QUAT, WIDTH, HEIGHT, bounces=BOUNCES, fov_degrees=FOV,
            leaf_k=leaf_k, tile_primary=True,
            generator=torch.Generator(device=env["dev"]).manual_seed(SAMPLE_SEED), stats=True)
    finally:
        render_pt.trace_rays = real_trace_rays
    log(f"[waves] captured {len(waves)} ray-buffer waves; alive rays per sample "
        f"{int(sample_stats['alive_rays'])} of {int(sample_stats['lane_rays'])} lanes")
    return waves, sample_stats


def check_waves(env: dict, qn: torch.Tensor, waves: list[dict], closest: str,
                occlusion: str, leaf_k: int = LEAF_K) -> dict:
    """The ray kernel against its plain version on 65,536 seeded active rays
    of every captured wave, with times and bounds → per kernel name
    (``closest`` for the bounce waves, ``occlusion`` for the shadow waves)
    the list of its waves' numbers."""
    from raytracer_tpu_torch.ops.cuda import traverse

    tris, card, dev = env["tris"], env["card"], env["dev"]
    pick_gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    wave_stats: dict[str, list] = {}
    picks = []
    for i, w in enumerate(waves):
        name = occlusion if w["any_hit"] else closest
        kind = "any hit" if w["any_hit"] else "closest hit"
        r = w["o"].shape[0]
        act = w["active"] if w["active"] is not None else torch.ones(r, dtype=torch.bool,
                                                                      device=dev)
        live = torch.nonzero(act).squeeze(1)
        if live.numel() == 0:
            fail(f"wave {i} ({name}) has no active ray to check")
        out = w["out"]
        if not bool((out[0][~act] == 1e30).all() & (out[4][~act] == -1).all()):
            fail(f"wave {i} ({name}): inactive lanes must return the miss values")
        pick = live[torch.randperm(live.numel(), generator=pick_gen)[:WAVE_SAMPLES].to(dev)]
        o, d = w["o"][pick].contiguous(), w["d"][pick].contiguous()
        picks.append((o, d))
        counts = traverse.TraversalCounts()
        ref = traverse.trace_rays_reference(qn, o, d, any_hit=w["any_hit"], leaf_k=leaf_k,
                                            counts=counts)
        kout = [p[pick] for p in out]
        n, n_live = pick.numel(), live.numel()
        what = f"{name} ({kind}) vs plain, wave {i}, {n} of {n_live} active rays"
        stats = (check_occlusion(kout, ref, what) if w["any_hit"]
                 else check_against(kout, ref, tris, o, d, what))
        plain_ms = statistics.median(cuda_ms(lambda: traverse.trace_rays_reference(
            qn, o, d, any_hit=w["any_hit"], leaf_k=leaf_k), 1, 3))
        ms = statistics.median(cuda_ms(lambda: traverse.trace_rays(
            qn, o, d, any_hit=w["any_hit"], leaf_k=leaf_k), FRAMES, 3))
        path_ms = statistics.median(cuda_ms(lambda: traverse.trace_rays(
            qn, w["o"], w["d"], any_hit=w["any_hit"], leaf_k=leaf_k, active=w["active"],
            scattered=w["scattered"]), 3, 3))
        b_ms, b_by, detail = bound(counts, 1.0, n * (OUT_BYTES + RAY_BYTES))
        pb_ms, pb_by, p_detail = bound(counts, n_live / n,
                                       r * OUT_BYTES + n_live * RAY_BYTES + r)
        wave_stats.setdefault(name, []).append({
            **stats, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_detail": detail,
            "path_ms": path_ms, "path_bound_ms": pb_ms, "path_bound_detail": p_detail,
            "active": n_live})
        log(f"[time] wave {i} {name} on its {n} checked rays: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by} {json.dumps(detail)} on {card}")
        log(f"[time] wave {i} {name} whole: {path_ms:.4f} ms for {r} lanes ({n_live} active) "
            f"= {n_live / path_ms / 1e3:.2f} M active rays/s; bound {pb_ms:.4f} ms by {pb_by} "
            f"{json.dumps(p_detail)} on {card}")
    want = {closest: BOUNCES - 1}
    want[occlusion] = want.get(occlusion, 0) + BOUNCES
    if {name: len(ws) for name, ws in wave_stats.items()} != want:
        fail(f"captured waves {[(k, len(v)) for k, v in wave_stats.items()]}, expected {want}")
    for name in wave_stats:
        mine = [(w, p) for w, p in zip(waves, picks) if (occlusion if w["any_hit"] else closest)
                == name]
        register_row(env, name, lambda core, mine=mine: [traverse.trace_rays(
            qn, o, d, any_hit=w["any_hit"], leaf_k=leaf_k, core=core) for w, (o, d) in mine],
            lambda core, mine=mine: [traverse.trace_rays(
                qn, w["o"], w["d"], any_hit=w["any_hit"], leaf_k=leaf_k, active=w["active"],
                scattered=w["scattered"], core=core) for w, _ in mine])
    return wave_stats


def register_row(env: dict, name: str, checked, path) -> None:
    """Keep the calls that a kernels-line row times — ``checked(core)`` on its
    checked rays, ``path(core)`` on its main path — for phase 28, which times
    both with the baseline core beside the redesigned one. The first
    registration of a name is its row's."""
    env.setdefault("row_calls", {}).setdefault(name, (checked, path))


def summed(details: list[dict]) -> tuple[float, str]:
    """The bound of several launches run one after another: the sum of their
    bounds, labelled by the larger of its bytes and its operations parts."""
    by_bytes = sum(max(x["bytes_ms"], x["ops_ms"]) for x in details
                   if x["bytes_ms"] >= x["ops_ms"])
    total = sum(max(x["bytes_ms"], x["ops_ms"]) for x in details)
    return total, ("bytes" if 2 * by_bytes >= total else "operations")


def wave_row(ws: list[dict], launches: int) -> dict:
    """The kernels-line row of a ray kernel from its waves' numbers."""
    b_ms, b_by = summed([s["bound_detail"] for s in ws])
    pb_ms, pb_by = summed([s["path_bound_detail"] for s in ws])
    return {"launches": launches, "max_abs_err": max(s["max_abs_err"] for s in ws),
            "rays": sum(s["rays"] for s in ws), "ms": sum(s["ms"] for s in ws),
            "plain_ms": sum(s["plain_ms"] for s in ws), "bound_ms": b_ms, "bound_by": b_by,
            "path_rays": sum(s["active"] for s in ws),
            "path_ms": sum(s["path_ms"] for s in ws), "path_bound_ms": pb_ms,
            "path_bound_by": pb_by, "waves_path_ms": [s["path_ms"] for s in ws]}


def check_images(images: dict, dev) -> dict:
    """rgba8 frames of the full size with alpha 255 → each one's share of
    pixels that are not the miss colour."""
    from raytracer_tpu_torch.ops.shade import MISS_COLOR, quantize_rgba8

    miss_u8 = int(quantize_rgba8(torch.full((1, 3), MISS_COLOR))[0, 0])
    hit_rates = {}
    for name, img in images.items():
        if img.shape != (HEIGHT, WIDTH, 4) or img.dtype != torch.uint8 or img.device != dev:
            fail(f"{name} image is {tuple(img.shape)} {img.dtype} on {img.device}")
        if not bool((img[..., 3] == 255).all()):
            fail(f"{name} image alpha is not 255 everywhere")
        hit_rates[name] = float((img[..., 0] != miss_u8).float().mean())
    return hit_rates


def progressive_samples(pt, want: dict, what: str) -> torch.Tensor:
    """SAMPLES × render_progressive(bounces=BOUNCES) and present_progressive
    from the framed view: the launches must be ``want`` and nothing else, the
    frame count SAMPLES, the buffer a finite non-negative (H, W, 3) image.
    Then one more sample under torch's sync debug mode."""
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.ops.shade import MISS_COLOR

    pt.set_camera_position(*FRAMED)
    torch.cuda.synchronize()
    traverse.reset_launches()
    for _ in range(SAMPLES):
        accum = pt.render_progressive(bounces=BOUNCES)
    shown = pt.present_progressive()
    torch.cuda.synchronize()
    launches = dict(traverse.LAUNCHES)
    log(f"[{what}] launches during {SAMPLES} x render_progressive(bounces={BOUNCES}) + "
        f"present_progressive: {json.dumps(launches)}")
    if launches != want:
        fail(f"{what}: progressive launches {launches}, expected {want}")
    if pt.frame_count != SAMPLES:
        fail(f"{what}: frame_count {pt.frame_count} after {SAMPLES} samples")
    if accum.shape != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(accum).all()
                                                     & (accum >= 0).all()):
        fail(f"{what}: the accumulation buffer is not a finite non-negative (H, W, 3) image")
    if shown.shape != (HEIGHT, WIDTH, 4) or shown.dtype != torch.uint8:
        fail(f"{what}: present_progressive gave {tuple(shown.shape)} {shown.dtype}")
    log(f"[{what}] frame_count {pt.frame_count}; mean radiance "
        f"{float(accum.mean()):.6f}, max {float(accum.max()):.6f}; background share "
        f"{float((accum[..., 0] == MISS_COLOR).float().mean()):.4f}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        pt.render_progressive(bounces=BOUNCES)
    except RuntimeError as exc:
        fail(f"{what}: render_progressive waited for the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log(f"[{what}] render_progressive(bounces={BOUNCES}) issued without a host-device "
        "synchronisation")
    return accum


def main() -> None:
    # 1. the device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from raytracer_tpu_torch import PathTracer, Scene, render_pt
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.ops.shade import quantize_rgba8, shade_lambert
    from raytracer_tpu_torch.utils import procgen

    dev = torch.device("cuda:0")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| python {sys.version.split()[0]}")

    # 2. the builds
    build_all()

    # 3. the primary-ray main path
    glb = ROOT / "data" / "dragon_standin.glb"
    if not glb.exists():
        glb.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procgen.write_glb(glb, procgen.make_dragon_stand_in())
        log(f"[main] wrote {glb.name} in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    scene = Scene().load_glb(glb, normalize=True, mode="cube")
    log(f"[main] ingest {scene.num_triangles} triangles in {time.perf_counter() - t0:.2f} s")
    if scene.num_triangles != DRAGON_TRIANGLES:
        fail(f"{glb} holds {scene.num_triangles} triangles, not the {DRAGON_TRIANGLES} of the "
             "dragon stand-in: delete it, and it is written anew")
    pt = PathTracer(WIDTH, HEIGHT, builder="sah", leaf_size=LEAF_K, device=dev)
    t0 = time.perf_counter()
    pt.set_scene(scene)
    qn = pt._qnodes
    tris = pt._tris_dev
    log(f"[main] set_scene in {time.perf_counter() - t0:.2f} s: {json.dumps(pt.build_stats)}; "
        f"records {tuple(qn.shape)} = {qn.numel() * 4 / 2**20:.1f} MiB")
    records_phase(pt, card)

    pt.set_camera_quaternion(*QUAT)
    pt.fov_degrees = FOV
    torch.cuda.synchronize()
    traverse.reset_launches()
    pt.set_camera_position(*FRAMED)
    img_framed = pt.render()
    pt.set_camera_position(*SPARSE)
    img_sparse = pt.render()
    pt.set_camera_position(*FRAMED)
    presented = pt.render_presented()
    torch.cuda.synchronize()
    render_launches = dict(traverse.LAUNCHES)
    log(f"[main] launches during render/render_presented: {json.dumps(render_launches)}")
    if render_launches != expected(trace_tiles_k1a=3):
        fail(f"the primary path launched {render_launches}, expected 3 K1a and nothing else")
    hit_rates = check_images({"framed": img_framed, "sparse": img_sparse,
                              "presented": presented}, dev)
    log(f"[main] hit rate (pixels not the miss color): framed {hit_rates['framed']:.4f}, "
        f"sparse {hit_rates['sparse']:.4f}")
    if hit_rates["framed"] < MIN_FRAMED_HIT_RATE:
        fail(f"framed hit rate {hit_rates['framed']:.3f} < {MIN_FRAMED_HIT_RATE}")

    # the rays every check below shares: the centre crop, the seeded pixels
    # held against brute force, and the seeded pixels that size the bounds
    r0, c0 = (HEIGHT - CROP) // 2, (WIDTH - CROP) // 2
    rows = torch.arange(r0, r0 + CROP, device=dev)
    cols = torch.arange(c0, c0 + CROP, device=dev)
    crop_pix = (rows[:, None] * WIDTH + cols[None, :]).reshape(-1)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    sample = torch.randperm(WIDTH * HEIGHT, generator=gen)[:BRUTE_SAMPLES].to(dev)
    bound_pix = torch.randperm(WIDTH * HEIGHT, generator=gen)[:WAVE_SAMPLES].to(dev)
    env = {"qn": qn, "tris": tris, "card": card, "dev": dev, "crop_pix": crop_pix,
           "crop_dirs": frame_dirs(crop_pix), "r0": r0, "c0": c0, "sample": sample,
           "bound_pix": bound_pix,
           "origin": torch.tensor(FRAMED, dtype=torch.float32, device=dev),
           "images": {"framed": img_framed, "sparse": img_sparse}}

    # 4., 5. K1a vs its plain torch version on the framed view's centre crop
    # and vs the brute-force tracer on seeded framed-view pixels
    k1a = check_tiles(env, qn, "K1a", jitter=False)
    hit_plane = float((k1a["planes"][4] >= 0).float().mean())
    if hit_plane != hit_rates["framed"]:
        fail(f"image hit rate {hit_rates['framed']} != kernel tri plane {hit_plane}")
    ker, ref = k1a["ker"], k1a["ref"]
    ref_rgb = quantize_rgba8(shade_lambert(torch.stack(ref[1:4], -1), ref[4] >= 0))
    img_crop = img_framed.reshape(-1, 4)[crop_pix]
    same = ker[4] == ref[4]
    rgb_err = int((img_crop[same].int() - ref_rgb[same].int()).abs().max())
    log(f"[check] render() vs plain shading on the crop: max rgba8 diff {rgb_err} "
        f"on {int(same.sum())} same-tri pixels")
    if rgb_err > 1:
        fail(f"render() differs from the plain version's shading by {rgb_err} LSB")

    # 6. K1b (jittered) vs its plain version on the crop and vs brute force
    k1b = check_tiles(env, qn, "K1b", jitter=True)

    # 7. the progressive main path
    pt_want = expected(trace_tiles_k1b=SAMPLES, trace_rays_k2a=SAMPLES * (BOUNCES - 1),
                       trace_rays_k2b=SAMPLES * BOUNCES)
    progressive_samples(pt, pt_want, "progressive")
    pt.set_camera_position(*MOVED)
    pt.render_progressive(bounces=BOUNCES)
    if pt.frame_count != 1:
        fail(f"frame_count {pt.frame_count} after a camera move: no reset")
    pt.set_camera_position(*FRAMED)
    torch.cuda.synchronize()
    traverse.reset_launches()
    for _ in range(SAMPLES):
        aa = pt.render_progressive(bounces=0)
    torch.cuda.synchronize()
    aa_launches = dict(traverse.LAUNCHES)
    log(f"[progressive] launches during {SAMPLES} x render_progressive(bounces=0): "
        f"{json.dumps(aa_launches)}")
    if aa_launches != expected(trace_tiles_k1b=SAMPLES):
        fail(f"bounces=0 launches {aa_launches}, expected {SAMPLES} K1b")
    if pt.frame_count != SAMPLES or not bool(torch.isfinite(aa).all() & (aa >= 0).all()):
        fail("bounces=0: wrong frame_count or a non-finite/negative buffer")
    torch.cuda.set_sync_debug_mode("error")
    try:
        pt.render_progressive(bounces=0)
    except RuntimeError as exc:
        fail(f"render_progressive(bounces=0) waited for the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log("[progressive] render_progressive(bounces=0) issued without a host-device "
        "synchronisation")

    # 8. K2a/K2b vs their plain versions on every wave of one 1080p sample
    waves, sample_stats = capture_waves(env, qn)
    alive_rays = int(sample_stats["alive_rays"])
    wave_stats = check_waves(env, qn, waves, "trace_rays_k2a", "trace_rays_k2b")
    env["waves"] = {LEAF_K: waves}  # for phase 28

    # 9. one whole 256x256 sample: kernels vs plain versions
    def plain_tiles(qnodes, cam_pos, cam_quat, width, height, fov_degrees=70.0, leaf_k=1,
                    jitter=False, jitter_seed=0):
        return traverse.trace_tiles_reference(qnodes, cam_pos, cam_quat, width, height,
                                              fov_degrees, leaf_k, jitter=jitter,
                                              jitter_seed=jitter_seed)

    def plain_rays(qnodes, origins, dirs, *, any_hit=False, leaf_k, active=None,
                   scattered=False):
        return traverse.trace_rays_reference(qnodes, origins, dirs, any_hit=any_hit,
                                             leaf_k=leaf_k, active=active)

    def small_sample():
        return render_pt.pt_sample_frame(
            qn, tris, FRAMED, QUAT, CROP, CROP, bounces=BOUNCES, fov_degrees=FOV,
            leaf_k=LEAF_K, tile_primary=True,
            generator=torch.Generator(device=dev).manual_seed(SAMPLE_SEED))

    by_kernels = small_sample()
    real = (render_pt.trace_tiles, render_pt.trace_rays)
    render_pt.trace_tiles, render_pt.trace_rays = plain_tiles, plain_rays
    try:
        by_plain, whole_plain_ms = timed_once(small_sample)
    finally:
        render_pt.trace_tiles, render_pt.trace_rays = real
    err = (by_kernels - by_plain).abs().amax(-1)
    share = float((err <= RADIANCE_ATOL).float().mean())
    log(f"[check] whole {CROP}x{CROP} sample, kernels vs plain: {share:.6f} of pixels within "
        f"{RADIANCE_ATOL} (max |d| {float(err.max()):.3g}); plain sample {whole_plain_ms:.1f} ms")
    if share < MIN_RADIANCE_MATCH or not bool(torch.isfinite(by_kernels).all()):
        fail(f"whole sample: {share:.6f} < {MIN_RADIANCE_MATCH} of pixels within {RADIANCE_ATOL}")

    # 10. times and bounds
    rows = {"trace_tiles_k1a": time_tiles(env, qn, "K1a", False, k1a,
                                          render_launches["trace_tiles_k1a"]),
            "trace_tiles_k1b": time_tiles(env, qn, "K1b", True, k1b,
                                          pt_want["trace_tiles_k1b"])}
    sparse_reps = cuda_ms(lambda: traverse.trace_tiles(
        qn, SPARSE, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K), FRAMES, REPEATS)
    log(f"[time] K1a sparse 1920x1080: {statistics.median(sparse_reps):.4f} ms/frame = "
        f"{WIDTH * HEIGHT / statistics.median(sparse_reps) / 1e3:.2f} Mrays/s "
        f"(reps {[round(r, 4) for r in sparse_reps]}) on {card}")
    window = traverse.trace_tiles(qn, FRAMED, QUAT, CROP, CROP, FOV, leaf_k=LEAF_K,
                                  raygen_size=(WIDTH, HEIGHT), row_offset=r0, col_offset=c0)
    if not all(torch.equal(w.reshape(-1), k) for w, k in zip(window, ker)):
        fail("the kernel's crop window differs from the same pixels of its full frame")

    sample_reps = {}
    for b in (BOUNCES, 0):
        pt.set_camera_position(*FRAMED)
        sample_reps[b] = cuda_ms(lambda b=b: pt.render_progressive(bounces=b), SAMPLES, 3)
        ms = statistics.median(sample_reps[b])
        rays = WIDTH * HEIGHT * max(b, 1) * (2 if b else 1)
        extra = (f", alive {alive_rays / ms / 1e3:.2f} Mrays/s" if b else "")
        log(f"[time] render_progressive(bounces={b}) 1920x1080: {ms:.4f} ms/sample = "
            f"{rays / ms / 1e3:.2f} Mrays/s (W*H*{'bounces*2' if b else '1'}){extra} "
            f"(reps {[round(r, 4) for r in sample_reps[b]]}) on {card}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pt.render_progressive(bounces=BOUNCES)
    torch.cuda.synchronize()
    log(f"[time] one synchronised render_progressive(bounces={BOUNCES}): "
        f"{(time.perf_counter() - t0) * 1e3:.4f} ms host clock on {card}")
    log(f"[mem] peak device memory allocated: "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    for name in ("trace_rays_k2a", "trace_rays_k2b"):
        rows[name] = wave_row(wave_stats[name], pt_want[name])
    k1b_ms = rows["trace_tiles_k1b"]["path_ms"]
    k2_ms = rows["trace_rays_k2a"]["path_ms"] + rows["trace_rays_k2b"]["path_ms"]
    log(f"[time] traversal kernels per 1080p sample: K1b {k1b_ms:.4f} ms + K2a "
        f"{rows['trace_rays_k2a']['path_ms']:.4f} ms + K2b "
        f"{rows['trace_rays_k2b']['path_ms']:.4f} ms = {k1b_ms + k2_ms:.4f} ms of "
        f"{statistics.median(sample_reps[BOUNCES]):.4f} ms per sample on {card}")

    # 11. where the time of a progressive sample goes
    pt.set_camera_position(*FRAMED)
    profile_calls(lambda: pt.render_progressive(bounces=BOUNCES),
                  f"render_progressive(bounces={BOUNCES})", card)

    # 20.-24. depth bounds and entry nodes (K1d)
    rows["trace_tiles_k1d"] = bounded_phase(env, pt)

    # 12.-14. the frame batch, the dynamic dragon and config 5
    rows["trace_tiles_k1c"] = batch_phase(env)
    dynamic_phase(env, pt)
    config5_phase(env)
    del pt

    # 15.-19. the 8-wide tree and the visits plane
    rows.update(wide8_phase(env, scene))

    # 25.-26. the Morton LBVH trees (K = 1, K = 8) and the leaf-size question
    trees = lbvh_phase(env, scene)
    leaf_phase(env, trees)

    # 28. the redesigned kernels against the frozen baseline core
    hopper_phase(env, trees, rows)
    del trees

    # 29. the apps and the rest of the build chain
    apps_phase(env, scene)

    # 27. the microbenchmark kernels
    mb_rows = microbench_phase(env)

    log(card)
    sources = {**KERNELS, **MB_KERNELS}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": sources[name][0],
        "replaces": sources[name][1], **row, "library_ms": None,
    } for name, row in {**rows, **mb_rows}.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


def host_issue_ms(fn, n: int = 8) -> tuple[float, float]:
    """(ms the host takes to issue one call of ``fn``, ms until the card has
    finished it), on the host clock over ``n`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return issued * 1e3 / n, (time.perf_counter() - t0) * 1e3 / n


def differing_words(a, b) -> int:
    """The 32-bit words in which two tuples of planes differ."""
    return sum(int((x.view(torch.int32) != y.view(torch.int32)).sum()) for x, y in zip(a, b))


def check_bounded_against(ker, ref, bpix: torch.Tensor, tris, origin, dirs, what: str) -> dict:
    """K1d's contract on flat planes against its plain version's, ``bpix``
    each ray's bound: the same rays hit; on those the closest-hit tolerances;
    on the others t = the bound exactly, a zero normal and tri = −1."""
    from raytracer_tpu_torch.ops.camera import INF

    miss = ker[4] < 0
    if not torch.equal(miss, ref[4] < 0):
        fail(f"{what}: hit/miss differs on {int((miss != (ref[4] < 0)).sum())} rays")
    for name, planes in (("the kernel", ker), ("the plain version", ref)):
        if not torch.equal(planes[0][miss], bpix[miss]):
            fail(f"{what}: {name} must report t = the tile's bound where it finds no hit")

    def unbounded(planes):
        return [torch.where(miss, torch.full_like(planes[0], INF), planes[0]), *planes[1:]]

    stats = check_against(unbounded(ker), unbounded(ref), tris, origin, dirs, what)
    stats["no_hit_under_a_bound"] = int((miss & (bpix < INF)).sum())
    return stats


def node_depths(wide) -> torch.Tensor:
    """The depth of every internal node of a wide tree below its root (−1
    for rows that no node refers to)."""
    cref = wide.cref.long()
    depth = torch.full((cref.shape[0],), -1, dtype=torch.int64, device=cref.device)
    frontier = torch.zeros(1, dtype=torch.int64, device=cref.device)
    level = 0
    while frontier.numel():
        depth[frontier] = level
        kids = cref[frontier].reshape(-1)
        frontier = kids[(kids >= 0) & ((kids & (1 << 30)) == 0)]
        level += 1
    return depth


def bounded_phase(env: dict, pt) -> dict:
    """20.–24. Depth bounds and entry nodes on the dragon at 1920x1080 → the
    kernels-line row of K1d."""
    from raytracer_tpu_torch import render
    from raytracer_tpu_torch.ops.camera import INF, generate_rays, primary_dirs, to_device
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.ops.cuda.entry import compute_tile_entries
    from raytracer_tpu_torch.ops.cuda.traverse import TILE

    qn, tris, card, dev, origin = env["qn"], env["tris"], env["card"], env["dev"], env["origin"]
    rays = WIDTH * HEIGHT
    nty, ntx = -(-HEIGHT // TILE), -(-WIDTH // TILE)
    wide = pt._wide_bvh()
    slack = {"default": (1.05, 0.02), "halved": (0.5, 0.0)}  # bound = scale * depth + pad

    def tiles(pos=FRAMED, **kw):
        return traverse.trace_tiles(qn, pos, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K, **kw)

    def frame_bounds(pos, scale=1.05, pad=0.02):
        return render._coarse_bounds(qn, pos, QUAT, WIDTH, HEIGHT, FOV, LEAF_K, 8, scale, pad)

    def frame_entries(pos):
        return compute_tile_entries(wide, pos, QUAT, WIDTH, HEIGHT, tile=TILE, fov_degrees=FOV)

    def bounded(pos=FRAMED, scale=1.05, pad=0.02, **kw):
        return render.trace_tiles_bounded(qn, pos, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K,
                                          _bound_scale=scale, _bound_pad=pad, **kw)

    # 20. K1d against its plain version on a crop whose corner is a multiple
    # of the tile, under the frame's own bounds and entries, and halved bounds
    bounds, entries = frame_bounds(FRAMED), frame_entries(FRAMED)
    if bounds.shape != (nty, ntx) or entries.shape != (HEIGHT // TILE, WIDTH // TILE):
        fail(f"bounds {tuple(bounds.shape)} / entries {tuple(entries.shape)} of the 1080p frame")
    r0, c0, nt = env["r0"] // TILE * TILE, env["c0"] // TILE * TILE, CROP // TILE
    crop_pix = (torch.arange(r0, r0 + CROP, device=dev)[:, None] * WIDTH
                + torch.arange(c0, c0 + CROP, device=dev)[None, :]).reshape(-1)
    crop_dirs = frame_dirs(crop_pix)
    ty, tx = r0 // TILE, c0 // TILE
    window_kw = dict(leaf_k=LEAF_K, raygen_size=(WIDTH, HEIGHT), row_offset=r0, col_offset=c0,
                     entries=entries[ty:ty + nt, tx:tx + nt])
    ref_kw = dict(leaf_k=LEAF_K, pixels=crop_pix)
    checked = {}
    for label, b in (("the frame's bounds", bounds),
                     ("halved bounds", frame_bounds(FRAMED, *slack["halved"]))):
        planes = tiles(entries=entries, tbounds=b)
        counts = traverse.TraversalCounts()
        ref = traverse.trace_tiles_reference(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, counts=counts,
                                             entries=entries, tbounds=b, **ref_kw)
        ker = [p.reshape(-1)[crop_pix] for p in planes]
        bpix = b[crop_pix // WIDTH // TILE, crop_pix % WIDTH // TILE]
        stats = check_bounded_against(ker, ref, bpix, tris, origin, crop_dirs,
                                      f"K1d vs plain, 256x256 crop, {label} and the entries")
        window = traverse.trace_tiles(qn, FRAMED, QUAT, CROP, CROP, FOV,
                                      tbounds=b[ty:ty + nt, tx:tx + nt], **window_kw)
        if not all(torch.equal(w.reshape(-1), k) for w, k in zip(window, ker)):
            fail(f"K1d's crop window ({label}) differs from the same pixels of its full frame")
        checked[label] = {"stats": stats, "counts": counts}
    if checked["halved bounds"]["stats"]["no_hit_under_a_bound"] == 0:
        fail("halved bounds cut no hit on the crop: the check of t = bound is empty")
    no_bounds = dict(entries=torch.zeros_like(entries), tbounds=torch.full_like(bounds, INF))
    for what, kw in (("K1a", {}), ("K1b", dict(jitter=True, jitter_seed=JITTER_SEED)),
                     ("K1f", dict(stats=True))):
        words = differing_words(tiles(**kw), tiles(**kw, **no_bounds))
        log(f"[check] {what} against K1d with all-1e30 bounds and all-0 entries, whole frame: "
            f"{words} differing words")
        if words:
            fail(f"all-1e30 bounds and all-0 entries change {what}'s frame in {words} words")

    # 21. the bounded trace at full size
    k1d_launches = 0
    n_repair = {}
    for view, pos in (("framed", FRAMED), ("sparse", SPARSE)):
        free = tiles(pos)
        for label, knobs in slack.items():
            torch.cuda.synchronize()
            traverse.reset_launches()
            out = bounded(pos, *knobs)
            torch.cuda.synchronize()
            launches = dict(traverse.LAUNCHES)
            if launches != expected(trace_tiles_k1a=1, trace_tiles_k1d=1, trace_rays_k2a=1):
                fail(f"the bounded trace launched {launches}, expected 1 K1a + 1 K1d + 1 K2a")
            k1d_launches += launches["trace_tiles_k1d"]
            words = differing_words(out[:5], free)
            finite = float((frame_bounds(pos, *knobs) < INF).float().mean())
            n_repair[view, label] = int(out[5])
            log(f"[bounded] {view}, {label} bounds: {words} words differ from trace_tiles; "
                f"n_repair {n_repair[view, label]} of {rays} pixels; {finite:.4f} of the "
                f"{nty * ntx} tiles bounded; launches {json.dumps(launches)}")
            if words:
                fail(f"the bounded trace ({view}, {label}) differs from trace_tiles in {words} "
                     "words")
    if n_repair["framed", "halved"] == 0:
        fail("halved bounds forced no repair on the framed view")
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = bounded(entries=entries)
    except RuntimeError as exc:
        fail(f"trace_tiles_bounded waited for the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if differing_words(out[:5], tiles()):
        fail("the bounded trace with entries differs from trace_tiles")
    log("[bounded] trace_tiles_bounded (with entries) issued without a host-device "
        "synchronisation, and equals trace_tiles")
    s_dirs = frame_dirs(env["sample"])
    check_against([p.reshape(-1)[env["sample"]] for p in out[:5]],
                  brute_planes(tris, origin, s_dirs), tris, origin, s_dirs,
                  f"bounded trace vs brute force, {BRUTE_SAMPLES} framed pixels")

    # 22. the entries at full size
    depth = node_depths(wide)
    for view, pos in (("framed", FRAMED), ("sparse", SPARSE)):
        e = frame_entries(pos)
        below = e != 0
        mean_depth = float(depth[e[below].long()].float().mean()) if bool(below.any()) else 0.0
        words = differing_words(tiles(pos, entries=e), tiles(pos))
        log(f"[entries] {view}: {float(below.float().mean()):.4f} of the {e.numel()} whole tiles "
            f"start below the root, at mean depth {mean_depth:.3f}; {words} words differ from "
            "trace_tiles")
        if words:
            fail(f"the entries change the {view} frame in {words} words")
    pt.set_camera_position(*FRAMED)
    plain_img = pt.render()
    pt.use_tile_entries = True
    torch.cuda.synchronize()
    traverse.reset_launches()
    entry_img = pt.render()
    torch.cuda.synchronize()
    launches = dict(traverse.LAUNCHES)
    if launches != expected(trace_tiles_k1d=1):
        fail(f"render() with use_tile_entries launched {launches}, expected 1 K1d")
    k1d_launches += launches["trace_tiles_k1d"]
    if not torch.equal(entry_img, plain_img):
        fail("render() with use_tile_entries differs from render() without")
    small = pt.render_stream(2)
    box = pt._render_planes()[0].double().reshape(HEIGHT // 2, 2, WIDTH // 2, 2, 3).mean((1, 3))
    if (small.shape != (HEIGHT // 2, WIDTH // 2, 3) or small.dtype != torch.uint8
            or int((small.int() - torch.round(box.clamp(0, 1) * 255).int()).abs().max()) > 1):
        fail("render_stream(2) is not the 2x2 box filter of the frame within 1 LSB")
    log("[entries] PathTracer.render() with use_tile_entries: 1 K1d launch, byte-equal to "
        f"without; render_stream(2) {tuple(small.shape)} uint8")

    # 23. the temporal trace over successive seeds
    def k1b(seed):
        return tiles(jitter=True, jitter_seed=seed)

    def temporal(prev, seed):
        return render.trace_tiles_temporal(qn, FRAMED, QUAT, WIDTH, HEIGHT, prev[0], prev[4],
                                           seed, FOV, leaf_k=LEAF_K)

    prev = k1b(JITTER_SEED)
    t_repair = []
    for seed in range(JITTER_SEED + 1, JITTER_SEED + 5):
        want = k1b(seed)
        torch.cuda.synchronize()
        traverse.reset_launches()
        out = temporal(prev, seed)
        torch.cuda.synchronize()
        launches = dict(traverse.LAUNCHES)
        if launches != expected(trace_tiles_k1d=1, trace_rays_k2a=1):
            fail(f"the temporal trace launched {launches}, expected 1 K1d + 1 K2a")
        k1d_launches += launches["trace_tiles_k1d"]
        if differing_words(out[:5], want):
            fail(f"the temporal trace of seed {seed} differs from K1b's")
        t_repair.append(int(out[5]))
        prev = out
    log(f"[temporal] 4 successive samples each bit-identical to K1b for its seed; n_repair "
        f"{t_repair}; launches per sample {json.dumps(launches)}")

    # 24. the measurement
    log(f"[A/B] bounds and entries against the plain kernels, 1920x1080, K = {LEAF_K}, order "
        f"A-B-B-A, on {card}")

    def compacting(pos):
        """The bounded trace with another repair: the lanes to repair are read
        back (one synchronisation a frame) and only their rays are made."""
        planes = tiles(pos, tbounds=frame_bounds(pos))
        need = (planes[4] < 0) & (planes[0] < INF)
        idx = torch.nonzero(need.reshape(-1)).squeeze(1)
        if idx.numel():
            d = primary_dirs(idx % WIDTH, idx // WIDTH, WIDTH, HEIGHT, QUAT, FOV)
            o = to_device(pos, dev).expand(idx.numel(), 3).contiguous()
            for p, f in zip(planes, traverse.trace_rays(qn, o, d, leaf_k=LEAF_K)):
                p.reshape(-1)[idx] = f
        return planes

    for view, pos in (("framed", FRAMED), ("sparse", SPARSE)):
        if differing_words(compacting(pos), tiles(pos)):
            fail(f"the compacting repair's {view} frame differs from trace_tiles")
        b, e = frame_bounds(pos), frame_entries(pos)
        visits = {name: int(tiles(pos, stats=True, **kw)[5].sum(dtype=torch.float64))
                  for name, kw in (("none", {}), ("bounds", dict(tbounds=b)),
                                   ("entries", dict(entries=e)),
                                   ("both", dict(tbounds=b, entries=e)))}
        ms = abba({"K1a": lambda: tiles(pos), "bounded": lambda: bounded(pos)}, FRAMES, REPEATS)
        alt = abba({"masked repair": lambda: bounded(pos),
                    "compacting repair": lambda: compacting(pos)}, FRAMES, REPEATS)
        ent = abba({"K1a": lambda: tiles(pos),
                    "entries + K1d": lambda: tiles(pos, entries=frame_entries(pos))},
                   FRAMES, REPEATS)
        parts = {"probe K1a 240x135 + bounds": lambda: frame_bounds(pos),
                 "K1d, bounds given": lambda: tiles(pos, tbounds=b),
                 "K1d, entries given": lambda: tiles(pos, entries=e),
                 "K1d, both given": lambda: tiles(pos, tbounds=b, entries=e),
                 "compute_tile_entries": lambda: frame_entries(pos),
                 "generate_rays": lambda: generate_rays(WIDTH, HEIGHT, pos, QUAT, FOV, device=dev)}
        part_ms = {k: statistics.median(cuda_ms(fn, FRAMES, 3)) for k, fn in parts.items()}
        log(f"[A/B] {view}: K1a {ms['K1a']:.4f} ms = {rays / ms['K1a'] / 1e3:.2f} Mrays/s; "
            f"trace_tiles_bounded {ms['bounded']:.4f} ms = {rays / ms['bounded'] / 1e3:.2f} "
            f"Mrays/s, ratio {ms['bounded'] / ms['K1a']:.4f}; n_repair "
            f"{n_repair[view, 'default']}")
        log(f"[A/B] {view}: masked repair {alt['masked repair']:.4f} ms against compacting "
            f"repair {alt['compacting repair']:.4f} ms a frame")
        log(f"[A/B] {view}: K1a {ent['K1a']:.4f} ms against compute_tile_entries + K1d "
            f"{ent['entries + K1d']:.4f} ms, ratio {ent['entries + K1d'] / ent['K1a']:.4f}")
        log(f"[A/B] {view} passes alone: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in part_ms.items()))
        log(f"[A/B] {view} visits a frame (K1f): "
            + ", ".join(f"{k} {v} ({v / visits['none']:.4f})" for k, v in visits.items()))
        for what, fn in (("trace_tiles (K1a)", lambda: tiles(pos)),
                         ("trace_tiles_bounded", lambda: bounded(pos)),
                         ("compute_tile_entries + K1d",
                          lambda: tiles(pos, entries=frame_entries(pos)))):
            issue, done = host_issue_ms(fn)
            log(f"[A/B] {view} {what}: host issues a call in {issue:.4f} ms, done in "
                f"{done:.4f} ms a call (host clock, 8 calls) on {card}")
            profile_calls(fn, f"{view} {what}", card)
        if view == "framed":
            path_ms = part_ms["K1d, both given"]

    seeds = iter(range(JITTER_SEED + 10, JITTER_SEED + 10_000))
    state = {"prev": k1b(JITTER_SEED)}

    def temporal_step():
        state["prev"] = temporal(state["prev"], next(seeds))

    tms = abba({"K1b": lambda: k1b(next(seeds)), "temporal": temporal_step}, FRAMES, REPEATS)
    log(f"[A/B] framed jittered sample: K1b {tms['K1b']:.4f} ms against trace_tiles_temporal "
        f"{tms['temporal']:.4f} ms, ratio {tms['temporal'] / tms['K1b']:.4f}")
    issue, done = host_issue_ms(temporal_step)
    log(f"[A/B] trace_tiles_temporal: host issues a call in {issue:.4f} ms, done in {done:.4f} "
        f"ms a call on {card}")
    profile_calls(temporal_step, "trace_tiles_temporal", card)

    # the work on the crop, as the plain version counts it
    work = {"bounds + entries": checked["the frame's bounds"]["counts"]}
    for name, kw in (("none", {}), ("bounds", dict(tbounds=bounds)),
                     ("entries", dict(entries=entries))):
        work[name] = traverse.TraversalCounts()
        traverse.trace_tiles_reference(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, counts=work[name],
                                       **ref_kw, **kw)
    log("[A/B] framed 256x256 crop, plain version's counts: "
        + ", ".join(f"{k}: {c.visits} visits, {c.mt_tests} MT tests" for k, c in work.items()))

    # K1d's row: the crop under the frame's bounds and entries; the frame
    crop_tb = bounds[ty:ty + nt, tx:tx + nt]
    ms = statistics.median(cuda_ms(lambda: traverse.trace_tiles(
        qn, FRAMED, QUAT, CROP, CROP, FOV, tbounds=crop_tb, **window_kw), FRAMES, REPEATS))
    register_row(env, "trace_tiles_k1d", lambda core: traverse.trace_tiles(
        qn, FRAMED, QUAT, CROP, CROP, FOV, tbounds=crop_tb, core=core, **window_kw),
        lambda core: tiles(entries=entries, tbounds=bounds, core=core))
    plain_ms = statistics.median(cuda_ms(lambda: traverse.trace_tiles_reference(
        qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, entries=entries, tbounds=bounds, **ref_kw), 1, 3))
    table_bytes = 2 * 4 * nty * ntx
    crop_bound = bound(work["bounds + entries"], 1.0, crop_pix.numel() * OUT_BYTES + table_bytes)
    counts = traverse.TraversalCounts()
    traverse.trace_tiles_reference(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K,
                                   pixels=env["bound_pix"], counts=counts, entries=entries,
                                   tbounds=bounds)
    frame_bound = bound(counts, rays / WAVE_SAMPLES, rays * OUT_BYTES + table_bytes)
    log(f"[time] K1d framed 256x256 crop: kernel {ms:.4f} ms, plain torch {plain_ms:.2f} ms "
        f"(median of 3), bound {crop_bound[0]:.4f} ms by {crop_bound[1]} "
        f"{json.dumps(crop_bound[2])}; framed 1080p frame {path_ms:.4f} ms, bound "
        f"{frame_bound[0]:.4f} ms by {frame_bound[1]} {json.dumps(frame_bound[2])} on {card}")
    pt.use_tile_entries = False
    return {"launches": k1d_launches,
            "max_abs_err": max(c["stats"]["max_abs_err"] for c in checked.values()),
            "rays": crop_pix.numel(), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": crop_bound[0], "bound_by": crop_bound[1], "path_rays": rays,
            "path_ms": path_ms, "path_bound_ms": frame_bound[0],
            "path_bound_by": frame_bound[1]}


def batch_cameras(z: float) -> tuple[list, list]:
    xs = torch.linspace(*CAM_XS, N_CAMS).tolist()
    return [(x, 0.0, z) for x in xs], [QUAT] * N_CAMS


def brute_planes(tris: torch.Tensor, origin: torch.Tensor, dirs: torch.Tensor):
    """Brute-force (t, nx, ny, nz, tri) of rays from one origin."""
    from raytracer_tpu_torch.ops.shade import triangle_normals
    from raytracer_tpu_torch.ops.trace import trace_rays_brute

    bt, btri = trace_rays_brute(tris, origin.expand(dirs.shape[0], 3), dirs)
    bn = torch.where((btri >= 0)[:, None], triangle_normals(tris, btri),
                     torch.zeros((dirs.shape[0], 3), device=dirs.device))
    return (bt, bn[:, 0], bn[:, 1], bn[:, 2], btri)


def batch_phase(env: dict) -> dict:
    """12. K1c on the dragon: launches, bit-identity with K1a/K1b, the plain
    version on two crops, times and bounds → its kernels-line row."""
    from raytracer_tpu_torch.ops.cuda import traverse

    qn, tris, card, dev = env["qn"], env["tris"], env["card"], env["dev"]
    crop_pix, r0, c0 = env["crop_pix"], env["r0"], env["c0"]
    cams, quats = batch_cameras(CAM_Z)
    seeds = [JITTER_SEED + f for f in range(N_CAMS)]
    torch.cuda.synchronize()
    traverse.reset_launches()
    batch = traverse.trace_tiles_batch(qn, cams, quats, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K)
    torch.cuda.synchronize()
    launches = dict(traverse.LAUNCHES)
    log(f"[batch] launches during one trace_tiles_batch of {N_CAMS} cameras: "
        f"{json.dumps(launches)}")
    if launches != expected(trace_tiles_k1c=1):
        fail(f"the batch launched {launches}, expected 1 K1c and nothing else")
    if any(p.shape != (N_CAMS, HEIGHT, WIDTH) for p in batch):
        fail(f"batch planes of shapes {[tuple(p.shape) for p in batch]}")
    if not all(bool(torch.isfinite(p).all()) for p in batch[:4]):
        fail("the batch holds non-finite values")
    jbatch = traverse.trace_tiles_batch(qn, cams, quats, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K,
                                        jitter=True, jitter_seeds=seeds)
    for f in range(N_CAMS):
        single = traverse.trace_tiles(qn, cams[f], QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K)
        jsingle = traverse.trace_tiles(qn, cams[f], QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K,
                                       jitter=True, jitter_seed=seeds[f])
        if not all(torch.equal(b[f], x) for b, x in zip(batch, single)):
            fail(f"K1c frame {f} differs from K1a for its camera")
        if not all(torch.equal(b[f], x) for b, x in zip(jbatch, jsingle)):
            fail(f"jittered K1c frame {f} differs from K1b with seed {seeds[f]}")
    hits = [float((batch[4][f] >= 0).float().mean()) for f in range(N_CAMS)]
    log(f"[check] K1c: all {N_CAMS} frames bit-identical to K1a, and jittered to K1b; "
        f"hit rates {[round(h, 4) for h in hits]}")

    ends = [0, N_CAMS - 1]
    crop_counts = traverse.TraversalCounts()
    ref = traverse.trace_tiles_batch_reference(qn, [cams[f] for f in ends], [QUAT, QUAT],
                                               WIDTH, HEIGHT, FOV, leaf_k=LEAF_K,
                                               pixels=crop_pix, counts=crop_counts)
    ker = [p[ends].reshape(len(ends), -1)[:, crop_pix].reshape(-1) for p in batch]
    origins = torch.tensor([cams[f] for f in ends], dtype=torch.float32, device=dev)
    origins = origins.repeat_interleave(crop_pix.numel(), dim=0)
    dirs = env["crop_dirs"].repeat(len(ends), 1)
    stats = check_against(ker, [p.reshape(-1) for p in ref], tris, origins, dirs,
                          "K1c vs plain, 256x256 crops of frames 0 and 7")
    window = traverse.trace_tiles_batch(qn, [cams[f] for f in ends], [QUAT, QUAT], CROP, CROP,
                                        FOV, leaf_k=LEAF_K, raygen_size=(WIDTH, HEIGHT),
                                        row_offset=r0, col_offset=c0)
    if not all(torch.equal(w.reshape(-1), k) for w, k in zip(window, ker)):
        fail("K1c's crop window differs from the same pixels of its full frames")

    crop_ms = statistics.median(cuda_ms(lambda: traverse.trace_tiles_batch(
        qn, [cams[f] for f in ends], [QUAT, QUAT], CROP, CROP, FOV, leaf_k=LEAF_K,
        raygen_size=(WIDTH, HEIGHT), row_offset=r0, col_offset=c0), FRAMES, REPEATS))
    register_row(env, "trace_tiles_k1c", lambda core: traverse.trace_tiles_batch(
        qn, [cams[f] for f in ends], [QUAT, QUAT], CROP, CROP, FOV, leaf_k=LEAF_K,
        raygen_size=(WIDTH, HEIGHT), row_offset=r0, col_offset=c0, core=core),
        lambda core: traverse.trace_tiles_batch(qn, cams, quats, WIDTH, HEIGHT, FOV,
                                                leaf_k=LEAF_K, core=core))
    plain_ms = statistics.median(cuda_ms(lambda: traverse.trace_tiles_batch_reference(
        qn, [cams[f] for f in ends], [QUAT, QUAT], WIDTH, HEIGHT, FOV, leaf_k=LEAF_K,
        pixels=crop_pix), 1, 3))
    cam_bytes = 16 * 4
    crop_bound = bound(crop_counts, 1.0, len(ends) * (crop_pix.numel() * OUT_BYTES + cam_bytes))
    log(f"[time] K1c on the 256x256 crops of frames 0 and 7: kernel {crop_ms:.4f} ms, plain "
        f"torch {plain_ms:.2f} ms (median of 3), bound {crop_bound[0]:.4f} ms by "
        f"{crop_bound[1]} {json.dumps(crop_bound[2])} on {card}")

    reps = cuda_ms(lambda: traverse.trace_tiles_batch(qn, cams, quats, WIDTH, HEIGHT, FOV,
                                                      leaf_k=LEAF_K), FRAMES // 2, REPEATS)
    singles = cuda_ms(lambda: [traverse.trace_tiles(qn, c, QUAT, WIDTH, HEIGHT, FOV,
                                                    leaf_k=LEAF_K) for c in cams],
                      FRAMES // 2, REPEATS)
    path_ms = statistics.median(reps)
    rays = N_CAMS * WIDTH * HEIGHT
    log(f"[time] K1c {N_CAMS} cameras x 1920x1080 in one launch: {path_ms:.4f} ms = "
        f"{rays / path_ms / 1e3:.2f} Mrays/s (reps {[round(r, 4) for r in reps]}); "
        f"{N_CAMS} host-issued K1a calls {statistics.median(singles):.4f} ms (reps "
        f"{[round(r, 4) for r in singles]}) on {card}")
    # where the batch's lead comes from: one camera as F = 1 (the same work
    # as K1a), and N_CAMS copies of one camera (no other camera's records)
    split = {
        "K1c F=1": lambda: traverse.trace_tiles_batch(qn, cams[:1], quats[:1], WIDTH, HEIGHT,
                                                      FOV, leaf_k=LEAF_K),
        "K1a": lambda: traverse.trace_tiles(qn, cams[0], QUAT, WIDTH, HEIGHT, FOV,
                                            leaf_k=LEAF_K),
        f"K1c {N_CAMS} x camera 0": lambda: traverse.trace_tiles_batch(
            qn, cams[:1] * N_CAMS, quats, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K),
        f"{N_CAMS} x K1a camera 0": lambda: [traverse.trace_tiles(
            qn, cams[0], QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K) for _ in range(N_CAMS)]}
    split_ms = {k: statistics.median(cuda_ms(fn, FRAMES // 2, REPEATS)) for k, fn in split.items()}
    log(f"[time] K1c against K1a on camera 0: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in split_ms.items()) + f" on {card}")

    counts = traverse.TraversalCounts()
    pick = torch.Generator(device="cpu").manual_seed(SEED + 2)
    for f in range(N_CAMS):
        pix = torch.randperm(WIDTH * HEIGHT, generator=pick)[:WAVE_SAMPLES].to(dev)
        traverse.trace_tiles_reference(qn, cams[f], QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K,
                                       pixels=pix, counts=counts)
    path_bound = bound(counts, WIDTH * HEIGHT / WAVE_SAMPLES,
                       rays * OUT_BYTES + N_CAMS * cam_bytes)
    log(f"[bound] K1c {N_CAMS}-camera 1080p batch: {path_bound[0]:.4f} ms by {path_bound[1]} "
        f"{json.dumps(path_bound[2])}")
    return {"launches": launches["trace_tiles_k1c"], "max_abs_err": stats["max_abs_err"],
            "rays": len(ends) * crop_pix.numel(), "ms": crop_ms, "plain_ms": plain_ms,
            "bound_ms": crop_bound[0], "bound_by": crop_bound[1], "path_rays": rays,
            "path_ms": path_ms, "path_bound_ms": path_bound[0], "path_bound_by": path_bound[1],
            "k1a_x8_ms": statistics.median(singles)}


def refit_chain(cs, plan, sweeps: int, tris0: torch.Tensor, cams, quats, size):
    """The dynamic frame chain of BASELINE config 5: deform → refit →
    collapse_apply_refit → make_wide_bvh → make_qnodes → K1c. Returns the
    stage functions and the frame."""
    from raytracer_tpu_torch.ops.cluster import refit_lbvh2_clustered
    from raytracer_tpu_torch.ops.collapse import collapse_apply_refit
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.ops.trace import make_wide_bvh

    w, h = size

    def refit(i):
        return refit_lbvh2_clustered(cs, tris0 * (1.0 + 0.1 * math.sin(0.1 * i)),
                                     num_sweeps=sweeps)

    def records(r):
        bvh4 = collapse_apply_refit(plan, r.bvh2.bounds_u32)
        return traverse.make_qnodes(make_wide_bvh(bvh4), r.tris_sorted, tri_ids=r.tri_order,
                                    leaf_size=r.leaf_size)

    def trace(q):
        return traverse.trace_tiles_batch(q, cams, quats, w, h, FOV, leaf_k=cs.leaf_size)

    def frame(i):
        r = refit(i)
        q = records(r)
        return r, q, trace(q)

    return refit, records, trace, frame


def device_topology(cs, dev):
    """The cluster tree with its topology copied to the card (once)."""
    from raytracer_tpu_torch.ops.collapse import LBVH2

    return cs._replace(bvh2=LBVH2(*(a.to(dev) for a in cs.bvh2)))


def full_collapse_bounds(plan, bvh2) -> torch.Tensor:
    """The full collapse's BVH4 bounds, merged apart from the plan's gather:
    each row's box is the union of the BVH2 leaf boxes under it, merged
    leaf-up over the plan's children with −0 below +0 (the JAX package's
    device collapse), then packed with the fp16 subnormals of internal rows
    flushed to signed zero (its truncating re-pack of fp16 values)."""
    from raytracer_tpu_torch.ops.collapse import INVALID
    from raytracer_tpu_torch.ops.lbvh import from_ordered_key, ordered_key
    from raytracer_tpu_torch.utils.fp16 import pack_bounds, unpack_bounds

    m = plan.src.shape[0]
    leaf = plan.meta != 0
    mn, mx = unpack_bounds(bvh2.bounds_u32[plan.src])
    kmn0, kmx0 = ordered_key(mn), ordered_key(mx)
    valid = (plan.children != INVALID)[..., None]
    kids = plan.children.clamp(0, m - 1)
    big = torch.iinfo(torch.int32).max
    kmn, kmx = kmn0, kmx0
    while True:
        nmn = torch.where(leaf[:, None], kmn0, torch.where(valid, kmn[kids], big).amin(dim=1))
        nmx = torch.where(leaf[:, None], kmx0, torch.where(valid, kmx[kids], -big).amax(dim=1))
        if torch.equal(nmn, kmn) and torch.equal(nmx, kmx):
            break
        kmn, kmx = nmn, nmx
    words = pack_bounds(from_ordered_key(kmn), from_ordered_key(kmx))
    lo, hi = words & 0xFFFF, words >> 16
    lo = torch.where((lo & 0x7C00) == 0, lo & 0x8000, lo)
    hi = torch.where((hi & 0x7C00) == 0, hi & 0x8000, hi)
    words = torch.where(leaf[:, None], words, lo | (hi << 16))
    return torch.where(plan.emitted[:, None], words, 0)


def records_phase(pt, card: str) -> None:
    """3. set_scene's records phase as it runs now (the device 4-wide
    collapse) and as it ran before (the native C++ collapse on the host),
    both warm, timed in the order native, device, device, native (host
    clock, each ending in a synchronise); the device's records equal
    set_scene's, the native's but for the sign of a zero."""
    from raytracer_tpu_torch.ops.cluster import records_pipeline

    fns = {"native": lambda: native_collapse_records(pt._cluster),
           "device": lambda: records_pipeline(pt._cluster, height=pt._bvh2_height)}
    ms, out = {"native": [], "device": []}, {}
    for name in ("native", "device", "device", "native"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fns[name]()
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3)
    qi = pt._qnodes.view(torch.int32)
    if not torch.equal(out["device"].view(torch.int32), qi):
        fail("records_pipeline's records differ from set_scene's")
    words, rows = signed_zero_words(qi, out["native"].view(torch.int32),
                                    "set_scene's records against the native collapse's")
    log(f"[main] records phase, warm, order native-device-device-native: native C++ collapse "
        f"{[round(x, 2) for x in ms['native']]} ms, device collapse "
        f"{[round(x, 2) for x in ms['device']]} ms (set_scene's first call "
        f"{pt.build_stats['records_ms']:.2f} ms); records equal but {words} box words (in "
        f"{rows} rows) of a zero's sign on {card}")


def native_collapse_records(cs) -> torch.Tensor:
    """The records of a cluster tree through the native C++ collapse (the
    cross-check of the device collapse), on the device of its triangles."""
    from raytracer_tpu_torch.ops.collapse import collapse4_native_padded
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.ops.trace import make_wide_bvh

    dev = cs.tris_sorted.device
    b4 = collapse4_native_padded(cs.bvh2)
    b4 = b4._replace(bounds_u32=b4.bounds_u32.to(dev), children=b4.children.to(dev),
                     meta=b4.meta.to(dev))
    return traverse.make_qnodes(make_wide_bvh(b4), cs.tris_sorted, tri_ids=cs.tri_order,
                                leaf_size=cs.leaf_size)


def signed_zero_words(a: torch.Tensor, b: torch.Tensor, what: str) -> tuple[int, int]:
    """Two int32 views of records that may differ only in f32 words that are
    +0 in one and −0 in the other → (differing words, rows with one)."""
    diff = a != b
    signed_zero = ((a | b) == -2**31) & ((a ^ b) == -2**31)
    if bool((diff & ~signed_zero).any()):
        fail(f"{what}: records differ beyond the sign of a zero on "
             f"{int((diff & ~signed_zero).any(dim=1).sum())} rows")
    return int(diff.sum()), int(diff.any(dim=1).sum())


def check_plan_contract(r, q: torch.Tensor, plan, what: str) -> None:
    """(a): the refit chain's records against the full collapse of the
    refitted tree. Byte-equal to the records of the full collapse's bounds
    in the JAX package's semantics (full_collapse_bounds) and to the records
    pipeline's (the device collapse); against the native C++ collapse, equal
    except f32 box words that are +0 in one and −0 in the other: the native
    collapse merges children already flushed to signed zeros with
    std::fmin/fmax in child order, which keeps the first of two zeros (the
    boxes are numerically equal)."""
    from raytracer_tpu_torch.ops.cluster import records_pipeline
    from raytracer_tpu_torch.ops.collapse import BVH4
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.ops.trace import make_wide_bvh

    full = BVH4(full_collapse_bounds(plan, r.bvh2), plan.children, plan.meta, plan.num_nodes)
    ref = traverse.make_qnodes(make_wide_bvh(full), r.tris_sorted, tri_ids=r.tri_order,
                               leaf_size=r.leaf_size)
    qi = q.view(torch.int32)
    for name, other in (("the full collapse's", ref), ("the device collapse's", records_pipeline(r))):
        if not torch.equal(qi, other.view(torch.int32)):
            bad = int((qi != other.view(torch.int32)).any(dim=1).sum())
            fail(f"{what}: refit-chain records differ from {name} on {bad} rows")
    words, rows = signed_zero_words(qi, native_collapse_records(r).view(torch.int32),
                                    f"{what} against the native collapse")
    log(f"[check] {what}: the refit chain's records {tuple(q.shape)} equal the full collapse's "
        f"and the device collapse's byte for byte; the native collapse's on all but {words} "
        f"box words (in {rows} rows) that hold +0 for its -0")


def check_refit_boxes(r) -> None:
    """(b): every internal box contains its children's boxes, every leaf box
    its cluster's triangles (fp16 boxes decoded exactly)."""
    from raytracer_tpu_torch.ops.collapse import LEAF_FLAG
    from raytracer_tpu_torch.utils.fp16 import unpack_bounds

    b = r.bvh2
    mn, mx = unpack_bounds(b.bounds_u32)
    leaf = (b.meta & LEAF_FLAG) != 0
    inner = ~leaf
    for kid in (b.left, b.right):
        if not bool(((mn[kid] >= mn) & (mx[kid] <= mx))[inner].all()):
            fail("a refitted internal box does not contain its child's box")
    k, n = r.leaf_size, r.tris_sorted.shape[0]
    c = b.num_internal + 1
    pad = torch.full((c * k - n, 3), float("inf"), device=mn.device)
    tmn = torch.cat([r.tris_sorted.amin(dim=1), pad]).reshape(c, k, 3).amin(dim=1)
    tmx = torch.cat([r.tris_sorted.amax(dim=1), -pad]).reshape(c, k, 3).amax(dim=1)
    cidx = (b.meta & 0x7FFFFFFF)[leaf]
    if not bool(((mn[leaf] <= tmn[cidx]) & (mx[leaf] >= tmx[cidx])).all()):
        fail("a refitted leaf box does not contain its cluster's triangles")


def dynamic_phase(env: dict, pt) -> None:
    """13. the dynamic dragon at full size, 8 cameras at 1080p per frame."""
    from raytracer_tpu_torch.ops.camera import primary_dirs
    from raytracer_tpu_torch.ops.collapse import collapse_plan
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.ops.shade import quantize_rgba8, shade_lambert

    card, dev, tris0 = env["card"], env["dev"], env["tris"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    sweeps = pt._bvh2_height + 2
    t0 = time.perf_counter()
    cs = device_topology(pt._cluster, dev)
    plan = collapse_plan(cs.bvh2, sweeps=sweeps)
    torch.cuda.synchronize()
    log(f"[dynamic] topology to the card and collapse plan ({plan.num_nodes} BVH4 rows, "
        f"{sweeps} sweeps) in {(time.perf_counter() - t0) * 1e3:.2f} ms host clock")
    cams, quats = batch_cameras(CAM_Z)
    refit, records, trace, frame = refit_chain(cs, plan, sweeps, tris0, cams, quats,
                                               (WIDTH, HEIGHT))
    frame(0)
    torch.cuda.synchronize()

    # (d) launches, (e) no synchronisation
    for i in (1, 2):
        traverse.reset_launches()
        if i == 2:
            torch.cuda.set_sync_debug_mode("error")
        try:
            r, q, out = frame(i)
        except RuntimeError as exc:
            fail(f"the dynamic frame waited for the card: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        launches = dict(traverse.LAUNCHES)
        if launches != expected(trace_tiles_k1c=1):
            fail(f"dynamic frame {i} launched {launches}, expected 1 K1c and nothing else")
    log(f"[dynamic] each frame launched {json.dumps(launches)}; frame 2 issued from refit to "
        "K1c without a host-device synchronisation")
    if any(p.shape != (N_CAMS, HEIGHT, WIDTH) for p in out) or not all(
            bool(torch.isfinite(p).all()) for p in out[:4]):
        fail("the dynamic frame's planes are misshapen or not finite")

    # (a) the plan's contract at full size, (b) containment
    check_plan_contract(r, q, plan, "dynamic frame 2")
    check_refit_boxes(r)
    log("[check] dynamic frame 2: every internal box contains its children's, every leaf box "
        "its cluster's deformed triangles")

    # (c) PathTracer.refit_bvh + render() against brute force
    deformed = tris0 * (1.0 + 0.1 * math.sin(0.1 * 3))
    pt.set_camera_position(*FRAMED)
    pt.refit_bvh(deformed.cpu().numpy())
    traverse.reset_launches()
    img = pt.render()
    torch.cuda.synchronize()
    if traverse.LAUNCHES["trace_tiles_k1a"] != 1:
        fail(f"render() after refit_bvh launched {traverse.LAUNCHES}")
    log(f"[dynamic] PathTracer.refit_bvh build_stats {json.dumps(pt.build_stats)}")
    origin = torch.tensor(FRAMED, dtype=torch.float32, device=dev)
    sample = env["sample"]
    planes = traverse.trace_tiles(pt._qnodes, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K)
    ker = [p.reshape(-1)[sample] for p in planes]
    s_dirs = primary_dirs(sample % WIDTH, sample // WIDTH, WIDTH, HEIGHT, QUAT, FOV)
    check_against(ker, brute_planes(pt._tris_dev, origin, s_dirs), pt._tris_dev, origin, s_dirs,
                  f"refit_bvh + render vs brute force, {BRUTE_SAMPLES} deformed framed pixels")
    shade = quantize_rgba8(shade_lambert(torch.stack(ker[1:4], -1), ker[4] >= 0))
    if not torch.equal(img.reshape(-1, 4)[sample], shade):
        fail("render() after refit_bvh differs from the shading of its traced planes")

    # (f) times
    n = DYN_FRAMES
    stage = {"refit": statistics.median(cuda_ms(lambda: refit(5), n, 3)),
             "apply+widen+records": statistics.median(cuda_ms(lambda: records(r), n, 3)),
             "K1c": statistics.median(cuda_ms(lambda: trace(q), n, 3))}
    frame_reps = cuda_ms(lambda: frame(6), n, REPEATS)
    frame_ms = statistics.median(frame_reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame(7)
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sync_ms = (time.perf_counter() - t0) * 1e3
    rays = WIDTH * HEIGHT * N_CAMS
    log(f"[time] dynamic dragon frame ({N_CAMS} cameras x 1920x1080, refit every frame): "
        f"{frame_ms:.4f} ms/frame = {rays / frame_ms / 1e3:.2f} Mrays/s (W*H*cameras / ms; reps "
        f"{[round(x, 4) for x in frame_reps]}); stages alone: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in stage.items()) + f" on {card}")
    log(f"[time] one dynamic frame on the host clock: issued in {issue_ms:.4f} ms, done "
        f"{sync_ms:.4f} ms after a synchronise on {card}")
    profile_calls(lambda: frame(8), "dynamic dragon frame", card)
    env["dynamic_frame"] = frame  # for phase 28
    log(f"[mem] peak device memory allocated in the dynamic phase: "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")


def config5_phase(env: dict) -> None:
    """14. BASELINE config 5: the dynamic icosphere(4), 8 cameras at 256x256."""
    from raytracer_tpu_torch import Scene
    from raytracer_tpu_torch.ops.cluster import build_sah2_clustered
    from raytracer_tpu_torch.ops.collapse import collapse_plan
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.utils import procgen

    card, dev = env["card"], env["dev"]
    scene = Scene().set_triangles(procgen.make_icosphere(4))
    scene._normalize_enabled, scene._normalize_mode = True, "cube"
    scene.normalize_mesh()
    tris0 = torch.from_numpy(scene.triangles).to(dev)
    cs, height = build_sah2_clustered(scene.triangles, LEAF_K, dev)
    cs = device_topology(cs, dev)
    plan = collapse_plan(cs.bvh2, sweeps=height + 2)
    cams, quats = batch_cameras(CONFIG5_Z)
    size = CONFIG5_SIZE
    _, _, _, frame = refit_chain(cs, plan, height + 2, tris0, cams, quats, (size, size))
    frame(0)
    torch.cuda.synchronize()
    traverse.reset_launches()
    hits = torch.zeros(N_CAMS, dtype=torch.int64, device=dev)
    for i in range(1, 1 + DYN_FRAMES):
        r, q, out = frame(i)
        hits += (out[4] >= 0).sum(dim=(1, 2))
    torch.cuda.synchronize()
    launches = dict(traverse.LAUNCHES)
    if launches != expected(trace_tiles_k1c=DYN_FRAMES):
        fail(f"config 5 launched {launches} in {DYN_FRAMES} frames, expected one K1c each")
    check_plan_contract(r, q, plan, "config 5")
    per_cam = (hits / DYN_FRAMES).tolist()
    if min(per_cam) <= 0:
        fail(f"config 5: a camera hit nothing ({per_cam})")
    reps = cuda_ms(lambda: frame(9), FRAMES, REPEATS)
    ms = statistics.median(reps)
    rays = size * size * N_CAMS
    log(f"[config5] icosphere(4) {scene.num_triangles} triangles, SAH K={LEAF_K}, height "
        f"{height}; {N_CAMS} cameras at {size}x{size}; launches in {DYN_FRAMES} frames "
        f"{json.dumps(launches)}; mean hits per camera per frame {per_cam}")
    log(f"[time] config 5 frame (refit + records + K1c): {ms:.4f} ms/frame = "
        f"{rays / ms / 1e3:.2f} Mrays/s (W*H*cameras / ms; reps {[round(x, 4) for x in reps]}) "
        f"on {card}")
    profile_calls(lambda: frame(10), "config 5 frame", card)


def check_visits(env: dict, qn: torch.Tensor, what: str) -> dict:
    """17. K1f on records of either width: the framed frame with and without
    ``stats``, and the visits plane against the plain version's on the crop
    → the check's numbers, the crop's times and bound."""
    from raytracer_tpu_torch.ops.cuda import traverse

    card, crop_pix, r0, c0 = env["card"], env["crop_pix"], env["r0"], env["c0"]
    without = traverse.trace_tiles(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K)
    planes = traverse.trace_tiles(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K,
                                  stats=True)
    if len(planes) != 6 or planes[5].dtype != torch.float32 or planes[5].shape != (HEIGHT, WIDTH):
        fail(f"{what}: stats=True must append one (H, W) f32 plane")
    if not all(torch.equal(a, b) for a, b in zip(planes[:5], without)):
        fail(f"{what}: stats=True changed one of the five other planes")
    if not bool((planes[5] >= 1).all()):
        fail(f"{what}: a pixel counts no visit, not even the root's")
    counts = traverse.TraversalCounts()
    ref = traverse.trace_tiles_reference(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K,
                                         pixels=crop_pix, counts=counts, stats=True)
    ker = [p.reshape(-1)[crop_pix] for p in planes]
    same = ker[4] == ref[4]
    err = (ker[5] - ref[5]).abs()[same]
    if float(same.float().mean()) < MIN_TRI_MATCH or float(err.max()) != 0.0:
        fail(f"{what}: the visits plane differs from the plain version's on "
             f"{int((err != 0).sum())} rays of the same triangle")
    crop_visits = int(ker[5].sum(dtype=torch.float64))
    if bool(same.all()) and crop_visits != counts.visits:
        fail(f"{what}: the plane sums to {crop_visits}, the plain version counted "
             f"{counts.visits} visits")
    window = traverse.trace_tiles(qn, FRAMED, QUAT, CROP, CROP, FOV, leaf_k=LEAF_K, stats=True,
                                  raygen_size=(WIDTH, HEIGHT), row_offset=r0, col_offset=c0)
    if not all(torch.equal(w.reshape(-1), k) for w, k in zip(window, ker)):
        fail(f"{what}: the crop window with stats differs from the same pixels of the frame")
    ms = statistics.median(cuda_ms(lambda: traverse.trace_tiles(
        qn, FRAMED, QUAT, CROP, CROP, FOV, leaf_k=LEAF_K, stats=True,
        raygen_size=(WIDTH, HEIGHT), row_offset=r0, col_offset=c0), FRAMES, REPEATS))
    plain_ms = statistics.median(cuda_ms(lambda: traverse.trace_tiles_reference(
        qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K, pixels=crop_pix, stats=True),
        1, 3))
    b_ms, b_by, detail = bound(counts, 1.0, crop_pix.numel() * (OUT_BYTES + 4))
    stats = {"rays": crop_pix.numel(), "tri_equal": float(same.float().mean()),
             "visits_equal_on": int(same.sum()), "crop_visits": crop_visits,
             "counted_visits": counts.visits, "max_abs_err": float(err.max())}
    log(f"[check] {what}: five planes bit-identical with and without stats on the 1080p "
        f"frame; visits plane vs plain on the crop: {json.dumps(stats)}")
    log(f"[time] {what} framed 256x256 crop: kernel {ms:.4f} ms, plain torch {plain_ms:.2f} ms "
        f"(median of 3), bound {b_ms:.4f} ms by {b_by} {json.dumps(detail)} on {card}")
    return {**stats, "ms": ms, "plain_ms": plain_ms, "bound_detail": detail}


def check_wide_structure(bvh2, b8) -> dict:
    """18. The structure of a BVH8 (``b8``, from the clustered ``bvh2``)."""
    from raytracer_tpu_torch.ops.collapse import INVALID, LEAF_FLAG
    from raytracer_tpu_torch.utils.fp16 import unpack_bounds

    n = b8.num_nodes
    kids, meta = b8.children[:n], b8.meta[:n]
    if kids.shape != (n, 8) or not bool((b8.children[n:] == INVALID).all()):
        fail(f"BVH8 children of shape {tuple(b8.children.shape)}, or padding rows with children")
    leaf = (meta & LEAF_FLAG) != 0
    valid = kids != INVALID
    nkids = valid.sum(dim=1)
    if bool((nkids[leaf] != 0).any()) or bool(((nkids[~leaf] < 2) | (nkids[~leaf] > 8)).any()):
        fail("a BVH8 leaf row has children, or an internal row fewer than 2 or more than 8")
    seen = torch.bincount(kids[valid], minlength=n)
    if int(seen[0]) != 0 or not bool((seen[1:] == 1).all()):
        fail("a BVH8 row is not reached exactly once from the root")
    leaves2 = bvh2.meta[(bvh2.meta & LEAF_FLAG) != 0]
    if not torch.equal(torch.sort(meta[leaf]).values, torch.sort(leaves2).values):
        fail("the BVH8's leaves are not the BVH2's cluster leaves, each once")
    mn, mx = unpack_bounds(b8.bounds_u32[:n])
    ki = kids.clamp(0, n - 1)
    inside = ((mn[:, None, :] <= mn[ki] + 2.0 ** -14)
              & (mx[:, None, :] >= mx[ki] - 2.0 ** -14)).all(dim=-1)
    if not bool(inside[valid].all()):
        fail(f"{int((~inside & valid).sum())} BVH8 child boxes reach outside their parent's")
    return {"rows": n, "internal": int((~leaf).sum()), "leaves": int(leaf.sum()),
            "mean_children": float(nkids[~leaf].float().mean()),
            "full_rows": int((nkids == 8).sum())}


def abba(fns: dict, frames: int, repeats: int) -> dict:
    """Median ms per call of each of two functions, timed back to back in the
    order first, second, second, first."""
    (a, fa), (b, fb) = fns.items()
    reps = {a: [], b: []}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        reps[name] += cuda_ms(fn, frames, repeats)
    return {name: statistics.median(r) for name, r in reps.items()}


def ab_phase(env: dict, qn8: torch.Tensor, waves: list[dict]) -> dict:
    """19. BVH4 against BVH8 at K = 32, back to back in one process → K1f's
    launches on these frames and its time on them."""
    from raytracer_tpu_torch import render_pt
    from raytracer_tpu_torch.ops.cuda import traverse

    card, dev, tris = env["card"], env["dev"], env["tris"]
    trees = {"BVH4": env["qn"], "BVH8": qn8}
    rays = WIDTH * HEIGHT
    log(f"[A/B] BVH4 {tuple(trees['BVH4'].shape)} against BVH8 {tuple(qn8.shape)} records, "
        f"K = {LEAF_K}, 1920x1080, order 4-8-8-4, on {card}")
    torch.cuda.synchronize()
    traverse.reset_launches()
    seen = {}
    for view, pos in (("framed", FRAMED), ("sparse", SPARSE)):
        for tree, q in trees.items():
            planes = traverse.trace_tiles(q, pos, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K,
                                          stats=True)
            seen[view, tree] = {"hits": int((planes[4] >= 0).sum()),
                                "visits": int(planes[5].sum(dtype=torch.float64)),
                                "tri": planes[4]}
    torch.cuda.synchronize()
    launches = dict(traverse.LAUNCHES)
    if launches != expected(trace_tiles_k1f=4):
        fail(f"the A/B's visit frames launched {launches}, expected 4 K1f and nothing else")
    stats_ms = {}
    for view, pos in (("framed", FRAMED), ("sparse", SPARSE)):
        s4, s8 = seen[view, "BVH4"], seen[view, "BVH8"]
        if s4["hits"] != s8["hits"]:
            fail(f"A/B {view}: BVH4 hits {s4['hits']} pixels, BVH8 {s8['hits']}")
        ms = abba({t: (lambda q=q: traverse.trace_tiles(q, pos, QUAT, WIDTH, HEIGHT, FOV,
                                                        leaf_k=LEAF_K))
                   for t, q in trees.items()}, FRAMES, REPEATS)
        stats_ms[view] = abba({t: (lambda q=q: traverse.trace_tiles(
            q, pos, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K, stats=True))
            for t, q in trees.items()}, FRAMES, 3)
        for tree, s in (("BVH4", s4), ("BVH8", s8)):
            log(f"[A/B] {view} {tree}: {ms[tree]:.4f} ms/frame = {rays / ms[tree] / 1e3:.2f} "
                f"Mrays/s; visits {s['visits']} ({s['visits'] / rays:.3f} a ray); hits "
                f"{s['hits']}; with the visits plane (K1f) {stats_ms[view][tree]:.4f} ms")
        log(f"[A/B] {view} BVH8 / BVH4: ms {ms['BVH8'] / ms['BVH4']:.4f}, visits "
            f"{s8['visits'] / s4['visits']:.4f}, same triangle on "
            f"{float((s4['tri'] == s8['tri']).float().mean()):.6f} of pixels")

    total = {"BVH4": 0.0, "BVH8": 0.0}
    for i, w in enumerate(waves):
        kw = dict(any_hit=w["any_hit"], leaf_k=LEAF_K, active=w["active"],
                  scattered=w["scattered"])
        found = {t: int((traverse.trace_rays(q, w["o"], w["d"], **kw)[4] >= 0).sum())
                 for t, q in trees.items()}
        if found["BVH4"] != found["BVH8"]:
            fail(f"A/B wave {i}: BVH4 finds {found['BVH4']} hits, BVH8 {found['BVH8']}")
        ms = abba({t: (lambda q=q: traverse.trace_rays(q, w["o"], w["d"], **kw))
                   for t, q in trees.items()}, 3, 3)
        for t in total:
            total[t] += ms[t]
        log(f"[A/B] wave {i} ({'any hit: K2b / K2c' if w['any_hit'] else 'closest: K2a / K2c'}): "
            f"BVH4 {ms['BVH4']:.4f} ms, BVH8 {ms['BVH8']:.4f} ms, ratio "
            f"{ms['BVH8'] / ms['BVH4']:.4f}; hits {found['BVH4']} both")
    log(f"[A/B] the {len(waves)} ray-buffer waves of one sample: BVH4 {total['BVH4']:.4f} ms, "
        f"BVH8 {total['BVH8']:.4f} ms, ratio {total['BVH8'] / total['BVH4']:.4f}")

    def sample_of(q):
        return render_pt.pt_sample_frame(
            q, tris, FRAMED, QUAT, WIDTH, HEIGHT, bounces=BOUNCES, fov_degrees=FOV,
            leaf_k=LEAF_K, tile_primary=True,
            generator=torch.Generator(device=dev).manual_seed(SAMPLE_SEED))

    ms = abba({t: (lambda q=q: sample_of(q)) for t, q in trees.items()}, SAMPLES, 3)
    near = float(((sample_of(trees["BVH4"]) - sample_of(qn8)).abs().amax(-1)
                  <= RADIANCE_ATOL).float().mean())
    log(f"[A/B] one {BOUNCES}-bounce 1080p sample (pt_sample_frame, same generator state): "
        f"BVH4 {ms['BVH4']:.4f} ms, BVH8 {ms['BVH8']:.4f} ms, ratio "
        f"{ms['BVH8'] / ms['BVH4']:.4f}; {near:.6f} of pixels within {RADIANCE_ATOL}")
    if near < MIN_RADIANCE_MATCH:
        fail(f"A/B: the two trees' samples agree on {near:.6f} < {MIN_RADIANCE_MATCH} of pixels")
    return {"launches": launches["trace_tiles_k1f"],
            "path_ms": stats_ms["framed"]["BVH4"] + stats_ms["framed"]["BVH8"]}


def wide8_phase(env: dict, scene) -> dict:
    """15.–19. The 8-wide tree on the dragon and the visits plane → the
    kernels-line rows of K1e, K2c and K1f."""
    from raytracer_tpu_torch import PathTracer
    from raytracer_tpu_torch.ops.collapse import LBVH2, collapse_lbvh2_to_bvh8
    from raytracer_tpu_torch.ops.cuda import traverse

    card, dev, qn4 = env["card"], env["dev"], env["qn"]

    # 15. the main path through widener="collapse8"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    pt = PathTracer(WIDTH, HEIGHT, widener="collapse8", builder="sah", leaf_size=LEAF_K,
                    device=dev)
    t0 = time.perf_counter()
    pt.set_scene(scene)
    qn8 = pt._qnodes
    log(f"[wide8] set_scene(widener=collapse8) in {time.perf_counter() - t0:.2f} s: "
        f"{json.dumps(pt.build_stats)}; records {tuple(qn8.shape)} = "
        f"{qn8.numel() * 4 / 2**20:.1f} MiB (4-wide {qn4.numel() * 4 / 2**20:.1f} MiB); peak "
        f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    if qn8.shape != (qn4.shape[0], traverse.rec_layout(LEAF_K, 8)[2]):
        fail(f"8-wide records of shape {tuple(qn8.shape)}")
    if not torch.equal(pt._tris_dev, env["tris"]):
        fail("the 8-wide tracer holds other triangles than the 4-wide one")
    pt.set_camera_quaternion(*QUAT)
    pt.fov_degrees = FOV
    torch.cuda.synchronize()
    traverse.reset_launches()
    images = {}
    for view, pos in (("framed", FRAMED), ("sparse", SPARSE)):
        pt.set_camera_position(*pos)
        images[view] = pt.render()
    torch.cuda.synchronize()
    render_launches = dict(traverse.LAUNCHES)
    log(f"[wide8] launches during two render() calls: {json.dumps(render_launches)}")
    if render_launches != expected(trace_tiles_k1e=2):
        fail(f"the 8-wide primary path launched {render_launches}, expected 2 K1e")
    hit_rates = check_images(images, dev)
    for view, img in images.items():
        equal = float((img == env["images"][view]).all(dim=-1).float().mean())
        log(f"[wide8] {view}: hit rate {hit_rates[view]:.4f}; {equal:.6f} of pixels equal to "
            "the 4-wide tree's image")
        if equal < MIN_TRI_MATCH:
            fail(f"the 8-wide {view} image equals the 4-wide one on {equal:.6f} of pixels")
    pt_want = expected(trace_tiles_k1e=SAMPLES, trace_rays_k2c=SAMPLES * (2 * BOUNCES - 1))
    progressive_samples(pt, pt_want, "wide8 progressive")
    sample_reps = cuda_ms(lambda: pt.render_progressive(bounces=BOUNCES), SAMPLES, 3)
    ms = statistics.median(sample_reps)
    log(f"[time] 8-wide render_progressive(bounces={BOUNCES}) 1920x1080: {ms:.4f} ms/sample = "
        f"{WIDTH * HEIGHT * BOUNCES * 2 / ms / 1e3:.2f} Mrays/s (W*H*bounces*2) "
        f"(reps {[round(r, 4) for r in sample_reps]}) on {card}")
    profile_calls(lambda: pt.render_progressive(bounces=BOUNCES),
                  f"8-wide render_progressive(bounces={BOUNCES})", card)

    # 16. K1e and K2c against their plain versions and brute force
    k1e = check_tiles(env, qn8, "K1e", jitter=False)
    words = differing_words(k1e["planes"], traverse.trace_tiles(
        qn8, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K,
        entries=torch.zeros((1, 1), dtype=torch.int32, device=dev),
        tbounds=torch.full((1, 1), 1e30, device=dev)))
    log(f"[check] K1e against K1d with all-1e30 bounds and all-0 entries, whole frame: {words} "
        "differing words")
    if words:
        fail(f"all-1e30 bounds and all-0 entries change K1e's frame in {words} words")
    k1e_j = check_tiles(env, qn8, "K1e", jitter=True)
    waves, _ = capture_waves(env, qn8)
    wave_stats = check_waves(env, qn8, waves, "trace_rays_k2c", "trace_rays_k2c")
    env["qn8"], env["waves"]["8-wide"] = qn8, waves  # for phase 28
    rows = {"trace_tiles_k1e": time_tiles(
        env, qn8, "K1e", False, k1e,
        render_launches["trace_tiles_k1e"] + pt_want["trace_tiles_k1e"])}
    rows["trace_tiles_k1e"]["max_abs_err"] = max(k1e["stats"]["max_abs_err"],
                                                 k1e_j["stats"]["max_abs_err"])
    rows["trace_rays_k2c"] = wave_row(wave_stats["trace_rays_k2c"], pt_want["trace_rays_k2c"])

    # 17. K1f at both widths
    visits = [check_visits(env, qn4, "K1f on 4-wide records"),
              check_visits(env, qn8, "K1f on 8-wide records")]
    register_row(env, "trace_tiles_k1f", lambda core: [traverse.trace_tiles(
        q, FRAMED, QUAT, CROP, CROP, FOV, leaf_k=LEAF_K, stats=True, raygen_size=(WIDTH, HEIGHT),
        row_offset=env["r0"], col_offset=env["c0"], core=core) for q in (qn4, qn8)],
        lambda core: [traverse.trace_tiles(q, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K,
                                           stats=True, core=core) for q in (qn4, qn8)])

    # 18. the structure of the full-size BVH8
    bvh2 = LBVH2(*(a.to(dev) for a in pt._cluster.bvh2))
    b8, collapse_ms = timed_once(lambda: collapse_lbvh2_to_bvh8(bvh2,
                                                                 sweeps=pt._bvh2_height + 2))
    log(f"[wide8] collapse_lbvh2_to_bvh8 of {bvh2.num_nodes} BVH2 nodes ({pt._bvh2_height + 2} "
        f"sweeps) on the card in {collapse_ms:.2f} ms: "
        f"{json.dumps(check_wide_structure(bvh2, b8))}")
    del pt, b8

    # 19. BVH4 against BVH8
    ab = ab_phase(env, qn8, waves)
    b_ms, b_by = summed([v["bound_detail"] for v in visits])
    # the visits plane adds 4 bytes a ray to the frames of K1a and K1e
    pb_ms, pb_by = summed([bound(env["frame_counts"][label], WIDTH * HEIGHT / WAVE_SAMPLES,
                                 WIDTH * HEIGHT * (OUT_BYTES + 4))[2]
                           for label in ("K1a", "K1e")])
    log(f"[bound] K1f framed 1080p frame at both widths: {pb_ms:.4f} ms by {pb_by}")
    rows["trace_tiles_k1f"] = {
        "launches": ab["launches"], "max_abs_err": max(v["max_abs_err"] for v in visits),
        "rays": sum(v["rays"] for v in visits), "ms": sum(v["ms"] for v in visits),
        "plain_ms": sum(v["plain_ms"] for v in visits), "bound_ms": b_ms, "bound_by": b_by,
        "path_rays": 2 * WIDTH * HEIGHT, "path_ms": ab["path_ms"],
        "path_bound_ms": pb_ms, "path_bound_by": pb_by}
    return rows


def lbvh_phase(env: dict, scene) -> dict:
    """25. The Morton LBVH dragon at full size, single-triangle leaves (K = 1)
    and Morton clusters of 8 → per K its records and the crop's traversal
    counts (for phase 26)."""
    from raytracer_tpu_torch import PathTracer
    from raytracer_tpu_torch.ops.cluster import build_lbvh2_clustered
    from raytracer_tpu_torch.ops.collapse import collapse_lbvh2_to_bvh4
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.ops.lbvh import build_lbvh2
    from raytracer_tpu_torch.ops.morton import build_morton_and_sort

    card, dev, tris = env["card"], env["dev"], env["tris"]
    tris_cpu = tris.cpu()
    views = (("framed", FRAMED), ("sparse", SPARSE))
    all_dirs = frame_dirs(torch.arange(WIDTH * HEIGHT, device=dev))
    k32 = {view: [p.reshape(-1) for p in traverse.trace_tiles(env["qn"], pos, QUAT, WIDTH, HEIGHT,
                                                               FOV, leaf_k=LEAF_K)]
           for view, pos in views}

    # the Morton order: the card's against the CPU's
    codes, order = build_morton_and_sort(tris)
    t0 = time.perf_counter()
    c_codes, c_order = build_morton_and_sort(tris_cpu)
    log(f"[lbvh] Morton codes and order of {tris.shape[0]} triangles: the card's equal the "
        f"CPU's ({time.perf_counter() - t0:.2f} s on the CPU): "
        f"{torch.equal(codes.cpu(), c_codes) and torch.equal(order.cpu(), c_order)}")
    if not (torch.equal(codes.cpu(), c_codes) and torch.equal(order.cpu(), c_order)):
        fail("the Morton codes or order on the card differ from the CPU's")
    del codes, order, c_codes, c_order

    trees = {}
    for k in (1, 8):
        what = f"lbvh K={k}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        pt = PathTracer(WIDTH, HEIGHT, builder="lbvh", leaf_size=k, device=dev)
        t0 = time.perf_counter()
        pt.set_scene(scene)
        secs = time.perf_counter() - t0
        qn = pt._qnodes
        log(f"[{what}] set_scene in {secs:.2f} s: {json.dumps(pt.build_stats)}; BVH2 rows "
            f"{pt._bvh2.num_nodes}; records {tuple(qn.shape)} of {qn.shape[1] * 4} bytes = "
            f"{qn.numel() * 4 / 2**20:.1f} MiB; peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB on {card}")
        if not torch.equal(pt._tris_dev, tris):
            fail(f"{what}: the tracer holds other triangles than the SAH one")

        # the BVH2 on the card against the same build on the CPU
        t0 = time.perf_counter()
        cpu2 = build_lbvh2(tris_cpu) if k == 1 else build_lbvh2_clustered(tris_cpu, k).bvh2
        cpu_s = time.perf_counter() - t0
        for name, a, b in zip(("bounds", "left", "right", "meta", "parent"), pt._bvh2, cpu2):
            if not torch.equal(a.cpu(), b):
                fail(f"{what}: BVH2 {name} on the card differs from the CPU build in "
                     f"{int((a.cpu() != b).sum())} words")
        log(f"[{what}] BVH2 on the card equals the CPU build word for word (bounds, left, right, "
            f"meta, parent; {pt._bvh2.num_nodes} rows; {cpu_s:.2f} s on the CPU)")
        if k == 8:
            b4, b4_cpu = collapse_lbvh2_to_bvh4(pt._bvh2), collapse_lbvh2_to_bvh4(cpu2)
            if b4.num_nodes != b4_cpu.num_nodes or not all(
                    torch.equal(a.cpu(), b) for a, b in zip(b4[:3], b4_cpu[:3])):
                fail(f"{what}: the 4-wide collapse on the card differs from the CPU's")
            log(f"[{what}] the 4-wide collapse on the card equals the CPU's ({b4.num_nodes} rows)")
            del b4, b4_cpu
        del cpu2

        # render(): one K1a launch a view, the frame the SAH K = 32 tree's but for ties
        pt.set_camera_quaternion(*QUAT)
        pt.fov_degrees = FOV
        torch.cuda.synchronize()
        traverse.reset_launches()
        images = {}
        for view, pos in views:
            pt.set_camera_position(*pos)
            images[view] = pt.render()
        torch.cuda.synchronize()
        launches = dict(traverse.LAUNCHES)
        log(f"[{what}] launches during two render() calls: {json.dumps(launches)}")
        if launches != expected(trace_tiles_k1a=2):
            fail(f"{what}: render() launched {launches}, expected 2 K1a and nothing else")
        check_images(images, dev)
        for view, pos in views:
            planes = [p.reshape(-1) for p in traverse.trace_tiles(qn, pos, QUAT, WIDTH, HEIGHT,
                                                                  FOV, leaf_k=k)]
            origin = torch.tensor(pos, dtype=torch.float32, device=dev)
            check_against(planes, k32[view], tris, origin, all_dirs,
                          f"{what} {view} 1080p frame vs the SAH K={LEAF_K} frame")
            same = planes[4] == k32[view][4]
            t_words = int((planes[0][same].view(torch.int32)
                           != k32[view][0][same].view(torch.int32)).sum())
            px_same = bool((images[view].reshape(-1, 4)[same]
                            == env["images"][view].reshape(-1, 4)[same]).all())
            log(f"[{what}] {view}: t bit-equal to the K={LEAF_K} frame's where tri agrees "
                f"({t_words} differing words); image equal there: {px_same}")
            if t_words or not px_same:
                fail(f"{what} {view}: t or the image differs from the K={LEAF_K} frame's where "
                     "the triangle agrees")

        # K1a at leaf_k = k against its plain version (crop) and brute force
        chk = check_tiles(env, qn, f"K1a at leaf_k={k}", jitter=False, leaf_k=k)
        if chk["stats"]["ties"] or chk["stats"]["max_abs_err"] != 0.0:
            fail(f"{what}: K1a differs from its plain version on the crop ({chk['stats']})")
        trees[k] = {"qn": qn, "counts": chk["counts"]}

        if k == 1:
            # one progressive sample: its launches, and its waves against K2a / K2b's plain versions
            pt.set_camera_position(*FRAMED)
            torch.cuda.synchronize()
            traverse.reset_launches()
            accum = pt.render_progressive(bounces=BOUNCES)
            torch.cuda.synchronize()
            launches = dict(traverse.LAUNCHES)
            want = expected(trace_tiles_k1b=1, trace_rays_k2a=BOUNCES - 1,
                            trace_rays_k2b=BOUNCES)
            log(f"[{what}] launches during render_progressive(bounces={BOUNCES}): "
                f"{json.dumps(launches)}")
            if launches != want or not bool(torch.isfinite(accum).all() & (accum >= 0).all()):
                fail(f"{what}: a progressive sample launched {launches} (expected {want}) or "
                     "left a non-finite buffer")
            waves, _ = capture_waves(env, qn, leaf_k=k)
            check_waves(env, qn, waves, "trace_rays_k2a", "trace_rays_k2b", leaf_k=k)
            env["waves"][1] = waves  # for phase 28
        del pt, images
    return trees


def leaf_phase(env: dict, trees: dict) -> None:
    """26. K = 1, 8 and 32 in one process, timed in the order 1-8-32-32-8-1:
    frame ms, visits a frame (K1f) and MT tests a ray on the crop, and one
    3-bounce sample."""
    from raytracer_tpu_torch import render_pt
    from raytracer_tpu_torch.ops.cuda import traverse

    card = env["card"]
    qns = {1: trees[1]["qn"], 8: trees[8]["qn"], LEAF_K: env["qn"]}
    counts = {1: trees[1]["counts"], 8: trees[8]["counts"], LEAF_K: traverse.TraversalCounts()}
    traverse.trace_tiles_reference(env["qn"], FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K,
                                   pixels=env["crop_pix"], counts=counts[LEAF_K])
    rays = WIDTH * HEIGHT
    log(f"[leaf] K = 1 / 8 / {LEAF_K} on the dragon at 1920x1080, order 1-8-{LEAF_K}-{LEAF_K}-8-1, "
        f"on {card}")
    for view, pos in (("framed", FRAMED), ("sparse", SPARSE)):
        reps = {k: [] for k in qns}
        for k in (1, 8, LEAF_K, LEAF_K, 8, 1):
            reps[k] += cuda_ms(lambda k=k: traverse.trace_tiles(qns[k], pos, QUAT, WIDTH, HEIGHT,
                                                                FOV, leaf_k=k), FRAMES, 3)
        hits = None
        for k, q in qns.items():
            planes = traverse.trace_tiles(q, pos, QUAT, WIDTH, HEIGHT, FOV, leaf_k=k, stats=True)
            h = int((planes[4] >= 0).sum())
            if hits is not None and h != hits:
                fail(f"leaf {view}: K={k} hits {h} pixels, K=1 {hits}")
            hits = h
            visits = int(planes[5].sum(dtype=torch.float64))
            ms = statistics.median(reps[k])
            c = counts[k]
            crop = (f"; crop: {c.visits / c.rays:.3f} visits and {c.mt_tests / c.rays:.3f} MT "
                    f"tests a ray" if view == "framed" else "")
            log(f"[leaf] {view} K={k:2d}: {ms:.4f} ms/frame = {rays / ms / 1e3:.2f} Mrays/s "
                f"(median of {len(reps[k])} reps of {FRAMES}); records "
                f"{q.numel() * 4 / 2**20:.1f} MiB; visits {visits} ({visits / rays:.3f} a ray); "
                f"hits {h}{crop}")

    def sample_of(k):
        return render_pt.pt_sample_frame(
            qns[k], env["tris"], FRAMED, QUAT, WIDTH, HEIGHT, bounces=BOUNCES, fov_degrees=FOV,
            leaf_k=k, tile_primary=True,
            generator=torch.Generator(device=env["dev"]).manual_seed(SAMPLE_SEED))

    reps = {k: [] for k in qns}
    for k in (1, 8, LEAF_K, LEAF_K, 8, 1):
        reps[k] += cuda_ms(lambda k=k: sample_of(k), SAMPLES, 3)
    ref = sample_of(LEAF_K)
    for k in qns:
        near = float(((sample_of(k) - ref).abs().amax(-1) <= RADIANCE_ATOL).float().mean())
        log(f"[leaf] one {BOUNCES}-bounce 1080p sample (pt_sample_frame, same generator state) "
            f"K={k:2d}: {statistics.median(reps[k]):.4f} ms (median of {len(reps[k])} reps of "
            f"{SAMPLES}); {near:.6f} of pixels within {RADIANCE_ATOL} of K={LEAF_K}'s on {card}")
        if near < MIN_RADIANCE_MATCH:
            fail(f"leaf: the K={k} sample agrees with K={LEAF_K}'s on {near:.6f} of pixels")


# the cores timed alone (traverse.core_id names), on K1a, K2a and K2b
ELEMENT_CORES = ("baseline", "none", "order", "stack", "prefetch", "order+stack",
                 "order+prefetch", "stack+prefetch", "order+stack+prefetch", "hopper")


def series(fns: dict, frames: int, repeats: int) -> dict:
    """Median ms per call of each function, timed in the order given and
    then in reverse (A-B-B-A for two)."""
    names = list(fns)
    reps = {n: [] for n in names}
    for n in names + names[::-1]:
        reps[n] += cuda_ms(fns[n], frames, repeats)
    return {n: statistics.median(r) for n, r in reps.items()}


def flat_planes(out) -> list:
    """The planes of a traversal call's result, or of a list of results."""
    if isinstance(out, list):
        return [p for o in out for p in o]
    return list(out)


def hopper_phase(env: dict, trees: dict, rows: dict) -> None:
    """28. The redesigned traversal core ("hopper", every render path)
    against the frozen baseline core ("baseline") in this one process:
    ptxas of both; every plane of every pixel and ray of the full-size frames
    and captured waves bit-identical; A-B-B-A times of frames, waves, whole
    samples, the K1c batch and the dynamic frame; each design element alone;
    K2's two schedules; and the baseline's times beside each kernels-line
    row's."""
    from raytracer_tpu_torch import render_pt
    from raytracer_tpu_torch.ops.cuda import traverse

    card, dev, tris = env["card"], env["dev"], env["tris"]
    qn32, qn1, qn8 = env["qn"], trees[1]["qn"], env["qn8"]
    t_phase = time.perf_counter()
    cores = ("hopper", "baseline")

    # ptxas: each instantiation of the redesigned core (the render core and
    # the measured sets of elements) beside its baseline twin
    for src in ("traverse_tiles.cu", "traverse_rays.cu"):
        found = {k: (r, f, st, ld) for k, r, f, st, ld in ptxas_rows(traverse.load_kernel(src)[1])}
        for kernel, (regs, frame, st, ld) in found.items():
            if kernel.endswith(",256>"):
                continue
            twin = (kernel.replace("_persistent", "")[:-1] + ",256>" if "persistent" in kernel
                    else kernel[:kernel.rindex(",")] + ",256>")
            b = found.get(twin)
            log(f"[hopper] ptxas {kernel}: {regs} registers, {frame} bytes stack frame, spills "
                f"{st}/{ld} bytes; baseline {twin}: " + (
                    f"{b[0]} registers, {b[1]} bytes stack frame, spills {b[2]}/{b[3]} bytes"
                    if b else "none"))

    # every plane of the full-size frames and waves, word for word
    cams, quats = batch_cameras(CAM_Z)
    frames = {
        f"K1a framed SAH K={LEAF_K}": lambda c: traverse.trace_tiles(
            qn32, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K, core=c),
        f"K1a sparse SAH K={LEAF_K}": lambda c: traverse.trace_tiles(
            qn32, SPARSE, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K, core=c),
        "K1a framed LBVH K=1": lambda c: traverse.trace_tiles(
            qn1, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=1, core=c),
        "K1a sparse LBVH K=1": lambda c: traverse.trace_tiles(
            qn1, SPARSE, QUAT, WIDTH, HEIGHT, FOV, leaf_k=1, core=c),
        f"K1b framed SAH K={LEAF_K}": lambda c: traverse.trace_tiles(
            qn32, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K, jitter=True,
            jitter_seed=JITTER_SEED, core=c),
        f"K1c {N_CAMS} cameras": lambda c: traverse.trace_tiles_batch(
            qn32, cams, quats, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K, core=c),
        "K1d framed, the frame's bounds and entries": env["row_calls"]["trace_tiles_k1d"][1],
        "K1e framed 8-wide": lambda c: traverse.trace_tiles(
            qn8, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K, core=c),
        "K1e sparse 8-wide": lambda c: traverse.trace_tiles(
            qn8, SPARSE, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K, core=c),
        "K1f framed, 4- and 8-wide": env["row_calls"]["trace_tiles_k1f"][1],
    }
    trees_of = {LEAF_K: (qn32, LEAF_K, "SAH K=32"), 1: (qn1, 1, "LBVH K=1"),
                "8-wide": (qn8, LEAF_K, "8-wide SAH K=32")}
    waves = {}
    for key, ws in env["waves"].items():
        qn, k, label = trees_of[key]
        for i, w in enumerate(ws):
            kind = "any hit" if w["any_hit"] else "closest"
            waves[f"{label} wave {i} ({kind})"] = (
                lambda c, scattered=None, qn=qn, k=k, w=w: traverse.trace_rays(
                    qn, w["o"], w["d"], any_hit=w["any_hit"], leaf_k=k, active=w["active"],
                    scattered=w["scattered"] if scattered is None else scattered, core=c))
            lanes = w["o"].shape[0]
            alive = lanes if w["active"] is None else int(w["active"].sum())
            log(f"[hopper] {label} wave {i} ({kind}): {alive} of {lanes} lanes alive "
                f"(share {alive / lanes:.4f})")
    for what, fn in {**frames, **waves}.items():
        words = differing_words(flat_planes(fn("hopper")), flat_planes(fn("baseline")))
        if words:
            fail(f"phase 28: {what}: the redesigned core differs from the baseline in {words} "
                 "words")
    log(f"[hopper] every plane bit-identical to the baseline core (0 differing words) on "
        f"{len(frames)} full-size frames or batches and {len(waves)} captured waves")

    # A-B-B-A: frames, waves, whole samples, the dynamic frame
    for what, fn in frames.items():
        ms = abba({c: (lambda c=c: fn(c)) for c in cores}, 2 if "K1c" in what else 8, 2)
        log(f"[hopper] A-B-B-A {what}: hopper {ms['hopper']:.4f} ms, baseline "
            f"{ms['baseline']:.4f} ms, speed-up {ms['baseline'] / ms['hopper']:.4f} on {card}")
    for what, fn in waves.items():
        ms = abba({c: (lambda c=c: fn(c)) for c in cores}, 3, 2)
        log(f"[hopper] A-B-B-A {what}: hopper {ms['hopper']:.4f} ms, baseline "
            f"{ms['baseline']:.4f} ms, speed-up {ms['baseline'] / ms['hopper']:.4f} on {card}")
    real = (render_pt.trace_tiles, render_pt.trace_rays, traverse.trace_tiles_batch)

    def with_core(c, fn):
        def run():
            render_pt.trace_tiles = functools.partial(real[0], core=c)
            render_pt.trace_rays = functools.partial(real[1], core=c)
            traverse.trace_tiles_batch = functools.partial(real[2], core=c)
            try:
                return fn()
            finally:
                render_pt.trace_tiles, render_pt.trace_rays, traverse.trace_tiles_batch = real
        return run

    for key in (LEAF_K, 1, "8-wide"):
        qn, k, label = trees_of[key]

        def sample(qn=qn, k=k):
            return render_pt.pt_sample_frame(
                qn, tris, FRAMED, QUAT, WIDTH, HEIGHT, bounces=BOUNCES, fov_degrees=FOV,
                leaf_k=k, tile_primary=True,
                generator=torch.Generator(device=dev).manual_seed(SAMPLE_SEED))

        if not torch.equal(with_core("hopper", sample)(), with_core("baseline", sample)()):
            fail(f"phase 28: the {label} sample differs between the two cores")
        ms = abba({c: with_core(c, sample) for c in cores}, 4, 3)
        log(f"[hopper] A-B-B-A one {BOUNCES}-bounce 1080p sample {label} (radiance equal): "
            f"hopper {ms['hopper']:.4f} ms, baseline {ms['baseline']:.4f} ms, speed-up "
            f"{ms['baseline'] / ms['hopper']:.4f} on {card}")
    frame = env["dynamic_frame"]
    ms = abba({c: with_core(c, lambda: frame(9)) for c in cores}, 4, 3)
    log(f"[hopper] A-B-B-A dynamic dragon frame ({N_CAMS} cameras, refit every frame): hopper "
        f"{ms['hopper']:.4f} ms, baseline {ms['baseline']:.4f} ms, speed-up "
        f"{ms['baseline'] / ms['hopper']:.4f} on {card}")

    # each design element alone (K2 one thread per ray), K2's two schedules
    # on every wave where the wrapper lets the caller choose
    firsts = {label: fn for label, fn in waves.items()
              if ("wave 1 (closest)" in label or "wave 0 (any hit)" in label)
              and "8-wide" not in label}
    targets = {f"K1a framed SAH K={LEAF_K}": frames[f"K1a framed SAH K={LEAF_K}"],
               "K1a framed LBVH K=1": frames["K1a framed LBVH K=1"], **firsts}
    for what, fn in targets.items():
        ms = series({c: (lambda c=c: fn(c, False)) if "wave" in what else (lambda c=c: fn(c))
                     for c in ELEMENT_CORES}, 3 if "wave" in what else 8, 2)
        log(f"[hopper] cores on {what} (K2: one thread per ray): "
            + ", ".join(f"{c} {v:.4f} ({ms['baseline'] / v:.4f}x)" for c, v in ms.items())
            + f" ms on {card}")
    for what, fn in waves.items():
        if "8-wide" in what or ("any hit" in what and "K=1 " not in what):
            continue  # any hit over leaves of K > 1 runs one thread per ray
        ms = abba({"one thread per ray": lambda fn=fn: fn("hopper", False),
                   "persistent": lambda fn=fn: fn("hopper", True)}, 3, 2)
        log(f"[hopper] K2 schedules on {what}: one thread per ray "
            f"{ms['one thread per ray']:.4f} ms, persistent warps (refill below 16 lanes) "
            f"{ms['persistent']:.4f} ms on {card}")

    # the deepest stacks, as the plain version counts them (the shared part
    # of the stack holds kSharedEntries; PERF.md)
    for key, (qn, k, label) in trees_of.items():
        crop, first = traverse.TraversalCounts(), traverse.TraversalCounts()
        traverse.trace_tiles_reference(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=k,
                                       pixels=env["crop_pix"], counts=crop)
        w = env["waves"][key][1]
        live = torch.nonzero(w["active"]).squeeze(1)[:WAVE_SAMPLES]
        traverse.trace_rays_reference(qn, w["o"][live].contiguous(), w["d"][live].contiguous(),
                                      leaf_k=k, counts=first)
        log(f"[hopper] deepest stack {label}: crop {crop.max_depth} entries, first closest "
            f"wave {first.max_depth} ({live.numel()} rays); pushes dropped "
            f"{crop.dropped + first.dropped}")

    # the kernels line: the baseline's times beside each row's
    for name, (checked, path) in env["row_calls"].items():
        c = abba({k: (lambda k=k: checked(k)) for k in cores}, 4, 2)
        p = abba({k: (lambda k=k: path(k)) for k in cores}, 2, 2)
        rows[name]["baseline_ms"], rows[name]["baseline_path_ms"] = c["baseline"], p["baseline"]
        log(f"[hopper] {name} A-B-B-A: checked rays hopper {c['hopper']:.4f} / baseline "
            f"{c['baseline']:.4f} ms; path hopper {p['hopper']:.4f} / baseline "
            f"{p['baseline']:.4f} ms on {card}")
    log(f"[hopper] phase 28 took {time.perf_counter() - t_phase:.1f} s")


def walk_bytes(span: int, rows_per: int, chains: int, n: int) -> int:
    """Bytes of the distinct 512-byte rows a walk of ``n`` iterations reads."""
    k = torch.arange(n * chains, dtype=torch.int64)
    rows = (k * 97) % span
    return int(torch.unique(rows[:, None] + torch.arange(rows_per)[None, :]).numel()) * 512


# MB2's work per iteration: (operations, bytes read and written once)
MB_SCALAR_WORK = {"loop": (1, 0), "smem24": (24, 256), "l1x24": (24, 256), "shfl_bcast": (1, 128),
                  "smem_bcast": (1, 128), "l1_bcast": (1, 128), "reduce": (2048 + 160, 4096)}


def mb_work(v, n: int) -> tuple[int, int]:
    """(bytes, operations) of ``n`` iterations of microbenchmark variant
    ``v`` (an ``ops.cuda.microbench.Variant``), outputs included."""
    p = v.params
    if v.kernel == "mb_walk":
        return (walk_bytes(p["span"], p["rows_per"], p["chains"], n) + 16,
                n * p["chains"] * (1 + (40 * 32 if p["mode"] == 1 else 0)))
    if v.kernel == "mb_scalar":
        ops, nbytes = MB_SCALAR_WORK[p["variant"]]
        return nbytes + 12, n * ops
    slots, bits = p["slots"], p["parts"]
    ops = ((SLAB_OPS * slots if bits & 1 else 0) + (MT_OPS if bits & 2 else 0)
           + (slots if bits & 4 else 0) + (slots if bits & 8 else 0))
    return 4 * (8 * slots + 12) + 24 + 12, n * ops


def microbench_phase(env: dict) -> dict:
    """27. MB1–MB4 on the card: each variant timed per iteration at small n
    (the counted run), then each against its plain version; MB4's largest
    block → the kernels-line rows of the four."""
    from raytracer_tpu_torch.ops.cuda import microbench as mb

    card, dev = env["card"], env["dev"]
    variants = list(mb.sweep(dev, levels=("L1", "L2")))
    probe_in = torch.arange(64 * 1024, dtype=torch.float32, device=dev)

    # the counted run: every variant timed per iteration, and the capacity probe
    torch.cuda.synchronize()
    mb.reset_launches()
    costs = []
    for v in variants:
        v.prepare()
        cost = mb.per_iteration(v.launch, MB_N_HI, MB_N_LO)
        costs.append(cost)
        log(f"[MB] {v.kernel} {v.label}: {cost.ns:.3f} ns/iter {cost.cycles:.2f} cycles/iter "
            f"(n {MB_N_LO} -> {MB_N_HI}) on {card}")
    cap = mb.smem_capacity(probe_in)
    torch.cuda.synchronize()
    launches = dict(mb.LAUNCHES)
    log(f"[MB] launches during the timed run: {json.dumps(launches)}")
    if not all(launches.values()):
        fail(f"a microbenchmark kernel was not launched: {launches}")
    if not cap["checked"] or cap["max_bytes"] < 48 * 1024:
        fail(f"mb_smem_probe: {cap}")
    log(f"[MB4] largest dynamic shared memory of one block: {cap['max_bytes']} bytes = "
        f"{cap['records_4wide_k32']} 4-wide or {cap['records_8wide_k32']} 8-wide K = 32 records "
        f"on {card}")

    # each variant against its plain version at n = MB_N_HI (not counted)
    rows = {k: {"launches": launches[k], "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                "bytes": 0, "ops": 0, "variants": 0} for k in MB_KERNELS}
    for v, cost in zip(variants, costs):
        v.prepare()
        got = v.run(MB_N_HI)
        t0 = time.perf_counter()
        ref = v.plain(MB_N_HI)
        plain_ms = (time.perf_counter() - t0) * 1e3
        if got != ref:
            fail(f"{v.kernel} {v.label}: kernel {got}, plain {ref}")
        nbytes, ops = mb_work(v, MB_N_HI)
        row = rows[v.kernel]
        row["ms"] += cost.ms_hi
        row["plain_ms"] += plain_ms
        row["bytes"] += nbytes
        row["ops"] += ops
        row["variants"] += 1
    out = mb.mb_smem_probe(probe_in, cap["max_bytes"])
    _, probe_ms = timed_once(lambda: mb.mb_smem_probe(probe_in, cap["max_bytes"]))
    t0 = time.perf_counter()
    want = mb.mb_smem_probe_reference(probe_in, cap["max_bytes"] // 4)
    probe_plain_ms = (time.perf_counter() - t0) * 1e3
    if out is None or out != want:
        fail(f"mb_smem_probe at {cap['max_bytes']} bytes: kernel {out}, plain {want}")
    rows["mb_smem_probe"].update(ms=probe_ms, plain_ms=probe_plain_ms, bytes=cap["max_bytes"] + 4,
                                 ops=0, variants=1, max_bytes=cap["max_bytes"])
    for kernel, row in rows.items():
        b_ms, o_ms = row["bytes"] / HBM_BYTES_PER_S * 1e3, row["ops"] / F32_OPS_PER_S * 1e3
        row.update(bound_ms=max(b_ms, o_ms), bound_by="bytes" if b_ms >= o_ms else "operations",
                   n=MB_N_HI)
        log(f"[MB] {kernel}: {row['variants']} variants against their plain versions at n = "
            f"{MB_N_HI}: equal; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.2f} ms, bound "
            f"{row['bound_ms']:.6f} ms by {row['bound_by']} on {card}")
    return rows


# 29. the apps and the build chain
APP_FRAMES, APP_FPS_FRAMES = 30, 3000  # the latter: a few 1 Hz readouts
APP_CAMERA = (0.0, 0.0, 3.5)  # apps/main.py's start camera (RenderConfig.camera)
TREES = (("sah K=32", "sah", LEAF_K), ("lbvh K=1", "lbvh", 1), ("sah K=1", "sah", 1),
         ("ploc K=1", "ploc", 1))


def decode_png(data: bytes):
    """(H, W, C) uint8 numpy array of a PNG as utils.image.encode_png writes
    it: 8-bit samples, no interlace, filter 0 on every row."""
    import struct
    import zlib

    import numpy as np

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail("not a PNG file")
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, color_type = ihdr[:4]
    channels = {0: 1, 4: 2, 2: 3, 6: 4}[color_type]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * channels)
    if depth != 8 or bool((raw[:, 0] != 0).any()):
        fail(f"PNG of depth {depth} or with row filters other than 0")
    return raw[:, 1:].reshape(h, w, channels)


def apps_phase(env: dict, scene) -> None:
    """29. The apps and the rest of the build chain on the dragon at 1080p:
    (a) PLOC and SAH at K = 1 built on the card (PLOC word for word the CPU
    build), K1a on them against its plain version and brute force, visits and
    MT tests a ray; (b) SAH K = 32, Morton LBVH K = 1, SAH K = 1 and PLOC
    K = 1 render() and K1a side by side, A-B-C-D-D-C-B-A, framed and sparse,
    beside fast_build_options; (c) apps.main with its artifact POST to the
    API server and its PNG checked, then at --builder auto with --orbit; (d)
    checkpoint round trips; (e) apps.debug at its defaults."""
    import argparse
    import shutil
    import tempfile
    import threading

    import numpy as np

    from raytracer_tpu_torch import PathTracer, fast_build_options
    from raytracer_tpu_torch.apps import debug as app_debug
    from raytracer_tpu_torch.apps import main as app_main
    from raytracer_tpu_torch.ops import ploc
    from raytracer_tpu_torch.ops.cluster import tree_height
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.server import api
    from raytracer_tpu_torch.utils import procgen

    card, dev, tris = env["card"], env["dev"], env["tris"]
    t_phase = time.perf_counter()
    views = (("framed", FRAMED), ("sparse", SPARSE))
    rays = WIDTH * HEIGHT

    # (a) the four trees; the PLOC build counts its rounds (live clusters at each)
    rounds = []
    real_nearest = ploc._nearest

    def counting_nearest(cmn, cmx, radius):
        rounds.append(cmn.shape[0])
        return real_nearest(cmn, cmx, radius)

    trees = {}
    for name, builder, k in TREES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        pt = PathTracer(WIDTH, HEIGHT, builder=builder, leaf_size=k, device=dev)
        ploc._nearest = counting_nearest
        try:
            t0 = time.perf_counter()
            pt.set_scene(scene)
            secs = time.perf_counter() - t0
        finally:
            ploc._nearest = real_nearest
        if not torch.equal(pt._tris_dev, tris):
            fail(f"{name}: the tracer holds other triangles than phase 3's")
        pt.set_camera_quaternion(*QUAT)
        pt.fov_degrees = FOV
        trees[name] = pt
        height = pt._bvh2_height if pt._bvh2_height is not None else tree_height(pt._bvh2)
        log(f"[apps] {name}: set_scene in {secs:.2f} s: {json.dumps(pt.build_stats)}; BVH2 rows "
            f"{pt._bvh2.num_nodes}, height {height}; records {tuple(pt._qnodes.shape)} = "
            f"{pt._qnodes.numel() * 4 / 2**20:.1f} MiB; peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB on {card}")
    log(f"[apps] PLOC on the card: {len(rounds)} rounds, live clusters at the first rounds "
        f"{rounds[:8]}, at the last {rounds[-4:]}; build {trees['ploc K=1'].build_stats['lbvh2_ms']:.2f} "
        f"ms on {card}")
    t0 = time.perf_counter()
    cpu2 = ploc.build_ploc2(tris.cpu())
    cpu_s = time.perf_counter() - t0
    for field, a, b in zip(("bounds", "left", "right", "meta", "parent"), trees["ploc K=1"]._bvh2,
                           cpu2):
        if not torch.equal(a.cpu(), b):
            fail(f"ploc K=1: BVH2 {field} on the card differs from the CPU build in "
                 f"{int((a.cpu() != b).sum())} words")
    log(f"[apps] ploc K=1: the BVH2 on the card equals the CPU build word for word (bounds, left, "
        f"right, meta, parent; {cpu2.num_nodes} rows; {cpu_s:.2f} s on the CPU)")
    del cpu2

    counts = {}
    for name in ("sah K=1", "ploc K=1"):
        chk = check_tiles(env, trees[name]._qnodes, f"K1a at {name}", jitter=False, leaf_k=1)
        if chk["stats"]["ties"] or chk["stats"]["max_abs_err"] != 0.0:
            fail(f"{name}: K1a differs from its plain version on the crop ({chk['stats']})")
        counts[name] = chk["counts"]

    # (b) the four trees side by side: render() and K1a alone, framed and sparse
    frame_ms = {}
    for view, pos in views:
        for pt in trees.values():
            pt.set_camera_position(*pos)
        renders = series({name: pt.render for name, pt in trees.items()}, FRAMES, 3)
        kernels = series({name: (lambda pt=pt, pos=pos: traverse.trace_tiles(
            pt._qnodes, pos, QUAT, WIDTH, HEIGHT, FOV, leaf_k=pt.leaf_size))
            for name, pt in trees.items()}, FRAMES, 3)
        hits = None
        for name, pt in trees.items():
            planes = traverse.trace_tiles(pt._qnodes, pos, QUAT, WIDTH, HEIGHT, FOV,
                                          leaf_k=pt.leaf_size, stats=True)
            h = int((planes[4] >= 0).sum())
            if hits is not None and h != hits:
                fail(f"apps {view}: {name} hits {h} pixels, SAH K={LEAF_K} {hits}")
            hits = h
            visits = float(planes[5].sum(dtype=torch.float64)) / rays
            c = counts.get(name)
            crop = (f"; crop: {c.visits / c.rays:.3f} visits and {c.mt_tests / c.rays:.3f} MT tests "
                    f"a ray" if c is not None and view == "framed" else "")
            log(f"[apps] {view} {name}: render() {renders[name]:.4f} ms = "
                f"{rays / renders[name] / 1e3:.2f} Mrays/s, K1a {kernels[name]:.4f} ms (medians, "
                f"order A-B-C-D-D-C-B-A, 3 reps of {FRAMES} each way); {visits:.3f} visits a ray "
                f"(K1f); hits {h}{crop} on {card}")
        frame_ms[view] = renders
    fastest = min(frame_ms["framed"], key=frame_ms["framed"].get)
    chosen = fast_build_options(dev)
    chosen_name = next(n for n, b, k in TREES if (b, k) == chosen)
    log(f"[apps] fastest framed render() in this run: {fastest}; fast_build_options({dev}) returns "
        f"{chosen} ({chosen_name}, {frame_ms['framed'][chosen_name]:.4f} ms) on {card}")

    # (c) the app, posting BVH2.bin to the API server
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_apps_"))
    srv = api.make_server(port=0, data_dir=tmp / "api", quiet=True)
    serving = threading.Thread(target=srv.serve_forever, daemon=True)
    serving.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    runs = []

    class RecordingStats(app_main.FrameStats):
        """The app's FrameStats, kept with the total the app reads at the end
        of its frame loop."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            runs.append(self)

        def summary(self):
            self.run = super().summary()
            return self.run

    real_stats = app_main.FrameStats
    app_main.FrameStats = RecordingStats
    try:
        size = ["--scene", "dragon", "--width", str(WIDTH), "--height", str(HEIGHT), "--api", url]
        torch.cuda.synchronize()
        traverse.reset_launches()
        t0 = time.perf_counter()
        rc = app_main.main([*size, "--frames", str(APP_FRAMES), "--builder", "lbvh",
                            "--out", str(tmp / "frame.png")])
        app_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(traverse.LAUNCHES)
        if rc != 0 or launches != expected(trace_tiles_k1a=APP_FRAMES):
            fail(f"apps.main returned {rc} and launched {launches}, expected "
                 f"{APP_FRAMES} K1a and nothing else")
        app_tris = app_main._load_scene(argparse.Namespace(glb=None, scene="dragon")).triangles
        ref = trees["lbvh K=1"]
        if not np.array_equal(app_tris, scene.triangles):
            ref = PathTracer(WIDTH, HEIGHT, device=dev)
            ref.build_bvh(app_tris)
        dumped = (tmp / "api" / "BVH2.bin").read_bytes()
        if dumped != ref.bvh2_artifact().tobytes():
            fail("the BVH2.bin the API server wrote differs from bvh2_artifact()")
        ref.set_camera_position(*APP_CAMERA)
        ref.set_camera_quaternion(*QUAT)
        want = ref.render().cpu().numpy()
        got = decode_png((tmp / "frame.png").read_bytes())
        if got.shape != want.shape or not np.array_equal(got, want):
            fail("the app's PNG does not decode to a fresh tracer's render() at its camera")
        run = runs[-1].run
        log(f"[apps] apps.main --builder lbvh, {APP_FRAMES} frames at {WIDTH}x{HEIGHT}: {app_s:.2f} s "
            f"in all; {APP_FRAMES} K1a launches; BVH2.bin ({len(dumped)} bytes) byte-equal to "
            f"bvh2_artifact(); the PNG decodes to render() at the start camera; FrameStats: "
            f"{run['fps']:.2f} FPS = {1e3 / run['fps']:.4f} ms a frame, 1 Hz readouts "
            f"{runs[-1].history} on {card}")
        for args in (["--builder", "lbvh"], ["--orbit"]):
            t0 = time.perf_counter()
            rc = app_main.main([*size, "--frames", str(APP_FPS_FRAMES), *args,
                                "--out", str(tmp / "fps.png")])
            app_s = time.perf_counter() - t0
            run = runs[-1].run
            if rc != 0 or not runs[-1].history:
                fail(f"apps.main {args} returned {rc} or gave no 1 Hz readout")
            log(f"[apps] apps.main {' '.join(args)}, {APP_FPS_FRAMES} frames at {WIDTH}x{HEIGHT}: "
                f"{app_s:.2f} s in all; FrameStats {run['fps']:.2f} FPS = "
                f"{1e3 / run['fps']:.4f} ms a frame ({run['mrays_per_s']:.2f} Mrays/s), 1 Hz "
                f"readouts {[r['fps'] for r in runs[-1].history]} on {card}")
    finally:
        app_main.FrameStats = real_stats
        srv.shutdown()
        srv.server_close()

    # (d) checkpoints: save, load into a fresh tracer, the same frame
    for name in ("sah K=32", "lbvh K=1"):
        src = trees[name]
        path = tmp / f"{name.replace(' ', '_').replace('=', '')}.npz"
        t0 = time.perf_counter()
        src.save_checkpoint(path)
        save_s = time.perf_counter() - t0
        fresh = PathTracer(WIDTH, HEIGHT, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.load_checkpoint(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        for pt in (src, fresh):
            pt.set_camera_position(*FRAMED)
            pt.set_camera_quaternion(*QUAT)
            pt.fov_degrees = FOV
        if fresh.leaf_size != src.leaf_size or not torch.equal(fresh.render(), src.render()):
            fail(f"{name}: the checkpoint's frame differs from the saved tracer's")
        log(f"[apps] checkpoint {name}: {path.stat().st_size / 2**20:.1f} MiB, saved in "
            f"{save_s:.2f} s, loaded in {load_s:.2f} s (records included); frame byte-equal on "
            f"{card}")
        del fresh
    del trees

    # (e) apps.debug at its defaults
    if app_debug.main(["--out", str(tmp / "debug.png"), "--json", str(tmp / "bvh.json")]) != 0:
        fail("apps.debug returned non-zero")
    debug_png = decode_png((tmp / "debug.png").read_bytes())
    dump = json.loads((tmp / "bvh.json").read_text())
    ref = PathTracer(960, 540, device=dev)
    ref.build_bvh(procgen.make_icosphere(3))
    n2 = int(ref.bvh2_artifact()[0])
    if debug_png.shape != (540, 960, 4) or dump["numNodes"] != n2 or len(dump["nodes"]) != n2:
        fail(f"apps.debug: PNG {debug_png.shape}, JSON {dump['numNodes']} nodes, "
             f"bvh2_artifact() {n2}")
    log(f"[apps] apps.debug: PNG 960x540, JSON of {n2} nodes = bvh2_artifact()'s; phase 29 in "
        f"{time.perf_counter() - t_phase:.1f} s on {card}")
    shutil.rmtree(tmp)


if __name__ == "__main__":
    main()
