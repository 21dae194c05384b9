"""Drive the PyTorch port's main paths once on one CUDA card and check its kernels.

Run from the repository root, with one card:

    python3 chip_smoke.py

Phases, each printing what it measures; the first failure exits non-zero:

1. the device: a CUDA card is required (there is no CPU path), and its name
   and power limit as nvidia-smi reports them;
2. the builds, started together: the native BVH library, the primary-ray
   kernels K1a/K1b/K1c/K1d/K1e/K1f (csrc/traverse_tiles.cu, in two builds:
   the render core, and TILE_CORE over leaves of K > 1), the ray-buffer
   kernels K2a/K2b/K2c (csrc/traverse_rays.cu), the camera
   wave's lanes (csrc/camera_lanes.cu), the sample's wave glue
   (csrc/wave_glue.cu) and the microbenchmark kernels
   MB1–MB4 (csrc/microbench.cu), with their seconds
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
   K1b, 1 camera_lanes, bounces−1 K2a, bounces K2b, bounces wave_hit and
   bounces wave_bounce, whether a sample runs op by op or is replayed from
   its CUDA graph; and the first sample of a frame size op by op, the second
   captured, the three after it replayed), the frame count, a finite
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
   frame chain: times, per-camera hit counts and launches; then the frame
   chain with K1c's raw tile layout (trace_tiles_batch(raw=True)), hits
   counted from its plane 4 as bench_suite.py:497 counts them: 1 K1c raw
   a frame and nothing else, per-camera counts equal to the image
   layout's, every word of one frame's raw array (written over NaN) equal
   to tiles_layout of its image planes, and raw against image A-B-B-A;
15. the 8-wide main path at full size: PathTracer(widener="collapse8") on
   the dragon: set_scene (build seconds, BVH8 rows, record bytes, peak
   memory), render framed and sparse (1 K1e each, images equal to the
   4-wide tree's but for ties), render_progressive(bounces=3) four times
   (per sample 1 K1e, 1 camera_lanes, 2·bounces−1 K2c, bounces wave_hit and
   bounces wave_bounce, nothing else), and one sample
   under sync debug mode;
16. K1e against its plain version on the centre crop, with and without
   jitter, and against brute force on the 1,024 seeded pixels; the camera
   wave from the camera row on the 8-wide records as in phase 37 (K1e from
   the row equal to the host-argument K1e, the lanes to their plain
   version); K2c closest
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
and the microbenchmark kernels; they run last, 27 after every other phase:

25. the LBVH dragon at full size through PathTracer(builder="lbvh") at
   leaf_size 1 and 8: set_scene's stages, BVH2 rows, record bytes and peak
   memory; the Morton codes and order and the BVH2 (bounds, left, right,
   meta, parent) built on the card equal word for word the same functions
   run on the CPU, and at K = 8 the 4-wide collapse too (the CPU builds run
   after every timed phase: lbvh_cpu_check); render() framed and
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

After every timed phase (untimed_checks), the render core's machine code
(what every launch at K = 1 runs) is held instruction for instruction
against the parent's (tools_torch/render_core_sass.json, regenerated from
the parent by tools_torch/ab_parent.py in every change to
csrc/traverse_core.cuh's render core), beside phase 25's CPU builds.

Phase 29 drives the headless apps and the rest of the build chain; it runs
after phase 33, before 27:

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

Phases 30–32 drive the last modules of the port; they run after phase 29,
before 27:

30. parallel/mesh.py on the dragon at 1080p (SAH K = 32): (a) a one-rank
   NCCL group in this process: the tile bands (K1a), spp (K1b), camera
   batch (K1c) and 3-bounce path-traced shardings bit-equal to the
   unsharded trace_tiles / K1b / trace_tiles_batch / pt_sample_frame of the
   same inputs, each call's launches, ms a call and of the collectives;
   (b) two gloo ranks sharing the card (spawned, each on cuda:0, each
   building the dragon itself): each band, the gathered frame and the
   cameras bit-equal to the one-rank run (digests, the records' too), the
   spp and path-traced means of two seeds within 1e-6 of the unsharded
   ones, launches checked on each rank, band and collective ms;
31. tools/mb_viewer_fps.py's protocol through the port's ViewerState on the
   dragon with fast_build_options, camera (0, 0, 1.3), at 960x540 and
   1920x1080: 60 active steps at stream scales 2 and 1 (one K1a each), ms a
   frame split into the host's issue / wait / encode, and render, pull and
   encode alone; the idle full-resolution publish (5 times, each PNG
   decoding to render() at the viewer's camera) and the park (no launch);
   at 960x540 five make_viewer_server round trips on localhost (GET
   /api/frame.png, POST /api/input);
32. graft_entry.entry() on the card against its CPU output, the NCCL dry
   run dryrun_multichip(1), and config 4's interior hall at 512x512 split
   (meshops.split_large_triangles at extent 0.25) and unsplit through K1a
   on SAH K = 32 records: the tri planes equal but for ties, shared-edge
   hits and cracks of the unsplit mesh (at most 0.5% of the pixels), each
   frame's ms and visits a ray (K1f).

Phase 33 drives wavefront compaction and K2 without near-first order; (a)
runs right after phase 11, the rest after phase 26, before 29:

33. (a) render_progressive(bounces=3) at 1080p with compaction on: 1 K1b,
   1 camera_lanes, 2 K2a, 3 K2b, 3 wave_hit and 3 wave_bounce a sample and
   nothing else, no host-device
   synchronisation, a finite non-negative buffer, the sort's and gathers'
   kernels under torch.profiler; (b) K2a / K2b / K2c with ordered=False on
   every captured wave (SAH K = 32, Morton K = 1, 8-wide): on all 2,073,600
   lanes the closest-hit planes bit-identical to the ordered kernel's and
   the occlusion masks equal, and on 65,536 seeded active rays of each
   every word equal to the plain version's (ordered=False), with visits
   and Möller–Trumbore tests a ray of both orders, times and bounds; (c) a
   compacted 256×256 sample, argsort and partition, through the kernels
   and through the plain versions, under phase 9's limits; (d) one
   compacted 1080p sample with both orders off on 4-wide and on 8-wide
   records: 1 K1b, 2 K2a, 3 K2b unordered and 1 K1e, 5 K2c unordered, 2
   camera_lanes, 6 wave_hit and 6 wave_bounce, and nothing else; (e) on the compactions of 1080p samples, the partition's
   permutation the stable argsort of the 8-bit key, which groups the lanes
   as the 32-bit key's argsort does; (f) at SAH K = 32 and Morton K = 1,
   the sample with no compaction (persistent warps on the scattered
   waves), argsort and partition compaction (one thread per ray), each
   with ordered and unordered any hit, timed in one series forward and
   back (4 samples each), with each wave's ms and alive share, the
   compactions' ms, and one thread per ray against persistent warps on
   the compacted waves.

Phase 37 runs after phase 10:

37. the camera wave as a progressive sample runs it, from the jittered
   framed 1080p view's camera row on the card: K1b traced from the row
   (traverse.trace_tiles_row, K1c's kernel over one frame) equal word for
   word on the whole frame to K1b's host-argument planes of phase 6 and
   within phase 6's tolerances of its plain version on the crop, one K1b
   and one camera_lanes launched; the camera wave's lanes
   (csrc/camera_lanes.cu) from the same row: d, t, tri and n torch.equal
   to its plain version's (camera_lanes_reference, the composition the
   sample ran before the kernel); the bare launch's CUDA-event time, the
   wrapper's host issue time, the plain version's time, and the bound, 52
   bytes a lane (five plane words read; d, n, t and tri written) over
   3.35 TB/s.

Phase 39 runs after phase 7's four samples:

39. one sample of the framed 1080p view replayed from the CUDA graph that
   phase 7 captured, started anew (frame count 0, so the mean returned is
   the sample): torch.equal to the same sample run op by op (counters on),
   the replay counted once, and what the replay adds to the kernels'
   launch counts equal to the launches the op-by-op sample made; and
   against the same sample through the plain versions of every kernel
   (plain_traversal), the share of pixels within 1e-5, as phase 9.

Phase 38 runs after phase 37:

38. the sample's wave glue (csrc/wave_glue.cu) on the waves of one
   render_progressive(bounces=3) of the framed 1080p view run op by op (with
   counters on, as every counted sample runs), captured at the wrappers:
   each wave's wave_hit, wave_bounce and the last wave's
   wave_last equal to their plain versions value for value (NaN for NaN);
   each call's CUDA-event time through the wrapper, the wrapper's host issue
   time, the plain version's time, and the bound by bytes (each input read
   once, each output written once; the bounce reads n, p and the draws of
   the lanes that hit, o and d of the others) over 3.35 TB/s.

Phases 34 and 35 drive the two options of the TPU kernels; they run after
phase 14:

34. BASELINE config 1 as bench_suite.py:64-110 runs it on the TPU: the Cornell
   box (34 triangles) through the Morton LBVH of single triangles
   (bvh2_as_bvh4(build_lbvh2(...)), K = 1), 256 frames from (1e-3·i, 0,
   2.2) at 256×256 in one K1c raw launch (exactly 1 and nothing else), the
   hits of each frame from plane 4; every word of the raw array (written
   over NaN) equal to tiles_layout of the image planes of the same
   cameras, the hit counts equal; frames 0 and 255 against the plain
   version; raw against image layout A-B-B-A, ms, Mrays/s and bounds;
35. K2's record placements (trace_rays(tree_space=...)) on the waves of
   tools_torch/mb_tree_space.py at 512×512 — nee (any hit toward the sun),
   bounce1 (cosine-sampled closest hit), incoherent (the same, permuted) —
   on config 4's hall (SAH K = 32) and config 1's Cornell box (its LBVH at
   K = 1, and SAH K = 32): every wave under "vmem", and under "smem" where
   the tree fits a block, with the launches counted (_vmem / _smem names,
   nothing else); every lane bit-identical to "hbm", one thread per ray and
   persistent, and on deep_records (stacks past 64) at both widths and
   orders; "smem" refused on the hall and the dragon, "vmem" on the
   dragon (ValueError, nothing launched); no access-policy window and the
   persisting carve-out as before after the "vmem" calls; each placement
   against "hbm" A-B-B-A, and the rows of the
   kernels line against the plain version on 65,536 seeded rays a wave.

Phase 36 drives the paths that only the benchmark runs; it runs after phase
32, before 27:

36. BASELINE configs 2 and 4 through bench_suite_torch.py's records and
   frame functions at full size: config 2, make_icosphere(6) (81,920
   triangles) at 512x512 from (0, 0, 2.8), 4 samples of 1 bounce + NEE, and
   config 4, the interior hall (5,250 triangles) at 512x512 from (0, 0, 0.8),
   1 sample of 4 bounces + NEE, both on SAH K = 32 records. One frame of each
   with the launches counted (config 2: 4 K1b, 4 camera_lanes, 4 K2b, 4
   wave_hit and 4 wave_bounce; config 4: 1 K1b, 1 camera_lanes, 3 K2a, 4
   K2b, 4 wave_hit and 4 wave_bounce; nothing else) and its
   alive share; one sample of each
   scene and camera at the frame's size (512x512, 262,144 lanes a wave) and
   one at 256x256 (65,536 lanes) through the kernels and through the plain
   versions, radiance within 1e-5 on >= 99.9% of the pixels; and each
   configuration's JSON line, timed on a stream of one frame.

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
crop under the frame's bounds and entries for K1d, frames 0 and 255 of
config 1 for K1c raw, the checked rays of the hall's waves for K2a/K2b
vmem and of config 1's tree's for K2a/K2b smem — and
``path_ms``/``path_bound_ms`` on the main path's whole frame, batch or
waves (``path_rays`` rays, active lanes for K2; for K1f the framed frame
at both widths; for K1d the framed frame under its bounds and entries, the
kernel alone). ``launches``: K1d's are those of phases 21–23's calls, K1e's
are those of phase 15's render calls
and samples, K2c's of its samples, K1f's of phase 19's frames, K1c raw's of
phases 14 and 34, the placements' of phase 35's path. A raw row's bytes
count six f32 planes a pixel; a placement row's ``ms`` includes what the
placement does around its launch ("vmem": the carve-out, the wait for the
launch and the reset).

The camera_lanes row (it replaces no TPU kernel: the JAX package's
pt_sample_frame does this set-up with array ops that XLA fuses) holds phase
37's numbers on the whole 1080p frame: ``rays`` = ``path_rays`` = its
lanes, ``ms`` = ``path_ms`` the bare launch, ``issue_ms`` the wrapper's
host time, ``launches`` those of phase 7.

The wave_hit and wave_bounce rows (they replace no TPU kernel either) hold
phase 38's numbers summed over the waves of one 1080p sample: ``rays`` =
``path_rays`` its lanes, ``ms`` = ``path_ms`` the launches through the
wrapper, ``issue_ms`` the wrappers' host time, ``launches`` those of phase 7.

The K1b, camera_lanes, K2a, K2b, wave_hit and wave_bounce rows also carry
``bench_launches``: phase 36's launches of one frame of config 2 and of
config 4.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels as JSON, and the line before that the card.
"""

from __future__ import annotations

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
LANE_BYTES = 52  # the camera wave's lanes: 5 plane words read, d, n (12 B), t, tri written
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
    "trace_rays_k2a_unordered": ("raytracer_tpu_torch/csrc/traverse_rays.cu",
                                 "raytracer_tpu/ops/pallas/traverse.py:919"),
    "trace_rays_k2b_unordered": ("raytracer_tpu_torch/csrc/traverse_rays.cu",
                                 "raytracer_tpu/ops/pallas/traverse.py:919"),
    "trace_rays_k2c_unordered": ("raytracer_tpu_torch/csrc/traverse_rays.cu",
                                 "raytracer_tpu/ops/pallas/traverse.py:919"),
    # the raw tile layout (trace_tiles_batch_pallas(raw=True)) and the record
    # placements (trace_rays_pallas(tree_space=...))
    **{f"trace_tiles_{k}_raw": ("raytracer_tpu_torch/csrc/traverse_tiles.cu",
                                "raytracer_tpu/ops/pallas/traverse.py:1135")
       for k in ("k1c", "k1e", "k1f")},
    **{f"trace_rays_{k}{order}_{space}": ("raytracer_tpu_torch/csrc/traverse_rays.cu",
                                          "raytracer_tpu/ops/pallas/traverse.py:1197")
       for space in ("vmem", "smem") for order in ("", "_unordered")
       for k in ("k2a", "k2b", "k2c")},
    "camera_lanes": ("raytracer_tpu_torch/csrc/camera_lanes.cu",
                     "none: array ops of raytracer_tpu/render_pt.py:303-356, fused by XLA"),
    **{name: ("raytracer_tpu_torch/csrc/wave_glue.cu",
              "none: array ops of raytracer_tpu/render_pt.py:369-406, 451-456, "
              "fused by XLA")
       for name in ("wave_hit", "wave_bounce")},
}
# the microbenchmark kernels (their launches are counted apart, in
# ops.cuda.microbench.LAUNCHES) and the TPU kernels they replace
MB_SOURCE = "raytracer_tpu_torch/csrc/microbench.cu"
MB_KERNELS = {"mb_walk": (MB_SOURCE, "tools/mb_kernel.py:108"),
              "mb_scalar": (MB_SOURCE, "tools/mb_kernel.py:86"),
              "mb_visit": (MB_SOURCE, "tools/mb_kernel2.py:66"),
              "mb_smem_probe": (MB_SOURCE, "tools/mb_smem_probe.py:29")}
MB_N_LO, MB_N_HI = 100, 1000  # small n: the full sweep is chip_microbench.py's


# LAUNCHES' counts of the progressive samples replayed from a CUDA graph and
# of the graphs captured (render_pt.SampleGraphs), beside the kernels'
GRAPH_COUNTS = ("sample_graph_replay", "sample_graph_capture")
# SAMPLES samples of a frame size a tracer has not sampled: the first runs op
# by op, the second captures the graph, and it and the rest replay it
GRAPHED = {"sample_graph_replay": SAMPLES - 1, "sample_graph_capture": 1}


def expected(**counts: int) -> dict:
    """The launch counts of a run that launched ``counts`` and nothing else."""
    return {name: counts.get(name, 0) for name in (*KERNELS, *GRAPH_COUNTS)}


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
    log. The template arguments are <child slots, jitter, visits, raw, core>
    for the batch tile kernel, <child slots, jitter, visits, bounds, core> for
    the one-frame tile kernel, <child slots, any hit, core> for both ray
    kernels (core: the feature mask of csrc/traverse_core.cuh, | 8 without
    near-first order, | 16 with the records in shared memory)."""
    rows, name, frame = [], None, (0, 0, 0)
    for line in nvcc_log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            k = re.search(r"((?:trace|mb|wave)_\w+?_kernel|camera_lanes_kernel)(I(?:L[ibj]\d+E)+)?",
                          m.group(1))
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
    """Build the native library and every kernel source at once, and print
    what ptxas says of every kernel instantiation."""
    from raytracer_tpu_torch.native import bvhtool
    from raytracer_tpu_torch.ops.cuda import camera, traverse, wave

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0

    from raytracer_tpu_torch.ops.cuda import microbench

    with ThreadPoolExecutor(max_workers=6) as pool:
        jobs = {"native BVH library": pool.submit(timed, bvhtool.ensure_built),
                "microbench.cu (MB1, MB2, MB3, MB4)": pool.submit(
                    timed, microbench.load_microbench),
                "traverse_tiles.cu (K1a, K1b, K1c, K1d, K1e, K1f)": pool.submit(
                    timed, traverse.load_kernel, "traverse_tiles.cu"),
                "traverse_tiles.cu:warp (K1 over leaves of K > 1)": pool.submit(
                    timed, traverse.load_kernel, "traverse_tiles.cu:warp"),
                "traverse_rays.cu (K2a, K2b, K2c)": pool.submit(
                    timed, traverse.load_kernel, "traverse_rays.cu"),
                "camera_lanes.cu (the camera wave's lanes)": pool.submit(
                    timed, camera.load_camera_lanes),
                "wave_glue.cu (the sample's wave glue)": pool.submit(
                    timed, wave.load_wave_glue)}
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


def capture_waves(env: dict, qn: torch.Tensor, leaf_k: int = LEAF_K,
                  **sample_kw) -> tuple[list[dict], dict]:
    """One 1080p 3-bounce sample of the framed view through the kernels, from
    SAMPLE_SEED (``sample_kw``: more arguments of pt_sample_frame), with the
    rays, active mask and result of every ray-buffer wave captured, and the
    lanes' origins, directions and liveness at every compaction → (waves,
    the sample's statistics with ``compactions``)."""
    from raytracer_tpu_torch import render_pt

    waves, compactions = [], []
    real_trace_rays, real_perm = render_pt.trace_rays, render_pt._compaction_perm

    def capturing(qnodes, origins, dirs, *, any_hit=False, leaf_k, active=None,
                  scattered=False, ordered=True):
        out = real_trace_rays(qnodes, origins, dirs, any_hit=any_hit, leaf_k=leaf_k,
                              active=active, scattered=scattered, ordered=ordered)
        waves.append({"any_hit": any_hit, "o": origins, "d": dirs, "active": active,
                      "scattered": scattered, "ordered": ordered, "out": out})
        return out

    def capturing_perm(o, d, alive, impl):
        compactions.append({"o": o, "d": d, "alive": alive, "impl": impl})
        return real_perm(o, d, alive, impl)

    render_pt.trace_rays, render_pt._compaction_perm = capturing, capturing_perm
    try:
        _, sample_stats = render_pt.pt_sample_frame(
            qn, env["tris"], FRAMED, QUAT, WIDTH, HEIGHT, bounces=BOUNCES, fov_degrees=FOV,
            leaf_k=leaf_k, tile_primary=True,
            generator=torch.Generator(device=env["dev"]).manual_seed(SAMPLE_SEED), stats=True,
            **sample_kw)
    finally:
        render_pt.trace_rays, render_pt._compaction_perm = real_trace_rays, real_perm
    log(f"[waves] captured {len(waves)} ray-buffer waves{' ' + json.dumps(sample_kw) if sample_kw else ''}; "
        f"alive rays per sample {int(sample_stats['alive_rays'])} of "
        f"{int(sample_stats['lane_rays'])} lanes")
    sample_stats["compactions"] = compactions
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
    return wave_stats


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
    pt_want = expected(trace_tiles_k1b=SAMPLES, camera_lanes=SAMPLES,
                       trace_rays_k2a=SAMPLES * (BOUNCES - 1), trace_rays_k2b=SAMPLES * BOUNCES,
                       wave_hit=SAMPLES * BOUNCES, wave_bounce=SAMPLES * BOUNCES, **GRAPHED)
    progressive_samples(pt, pt_want, "progressive")
    # 39. one replayed 1080p sample against op by op and the plain versions
    replay_phase(env, pt)
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
    env["waves"] = {LEAF_K: waves}  # for phase 33

    # 9. one whole 256x256 sample: kernels vs plain versions
    def small_sample():
        return render_pt.pt_sample_frame(
            qn, tris, FRAMED, QUAT, CROP, CROP, bounces=BOUNCES, fov_degrees=FOV,
            leaf_k=LEAF_K, tile_primary=True,
            generator=torch.Generator(device=dev).manual_seed(SAMPLE_SEED))

    by_kernels = small_sample()
    by_plain, whole_plain_ms = timed_once(lambda: plain_traversal(small_sample))
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

    # 37. the camera wave's lanes on K1b's planes
    rows["camera_lanes"] = camera_lanes_phase(env, k1b, pt_want["camera_lanes"])

    # 38. the sample's wave glue on the waves of one 1080p sample
    rows.update(wave_glue_phase(env, pt, pt_want))

    # 11. where the time of a progressive sample goes
    pt.set_camera_position(*FRAMED)
    profile_calls(lambda: pt.render_progressive(bounces=BOUNCES),
                  f"render_progressive(bounces={BOUNCES})", card)

    # 33 (a). render_progressive with compaction on
    compacted_progressive_phase(env, pt)

    # 20.-24. depth bounds and entry nodes (K1d)
    rows["trace_tiles_k1d"] = bounded_phase(env, pt)

    # 12.-14. the frame batch, the dynamic dragon and config 5
    rows["trace_tiles_k1c"] = batch_phase(env)
    dynamic_phase(env, pt)
    config5_launches = config5_phase(env)
    del pt

    # 34. config 1 through the raw tile layout; 35. K2's record placements
    rows["trace_tiles_k1c_raw"] = config1_phase(env, config5_launches)
    rows.update(tree_space_phase(env))

    # 15.-19. the 8-wide tree and the visits plane
    rows.update(wide8_phase(env, scene))

    # 25.-26. the Morton LBVH trees (K = 1, K = 8) and the leaf-size question
    trees = lbvh_phase(env, scene)
    leaf_phase(env, trees)

    # 33. compaction and K2 without near-first order
    compaction_phase(env, trees, rows)

    del trees

    # 29. the apps and the rest of the build chain
    apps_phase(env, scene)

    # 30.-32. the shardings, the live viewer, the driver entry points and meshops
    sharding_phase(env)
    viewer_phase(env, scene)
    graft_phase(env)

    # 36. the bench's new paths: configs 2 and 4
    bench_phase(env, rows)

    # 27. the microbenchmark kernels
    mb_rows = microbench_phase(env)

    # after every timed phase: the checks that only the host's CPU runs
    # (phase 25's reference builds, the render core's machine code)
    untimed_checks(env)

    log(card)
    sources = {**KERNELS, **MB_KERNELS}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": sources[name][0],
        "replaces": sources[name][1], **row, "library_ms": None,
    } for name, row in {**rows, **mb_rows}.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


def framed_row(dev) -> torch.Tensor:
    """The framed 1080p view's camera row with JITTER_SEED, on ``dev``: what
    a progressive sample of that view hands K1b and the lanes kernel."""
    from raytracer_tpu_torch.ops.cuda import traverse

    return torch.tensor(traverse.camera_row(FRAMED, QUAT, WIDTH, HEIGHT, FOV, JITTER_SEED),
                        dtype=torch.float32, device=dev)


def check_row_wave(env: dict, qn: torch.Tensor, host: dict, label: str) -> tuple:
    """The camera wave as a progressive sample runs it, from the framed
    view's camera row on the card: K1b (K1e on 8-wide ``qn``) traced from the
    row (traverse.trace_tiles_row, K1c's kernel over one frame) equal word
    for word on the whole frame to the host-argument kernel's jittered
    planes ``host`` (check_tiles) and within phase 6's tolerances of the
    plain version on the crop; the lanes kernel from the row equal word for
    word to its plain version. Returns (row, planes, lanes)."""
    from raytracer_tpu_torch.ops.cuda import camera, traverse

    row = framed_row(env["dev"])
    before = dict(traverse.LAUNCHES)
    planes = traverse.trace_tiles_row(qn, row, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K)
    lanes = camera.camera_lanes(planes, row, WIDTH, HEIGHT, FOV)
    torch.cuda.synchronize()
    added = {k: v - before[k] for k, v in traverse.LAUNCHES.items() if v != before[k]}
    name = "trace_tiles_k1e" if qn.shape[1] == traverse.rec_layout(LEAF_K, 8)[2] \
        else "trace_tiles_k1b"
    if added != {name: 1, "camera_lanes": 1}:
        fail(f"{label} from the camera row launched {added}, expected one {name} and one "
             "camera_lanes")
    words = differing_words(planes, host["planes"])
    if words:
        fail(f"{label} from the camera row differs from the host-argument kernel in {words} "
             "words of the framed 1080p frame")
    crop_pix = env["crop_pix"]
    check_against([p.reshape(-1)[crop_pix] for p in planes], host["ref"], env["tris"],
                  env["origin"], frame_dirs(crop_pix, True),
                  f"{label} from the camera row vs plain, jittered 256x256 crop")
    ref = camera.camera_lanes_reference(planes, QUAT, WIDTH, HEIGHT, FOV, JITTER_SEED)
    for name, a, b in zip(("d", "t", "tri", "n"), lanes, ref):
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"camera_lanes {name}: {a.dtype} {tuple(a.shape)}, plain {b.dtype} "
                 f"{tuple(b.shape)}")
        if not torch.equal(a, b):
            fail(f"camera_lanes {name} after {label} differs from its plain version in "
                 f"{int((a != b).sum())} words at {WIDTH}x{HEIGHT}")
    log(f"[camera row] {label} traced from the framed view's camera row (jitter seed "
        f"{JITTER_SEED}) equals the host-argument kernel on all {WIDTH * HEIGHT} pixels; "
        "the lanes kernel from the row equals its plain version on every lane")
    return row, planes, lanes


def camera_lanes_phase(env: dict, k1b: dict, launches: int) -> dict:
    """37. The camera wave from the framed 1080p view's camera row
    (check_row_wave on K1b), then the lanes kernel's bare launch's
    CUDA-event time, the wrapper's host issue time, the plain version's
    time and the bound → its kernels-line row."""
    from raytracer_tpu_torch.ops.cuda import camera
    from raytracer_tpu_torch.ops.lanes import img_to_lanes

    card, dev = env["card"], env["dev"]
    row, planes, ker = check_row_wave(env, env["qn"], k1b, "K1b")
    lanes = WIDTH * HEIGHT
    hits = int((ker[2] >= 0).sum())
    turned = int((ker[3] != img_to_lanes(torch.stack(planes[1:4], -1), WIDTH, HEIGHT))
                 .any(-1).sum())
    log(f"[camera_lanes] {WIDTH}x{HEIGHT}, jitter seed {JITTER_SEED}: {hits} hits, {turned} "
        "normals turned")

    lib, _ = camera.load_camera_lanes()
    outs = [torch.empty_like(x) for x in ker]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def bare():
        err = lib.rt_camera_lanes(row.data_ptr(), WIDTH, HEIGHT, *(p.data_ptr() for p in planes),
                                  *(o.data_ptr() for o in outs), stream)
        if err:
            fail(f"rt_camera_lanes returned cudaError {err}")

    reps = cuda_ms(bare, FRAMES, REPEATS)
    if not all(torch.equal(o, k) for o, k in zip(outs, ker)):
        fail("the bare camera_lanes launches wrote other lanes than the wrapper's")
    ms = statistics.median(reps)
    args = (planes, row, WIDTH, HEIGHT, FOV)
    plain_args = (planes, QUAT, WIDTH, HEIGHT, FOV, JITTER_SEED)
    issue_ms, _ = host_issue_ms(lambda: camera.camera_lanes(*args))
    plain_ms = statistics.median(cuda_ms(lambda: camera.camera_lanes_reference(*plain_args),
                                         1, 3))
    b_ms = LANE_BYTES * lanes / HBM_BYTES_PER_S * 1e3
    log(f"[time] camera_lanes {WIDTH}x{HEIGHT}: kernel {ms:.4f} ms (reps "
        f"{[round(r, 4) for r in reps]}), wrapper {issue_ms:.4f} ms of host a call, plain "
        f"torch {plain_ms:.3f} ms, bound {b_ms:.4f} ms by bytes ({LANE_BYTES} B a lane) on {card}")
    return {"launches": launches, "max_abs_err": 0.0, "rays": lanes, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": "bytes", "issue_ms": issue_ms,
            "path_rays": lanes, "path_ms": ms, "path_bound_ms": b_ms, "path_bound_by": "bytes"}


def replay_phase(env: dict, pt) -> None:
    """39. One sample of the framed 1080p view replayed from the tracer's
    CUDA graph (captured in phase 7), started anew (frame count 0, so the
    mean returned is the sample): equal word for word to the same sample run
    op by op (counters on), whose launches, counted as each kernel is
    launched, must equal what the replay adds to LAUNCHES; and held to the
    same sample through the plain versions of every kernel, as phase 9
    holds the 256x256 sample."""
    from raytracer_tpu_torch import render_pt
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.utils import profiling

    dev = env["dev"]
    pt.set_camera_position(*FRAMED)

    def sample(counters: bool):
        pt.set_frame_count(0)
        torch.cuda.synchronize()
        before = dict(traverse.LAUNCHES)
        with profiling.tracing(spans=False, counters=counters):
            mean = pt.render_progressive(bounces=BOUNCES)
        torch.cuda.synchronize()
        profiling.collect()
        return mean, {k: v - before[k] for k, v in traverse.LAUNCHES.items() if v != before[k]}

    replayed, replay_added = sample(False)
    eager, eager_added = sample(True)
    log(f"[replay] launches of one replayed 1080p sample {json.dumps(replay_added)}; of the "
        f"same sample op by op {json.dumps(eager_added)}")
    graph = {k: replay_added.pop(k, 0) for k in GRAPH_COUNTS}
    if graph != {"sample_graph_replay": 1, "sample_graph_capture": 0}:
        fail(f"the 1080p sample after phase 7 was not one replay: {graph}")
    if replay_added != eager_added:
        fail(f"a replay adds {replay_added} to LAUNCHES; the sample op by op launches "
             f"{eager_added}")
    if not torch.equal(replayed, eager):
        fail(f"the replayed 1080p sample differs from the sample op by op in "
             f"{int((replayed != eager).sum())} words")

    def plain_sample():
        return render_pt.pt_sample_frame(
            env["qn"], env["tris"], FRAMED, QUAT, WIDTH, HEIGHT, bounces=BOUNCES,
            fov_degrees=FOV, leaf_k=LEAF_K, tile_primary=True,
            generator=torch.Generator(device=dev).manual_seed(0))

    plain, plain_ms = timed_once(lambda: plain_traversal(plain_sample))
    err = (replayed - plain).abs().amax(-1)
    share = float((err <= RADIANCE_ATOL).float().mean())
    log(f"[replay] the replayed 1080p sample equals the sample op by op word for word; against "
        f"the plain versions {share:.6f} of pixels within {RADIANCE_ATOL} (max |d| "
        f"{float(err.max()):.3g}); plain sample {plain_ms:.1f} ms")
    if share < MIN_RADIANCE_MATCH or not bool(torch.isfinite(replayed).all()):
        fail(f"replayed 1080p sample: {share:.6f} < {MIN_RADIANCE_MATCH} of pixels within "
             f"{RADIANCE_ATOL} of the plain sample")


def wave_bytes(name: str, args: tuple) -> int:
    """The bytes a wave glue call must move (phase 38): each input word read
    once (a broadcast origin once), each output written once; the bounce
    reads n, p, u1 and u2 of the lanes that hit, o and d of the others."""
    if name == "wave_hit":
        t, o = args[0], args[3]
        r = t.shape[0]
        return r * (4 + 4 + 12 + 12 + 1 + 12 + 12 + 42) + 12 * (r if o.stride(0) else 1)
    r = args[0].shape[0]
    if name == "wave_last":
        return r * (4 + 1 + 4 + 12 + 12 + 12)
    hits, o = int(args[1].sum()), args[7]
    return (r * (4 + 1 + 4 + 12 + 12 + 49) + hits * (12 + 12 + 4 + 4)
            + (r - hits) * 12 + 12 * ((r - hits) if o.stride(0) else 1))


def wave_glue_phase(env: dict, pt, pt_want: dict) -> dict:
    """38. The sample's wave glue on the waves of one 1080p
    render_progressive(bounces=3) of the framed view, captured at the
    wrappers: each call against its plain version (value for value, NaN for
    NaN), its CUDA-event time through the wrapper, the wrapper's host issue
    time, the plain version's time and the bound by bytes → the wave_hit and
    wave_bounce rows of the kernels line, summed over the sample's waves."""
    from raytracer_tpu_torch import render_pt
    from raytracer_tpu_torch.ops.cuda import wave
    from raytracer_tpu_torch.utils import profiling

    card = env["card"]
    real = {name: getattr(render_pt, name) for name in ("wave_hit", "wave_bounce", "wave_last")}
    plain = {"wave_hit": wave.wave_hit_reference, "wave_bounce": wave.wave_bounce_reference,
             "wave_last": wave.wave_last_reference}
    calls = []

    def capturing(name):
        def call(*args, **kw):
            calls.append((name, args, kw))
            return real[name](*args, **kw)
        return call

    for name in real:
        setattr(render_pt, name, capturing(name))
    pt.set_camera_position(*FRAMED)
    try:
        # counters on: the sample runs op by op, so that its wrappers are called
        with profiling.tracing(spans=False, counters=True):
            pt.render_progressive(bounces=BOUNCES)
    finally:
        for name, fn in real.items():
            setattr(render_pt, name, fn)
    torch.cuda.synchronize()
    profiling.collect()
    order = ["wave_hit", "wave_bounce"] * (BOUNCES - 1) + ["wave_hit", "wave_last"]
    if [c[0] for c in calls] != order:
        fail(f"a 1080p sample called {[c[0] for c in calls]}, expected {order}")
    rows = {k: dict.fromkeys(("rays", "ms", "plain_ms", "bound_ms", "issue_ms"), 0)
            for k in ("wave_hit", "wave_bounce")}
    for i, (name, args, kw) in enumerate(calls):
        ours, ref = (x if isinstance(x, tuple) else (x,) for x in (real[name](*args, **kw),
                                                                   plain[name](*args, **kw)))
        for j, (a, b) in enumerate(zip(ours, ref)):
            if a.dtype != b.dtype or a.shape != b.shape:
                fail(f"{name} of wave {i // 2}: output {j} is {a.dtype} {tuple(a.shape)}, plain "
                     f"{b.dtype} {tuple(b.shape)}")
            same = a == b
            if a.is_floating_point():
                same |= a.isnan() & b.isnan()
            if not bool(same.all()):
                fail(f"{name} of wave {i // 2}: output {j} differs from its plain version in "
                     f"{int((~same).sum())} values")
        lanes = args[0].shape[0]
        ms = statistics.median(cuda_ms(lambda: real[name](*args, **kw), FRAMES, REPEATS))
        issue, _ = host_issue_ms(lambda: real[name](*args, **kw))
        plain_ms = statistics.median(cuda_ms(lambda: plain[name](*args, **kw), 1, 3))
        nbytes = wave_bytes(name, args)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"[time] {name} of wave {i // 2} ({lanes} lanes): kernel {ms:.4f} ms, wrapper "
            f"{issue:.4f} ms of host a call, plain torch {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
            f"by bytes ({nbytes / lanes:.1f} B a lane), equal to the plain version on {card}")
        row = rows["wave_hit" if name == "wave_hit" else "wave_bounce"]
        for key, value in (("rays", lanes), ("ms", ms), ("plain_ms", plain_ms),
                           ("bound_ms", b_ms), ("issue_ms", issue)):
            row[key] += value
    return {name: {**row, "launches": pt_want[name], "max_abs_err": 0.0, "bound_by": "bytes",
                   "path_rays": row["rays"], "path_ms": row["ms"],
                   "path_bound_ms": row["bound_ms"], "path_bound_by": "bytes"}
            for name, row in rows.items()}


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
    refit, records, trace, frame = refit_chain(cs, plan, height + 2, tris0, cams, quats,
                                               (size, size))
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

    # the raw tile layout, as bench_suite.py:497 counts config 5's hits
    def trace_raw(q):
        return traverse.trace_tiles_batch(q, cams, quats, size, size, FOV, leaf_k=LEAF_K,
                                          raw=True)

    def frame_raw(i):
        return trace_raw(records(refit(i)))

    torch.cuda.synchronize()
    traverse.reset_launches()
    raw_hits = torch.zeros(N_CAMS, dtype=torch.int64, device=dev)
    for i in range(1, 1 + DYN_FRAMES):
        raw_hits += (frame_raw(i)[:, :, 4] >= 0).sum(dim=(1, 2, 3))
    torch.cuda.synchronize()
    raw_launches = dict(traverse.LAUNCHES)
    if raw_launches != expected(trace_tiles_k1c_raw=DYN_FRAMES):
        fail(f"config 5 raw launched {raw_launches} in {DYN_FRAMES} frames, expected one K1c "
             "raw each")
    if not torch.equal(raw_hits, hits):
        fail(f"config 5: hit counts of the raw layout {raw_hits.tolist()} differ from the image "
             f"layout's {hits.tolist()}")
    q = records(refit(3))
    raw, image = checked_raw(trace_raw, q, N_CAMS, size), trace(q)
    words = differing_words(raw, traverse.tiles_layout(image))
    if words:
        fail(f"config 5: the raw layout differs from the image planes' in {words} words")
    k1c = abba({"image": lambda: trace(q), "raw": lambda: trace_raw(q)}, FRAMES, REPEATS)
    whole = abba({"image": lambda: frame(9), "raw": lambda: frame_raw(9)}, FRAMES, REPEATS)
    log(f"[config5] raw layout: {DYN_FRAMES} frames, 1 K1c raw each and nothing else; "
        f"per-camera hits equal to the image layout's; every word of frame 3's "
        f"({N_CAMS}, {size * size // 1024}, 6, 8, 128) raw array equal to the layout of its "
        "image planes (written over NaN)")
    log(f"[A/B] config 5 A-B-B-A: K1c image {k1c['image']:.4f} ms, raw {k1c['raw']:.4f} ms; "
        f"whole frame image {whole['image']:.4f} ms, raw {whole['raw']:.4f} ms "
        f"({rays / whole['raw'] / 1e3:.2f} Mrays/s) on {card}")
    return raw_launches["trace_tiles_k1c_raw"]


def checked_raw(call, qn: torch.Tensor, frames: int, size: int) -> torch.Tensor:
    """``call(qn)``, a raw trace of ``frames`` frames of size × size, into a
    block that held NaN (the block of a NaN tensor of its shape, just
    freed): fails unless the raw array took that block and no NaN is left,
    so that every word was written."""
    shape = (frames, (size // 32) ** 2, 6, 8, 128)
    probe = torch.full(shape, float("nan"), device=qn.device)
    ptr = probe.data_ptr()
    del probe
    raw = call(qn)
    if raw.shape != shape or raw.data_ptr() != ptr:
        fail(f"raw array {tuple(raw.shape)} did not take the NaN block of {shape}")
    if bool(torch.isnan(raw).any()):
        fail(f"{int(torch.isnan(raw).sum())} words of the raw array were not written")
    return raw


C1_FRAMES, C1_SIZE, C1_Z = 256, 256, 2.2  # bench_suite.py:79-110: n_batch = max(frames, 256)
RAW_OUT_BYTES = 24  # six f32 planes a pixel


def tile_order_pixels(frames: int, size: int, dev) -> torch.Tensor:
    """The flat pixel index (py·size + px) of every word of a raw plane, in
    the raw layout's order, for ``frames`` frames → (frames·size²,)."""
    from raytracer_tpu_torch.ops.cuda import traverse

    idx = torch.arange(size * size, device=dev, dtype=torch.float32).reshape(1, size, size)
    planes = [idx.expand(frames, size, size)] * 5
    return traverse.tiles_layout(planes)[:, :, 0].reshape(-1).long()


def config1_phase(env: dict, config5_launches: int) -> dict:
    """34. BASELINE config 1 as bench_suite.py defines it on the TPU: the
    Cornell box (34 triangles, cube-normalized) through the Morton LBVH of
    single triangles (bvh2_as_bvh4(build_lbvh2(...)), K = 1), 256 frames
    from (1e-3·i, 0, 2.2) at 256x256 in one K1c raw launch, hits counted per
    frame from plane 4. The raw array against the image planes word for
    word, against the plain version on frames 0 and 255, raw against image
    layout A-B-B-A → the kernels-line row of K1c raw (its launches those of
    this phase and of config 5)."""
    from raytracer_tpu_torch import Scene
    from raytracer_tpu_torch.ops.camera import primary_dirs
    from raytracer_tpu_torch.ops.collapse import bvh2_as_bvh4
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.ops.lbvh import build_lbvh2
    from raytracer_tpu_torch.ops.trace import make_wide_bvh
    from raytracer_tpu_torch.utils import procgen

    card, dev = env["card"], env["dev"]
    t_phase = time.perf_counter()
    scene = Scene().set_triangles(procgen.make_cornell_box())
    scene._normalize_enabled, scene._normalize_mode = True, "cube"
    scene.normalize_mesh()
    tris = torch.from_numpy(scene.triangles).to(dev)
    qn = traverse.make_qnodes(make_wide_bvh(bvh2_as_bvh4(build_lbvh2(tris))), tris)
    n, size = C1_FRAMES, C1_SIZE
    poss = [(1e-3 * i, 0.0, C1_Z) for i in range(n)]
    quats = [QUAT] * n

    def raw_call(q=qn, p=poss, qs=quats):
        return traverse.trace_tiles_batch(q, p, qs, size, size, FOV, leaf_k=1, raw=True)

    def image_call(p=poss, qs=quats):
        return traverse.trace_tiles_batch(qn, p, qs, size, size, FOV, leaf_k=1)

    torch.cuda.synchronize()
    traverse.reset_launches()
    raw = checked_raw(raw_call, qn, n, size)
    hits = (raw[:, :, 4] >= 0).sum(dim=(1, 2, 3))
    torch.cuda.synchronize()
    launches = dict(traverse.LAUNCHES)
    if launches != expected(trace_tiles_k1c_raw=1):
        fail(f"config 1 launched {launches}, expected 1 K1c raw and nothing else")
    image = image_call()
    words = differing_words(raw, traverse.tiles_layout(image))
    if words:
        fail(f"config 1: the raw layout differs from the image planes' in {words} words")
    if not torch.equal(hits, (image[4] >= 0).sum(dim=(1, 2))) or int(hits.min()) <= 0:
        fail("config 1: per-frame hit counts of the raw layout differ from the image layout's")
    log(f"[config1] Cornell box {tris.shape[0]} triangles, LBVH K=1 records {tuple(qn.shape)} = "
        f"{qn.numel() * 4} bytes; {n} frames x {size}x{size} in 1 K1c raw launch "
        f"{tuple(raw.shape)}; every word of the raw array equal to the layout of the image "
        f"planes (written over NaN); hits a frame {int(hits.min())}..{int(hits.max())} of "
        f"{size * size}, equal to the image layout's")

    # frames 0 and n - 1 against the plain version, in the raw layout's order
    ends = [0, n - 1]
    counts = traverse.TraversalCounts()
    ref = traverse.trace_tiles_batch_reference(qn, [poss[f] for f in ends], [QUAT, QUAT], size,
                                               size, FOV, leaf_k=1, counts=counts)
    ker_raw = raw_call(p=[poss[f] for f in ends], qs=[QUAT, QUAT])
    ref_raw = traverse.tiles_layout(ref)

    def planes_of(a):
        return [a[:, :, p].reshape(-1) for p in range(4)] + [a[:, :, 4].reshape(-1).int()]

    pix = tile_order_pixels(len(ends), size, dev)
    dirs = primary_dirs(pix % size, pix // size, size, size, QUAT, FOV)
    origins = torch.tensor([poss[f] for f in ends], dtype=torch.float32, device=dev)
    origins = origins.repeat_interleave(size * size, dim=0)
    stats = check_against(planes_of(ker_raw), planes_of(ref_raw), tris, origins, dirs,
                          f"K1c raw vs plain, frames 0 and {n - 1} of config 1")
    ms = statistics.median(cuda_ms(lambda: raw_call(p=[poss[f] for f in ends],
                                                    qs=[QUAT, QUAT]), FRAMES, REPEATS))
    _, plain_ms = timed_once(lambda: traverse.tiles_layout(traverse.trace_tiles_batch_reference(
        qn, [poss[f] for f in ends], [QUAT, QUAT], size, size, FOV, leaf_k=1)))
    rays = len(ends) * size * size
    b_ms, b_by, detail = bound(counts, 1.0, rays * RAW_OUT_BYTES + len(ends) * 64)

    path = abba({"image": image_call, "raw": raw_call}, 3, REPEATS)
    path_counts = traverse.TraversalCounts()
    pick = torch.Generator(device="cpu").manual_seed(SEED + 4)
    sampled = (0, n // 3, 2 * n // 3, n - 1)
    for f in sampled:
        px = torch.randperm(size * size, generator=pick)[:WAVE_SAMPLES // 4].to(dev)
        traverse.trace_tiles_reference(qn, poss[f], QUAT, size, size, FOV, leaf_k=1, pixels=px,
                                       counts=path_counts)
    path_rays = n * size * size
    pb_ms, pb_by, p_detail = bound(path_counts, path_rays / path_counts.rays,
                                   path_rays * RAW_OUT_BYTES + n * 64)
    log(f"[time] config 1 K1c raw on frames 0 and {n - 1}: kernel {ms:.4f} ms, plain torch "
        f"{plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by} {json.dumps(detail)} on {card}")
    log(f"[A/B] config 1, {n} frames of {size}x{size} in one launch, A-B-B-A: image layout "
        f"{path['image']:.4f} ms, raw {path['raw']:.4f} ms = "
        f"{path['raw'] / n * 1e3:.3f} us a frame, {path_rays / path['raw'] / 1e3:.2f} Mrays/s; "
        f"bound {pb_ms:.4f} ms by {pb_by} {json.dumps(p_detail)} on {card}")
    log(f"[config1] phase 34 in {time.perf_counter() - t_phase:.1f} s on {card}")
    return {"launches": launches["trace_tiles_k1c_raw"] + config5_launches,
            "max_abs_err": stats["max_abs_err"], "rays": rays, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "path_rays": path_rays, "path_ms": path["raw"],
            "path_bound_ms": pb_ms, "path_bound_by": pb_by, "image_path_ms": path["image"]}


# chain levels of deep_records whose records fit one block's shared memory at
# 8 slots (197,632 bytes; 32 levels take 263,168) and still overflow 64-entry
# stacks
DEEP_SMEM_DEPTH = 24


def tree_space_phase(env: dict) -> dict:
    """35. K2's record placements (trace_rays(tree_space=...)) on the waves
    of tools_torch/mb_tree_space.py (the JAX tool's, 512x512): config 4's
    hall (SAH K = 32) and config 1's Cornell box (its Morton LBVH at K = 1,
    and SAH K = 32). The path: every
    wave under "vmem", and under "smem" where the tree fits, with their
    launches counted; every lane bit-identical to "hbm" in both schedules
    and on deep_records (stacks past 64, both widths and orders); the
    refusals where a tree does not fit; no access-policy window or carve-out
    left behind; each placement against "hbm" A-B-B-A and "smem"'s block
    sizes; the kernels-line rows (vmem: the hall's waves; smem: config 1's
    tree) against the plain version on 65,536 seeded rays a wave."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_parity import deep_records

    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.utils import procgen
    from tools_torch import mb_tree_space

    card, dev = env["card"], env["dev"]
    t_phase = time.perf_counter()
    limits = traverse.tree_space_limits(dev)
    window0 = traverse.l2_window(dev)
    scenes = mb_tree_space.trees(dev)
    waves = {label: mb_tree_space.waves(qn, k) for label, (qn, k) in scenes.items()}
    fits = {label: qn.numel() * 4 <= limits["smem_optin"] for label, (qn, k) in scenes.items()}
    log(f"[tree_space] limits of {card}: {json.dumps(limits)}; L2 state before: "
        f"{json.dumps(window0)}; trees " + ", ".join(
            f"{label} {tuple(qn.shape)} = {qn.numel() * 4} bytes" for label, (qn, _) in
            scenes.items()))

    def run(label, space, name, **kw):
        qn, k = scenes[label]
        o, d, ah = waves[label][name]
        return traverse.trace_rays(qn, o, d, any_hit=ah, leaf_k=k, tree_space=space, **kw)

    spaces = {label: ("vmem", "smem") if fits[label] else ("vmem",) for label in scenes}
    torch.cuda.synchronize()
    traverse.reset_launches()
    outs = {(label, space, name): run(label, space, name)
            for label in scenes for space in spaces[label] for name in waves[label]}
    torch.cuda.synchronize()
    launches = dict(traverse.LAUNCHES)
    want = {}
    for label in scenes:
        for space in spaces[label]:
            for name, (_, _, ah) in waves[label].items():
                key = f"trace_rays_{'k2b' if ah else 'k2a'}_{space}"
                want[key] = want.get(key, 0) + 1
    log(f"[tree_space] launches of the placements' path: "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    if launches != expected(**want):
        fail(f"phase 35: the placements launched {launches}, expected {want}")

    # every lane against "hbm", both schedules; deep stacks; refusals
    checked = 0
    for label in scenes:
        for name in waves[label]:
            base = run(label, "hbm", name)
            for space in spaces[label]:
                for out in (outs[(label, space, name)], run(label, space, name, scattered=True)):
                    words = differing_words(out, base)
                    if words:
                        fail(f"phase 35: {label} {name} under {space} differs from hbm in "
                             f"{words} words")
                    checked += base[0].numel()
    for width in (4, 8):
        qd, od, dd = deep_records(width, depth=DEEP_SMEM_DEPTH)
        qd = qd.to(dev)
        od, dd = torch.from_numpy(od).to(dev), torch.from_numpy(dd).to(dev)
        for any_hit in (False, True):
            for ordered in (True, False):
                kw = dict(any_hit=any_hit, leaf_k=1, ordered=ordered)
                base = traverse.trace_rays(qd, od, dd, **kw)
                for space in ("vmem", "smem"):
                    words = differing_words(traverse.trace_rays(qd, od, dd, tree_space=space,
                                                                **kw), base)
                    if words:
                        fail(f"phase 35: deep_records({width}) under {space} differs from hbm "
                             f"in {words} words")
                    checked += base[0].numel()
    log(f"[tree_space] {checked} lanes bit-identical to hbm (every wave, one thread per ray "
        f"and persistent, and deep_records at 4 and 8 slots in both orders)")
    o1, d1, _ = waves["hall SAH K=32"]["bounce1"]
    o1, d1 = o1[:1024].contiguous(), d1[:1024].contiguous()
    refusals = [("hall SAH K=32", scenes["hall SAH K=32"][0], 32, "smem"),
                ("dragon SAH K=32", env["qn"], LEAF_K, "smem"),
                ("dragon SAH K=32", env["qn"], LEAF_K, "vmem")]
    before = dict(traverse.LAUNCHES)
    for label, qn, k, space in refusals:
        try:
            traverse.trace_rays(qn, o1, d1, leaf_k=k, tree_space=space)
        except ValueError as exc:
            log(f"[tree_space] {label} under {space}: ValueError as expected: {exc}")
        else:
            fail(f"phase 35: {label} ({qn.numel() * 4} bytes) did not raise under {space}")
    if dict(traverse.LAUNCHES) != before:
        fail("phase 35: a refused placement launched a kernel")
    after = traverse.l2_window(dev)
    if after["num_bytes"] or after["base"] or after["persisting_l2"] != window0["persisting_l2"]:
        fail(f"phase 35: vmem left L2 state behind: {after} (before {window0})")
    log(f"[tree_space] after the vmem calls: stream window {after['num_bytes']} bytes at "
        f"{after['base']}, persisting carve-out {after['persisting_l2']} bytes (as before)")

    # each placement against hbm, A-B-B-A
    rays = waves["hall SAH K=32"]["nee"][0].shape[0]
    for label in scenes:
        for space in spaces[label]:
            for name in waves[label]:
                ms = abba({"hbm": lambda label=label, name=name: run(label, "hbm", name),
                           space: lambda label=label, space=space, name=name:
                           run(label, space, name)}, 4, 2)
                log(f"[A/B] {label} {name}: hbm {ms['hbm']:.4f} ms, {space} {ms[space]:.4f} ms "
                    f"({rays / ms['hbm'] / 1e3:.1f} / {rays / ms[space] / 1e3:.1f} Mrays/s) "
                    f"on {card}")

    # the kernels-line rows: vmem on the hall, smem on config 1's tree
    tris_of = {"hall SAH K=32": mb_tree_space.normalized(procgen.make_interior_hall()).to(dev),
               "Cornell LBVH K=1": mb_tree_space.normalized(procgen.make_cornell_box()).to(dev)}
    rows = {}
    pick_gen = torch.Generator(device="cpu").manual_seed(SEED + 5)
    for space, label in (("vmem", "hall SAH K=32"), ("smem", "Cornell LBVH K=1")):
        qn, k = scenes[label]
        per_name: dict[str, list] = {}
        for name, (o, d, ah) in waves[label].items():
            r = o.shape[0]
            pick = torch.randperm(r, generator=pick_gen)[:WAVE_SAMPLES].to(dev)
            po, pd = o[pick].contiguous(), d[pick].contiguous()
            counts = traverse.TraversalCounts()
            plain = traverse.trace_rays_reference(qn, po, pd, any_hit=ah, leaf_k=k, counts=counts)
            _, plain_ms = timed_once(lambda: traverse.trace_rays_reference(
                qn, po, pd, any_hit=ah, leaf_k=k))
            ker = traverse.trace_rays(qn, po, pd, any_hit=ah, leaf_k=k, tree_space=space)
            what = f"K2{'b' if ah else 'a'} {space} vs plain, {label} {name}"
            stats = (check_occlusion(ker, plain, what) if ah else
                     check_against(ker, plain, tris_of[label], po, pd, what))
            ms = statistics.median(cuda_ms(lambda: traverse.trace_rays(
                qn, po, pd, any_hit=ah, leaf_k=k, tree_space=space), FRAMES, 3))
            path_ms = statistics.median(cuda_ms(lambda: run(label, space, name), FRAMES, 3))
            n = pick.numel()
            _, _, detail = bound(counts, 1.0, n * (OUT_BYTES + RAY_BYTES))
            _, _, p_detail = bound(counts, r / n, r * (OUT_BYTES + RAY_BYTES))
            key = f"trace_rays_{'k2b' if ah else 'k2a'}_{space}"
            per_name.setdefault(key, []).append({
                "rays": n, "max_abs_err": stats["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                "bound_detail": detail, "active": r, "path_ms": path_ms,
                "path_bound_detail": p_detail})
        for key, ws in per_name.items():
            rows[key] = wave_row(ws, launches[key])
            log(f"[tree_space] {key}: {json.dumps(rows[key])} on {card}")
    log(f"[tree_space] phase 35 in {time.perf_counter() - t_phase:.1f} s on {card}")
    return rows


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
    pt_want = expected(trace_tiles_k1e=SAMPLES, camera_lanes=SAMPLES,
                       trace_rays_k2c=SAMPLES * (2 * BOUNCES - 1), wave_hit=SAMPLES * BOUNCES,
                       wave_bounce=SAMPLES * BOUNCES, **GRAPHED)
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
    check_row_wave(env, qn8, k1e_j, "K1e")
    waves, _ = capture_waves(env, qn8)
    wave_stats = check_waves(env, qn8, waves, "trace_rays_k2c", "trace_rays_k2c")
    env["qn8"], env["waves"]["8-wide"] = qn8, waves  # for phase 33
    rows = {"trace_tiles_k1e": time_tiles(
        env, qn8, "K1e", False, k1e,
        render_launches["trace_tiles_k1e"] + pt_want["trace_tiles_k1e"])}
    rows["trace_tiles_k1e"]["max_abs_err"] = max(k1e["stats"]["max_abs_err"],
                                                 k1e_j["stats"]["max_abs_err"])
    rows["trace_rays_k2c"] = wave_row(wave_stats["trace_rays_k2c"], pt_want["trace_rays_k2c"])

    # 17. K1f at both widths
    visits = [check_visits(env, qn4, "K1f on 4-wide records"),
              check_visits(env, qn8, "K1f on 8-wide records")]

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
    from raytracer_tpu_torch.ops.collapse import collapse_lbvh2_to_bvh4
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.ops.morton import build_morton_and_sort

    card, dev, tris = env["card"], env["dev"], env["tris"]
    views = (("framed", FRAMED), ("sparse", SPARSE))
    all_dirs = frame_dirs(torch.arange(WIDTH * HEIGHT, device=dev))
    k32 = {view: [p.reshape(-1) for p in traverse.trace_tiles(env["qn"], pos, QUAT, WIDTH, HEIGHT,
                                                               FOV, leaf_k=LEAF_K)]
           for view, pos in views}

    codes, order = build_morton_and_sort(tris)
    card_bvh2 = {}

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

        card_bvh2[k] = pt._bvh2  # held against the CPU build after every timed phase

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
            want = expected(trace_tiles_k1b=1, camera_lanes=1, trace_rays_k2a=BOUNCES - 1,
                            trace_rays_k2b=BOUNCES, wave_hit=BOUNCES, wave_bounce=BOUNCES)
            log(f"[{what}] launches during render_progressive(bounces={BOUNCES}): "
                f"{json.dumps(launches)}")
            if launches != want or not bool(torch.isfinite(accum).all() & (accum >= 0).all()):
                fail(f"{what}: a progressive sample launched {launches} (expected {want}) or "
                     "left a non-finite buffer")
            waves, _ = capture_waves(env, qn, leaf_k=k)
            check_waves(env, qn, waves, "trace_rays_k2a", "trace_rays_k2b", leaf_k=k)
            env["waves"][1] = waves  # for phase 33
        del pt, images

    # the Morton order, the BVH2s and K = 8's 4-wide collapse on the card,
    # held against the same builds on the CPU after every timed phase
    # (lbvh_cpu_check)
    b4 = collapse_lbvh2_to_bvh4(card_bvh2[8])
    env["lbvh_card"] = ((codes.cpu(), order.cpu()),
                        {k: [a.cpu() for a in bvh2] for k, bvh2 in card_bvh2.items()},
                        (b4.num_nodes, [a.cpu() for a in b4[:3]]))
    return trees


def lbvh_cpu_check(env: dict) -> None:
    """25 (end). The CPU's Morton order, BVH2s (K = 1, 8) and K = 8's 4-wide
    collapse of the dragon equal the card's of lbvh_phase word for word."""
    from raytracer_tpu_torch.ops.cluster import build_lbvh2_clustered
    from raytracer_tpu_torch.ops.collapse import collapse_lbvh2_to_bvh4
    from raytracer_tpu_torch.ops.lbvh import build_lbvh2
    from raytracer_tpu_torch.ops.morton import build_morton_and_sort

    (codes, order), card_bvh2, (n4, b4) = env["lbvh_card"]
    tris = env["tris"].cpu()
    t0 = time.perf_counter()
    c_codes, c_order = build_morton_and_sort(tris)
    cpu2 = {1: build_lbvh2(tris), 8: build_lbvh2_clustered(tris, 8).bvh2}
    b4_cpu = collapse_lbvh2_to_bvh4(cpu2[8])
    cpu_s = time.perf_counter() - t0
    if not (torch.equal(codes, c_codes) and torch.equal(order, c_order)):
        fail("the Morton codes or order on the card differ from the CPU's")
    log(f"[lbvh] Morton codes and order of {tris.shape[0]} triangles: the card's equal the "
        f"CPU's ({cpu_s:.2f} s for the CPU's builds)")
    for k, bvh2 in card_bvh2.items():
        what = f"lbvh K={k}"
        for name, a, b in zip(("bounds", "left", "right", "meta", "parent"), bvh2, cpu2[k]):
            if not torch.equal(a, b):
                fail(f"{what}: BVH2 {name} on the card differs from the CPU build in "
                     f"{int((a != b).sum())} words")
        log(f"[{what}] BVH2 on the card equals the CPU build word for word (bounds, left, right, "
            f"meta, parent; {cpu2[k].num_nodes} rows)")
    if n4 != b4_cpu.num_nodes or not all(torch.equal(a, b) for a, b in zip(b4, b4_cpu[:3])):
        fail("lbvh K=8: the 4-wide collapse on the card differs from the CPU's")
    log(f"[lbvh K=8] the 4-wide collapse on the card equals the CPU's ({n4} rows)")


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


def series(fns: dict, frames: int, repeats: int) -> dict:
    """Median ms per call of each function, timed in the order given and
    then in reverse (A-B-B-A for two)."""
    names = list(fns)
    reps = {n: [] for n in names}
    for n in names + names[::-1]:
        reps[n] += cuda_ms(fns[n], frames, repeats)
    return {n: statistics.median(r) for n, r in reps.items()}


def render_core_sass() -> tuple[dict, dict, str]:
    """(the digests of tools_torch/render_core_sass.json, this build's
    digests of the same sources, this nvcc): cuobjdump takes seconds a
    library, so untimed_checks() runs this beside phase 25's CPU builds."""
    from raytracer_tpu_torch.ops.cuda import traverse
    from tools_torch.ab_parent import nvcc_version, render_core_digests

    ref = json.loads((ROOT / "tools_torch" / "render_core_sass.json").read_text())
    with ThreadPoolExecutor(max_workers=len(ref["kernels"])) as pool:
        got = dict(zip(ref["kernels"], pool.map(
            lambda src: render_core_digests(traverse.load_kernel(src)[0]), ref["kernels"])))
    return ref, got, nvcc_version()


def check_render_core_sass(sass) -> None:
    """The render core's instructions (every K1 and K2 launch at K = 1)
    against the digests of tools_torch/render_core_sass.json, which
    tools_torch/ab_parent.py writes from the parent commit (``sass``:
    render_core_sass()'s result). A difference fails under the same nvcc."""
    ref, digests, nvcc = sass
    for source, want in ref["kernels"].items():
        got = digests[source]
        same = [k for k in want if got.get(k) == want[k]]
        log(f"[k1] SASS {source}: {len(same)} of {len(want)} render-core kernels identical, "
            f"instruction for instruction, to the parent's ({ref['from']}; nvcc here "
            f"'{nvcc}', there '{ref['nvcc']}')")
        if len(same) != len(want) or set(got) != set(want):
            differ = sorted(set(want) ^ set(got) | {k for k in want if got.get(k) != want[k]})
            if nvcc == ref["nvcc"]:
                fail(f"the render core's machine code changed in {source}: {differ}")
            log(f"[k1] SASS {source}: another nvcc, not comparable: {differ}")


def untimed_checks(env: dict) -> None:
    """After every timed phase, the checks that only the host's CPU runs,
    side by side: phase 25's CPU builds against the card's trees
    (lbvh_cpu_check) and the render core's machine code against the
    parent's (check_render_core_sass)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        sass = pool.submit(render_core_sass)
        lbvh_cpu_check(env)
        check_render_core_sass(sass.result())
    log(f"[untimed] phase 25's CPU builds and the SASS read-back took "
        f"{time.perf_counter() - t0:.1f} s")


# 33. wavefront compaction and K2 without near-first order: the sample's
# forms timed against each other (pt_sample_frame keyword arguments)
SAMPLE_FORMS = {
    "off + persistent": dict(compact=False),
    "argsort + dense": dict(compact=True, compact_impl="argsort"),
    "partition + dense": dict(compact=True, compact_impl="partition"),
}


def compacted_progressive_phase(env: dict, pt) -> None:
    """33 (a). render_progressive(bounces=3) at 1080p with compaction on:
    its launches (1 K1b, 1 camera_lanes, 2 K2a, 3 K2b, 3 wave_hit and 3
    wave_bounce a sample and nothing else), the sort's
    and gathers' kernels under torch.profiler, no host-device
    synchronisation, a finite non-negative buffer."""
    from raytracer_tpu_torch import pathtracer

    saved = pathtracer.COMPACT_WAVES
    pathtracer.COMPACT_WAVES = True
    try:
        want = expected(trace_tiles_k1b=SAMPLES, camera_lanes=SAMPLES,
                        trace_rays_k2a=SAMPLES * (BOUNCES - 1), trace_rays_k2b=SAMPLES * BOUNCES,
                        wave_hit=SAMPLES * BOUNCES, wave_bounce=SAMPLES * BOUNCES)
        pt.set_camera_position(*MOVED)
        pt.render_progressive(bounces=BOUNCES)  # so that the framed view starts a buffer
        progressive_samples(pt, want, "compaction")
        profile_calls(lambda: pt.render_progressive(bounces=BOUNCES),
                      f"compacted render_progressive(bounces={BOUNCES})", env["card"])
    finally:
        pathtracer.COMPACT_WAVES = saved


def plain_traversal(fn):
    """``fn`` run with render_pt's kernels replaced by their plain versions."""
    from raytracer_tpu_torch import render_pt
    from raytracer_tpu_torch.ops.cuda import camera, traverse, wave

    def tiles(qnodes, row, width, height, fov_degrees=70.0, leaf_k=1):
        values = row.tolist()
        return traverse.trace_tiles_reference(qnodes, values[0:3], values[3:7], width, height,
                                              fov_degrees, leaf_k, jitter=True,
                                              jitter_seed=int(values[11]))

    def lanes(planes, row, width, height, fov_degrees):
        values = row.tolist()
        return camera.camera_lanes_reference(planes, values[3:7], width, height, fov_degrees,
                                             int(values[11]))

    def rays(qnodes, origins, dirs, *, any_hit=False, leaf_k, active=None, scattered=False,
             ordered=True):
        return traverse.trace_rays_reference(qnodes, origins, dirs, any_hit=any_hit,
                                             leaf_k=leaf_k, active=active, ordered=ordered)

    names = ("trace_tiles_row", "trace_rays", "camera_lanes", "wave_hit", "wave_bounce",
             "wave_last")
    real = {name: getattr(render_pt, name) for name in names}
    plain = (tiles, rays, lanes, wave.wave_hit_reference,
             wave.wave_bounce_reference, wave.wave_last_reference)
    for name, fn_plain in zip(names, plain):
        setattr(render_pt, name, fn_plain)
    try:
        return fn()
    finally:
        for name, fn_real in real.items():
            setattr(render_pt, name, fn_real)


def max_abs_diff(a, b) -> float:
    """The largest |difference| over the float planes of two traversals."""
    return max(float((x - y).abs().max()) if x.numel() else 0.0 for x, y in zip(a[:4], b[:4]))


def compaction_phase(env: dict, trees: dict, rows: dict) -> None:
    """33 (b)-(f). K2a / K2b / K2c with ordered=False on every captured wave
    (SAH K = 32, Morton K = 1, 8-wide): on every lane against the ordered
    kernel (closest-hit planes bit-identical, occlusion masks equal) and on
    65,536 seeded active rays against the plain version (bit for bit), with
    visits and bounds; the kernels-line rows. A compacted 256x256 sample,
    kernels against plain versions, per impl; the partition's grouping
    against the argsort's on the captured 1080p compactions. The launches of
    the unordered path. The sample's forms timed in one series
    (SAMPLE_FORMS x ordered / unordered any hit, 4 samples each) at SAH
    K = 32 and Morton K = 1: sample ms, each wave's ms and alive share, the
    compaction's ms; one thread per ray against persistent warps on the
    compacted waves."""
    from raytracer_tpu_torch import render_pt
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.ops.partition import bucket_partition_perm

    card, dev, tris = env["card"], env["dev"], env["tris"]
    t_phase = time.perf_counter()
    qn32, qn1, qn8 = env["qn"], trees[1]["qn"], env["qn8"]
    trees_of = {LEAF_K: (qn32, LEAF_K, f"SAH K={LEAF_K}"), 1: (qn1, 1, "Morton K=1"),
                "8-wide": (qn8, LEAF_K, f"8-wide SAH K={LEAF_K}")}

    # (b) every lane against the ordered kernel; checked rays against the plain version
    pick_gen = torch.Generator(device="cpu").manual_seed(SEED + 3)
    row_waves: dict[str, list] = {}
    for key, (qn, k, label) in trees_of.items():
        for i, w in enumerate(env["waves"][key]):
            kw = dict(any_hit=w["any_hit"], leaf_k=k)
            kind = "any hit" if w["any_hit"] else "closest hit"
            r = w["o"].shape[0]
            full = traverse.trace_rays(qn, w["o"], w["d"], active=w["active"], ordered=False,
                                       scattered=w["scattered"], **kw)
            if w["any_hit"]:
                if not torch.equal(full[4] >= 0, w["out"][4] >= 0):
                    fail(f"phase 33: {label} wave {i}: unordered occlusion mask differs on "
                         f"{int(((full[4] >= 0) != (w['out'][4] >= 0)).sum())} of {r} lanes")
            elif differing_words(full, w["out"]):
                fail(f"phase 33: {label} wave {i}: unordered closest-hit planes differ from "
                     f"the ordered kernel's in {differing_words(full, w['out'])} words")
            act = w["active"] if w["active"] is not None else torch.ones(
                r, dtype=torch.bool, device=dev)
            live = torch.nonzero(act).squeeze(1)
            pick = live[torch.randperm(live.numel(), generator=pick_gen)[:WAVE_SAMPLES].to(dev)]
            o, d = w["o"][pick].contiguous(), w["d"][pick].contiguous()
            counts, ordered_counts = traverse.TraversalCounts(), traverse.TraversalCounts()
            plain = traverse.trace_rays_reference(qn, o, d, ordered=False, counts=counts, **kw)
            traverse.trace_rays_reference(qn, o, d, counts=ordered_counts, **kw)
            ker = [p[pick] for p in full]
            words = differing_words(ker, plain)
            if words:
                fail(f"phase 33: {label} wave {i}: the unordered kernel differs from its plain "
                     f"version in {words} words on {pick.numel()} checked rays")
            _, plain_ms = timed_once(lambda: traverse.trace_rays_reference(
                qn, o, d, ordered=False, **kw))
            ms = statistics.median(cuda_ms(lambda: traverse.trace_rays(
                qn, o, d, ordered=False, **kw), FRAMES, 3))
            ordered_ms = statistics.median(cuda_ms(lambda: traverse.trace_rays(
                qn, o, d, **kw), FRAMES, 3))
            path = abba({o_: (lambda o_=o_: traverse.trace_rays(
                qn, w["o"], w["d"], active=w["active"], scattered=w["scattered"],
                ordered=o_ == "ordered", **kw)) for o_ in ("ordered", "unordered")}, 3, 2)
            n, n_live = pick.numel(), live.numel()
            b_ms, b_by, detail = bound(counts, 1.0, n * (OUT_BYTES + RAY_BYTES))
            pb_ms, pb_by, p_detail = bound(counts, n_live / n,
                                           r * OUT_BYTES + n_live * RAY_BYTES + r)
            log(f"[unordered] {label} wave {i} ({kind}): all {r} lanes "
                f"{'masks equal' if w['any_hit'] else 'planes bit-identical'} to the ordered "
                f"kernel; {n} of {n_live} active rays bit-identical to the plain version; "
                f"visits a ray {counts.visits / n:.3f} unordered against "
                f"{ordered_counts.visits / n:.3f} ordered, MT tests {counts.mt_tests / n:.3f} "
                f"against {ordered_counts.mt_tests / n:.3f}; checked rays unordered {ms:.4f} ms, "
                f"ordered {ordered_ms:.4f} ms, plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by "
                f"{b_by}; whole wave (A-B-B-A) unordered {path['unordered']:.4f} ms, ordered "
                f"{path['ordered']:.4f} ms, bound {pb_ms:.4f} ms by {pb_by} on {card}")
            if key == 1:
                continue
            name = ("trace_rays_k2c_unordered" if key == "8-wide" else
                    "trace_rays_k2b_unordered" if w["any_hit"] else "trace_rays_k2a_unordered")
            row_waves.setdefault(name, []).append({
                "rays": n,
                "max_abs_err": max_abs_diff(ker, plain), "ms": ms, "plain_ms": plain_ms,
                "bound_detail": detail, "active": n_live, "path_ms": path["unordered"],
                "path_bound_detail": p_detail})

    # (c) a compacted 256x256 sample through the kernels and the plain versions
    for impl in ("argsort", "partition"):
        def small(impl=impl):
            return render_pt.pt_sample_frame(
                qn32, tris, FRAMED, QUAT, CROP, CROP, bounces=BOUNCES, fov_degrees=FOV,
                leaf_k=LEAF_K, tile_primary=True, compact=True, compact_impl=impl,
                generator=torch.Generator(device=dev).manual_seed(SAMPLE_SEED))

        by_kernels = small()
        by_plain = plain_traversal(small)
        err = (by_kernels - by_plain).abs().amax(-1)
        share = float((err <= RADIANCE_ATOL).float().mean())
        log(f"[compaction] whole {CROP}x{CROP} sample compacted by {impl}, kernels vs plain: "
            f"{share:.6f} of pixels within {RADIANCE_ATOL} (max |d| {float(err.max()):.3g})")
        if share < MIN_RADIANCE_MATCH or not bool(torch.isfinite(by_kernels).all()):
            fail(f"phase 33: compacted ({impl}) sample: {share:.6f} < {MIN_RADIANCE_MATCH} "
                 f"of pixels within {RADIANCE_ATOL}")

    # (d) the launches of the unordered path: compacted samples with both
    # orders off, 4-wide and 8-wide records
    unordered = dict(compact=True, ordered_ch=False, ordered_ah=False)
    torch.cuda.synchronize()
    traverse.reset_launches()
    for qn in (qn32, qn8):
        render_pt.pt_sample_frame(qn, tris, FRAMED, QUAT, WIDTH, HEIGHT, bounces=BOUNCES,
                                  fov_degrees=FOV, leaf_k=LEAF_K, tile_primary=True,
                                  generator=torch.Generator(device=dev).manual_seed(SAMPLE_SEED),
                                  **unordered)
    torch.cuda.synchronize()
    launches = dict(traverse.LAUNCHES)
    want = expected(trace_tiles_k1b=1, trace_tiles_k1e=1, camera_lanes=2,
                    trace_rays_k2a_unordered=BOUNCES - 1, trace_rays_k2b_unordered=BOUNCES,
                    trace_rays_k2c_unordered=2 * BOUNCES - 1, wave_hit=2 * BOUNCES,
                    wave_bounce=2 * BOUNCES)
    log(f"[unordered] launches of one compacted unordered 1080p sample on 4-wide and one on "
        f"8-wide records: {json.dumps({k: v for k, v in launches.items() if v})}")
    if launches != want:
        fail(f"phase 33: the unordered samples launched {launches}, expected {want}")
    for name, ws in row_waves.items():
        rows[name] = wave_row(ws, launches[name])

    # (e) the partition's grouping against the argsort's, on the captured
    # compactions of 1080p samples (tests/test_partition.py's contract)
    for key in (LEAF_K, 1):
        qn, k, label = trees_of[key]
        _, stats = capture_waves(env, qn, k, compact=True)
        for j, c in enumerate(stats["compactions"]):
            small = render_pt.compaction_key(c["o"], c["d"], c["alive"], "partition")
            full = render_pt.compaction_key(c["o"], c["d"], c["alive"], "argsort")
            by_part = bucket_partition_perm(small, 256)
            by_sort = render_pt._compaction_perm(c["o"], c["d"], c["alive"], "argsort")
            if not (torch.equal(full >> 24, small)
                    and torch.equal(by_part, torch.argsort(small, stable=True))
                    and torch.equal(small[by_sort], small[by_part])
                    and bool((full[by_sort].diff() >= 0).all())):
                fail(f"phase 33: {label} compaction {j}: the partition does not group the "
                     "lanes as the argsort does")
            alive = int(c["alive"].sum())
            log(f"[compaction] {label} compaction {j}: {alive} of {c['alive'].numel()} lanes "
                f"alive; partition and argsort group alike, {int(torch.unique(small).numel())} "
                f"buckets in use")

    # (f) the forms of the sample, timed in one series
    for key in (LEAF_K, 1):
        qn, k, label = trees_of[key]
        forms = {f"{name}, {'ordered' if ah else 'unordered'} any hit": dict(kw, ordered_ah=ah)
                 for name, kw in SAMPLE_FORMS.items() for ah in (True, False)}

        def sample(kw, qn=qn, k=k):
            return render_pt.pt_sample_frame(
                qn, tris, FRAMED, QUAT, WIDTH, HEIGHT, bounces=BOUNCES, fov_degrees=FOV,
                leaf_k=k, tile_primary=True,
                generator=torch.Generator(device=dev).manual_seed(SAMPLE_SEED), **kw)

        ms = series({f: (lambda kw=kw: sample(kw)) for f, kw in forms.items()}, SAMPLES, 1)
        for f, kw in forms.items():
            waves, stats = capture_waves(env, qn, k, **kw)
            wave_ms = []
            for w in waves:
                call = (lambda w=w: traverse.trace_rays(
                    qn, w["o"], w["d"], any_hit=w["any_hit"], leaf_k=k, active=w["active"],
                    scattered=w["scattered"], ordered=w["ordered"]))
                alive = w["o"].shape[0] if w["active"] is None else int(w["active"].sum())
                wave_ms.append(f"{'K2b' if w['any_hit'] else 'K2a'} "
                               f"{statistics.median(cuda_ms(call, 3, 2)):.4f} ms "
                               f"(alive {alive / w['o'].shape[0]:.4f})")
            comp_ms = []
            for c in stats["compactions"]:
                state = [c["o"], c["d"], torch.rand_like(c["o"]), torch.rand_like(c["o"]),
                         c["alive"], torch.arange(c["o"].shape[0], device=dev)]

                def compact(c=c, state=state):
                    perm = render_pt._compaction_perm(c["o"], c["d"], c["alive"], c["impl"])
                    return [x[perm] for x in state]

                comp_ms.append(statistics.median(cuda_ms(compact, 3, 2)))
                if key == LEAF_K and kw["ordered_ah"] and len(comp_ms) == 1:
                    profile_calls(compact, f"one compaction ({c['impl']}) of the {label} "
                                  "sample with its 6 gathers", card)
            log(f"[A/B] {label} {BOUNCES}-bounce 1080p sample, {f}: {ms[f]:.4f} ms a sample "
                f"(series of {SAMPLES} samples, forward and back); waves in order: "
                + "; ".join(wave_ms)
                + (f"; compactions {', '.join(f'{x:.4f}' for x in comp_ms)} ms" if comp_ms
                   else "") + f" on {card}")
            if kw.get("compact") and kw["compact_impl"] == "argsort" and kw["ordered_ah"]:
                for i, w in enumerate(waves):
                    if w["active"] is None or (w["any_hit"] and k > 1):
                        continue  # dense camera wave; any hit at K = 32 has one schedule
                    sched = abba({s: (lambda s=s, w=w: traverse.trace_rays(
                        qn, w["o"], w["d"], any_hit=w["any_hit"], leaf_k=k, active=w["active"],
                        scattered=s == "persistent")) for s in ("dense", "persistent")}, 3, 2)
                    log(f"[A/B] {label} compacted wave {i} "
                        f"({'any hit' if w['any_hit'] else 'closest'}): one thread per ray "
                        f"{sched['dense']:.4f} ms, persistent warps {sched['persistent']:.4f} ms "
                        f"on {card}")
    log(f"[compaction] phase 33 took {time.perf_counter() - t_phase:.1f} s")


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
        """The app's FrameStats, kept with its 1 Hz readouts and the total
        the app reads at the end of its frame loop."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.history = []
            runs.append(self)

        def tick(self, quiet=False):
            rec = super().tick(quiet)
            if rec is not None:
                self.history.append(rec)
            return rec

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



SHARD_SEEDS = (JITTER_SEED, JITTER_SEED + 1)   # the spp seeds of ranks 0 and 1
PT_SHARD_SEEDS = (SAMPLE_SEED, SAMPLE_SEED + 1)  # the path-traced sample seeds
SHARD_TIMEOUT = 600.0  # the gloo group's and the join's; the ranks build the dragon first
MEAN_ATOL = 1e-6


def shard_refs(qn: torch.Tensor, tris: torch.Tensor, seeds, pt_seeds) -> dict:
    """What the shardings must give, computed unsharded on this rank's card:
    the shaded framed frame and its (t, tri), the mean of the jittered shaded
    frames of ``seeds``, the 8-camera batch shaded, and the mean of the
    3-bounce samples of ``pt_seeds``."""
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.ops.shade import shade_lambert
    from raytracer_tpu_torch.render_pt import pt_sample_frame

    def shaded(planes):
        return shade_lambert(torch.stack(planes[1:4], -1), planes[4] >= 0)

    full = traverse.trace_tiles(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K)
    spp = [shaded(traverse.trace_tiles(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K,
                                       jitter=True, jitter_seed=s)) for s in seeds]
    pos, quat = batch_cameras(CAM_Z)
    cams = traverse.trace_tiles_batch(qn, pos, quat, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K)
    pt = [pt_sample_frame(qn, tris, FRAMED, QUAT, WIDTH, HEIGHT, bounces=BOUNCES, fov_degrees=FOV,
                          leaf_k=LEAF_K, tile_primary=True,
                          generator=torch.Generator(device=qn.device).manual_seed(s))
          for s in pt_seeds]
    return {"tiles": (shaded(full), full[0], full[4]), "spp": sum(spp) / len(spp),
            "cams": shaded(cams), "pt": sum(pt) / len(pt)}


def run_shardings(mesh, qn: torch.Tensor, tris: torch.Tensor, seeds, pt_seeds) -> dict:
    """Every sharding once on the dragon's framed view: launches (set to 0
    just before, read just after) and the outputs."""
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.parallel import mesh as pm

    pos, quat = batch_cameras(CAM_Z)
    calls = {
        "tiles": lambda: pm.render_tiles_sharded(qn, tris, FRAMED, QUAT, WIDTH, HEIGHT, mesh,
                                                 FOV, leaf_k=LEAF_K),
        "spp": lambda: pm.render_spp_sharded(qn, tris, FRAMED, QUAT, seeds, WIDTH, HEIGHT, mesh,
                                             FOV, leaf_k=LEAF_K),
        "cams": lambda: pm.render_cameras_sharded(qn, tris, pos, quat, WIDTH, HEIGHT, mesh, FOV,
                                                  leaf_k=LEAF_K),
        "pt": lambda: pm.render_pt_spp_sharded(qn, tris, FRAMED, QUAT, pt_seeds, WIDTH, HEIGHT,
                                               mesh, bounces=BOUNCES, fov_degrees=FOV,
                                               leaf_k=LEAF_K, tile_primary=True),
    }
    n = mesh.size
    want = {"tiles": expected(trace_tiles_k1a=1), "spp": expected(trace_tiles_k1b=1),
            "cams": expected(trace_tiles_k1c=1),
            "pt": expected(trace_tiles_k1b=1, camera_lanes=1, trace_rays_k2a=BOUNCES - 1,
                           trace_rays_k2b=BOUNCES, wave_hit=BOUNCES, wave_bounce=BOUNCES)}
    out, launches, host_ms = {}, {}, {}
    for name, call in calls.items():
        torch.cuda.synchronize()
        traverse.reset_launches()
        t0 = time.perf_counter()
        out[name] = call()
        torch.cuda.synchronize()
        host_ms[name] = (time.perf_counter() - t0) * 1e3
        launches[name] = dict(traverse.LAUNCHES)
        if launches[name] != want[name]:
            raise AssertionError(f"rank {mesh.rank} of {n}: {name} launched {launches[name]}, "
                                 f"expected {want[name]}")
    return {"out": out, "launches": launches, "host_ms": host_ms}


def shard_compare(got: dict, refs: dict, rank: int, n: int) -> dict:
    """Bands, gathered frames and cameras bit-equal to ``refs``; the spp and
    path-traced means within MEAN_ATOL → their max |d| and this rank's band
    check."""
    band = HEIGHT // n
    rows = slice(rank * band, (rank + 1) * band)
    for i, what in enumerate(("rgb", "t", "tri")):
        a, b = got["tiles"][i], refs["tiles"][i]
        if not torch.equal(a[rows], b[rows]):
            raise AssertionError(f"rank {rank} of {n}: its band's {what} differs from the "
                                 "one-rank frame")
        if not torch.equal(a, b):
            raise AssertionError(f"rank {rank} of {n}: the gathered {what} differs")
    if not torch.equal(got["cams"], refs["cams"]):
        raise AssertionError(f"rank {rank} of {n}: the camera batch differs")
    errs = {k: float((got[k] - refs[k]).abs().max()) for k in ("spp", "pt")}
    for k, e in errs.items():
        if not e <= MEAN_ATOL:
            raise AssertionError(f"rank {rank} of {n}: the {k} mean differs by {e} > {MEAN_ATOL}")
    return errs


def launched(calls: dict) -> dict:
    """Each call's launch counts, the kernels it launched only."""
    return {call: {k: n for k, n in counts.items() if n} for call, counts in calls.items()}


def digest(*tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def collective_ms(mesh, like: torch.Tensor, op: str) -> float:
    """ms of one all_gather (or all_reduce) of a tensor like ``like`` over the
    mesh, on the host clock between synchronised barriers (median of 5)."""
    import torch.distributed as dist

    parts = [torch.empty_like(like) for _ in range(mesh.size)]
    times = []
    for _ in range(6):
        x = like.clone()
        torch.cuda.synchronize()
        dist.barrier(group=mesh.group)
        t0 = time.perf_counter()
        if op == "all_gather":
            dist.all_gather(parts, x, group=mesh.group)
        else:
            dist.all_reduce(x, group=mesh.group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def shard_rank(mesh, glb: str) -> dict:
    """30 (b). One of the gloo ranks that share the card: the dragon's SAH
    K = 32 records built on this rank, the unsharded results, every sharding
    (launches checked on this rank), bit-equality / the mean tolerance, and
    digests of what the parent compares with its one-rank run."""
    from raytracer_tpu_torch import PathTracer, Scene

    pt = PathTracer(WIDTH, HEIGHT, builder="sah", leaf_size=LEAF_K, device=mesh.device)
    pt.set_scene(Scene().load_glb(glb, normalize=True, mode="cube"))
    qn, tris = pt._qnodes, pt._tris_dev
    refs = shard_refs(qn, tris, SHARD_SEEDS, PT_SHARD_SEEDS)
    run = run_shardings(mesh, qn, tris, SHARD_SEEDS, PT_SHARD_SEEDS)
    errs = shard_compare(run["out"], refs, mesh.rank, mesh.size)
    band = HEIGHT // mesh.size
    from raytracer_tpu_torch.ops.cuda import traverse

    band_ms = statistics.median(cuda_ms(lambda: traverse.trace_tiles(
        qn, FRAMED, QUAT, WIDTH, band, FOV, leaf_k=LEAF_K, raygen_size=(WIDTH, HEIGHT),
        row_offset=mesh.rank * band), 8, 3))
    rgb = run["out"]["tiles"][0]
    return {"rank": mesh.rank, "device": str(mesh.device), "launches": run["launches"],
            "host_ms": run["host_ms"], "mean_err": errs, "band_ms": band_ms,
            "gather_ms": collective_ms(mesh, rgb[:band], "all_gather"),
            "reduce_ms": collective_ms(mesh, rgb, "all_reduce"),
            "records": digest(qn), "tiles": digest(*run["out"]["tiles"]),
            "cams": digest(run["out"]["cams"])}


def sharding_phase(env: dict) -> None:
    """30. parallel/mesh.py on the card: (a) a one-rank NCCL group in this
    process, every sharding bit-equal to the unsharded kernels (the means of
    one sample are the sample) with its launches, per-rank frame ms and
    collective ms; (b) two gloo ranks sharing this card (spawned processes,
    each on cuda:0): each band and the gathered frame and cameras bit-equal
    to the one-rank frame (digests), the spp and path-traced means of two
    seeds within 1e-6 of the unsharded ones, launches per rank."""
    import tempfile

    import torch.distributed as dist

    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.parallel import mesh as pm

    card, dev, qn, tris = env["card"], env["dev"], env["qn"], env["tris"]
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(str(Path(tmp) / "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = pm.make_mesh(1, dev)
            refs = shard_refs(qn, tris, SHARD_SEEDS[:1], PT_SHARD_SEEDS[:1])
            run = run_shardings(mesh, qn, tris, SHARD_SEEDS[:1], PT_SHARD_SEEDS[:1])
            errs = shard_compare(run["out"], refs, 0, 1)
            if any(errs.values()):
                fail(f"sharding: one rank's spp / path-traced mean is not its sample: {errs}")
            log(f"[shard] one-rank NCCL group on {dev}: bands, spp, cameras and the "
                f"{BOUNCES}-bounce sample bit-equal to trace_tiles / K1b / trace_tiles_batch / "
                f"pt_sample_frame; launches {json.dumps(launched(run['launches']))}")
            ms = {name: statistics.median(cuda_ms(fn, 4, 3)) for name, fn in (
                ("tiles", lambda: pm.render_tiles_sharded(qn, tris, FRAMED, QUAT, WIDTH, HEIGHT,
                                                          mesh, FOV, leaf_k=LEAF_K)),
                ("spp", lambda: pm.render_spp_sharded(qn, tris, FRAMED, QUAT, SHARD_SEEDS[:1],
                                                      WIDTH, HEIGHT, mesh, FOV, leaf_k=LEAF_K)),
                ("cams", lambda: pm.render_cameras_sharded(qn, tris, *batch_cameras(CAM_Z), WIDTH,
                                                           HEIGHT, mesh, FOV, leaf_k=LEAF_K)),
                ("pt", lambda: pm.render_pt_spp_sharded(
                    qn, tris, FRAMED, QUAT, PT_SHARD_SEEDS[:1], WIDTH, HEIGHT, mesh,
                    bounces=BOUNCES, fov_degrees=FOV, leaf_k=LEAF_K, tile_primary=True)))}
            rgb = run["out"]["tiles"][0]
            coll = {"all_gather": statistics.median(cuda_ms(
                        lambda: dist.all_gather([torch.empty_like(rgb)], rgb), 8, 3)),
                    "all_reduce": statistics.median(cuda_ms(lambda: dist.all_reduce(rgb), 8, 3))}
            log(f"[shard] one rank, ms a call (CUDA events, median): {json.dumps(ms)}; "
                f"collectives of the 1080p rgb frame: {json.dumps(coll)} on {card}")
            one = {"records": digest(qn), "tiles": digest(*run["out"]["tiles"]),
                   "cams": digest(run["out"]["cams"])}
            del refs, run
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    glb = str(ROOT / "data" / "dragon_standin.glb")
    t0 = time.perf_counter()
    ranks = pm.run_ranks(shard_rank, 2, (glb,), device=dev, backend="gloo",
                         timeout=SHARD_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    for r in ranks:
        for key in ("records", "tiles", "cams"):
            if r[key] != one[key]:
                fail(f"sharding: gloo rank {r['rank']}'s {key} digest {r[key]} differs from the "
                     f"one-rank run's {one[key]}")
        log(f"[shard] gloo rank {r['rank']} of 2 on {r['device']}: band and gathered frame, "
            f"cameras bit-equal to the one-rank run; spp / pt means within {MEAN_ATOL} "
            f"(max |d| {json.dumps(r['mean_err'])}); launches "
            f"{json.dumps(launched(r['launches']))}; band "
            f"{r['band_ms']:.4f} ms (K1a, CUDA events), all_gather of its rgb band "
            f"{r['gather_ms']:.4f} ms, all_reduce of the rgb frame {r['reduce_ms']:.4f} ms (host "
            f"clock); calls {json.dumps({k: round(v, 4) for k, v in r['host_ms'].items()})} ms on "
            f"{card}")
    log(f"[shard] two gloo ranks in {spawn_s:.1f} s (spawn, builds, checks); phase 30 in "
        f"{time.perf_counter() - t_phase:.1f} s on {card}")


VIEWER_SIZES = ((960, 540), (1920, 1080))
VIEWER_CAMERA = (0.0, 0.0, 1.3)  # tools/mb_viewer_fps.py's
VIEWER_STEPS = 60
IDLE_REPEATS = 5


def viewer_phase(env: dict, scene) -> None:
    """31. tools/mb_viewer_fps.py's protocol through the port's ViewerState on
    the dragon with fast_build_options, at 960x540 and 1920x1080: ms a frame
    while active at stream scales 2 and 1 (60 steps, one K1a each) split into
    the host's issue / wait / encode and the parts alone (render and pull by
    CUDA events, encode on the host clock), the idle full-resolution publish
    (its PNG decodes to render() at the viewer's camera), the park (no launch);
    then one make_viewer_server round trip on localhost."""
    import threading
    import urllib.request

    import numpy as np

    from raytracer_tpu_torch import FPSCamera, PathTracer, fast_build_options
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.server.viewer import ViewerState, make_viewer_server
    from raytracer_tpu_torch.utils.image import encode_png

    card, dev = env["card"], env["dev"]
    t_phase = time.perf_counter()
    builder, leaf = fast_build_options(dev)
    for w, h in VIEWER_SIZES:
        tracer = PathTracer(w, h, builder=builder, leaf_size=leaf, device=dev)
        tracer.set_scene(scene)
        for scale in (2, 1):
            state = ViewerState(tracer, FPSCamera(position=list(VIEWER_CAMERA)),
                                stream_scale=scale)
            state.apply_input({"dx": 1.0})
            state.step(1 / 30)
            state._last_input = 0.0
            state.step(1 / 30)           # warm both paths
            torch.cuda.synchronize()
            traverse.reset_launches()
            parts = []
            t0 = time.perf_counter()
            for _ in range(VIEWER_STEPS):
                state.apply_input({"dx": 2.0, "dy": 1.0})   # keep ACTIVE
                state.step(1 / 30)
                parts.append(state.timings)
            active_ms = (time.perf_counter() - t0) * 1e3 / VIEWER_STEPS
            torch.cuda.synchronize()
            launches = dict(traverse.LAUNCHES)
            if launches != expected(trace_tiles_k1a=VIEWER_STEPS):
                fail(f"viewer {w}x{h} scale {scale}: {VIEWER_STEPS} active steps launched "
                     f"{launches}")
            split = {k: statistics.mean(p[k] for p in parts) for k in parts[0]}
            render = (lambda s=scale: tracer.render_stream(s)) if scale > 1 else tracer.render
            render_ms = statistics.median(cuda_ms(render, 8, 3))
            frame = render()
            host = torch.empty(frame.shape, dtype=frame.dtype, pin_memory=True)
            pull_ms = statistics.median(cuda_ms(lambda: host.copy_(frame, non_blocking=True),
                                                8, 3))
            img = frame.cpu().numpy()
            img = img[..., :3] if scale == 1 else img
            t0 = time.perf_counter()
            for _ in range(5):
                png = encode_png(img, level=1)
            encode_ms = (time.perf_counter() - t0) * 1e3 / 5
            log(f"[viewer] {w}x{h} active, stream scale {scale}: {active_ms:.4f} ms a frame = "
                f"{1e3 / active_ms:.2f} FPS over {VIEWER_STEPS} steps ({VIEWER_STEPS} K1a); a step "
                f"on the host: issue {split['issue_ms']:.4f}, wait {split['wait_ms']:.4f}, encode "
                f"{split['encode_ms']:.4f} ms; alone: render {render_ms:.4f} ms, pull "
                f"{pull_ms:.4f} ms (CUDA events, {frame.numel()} bytes), encode {encode_ms:.4f} ms "
                f"(PNG {len(png) / 1024:.0f} KiB); {builder} K={leaf} on {card}")
        idle = []
        for _ in range(IDLE_REPEATS):
            state.apply_input({"dx": 2.0})
            state.step(1 / 30)
            state._last_input = 0.0
            torch.cuda.synchronize()
            traverse.reset_launches()
            t0 = time.perf_counter()
            if state.step(1 / 30) is not True:
                fail(f"viewer {w}x{h}: the idle step published nothing")
            idle.append(((time.perf_counter() - t0) * 1e3, state.timings))
            idle_launches = dict(traverse.LAUNCHES)
            shown = decode_png(state.frame_png)
            want = tracer.render().cpu().numpy()[..., :3]
            if idle_launches != expected(trace_tiles_k1a=1) or not np.array_equal(shown, want):
                fail(f"viewer {w}x{h}: the idle publish launched {idle_launches} or its PNG is "
                     "not render() at the viewer's camera")
        full_ms = statistics.median(m for m, _ in idle)
        idle_split = {k: statistics.median(p[k] for _, p in idle) for k in idle[0][1]}
        torch.cuda.synchronize()
        traverse.reset_launches()
        t0 = time.perf_counter()
        parked = state.step(1 / 30)
        park_ms = (time.perf_counter() - t0) * 1e3
        if parked is not False or any(traverse.LAUNCHES.values()):
            fail(f"viewer {w}x{h}: the idle loop did not park")
        log(f"[viewer] {w}x{h} idle full-resolution publish {full_ms:.4f} ms (median of "
            f"{IDLE_REPEATS}: {[round(m, 4) for m, _ in idle]}; issue "
            f"{idle_split['issue_ms']:.4f}, wait {idle_split['wait_ms']:.4f}, encode "
            f"{idle_split['encode_ms']:.4f} ms; 1 K1a each, "
            f"PNG {len(state.frame_png) / 1024:.0f} KiB = render() at the camera); parked step "
            f"{park_ms:.4f} ms, no launch, on {card}")
        if (w, h) != VIEWER_SIZES[0]:
            continue
        srv = make_viewer_server(state, port=0)
        serving = threading.Thread(target=srv.serve_forever, daemon=True)
        serving.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        get_ms, post_ms = [], []
        try:
            for i in range(IDLE_REPEATS):
                t0 = time.perf_counter()
                with urllib.request.urlopen(f"{url}/api/frame.png", timeout=30) as r:
                    got = r.read()
                get_ms.append((time.perf_counter() - t0) * 1e3)
                req = urllib.request.Request(f"{url}/api/input", data=b'{"dx": 3.0}')
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=30) as r:
                    ok = json.loads(r.read())
                post_ms.append((time.perf_counter() - t0) * 1e3)
                if got != state.frame_png or ok != {"ok": True} \
                        or state._pending_mouse[0] != 3.0 * (i + 1):
                    fail("viewer server: GET /api/frame.png or POST /api/input did not "
                         "round-trip")
        finally:
            srv.shutdown()
            srv.server_close()
        log(f"[viewer] server on localhost, {IDLE_REPEATS} round trips: GET /api/frame.png "
            f"{[round(m, 4) for m in get_ms]} ms ({len(got)} bytes), POST /api/input "
            f"{[round(m, 4) for m in post_ms]} ms on {card}")
        del state, tracer
    log(f"[viewer] phase 31 in {time.perf_counter() - t_phase:.1f} s on {card}")


HALL_SIZE, HALL_EXTENT, HALL_CAM = 512, 0.25, (0.0, 0.0, 0.8)  # bench_suite.py:310-313
HALL_TIE_SHARE = 0.005  # the camera sits on the hall's symmetry planes


def check_split_frame(unsplit, split, hall: torch.Tensor, what: str) -> dict:
    """The split hall's (t, …, tri) planes against the unsplit hall's: every
    pixel whose triangle differs is a tie (both original triangles accept the
    ray, t within rtol 1e-6), a shared-edge hit (the two triangles share an
    edge and the frames' t agree within rtol 1e-6: a fragment takes a ray
    its parent rejects by rounding on that edge) or a crack of the unsplit
    mesh (its frame and brute force miss); together at most HALL_TIE_SHARE."""
    from raytracer_tpu_torch.ops.camera import primary_dirs
    from raytracer_tpu_torch.ops.trace import moller_trumbore, trace_rays_brute

    a, b = unsplit[4].reshape(-1), split[4].reshape(-1)
    d = torch.nonzero(a != b).squeeze(1)
    n = a.numel()
    px, py = d % HALL_SIZE, d // HALL_SIZE
    dirs = primary_dirs(px, py, HALL_SIZE, HALL_SIZE, QUAT, FOV)
    o = torch.tensor(HALL_CAM, dtype=torch.float32, device=hall.device).expand(d.numel(), 3)
    ai, bi = a[d].long(), b[d].long()

    def mt(ids):
        v = hall[ids.clamp(min=0)]
        return moller_trumbore(o, dirs, v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])

    (ta, oka), (tb, okb) = mt(ai), mt(bi)
    both = (ai >= 0) & (bi >= 0)
    tie = both & oka & okb & torch.isclose(ta, tb, rtol=TIE_RTOL, atol=0.0)
    va, vb = hall[ai.clamp(min=0)], hall[bi.clamp(min=0)]
    shared = (va[:, :, None, :] == vb[:, None, :, :]).all(-1).sum((1, 2)) >= 2
    t_same = torch.isclose(unsplit[0].reshape(-1)[d], split[0].reshape(-1)[d], rtol=TIE_RTOL,
                           atol=0.0)
    edge = both & ~tie & shared & t_same
    crack = (ai < 0) & (bi >= 0) & (trace_rays_brute(hall, o.contiguous(), dirs)[1] < 0)
    other = int((~tie & ~edge & ~crack).sum())
    stats = {"pixels": n, "differ": int(d.numel()), "ties": int(tie.sum()),
             "shared_edge": int(edge.sum()), "cracks": int(crack.sum()), "other": other}
    log(f"[graft] {what}: {json.dumps(stats)}")
    if other or d.numel() > HALL_TIE_SHARE * n:
        fail(f"{what}: {other} differing pixels are no tie, shared edge or crack, or "
             f"{d.numel()} > {HALL_TIE_SHARE:.1%} of the pixels differ")
    return stats


def graft_phase(env: dict) -> None:
    """32. graft_entry.entry() on the card against its CPU output; the NCCL
    dry run dryrun_multichip(1); the interior hall of config 4 at 512x512,
    unsplit and split by meshops.split_large_triangles, through K1a on SAH
    K = 32 records: the tri planes equal but for ties, shared-edge hits and
    cracks of the unsplit mesh, the frame ms and visits a ray (K1f) of
    each."""
    import numpy as np

    from raytracer_tpu_torch import Scene, graft_entry
    from raytracer_tpu_torch.ops.cluster import build_sah2_clustered, wide_pipeline
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.render import render_ldr
    from raytracer_tpu_torch.utils import meshops, procgen

    card, dev = env["card"], env["dev"]
    t_phase = time.perf_counter()
    fn, args = graft_entry.entry()
    fn_c, args_c = graft_entry.entry(device="cpu")
    rgb, rgb_c = fn(*args), fn_c(*args_c)
    _, _, tri = render_ldr(*args, 64, 64)
    _, _, tri_c = render_ldr(*args_c, 64, 64)
    err = float((rgb.cpu() - rgb_c).abs().max())
    if rgb.device != dev or rgb.shape != (64, 64, 3) or not torch.equal(tri.cpu(), tri_c) \
            or err > NORMAL_ATOL:
        fail(f"entry(): the card's frame is not the CPU's (max |d| {err})")
    log(f"[graft] entry(): 64x64 rgb on {rgb.device} equals the CPU forward (tri equal, max |d| "
        f"{err})")
    t0 = time.perf_counter()
    lines = graft_entry.dryrun_multichip(1)
    if len(lines) != 1 or not lines[0].endswith("OK"):
        fail(f"dryrun_multichip(1): {lines}")
    log(f"[graft] dryrun_multichip(1) (NCCL, one spawned rank) in "
        f"{time.perf_counter() - t0:.1f} s")

    scene = Scene().set_triangles(procgen.make_interior_hall())
    scene.normalize_mesh()
    hall = scene.triangles
    frags, ids = meshops.split_large_triangles(hall, HALL_EXTENT)
    planes = {}
    for name, tri_in, orig in (("unsplit", hall, None), ("split", frags, ids)):
        cs, height = build_sah2_clustered(tri_in, LEAF_K, dev)
        tri_ids = cs.tri_order if orig is None else \
            torch.from_numpy(orig.astype(np.int64)).to(dev)[cs.tri_order]
        qn = traverse.make_qnodes(wide_pipeline(cs, height=height), cs.tris_sorted,
                                  tri_ids=tri_ids, leaf_size=LEAF_K)

        def frame(qn=qn, **kw):
            return traverse.trace_tiles(qn, HALL_CAM, QUAT, HALL_SIZE, HALL_SIZE, FOV,
                                        leaf_k=LEAF_K, **kw)

        torch.cuda.synchronize()
        traverse.reset_launches()
        planes[name] = frame()
        torch.cuda.synchronize()
        if dict(traverse.LAUNCHES) != expected(trace_tiles_k1a=1):
            fail(f"hall {name}: launched {traverse.LAUNCHES}")
        ms = statistics.median(cuda_ms(frame, FRAMES, 3))
        visits = float(frame(stats=True)[5].sum(dtype=torch.float64)) / HALL_SIZE ** 2
        log(f"[graft] hall {name}: {len(tri_in)} triangles (split extent {HALL_EXTENT}), records "
            f"{tuple(qn.shape)}; K1a {HALL_SIZE}x{HALL_SIZE} {ms:.4f} ms a frame, {visits:.3f} "
            f"visits a ray (K1f), hit share {float((planes[name][4] >= 0).float().mean()):.6f} "
            f"on {card}")
    check_split_frame(planes["unsplit"], planes["split"], torch.from_numpy(hall).to(dev),
                      f"hall split at {HALL_EXTENT} vs unsplit, {HALL_SIZE}x{HALL_SIZE}")
    log(f"[graft] phase 32 in {time.perf_counter() - t_phase:.1f} s on {card}")


# 36. what each configuration's one frame launches, and its samples and bounces
BENCH_LAUNCHES = {
    2: {"trace_tiles_k1b": 4, "camera_lanes": 4, "trace_rays_k2b": 4, "wave_hit": 4,
        "wave_bounce": 4},
    4: {"trace_tiles_k1b": 1, "camera_lanes": 1, "trace_rays_k2a": 3, "trace_rays_k2b": 4,
        "wave_hit": 4, "wave_bounce": 4},
}


def bench_phase(env: dict, rows: dict) -> None:
    """36. BASELINE configs 2 and 4 through bench_suite_torch.py's records,
    sample and frame functions at full size: one frame of each with its
    launches counted (exactly BENCH_LAUNCHES) and its alive share, one
    sample of the same scene and camera at the frame's size (512x512,
    262,144 lanes a wave) and one at 256x256 (65,536 lanes) through the
    kernels and through the plain versions, and the configuration's JSON
    line from a one-frame stream. The launches join the kernels line as each row's
    ``bench_launches``."""
    import bench_suite_torch as suite
    from raytracer_tpu_torch.ops.cuda import traverse

    card, dev = env["card"], env["dev"]
    t_phase = time.perf_counter()
    configs = {2: (suite.config2_records, suite.config2_measure, suite.C2_POS, suite.C2_SIZE,
                   suite.C2_SPP, suite.C2_BOUNCES),
               4: (suite.config4_records, suite.config4_measure, suite.C4_POS, suite.C4_SIZE,
                   1, suite.C4_BOUNCES)}
    for n, (records, measure, pos, size, spp, bounces) in configs.items():
        t0 = time.perf_counter()
        rec = records(dev)
        torch.cuda.synchronize()
        log(f"[bench] config {n}: {rec.tris.shape[0]} triangles, records {tuple(rec.qnodes.shape)} "
            f"{json.dumps(rec.detail)} in {time.perf_counter() - t0:.2f} s")
        frame = suite.sample_frames(rec, pos, size, 1, spp, bounces)
        frame()
        torch.cuda.synchronize()
        traverse.reset_launches()
        total, alive = frame()
        torch.cuda.synchronize()
        launches = {k: v for k, v in traverse.LAUNCHES.items() if v}
        if launches != BENCH_LAUNCHES[n]:
            fail(f"config {n}: one frame launched {launches}, expected {BENCH_LAUNCHES[n]}")
        for name, count in launches.items():
            rows[name].setdefault("bench_launches", {})[f"config{n}"] = count
        lanes = 2 * size * size * spp * bounces
        if not math.isfinite(float(total)) or float(total) <= 0:
            fail(f"config {n}: the frame's summed radiance is {float(total)}")
        log(f"[bench] config {n}, one frame at {size}x{size}: launches {json.dumps(launches)}; "
            f"alive {int(alive)} of {lanes} lanes (share {int(alive) / lanes:.4f}); mean "
            f"radiance {float(total) / (size * size * spp):.6f}")

        def sample(side, rec=rec, pos=pos, bounces=bounces):
            return suite.config_sample(rec, pos, side, bounces, generator=torch.Generator(
                device=dev).manual_seed(SAMPLE_SEED))[0]

        # the frame's own size (its lanes a wave), then the checked crop of phases 11 and 33
        for side in (size, CROP):
            by_kernels = sample(side)
            by_plain, plain_ms = timed_once(lambda: plain_traversal(lambda: sample(side)))
            err = (by_kernels - by_plain).abs().amax(-1)
            share = float((err <= RADIANCE_ATOL).float().mean())
            log(f"[check] config {n}, one {side}x{side} sample ({side * side} lanes a wave), "
                f"kernels vs plain: {share:.6f} of pixels within {RADIANCE_ATOL} (max |d| "
                f"{float(err.max()):.3g}); plain sample {plain_ms:.1f} ms")
            if share < MIN_RADIANCE_MATCH or not bool(torch.isfinite(by_kernels).all()):
                fail(f"config {n}, {side}x{side}: {share:.6f} < {MIN_RADIANCE_MATCH} of pixels "
                     f"within {RADIANCE_ATOL}")
        log(f"[bench] config {n} line, a stream of one frame on {card}:")
        measure(rec, 1, dev)
    log(f"[bench] phase 36 in {time.perf_counter() - t_phase:.1f} s on {card}")


if __name__ == "__main__":
    main()
