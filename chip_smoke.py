"""Drive the PyTorch port's main paths once on one CUDA card and check its kernels.

Run from the repository root, with one card:

    python3 chip_smoke.py

Phases, each printing what it measures; the first failure exits non-zero:

1. the device: a CUDA card is required (there is no CPU path), and its name
   and power limit as nvidia-smi reports them;
2. the builds, started together: the native BVH library, the primary-ray
   kernels K1a/K1b (csrc/traverse_tiles.cu) and the ray-buffer kernels
   K2a/K2b (csrc/traverse_rays.cu), with their seconds and each kernel's
   ptxas registers, stack frame and spills;
3. the primary-ray main path at full size: the 871,200-triangle dragon
   stand-in at 1920×1080 through Scene.load_glb → PathTracer.set_scene →
   render (framed and sparse view) → render_presented, counting K1a's
   launches;
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
   device's idle share of the wall time.

Tolerances (what the kernels must meet): for closest hit (K1a, K1b, K2a),
tri equal on >= 99.99% of the rays and every other ray a tie (both
triangles are accepted hits of that ray with t within rtol 1e-6), t within
rtol 1e-5 on hits and 1e30 on misses, normals within atol 1e-5 of the
reference and zero on misses; for any hit (K2b), the occlusion mask equal
on every ray, t 0 where occluded and 1e30 elsewhere, and normals within
atol 1e-5 where both report the same occluder; for the whole sample, radiance within atol 1e-5 on >= 99.9%
of the pixels.

Bounds: a kernel's least time on the card is the larger of its bytes over
3.35 TB/s and its f32 operations over 67 TFLOP/s (the H100 SXM's published
peaks). Bytes: each ray read once (24 bytes; K2 only), each output written
once (20 bytes a ray), and the distinct record headers and triangle
records that the rays read. Operations: 100 per node visit (four slab
tests) and 54 per Möller–Trumbore test, as the plain version counts them
(an any-hit ray stops testing at its first accepted triangle). On the
checked rays the counts are exact; for a whole frame or wave they are
counted on a seeded subset and scaled to it (its distinct record bytes are
then a lower bound). No PyTorch call computes BVH traversal, so there is no
library yardstick (library_ms is null).

The kernels line: ``ms``, ``plain_ms`` and ``bound_ms`` are all on the
same ``rays`` — the 256×256 crop for K1a/K1b, the checked subset of each
wave for K2a/K2b (summed over the waves of one 1080p sample) — and
``path_ms``/``path_bound_ms`` on the main path's whole frame or waves
(``path_rays`` rays, active lanes for K2).

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels as JSON, and the line before that the card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
WIDTH, HEIGHT, LEAF_K, FOV = 1920, 1080, 32, 70.0
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
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
SLAB_OPS, MT_OPS = 100, 54
OUT_BYTES, RAY_BYTES = 20, 24
KERNELS = {
    "trace_tiles_k1a": ("raytracer_tpu_torch/csrc/traverse_tiles.cu",
                        "raytracer_tpu/ops/pallas/traverse.py:666"),
    "trace_tiles_k1b": ("raytracer_tpu_torch/csrc/traverse_tiles.cu",
                        "raytracer_tpu/ops/pallas/traverse.py:666"),
    "trace_rays_k2a": ("raytracer_tpu_torch/csrc/traverse_rays.cu",
                       "raytracer_tpu/ops/pallas/traverse.py:914"),
    "trace_rays_k2b": ("raytracer_tpu_torch/csrc/traverse_rays.cu",
                       "raytracer_tpu/ops/pallas/traverse.py:914"),
}


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
    ops = (counts.visits * SLAB_OPS + counts.mt_tests * MT_OPS) * scale
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    detail = {"bytes": nbytes, "ops": ops, "bytes_ms": b_ms, "ops_ms": o_ms,
              "visits_per_ray": counts.visits / max(counts.rays, 1),
              "mt_per_ray": counts.mt_tests / max(counts.rays, 1)}
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations"), detail


def profile_samples(pt, card: str, n: int = 3) -> None:
    """torch.profiler over ``n`` framed render_progressive(bounces=3) calls:
    device busy ms per sample (the sum of the CUDA kernels' own times), the
    top kernels, and the device's idle share of the wall time (inflated by
    the profiler's own host cost)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pt.set_camera_position(*FRAMED)
    pt.render_progressive(bounces=BOUNCES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            pt.render_progressive(bounces=BOUNCES)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if busy_ms == 0:
        log("[profile] the profiler recorded no device time: device busy share not measured")
        return
    log(f"[profile] render_progressive(bounces={BOUNCES}) under torch.profiler: wall "
        f"{wall_ms:.4f} ms/sample, device busy {busy_ms:.4f} ms/sample, idle share "
        f"{1 - busy_ms / wall_ms:.4f} on {card}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3 / n:9.4f} ms/sample "
            f"x{e.count / n:6.1f}  {e.key[:110]}")


def build_all() -> dict:
    """Build the native library and both kernel sources at once."""
    from raytracer_tpu_torch.native import bvhtool
    from raytracer_tpu_torch.ops.cuda import traverse

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=3) as pool:
        jobs = {"native BVH library": pool.submit(timed, bvhtool.ensure_built),
                "traverse_tiles.cu (K1a, K1b)": pool.submit(timed, traverse.load_kernel,
                                                            "traverse_tiles.cu"),
                "traverse_rays.cu (K2a, K2b)": pool.submit(timed, traverse.load_kernel,
                                                           "traverse_rays.cu")}
        results = {name: job.result() for name, job in jobs.items()}
    for name, (out, secs) in results.items():
        log(f"[build] {name} ready in {secs:.2f} s")
        if isinstance(out, tuple):
            for line in out[1].splitlines():
                if any(k in line for k in ("Compiling entry", "registers", "spill",
                                           "stack frame")):
                    log(f"[build] ptxas {name.split()[0]}: {line.strip()}")
    return results


def main() -> None:
    # 1. the device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from raytracer_tpu_torch import PathTracer, Scene, render_pt
    from raytracer_tpu_torch.ops.camera import primary_dirs, subpixel_hash01
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.ops.shade import (MISS_COLOR, quantize_rgba8, shade_lambert,
                                               triangle_normals)
    from raytracer_tpu_torch.ops.trace import trace_rays_brute
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
    pt = PathTracer(WIDTH, HEIGHT, builder="sah", leaf_size=LEAF_K, device=dev)
    t0 = time.perf_counter()
    pt.set_scene(scene)
    qn = pt._qnodes
    tris = pt._tris_dev
    log(f"[main] set_scene in {time.perf_counter() - t0:.2f} s: {json.dumps(pt.build_stats)}; "
        f"records {tuple(qn.shape)} = {qn.numel() * 4 / 2**20:.1f} MiB")

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
    if render_launches != {"trace_tiles_k1a": 3, "trace_tiles_k1b": 0, "trace_rays_k2a": 0,
                           "trace_rays_k2b": 0}:
        fail(f"the primary path launched {render_launches}, expected 3 K1a and nothing else")
    miss_u8 = int(quantize_rgba8(torch.full((1, 3), MISS_COLOR))[0, 0])
    hit_rates = {}
    for name, img in (("framed", img_framed), ("sparse", img_sparse), ("presented", presented)):
        if img.shape != (HEIGHT, WIDTH, 4) or img.dtype != torch.uint8 or img.device != dev:
            fail(f"{name} image is {tuple(img.shape)} {img.dtype} on {img.device}")
        if not bool((img[..., 3] == 255).all()):
            fail(f"{name} image alpha is not 255 everywhere")
        hit_rates[name] = float((img[..., 0] != miss_u8).float().mean())
    log(f"[main] hit rate (pixels not the miss color): framed {hit_rates['framed']:.4f}, "
        f"sparse {hit_rates['sparse']:.4f}")
    if hit_rates["framed"] < MIN_FRAMED_HIT_RATE:
        fail(f"framed hit rate {hit_rates['framed']:.3f} < {MIN_FRAMED_HIT_RATE}")

    # 4. K1a vs its plain torch version on the framed view's centre crop
    planes = traverse.trace_tiles(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K)
    hit_plane = float((planes[4] >= 0).float().mean())
    if hit_plane != hit_rates["framed"]:
        fail(f"image hit rate {hit_rates['framed']} != kernel tri plane {hit_plane}")
    r0, c0 = (HEIGHT - CROP) // 2, (WIDTH - CROP) // 2
    rows = torch.arange(r0, r0 + CROP, device=dev)
    cols = torch.arange(c0, c0 + CROP, device=dev)
    crop_pix = (rows[:, None] * WIDTH + cols[None, :]).reshape(-1)
    crop_counts = {name: traverse.TraversalCounts()
                   for name in ("trace_tiles_k1a", "trace_tiles_k1b")}
    ref = traverse.trace_tiles_reference(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV,
                                         leaf_k=LEAF_K, pixels=crop_pix,
                                         counts=crop_counts["trace_tiles_k1a"])
    ker = [p.reshape(-1)[crop_pix] for p in planes]
    origin = torch.tensor(FRAMED, dtype=torch.float32, device=dev)
    crop_dirs = primary_dirs(crop_pix % WIDTH, crop_pix // WIDTH, WIDTH, HEIGHT, QUAT, FOV)
    checks = {"trace_tiles_k1a": check_against(ker, ref, tris, origin, crop_dirs,
                                               "K1a vs plain, 256x256 crop")}
    ref_rgb = quantize_rgba8(shade_lambert(torch.stack(ref[1:4], -1), ref[4] >= 0))
    img_crop = img_framed.reshape(-1, 4)[crop_pix]
    same = ker[4] == ref[4]
    rgb_err = int((img_crop[same].int() - ref_rgb[same].int()).abs().max())
    log(f"[check] render() vs plain shading on the crop: max rgba8 diff {rgb_err} "
        f"on {int(same.sum())} same-tri pixels")
    if rgb_err > 1:
        fail(f"render() differs from the plain version's shading by {rgb_err} LSB")

    # 5. K1a vs the brute-force tracer on seeded framed-view pixels
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    sample = torch.randperm(WIDTH * HEIGHT, generator=gen)[:BRUTE_SAMPLES].to(dev)

    def brute_planes(dirs):
        bt, btri = trace_rays_brute(tris, origin.expand(dirs.shape[0], 3), dirs)
        bn = torch.where((btri >= 0)[:, None], triangle_normals(tris, btri),
                         torch.zeros((dirs.shape[0], 3), device=dev))
        return (bt, bn[:, 0], bn[:, 1], bn[:, 2], btri)

    s_dirs = primary_dirs(sample % WIDTH, sample // WIDTH, WIDTH, HEIGHT, QUAT, FOV)
    check_against([p.reshape(-1)[sample] for p in planes], brute_planes(s_dirs), tris, origin,
                  s_dirs, f"K1a vs brute force, {BRUTE_SAMPLES} framed pixels")

    # 6. K1b (jittered) vs its plain version on the crop and vs brute force
    def jittered_dirs(pix, seed):
        px, py = pix % WIDTH, pix // WIDTH
        return primary_dirs(px, py, WIDTH, HEIGHT, QUAT, FOV, subpixel_hash01(px, py, 2 * seed),
                            subpixel_hash01(px, py, 2 * seed + 1))

    jplanes = traverse.trace_tiles(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K,
                                   jitter=True, jitter_seed=JITTER_SEED)
    jref = traverse.trace_tiles_reference(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K,
                                          pixels=crop_pix, jitter=True,
                                          jitter_seed=JITTER_SEED,
                                          counts=crop_counts["trace_tiles_k1b"])
    checks["trace_tiles_k1b"] = check_against(
        [p.reshape(-1)[crop_pix] for p in jplanes], jref, tris, origin,
        jittered_dirs(crop_pix, JITTER_SEED), "K1b vs plain, jittered 256x256 crop")
    js_dirs = jittered_dirs(sample, JITTER_SEED)
    check_against([p.reshape(-1)[sample] for p in jplanes], brute_planes(js_dirs), tris, origin,
                  js_dirs, f"K1b vs brute force, {BRUTE_SAMPLES} jittered framed pixels")

    # 7. the progressive main path
    pt.set_camera_position(*FRAMED)
    torch.cuda.synchronize()
    traverse.reset_launches()
    for _ in range(SAMPLES):
        accum = pt.render_progressive(bounces=BOUNCES)
    shown = pt.present_progressive()
    torch.cuda.synchronize()
    pt_launches = dict(traverse.LAUNCHES)
    want = {"trace_tiles_k1a": 0, "trace_tiles_k1b": SAMPLES,
            "trace_rays_k2a": SAMPLES * (BOUNCES - 1), "trace_rays_k2b": SAMPLES * BOUNCES}
    log(f"[progressive] launches during {SAMPLES} x render_progressive(bounces={BOUNCES}) + "
        f"present_progressive: {json.dumps(pt_launches)}")
    if pt_launches != want:
        fail(f"progressive launches {pt_launches}, expected {want}")
    if pt.frame_count != SAMPLES:
        fail(f"frame_count {pt.frame_count} after {SAMPLES} samples")
    if accum.shape != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(accum).all()
                                                     & (accum >= 0).all()):
        fail("the accumulation buffer is not a finite non-negative (H, W, 3) image")
    if shown.shape != (HEIGHT, WIDTH, 4) or shown.dtype != torch.uint8:
        fail(f"present_progressive gave {tuple(shown.shape)} {shown.dtype}")
    log(f"[progressive] frame_count {pt.frame_count}; mean radiance "
        f"{float(accum.mean()):.6f}, max {float(accum.max()):.6f}; background share "
        f"{float((accum[..., 0] == MISS_COLOR).float().mean()):.4f}")
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
    if aa_launches != {"trace_tiles_k1a": 0, "trace_tiles_k1b": SAMPLES, "trace_rays_k2a": 0,
                       "trace_rays_k2b": 0}:
        fail(f"bounces=0 launches {aa_launches}, expected {SAMPLES} K1b")
    if pt.frame_count != SAMPLES or not bool(torch.isfinite(aa).all() & (aa >= 0).all()):
        fail("bounces=0: wrong frame_count or a non-finite/negative buffer")
    torch.cuda.set_sync_debug_mode("error")
    try:
        pt.render_progressive(bounces=BOUNCES)
        pt.render_progressive(bounces=0)
    except RuntimeError as exc:
        fail(f"render_progressive waited for the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log("[progressive] render_progressive(bounces=3) and (bounces=0) issued without a "
        "host-device synchronisation")

    # 8. K2a/K2b vs their plain versions on every wave of one 1080p sample
    waves = []
    real_trace_rays = render_pt.trace_rays

    def capturing(qnodes, origins, dirs, *, any_hit=False, leaf_k, active=None):
        out = real_trace_rays(qnodes, origins, dirs, any_hit=any_hit, leaf_k=leaf_k,
                              active=active)
        waves.append({"any_hit": any_hit, "o": origins, "d": dirs, "active": active,
                      "out": out})
        return out

    render_pt.trace_rays = capturing
    try:
        _, sample_stats = render_pt.pt_sample_frame(
            qn, tris, FRAMED, QUAT, WIDTH, HEIGHT, bounces=BOUNCES, fov_degrees=FOV,
            leaf_k=LEAF_K, tile_primary=True,
            generator=torch.Generator(device=dev).manual_seed(SAMPLE_SEED), stats=True)
    finally:
        render_pt.trace_rays = real_trace_rays
    alive_rays = int(sample_stats["alive_rays"])
    log(f"[waves] captured {len(waves)} ray-buffer waves; alive rays per sample {alive_rays} "
        f"of {int(sample_stats['lane_rays'])} lanes")
    pick_gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    wave_stats = {"trace_rays_k2a": [], "trace_rays_k2b": []}
    for i, w in enumerate(waves):
        name = "trace_rays_k2b" if w["any_hit"] else "trace_rays_k2a"
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
        ref = traverse.trace_rays_reference(qn, o, d, any_hit=w["any_hit"], leaf_k=LEAF_K,
                                            counts=counts)
        kout = [p[pick] for p in out]
        n, n_live = pick.numel(), live.numel()
        what = f"{name} vs plain, wave {i}, {n} of {n_live} active rays"
        stats = (check_occlusion(kout, ref, what) if w["any_hit"]
                 else check_against(kout, ref, tris, o, d, what))
        plain_ms = statistics.median(cuda_ms(lambda: traverse.trace_rays_reference(
            qn, o, d, any_hit=w["any_hit"], leaf_k=LEAF_K), 1, 3))
        ms = statistics.median(cuda_ms(lambda: traverse.trace_rays(
            qn, o, d, any_hit=w["any_hit"], leaf_k=LEAF_K), FRAMES, 3))
        path_ms = statistics.median(cuda_ms(lambda: traverse.trace_rays(
            qn, w["o"], w["d"], any_hit=w["any_hit"], leaf_k=LEAF_K, active=w["active"]),
            3, 3))
        b_ms, b_by, detail = bound(counts, 1.0, n * (OUT_BYTES + RAY_BYTES))
        pb_ms, pb_by, p_detail = bound(counts, n_live / n,
                                       r * OUT_BYTES + n_live * RAY_BYTES + r)
        wave_stats[name].append({**stats, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                 "bound_detail": detail, "path_ms": path_ms,
                                 "path_bound_ms": pb_ms, "path_bound_detail": p_detail,
                                 "active": n_live})
        log(f"[time] wave {i} {name} on its {n} checked rays: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by} {json.dumps(detail)} on {card}")
        log(f"[time] wave {i} {name} whole: {path_ms:.4f} ms for {r} lanes ({n_live} active) "
            f"= {n_live / path_ms / 1e3:.2f} M active rays/s; bound {pb_ms:.4f} ms by {pb_by} "
            f"{json.dumps(p_detail)} on {card}")
    for name, n_waves in (("trace_rays_k2a", BOUNCES - 1), ("trace_rays_k2b", BOUNCES)):
        if len(wave_stats[name]) != n_waves:
            fail(f"captured {len(wave_stats[name])} {name} waves, expected {n_waves}")
    del waves

    # 9. one whole 256x256 sample: kernels vs plain versions
    def plain_tiles(qnodes, cam_pos, cam_quat, width, height, fov_degrees=70.0, leaf_k=1,
                    jitter=False, jitter_seed=0):
        return traverse.trace_tiles_reference(qnodes, cam_pos, cam_quat, width, height,
                                              fov_degrees, leaf_k, jitter=jitter,
                                              jitter_seed=jitter_seed)

    def plain_rays(qnodes, origins, dirs, *, any_hit=False, leaf_k, active=None):
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
    timings = {}
    for name, pos in (("framed", FRAMED), ("sparse", SPARSE)):
        reps = cuda_ms(lambda pos=pos: traverse.trace_tiles(
            qn, pos, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K), FRAMES, REPEATS)
        ms = statistics.median(reps)
        timings[name] = ms
        log(f"[time] K1a {name} 1920x1080: {ms:.4f} ms/frame = "
            f"{WIDTH * HEIGHT / ms / 1e3:.2f} Mrays/s (median of {REPEATS} x {FRAMES} "
            f"frames; reps {[round(r, 4) for r in reps]}) on {card}")
    jreps = cuda_ms(lambda: traverse.trace_tiles(
        qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K, jitter=True,
        jitter_seed=JITTER_SEED), FRAMES, REPEATS)
    timings["jittered"] = statistics.median(jreps)
    log(f"[time] K1b framed 1920x1080 (the camera wave): {timings['jittered']:.4f} ms/frame "
        f"(reps {[round(r, 4) for r in jreps]}) on {card}")
    crop_ms, plain_ms, crop_bounds = {}, {}, {}
    for name, jitter in (("trace_tiles_k1a", False), ("trace_tiles_k1b", True)):
        crop_ms[name] = statistics.median(cuda_ms(lambda jitter=jitter: traverse.trace_tiles(
            qn, FRAMED, QUAT, CROP, CROP, FOV, leaf_k=LEAF_K, raygen_size=(WIDTH, HEIGHT),
            row_offset=r0, col_offset=c0, jitter=jitter, jitter_seed=JITTER_SEED),
            FRAMES, REPEATS))
        plain_ms[name] = statistics.median(cuda_ms(lambda jitter=jitter: (
            traverse.trace_tiles_reference(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV,
                                           leaf_k=LEAF_K, pixels=crop_pix, jitter=jitter,
                                           jitter_seed=JITTER_SEED)), 1, 3))
        crop_bounds[name] = bound(crop_counts[name], 1.0, crop_pix.numel() * OUT_BYTES)
        log(f"[time] {name} framed 256x256 crop: kernel {crop_ms[name]:.4f} ms, plain torch "
            f"{plain_ms[name]:.2f} ms (median of 3), bound {crop_bounds[name][0]:.4f} ms by "
            f"{crop_bounds[name][1]} {json.dumps(crop_bounds[name][2])} on {card}")
    window = traverse.trace_tiles(qn, FRAMED, QUAT, CROP, CROP, FOV, leaf_k=LEAF_K,
                                  raygen_size=(WIDTH, HEIGHT), row_offset=r0, col_offset=c0)
    if not all(torch.equal(w.reshape(-1), k) for w, k in zip(window, ker)):
        fail("the kernel's crop window differs from the same pixels of its full frame")

    frame_bounds = {}
    bound_pix = torch.randperm(WIDTH * HEIGHT, generator=gen)[:WAVE_SAMPLES].to(dev)
    for name, jitter in (("trace_tiles_k1a", False), ("trace_tiles_k1b", True)):
        counts = traverse.TraversalCounts()
        traverse.trace_tiles_reference(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K,
                                       pixels=bound_pix, jitter=jitter,
                                       jitter_seed=JITTER_SEED, counts=counts)
        frame_bounds[name] = bound(counts, WIDTH * HEIGHT / WAVE_SAMPLES,
                                   WIDTH * HEIGHT * OUT_BYTES)
        log(f"[bound] {name} framed 1080p frame: {frame_bounds[name][0]:.4f} ms by "
            f"{frame_bounds[name][1]} {json.dumps(frame_bounds[name][2])}")

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
    wave_ms = {name: sum(s["path_ms"] for s in stats) for name, stats in wave_stats.items()}
    log(f"[time] traversal kernels per 1080p sample: K1b {timings['jittered']:.4f} ms + K2a "
        f"{wave_ms['trace_rays_k2a']:.4f} ms + K2b {wave_ms['trace_rays_k2b']:.4f} ms = "
        f"{timings['jittered'] + sum(wave_ms.values()):.4f} ms of "
        f"{statistics.median(sample_reps[BOUNCES]):.4f} ms per sample on {card}")

    # 11. where the time of a progressive sample goes
    profile_samples(pt, card)

    def summed(details):
        """The bound of several waves run one after another: the sum of
        their bounds, labelled by the larger of its bytes and its
        operations parts."""
        by_bytes = sum(max(x["bytes_ms"], x["ops_ms"]) for x in details
                       if x["bytes_ms"] >= x["ops_ms"])
        total = sum(max(x["bytes_ms"], x["ops_ms"]) for x in details)
        return total, ("bytes" if 2 * by_bytes >= total else "operations")

    rows = {}
    for name, launches, frame_ms in (
            ("trace_tiles_k1a", render_launches["trace_tiles_k1a"], timings["framed"]),
            ("trace_tiles_k1b", pt_launches["trace_tiles_k1b"], timings["jittered"])):
        rows[name] = {"launches": launches, "max_abs_err": checks[name]["max_abs_err"],
                      "rays": crop_pix.numel(), "ms": crop_ms[name], "plain_ms": plain_ms[name],
                      "bound_ms": crop_bounds[name][0], "bound_by": crop_bounds[name][1],
                      "path_rays": WIDTH * HEIGHT, "path_ms": frame_ms,
                      "path_bound_ms": frame_bounds[name][0],
                      "path_bound_by": frame_bounds[name][1]}
    for name in ("trace_rays_k2a", "trace_rays_k2b"):
        ws = wave_stats[name]
        b_ms, b_by = summed([s["bound_detail"] for s in ws])
        pb_ms, pb_by = summed([s["path_bound_detail"] for s in ws])
        rows[name] = {"launches": pt_launches[name],
                      "max_abs_err": max(s["max_abs_err"] for s in ws),
                      "rays": sum(s["rays"] for s in ws), "ms": sum(s["ms"] for s in ws),
                      "plain_ms": sum(s["plain_ms"] for s in ws), "bound_ms": b_ms,
                      "bound_by": b_by, "path_rays": sum(s["active"] for s in ws),
                      "path_ms": sum(s["path_ms"] for s in ws), "path_bound_ms": pb_ms,
                      "path_bound_by": pb_by, "waves_path_ms": [s["path_ms"] for s in ws]}
    log(card)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[name][0],
        "replaces": KERNELS[name][1], **row, "library_ms": None,
    } for name, row in rows.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
