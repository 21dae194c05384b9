"""Drive the PyTorch port's main path once on one CUDA card and check its kernel.

Run from the repository root, with one card:

    python3 chip_smoke.py

Phases, each printing what it measures; the first failure exits non-zero:

1. the device: a CUDA card is required (there is no CPU path), and its name
   and power limit as nvidia-smi reports them;
2. the builds: the native BVH library and the traversal kernel K1a, with
   their seconds;
3. the main path at full size: the 871,200-triangle dragon stand-in at
   1920×1080 through Scene.load_glb → PathTracer.set_scene → render (framed
   and sparse view) → render_presented, counting K1a's launches;
4. K1a against its plain torch version on a 256×256 centre crop of the framed
   view (65,536 pixels), and the shaded image against the plain version's;
5. K1a against the brute-force tracer on 1,024 seeded framed-view pixels;
6. times: K1a's ms per frame and Mrays/s on both views, and K1a against the
   plain version on the crop, with CUDA events.

Tolerances (what the kernel must meet): tri equal on >= 99.99% of the
pixels and every other pixel a tie (both triangles are accepted hits of that
ray with t within rtol 1e-6); t within rtol 1e-5 on hits and 1e30 on misses;
normals within atol 1e-5 of the reference, zero on misses.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels as JSON, and the line before that the card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
WIDTH, HEIGHT, LEAF_K, FOV = 1920, 1080, 32, 70.0
FRAMED, SPARSE = (0.0, 0.0, 1.15), (0.0, 0.0, 2.5)
QUAT = (0.0, 0.0, 0.0, 1.0)
CROP = 256
BRUTE_SAMPLES = 1024
SEED = 0
T_RTOL, NORMAL_ATOL, TIE_RTOL, MIN_TRI_MATCH = 1e-5, 1e-5, 1e-6, 0.9999
MIN_FRAMED_HIT_RATE = 0.4
FRAMES, REPEATS = 16, 5


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def check_against(kernel, ref, tris, origin, dirs, what: str) -> dict:
    """Hold K1a's flat (t, nx, ny, nz, tri) planes against a reference's on
    the same rays; fail on any breach of the tolerances above."""
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

        def hit_t(idx):
            v = tris[idx]
            return moller_trumbore(origin, dirs[diff], v[:, 0], v[:, 1] - v[:, 0],
                                   v[:, 2] - v[:, 0])

        (ta, oka), (tb, okb) = hit_t(a), hit_t(b)
        tie = oka & okb & torch.isclose(ta, tb, rtol=TIE_RTOL, atol=0.0) \
            & torch.isclose(kt[diff], rt[diff], rtol=TIE_RTOL, atol=0.0)
        if not bool(tie.all()):
            fail(f"{what}: {int((~tie).sum())} tri mismatches are not ties")
    match = float(same.float().mean())
    if match < MIN_TRI_MATCH:
        fail(f"{what}: tri equal on {match:.6f} < {MIN_TRI_MATCH} of pixels")
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


def main() -> None:
    # 1. the device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from raytracer_tpu_torch import PathTracer, Scene
    from raytracer_tpu_torch.native import bvhtool
    from raytracer_tpu_torch.ops.camera import primary_dirs
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
    t0 = time.perf_counter()
    bvhtool.ensure_built()
    log(f"[build] native BVH library ready in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    _, nvcc_log = traverse.load_kernel()
    log(f"[build] K1a nvcc build + load in {time.perf_counter() - t0:.2f} s")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            log(f"[build] ptxas: {line.strip()}")

    # 3. the main path
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
    log(f"[main] set_scene in {time.perf_counter() - t0:.2f} s: {json.dumps(pt.build_stats)}; "
        f"records {tuple(qn.shape)} = {qn.numel() * 4 / 2**20:.1f} MiB")

    pt.set_camera_quaternion(*QUAT)
    pt.fov_degrees = FOV
    torch.cuda.synchronize()
    traverse.LAUNCHES = 0
    pt.set_camera_position(*FRAMED)
    img_framed = pt.render()
    pt.set_camera_position(*SPARSE)
    img_sparse = pt.render()
    pt.set_camera_position(*FRAMED)
    presented = pt.render_presented()
    torch.cuda.synchronize()
    launches = traverse.LAUNCHES
    log(f"[main] K1a launches during the main path: {launches}")
    if launches < 3:
        fail(f"the main path launched K1a {launches} times, expected 3")
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
    ref = traverse.trace_tiles_reference(qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV,
                                         leaf_k=LEAF_K, pixels=crop_pix)
    ker = [p.reshape(-1)[crop_pix] for p in planes]
    origin = torch.tensor(FRAMED, dtype=torch.float32, device=dev)
    tris = pt._tris_dev
    crop_dirs = primary_dirs(crop_pix % WIDTH, crop_pix // WIDTH, WIDTH, HEIGHT, QUAT, FOV)
    plain = check_against(ker, ref, tris, origin, crop_dirs, "K1a vs plain, 256x256 crop")
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
    s_dirs = primary_dirs(sample % WIDTH, sample // WIDTH, WIDTH, HEIGHT, QUAT, FOV)
    bt, btri = trace_rays_brute(tris, origin.expand(BRUTE_SAMPLES, 3), s_dirs)
    bn = torch.where((btri >= 0)[:, None], triangle_normals(tris, btri),
                     torch.zeros((BRUTE_SAMPLES, 3), device=dev))
    brute = (bt, bn[:, 0], bn[:, 1], bn[:, 2], btri)
    check_against([p.reshape(-1)[sample] for p in planes], brute, tris, origin, s_dirs,
                  f"K1a vs brute force, {BRUTE_SAMPLES} framed pixels")

    # 6. times
    timings = {}
    for name, pos in (("framed", FRAMED), ("sparse", SPARSE)):
        reps = cuda_ms(lambda pos=pos: traverse.trace_tiles(
            qn, pos, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K), FRAMES, REPEATS)
        ms = statistics.median(reps)
        timings[name] = ms
        log(f"[time] K1a {name} 1920x1080: {ms:.4f} ms/frame = "
            f"{WIDTH * HEIGHT / ms / 1e3:.2f} Mrays/s (median of {REPEATS} x {FRAMES} "
            f"frames; reps {[round(r, 4) for r in reps]}) on {card}")
    crop_reps = cuda_ms(lambda: traverse.trace_tiles(
        qn, FRAMED, QUAT, CROP, CROP, FOV, leaf_k=LEAF_K, raygen_size=(WIDTH, HEIGHT),
        row_offset=r0, col_offset=c0), FRAMES, REPEATS)
    plain_reps = cuda_ms(lambda: traverse.trace_tiles_reference(
        qn, FRAMED, QUAT, WIDTH, HEIGHT, FOV, leaf_k=LEAF_K, pixels=crop_pix), 1, 3)
    crop_ms, plain_ms = statistics.median(crop_reps), statistics.median(plain_reps)
    log(f"[time] framed 256x256 crop: K1a {crop_ms:.4f} ms, plain torch {plain_ms:.2f} ms "
        f"(medians; plain reps {[round(r, 2) for r in plain_reps]}) on {card}")
    window = traverse.trace_tiles(qn, FRAMED, QUAT, CROP, CROP, FOV, leaf_k=LEAF_K,
                                  raygen_size=(WIDTH, HEIGHT), row_offset=r0, col_offset=c0)
    if not all(torch.equal(w.reshape(-1), k) for w, k in zip(window, ker)):
        fail("the kernel's crop window differs from the same pixels of its full frame")
    log(f"[mem] peak device memory allocated: "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    log(card)
    print(json.dumps({"kernels": [{
        "name": "trace_tiles_k1a", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/traverse_tiles.cu",
        "replaces": "raytracer_tpu/ops/pallas/traverse.py:666",
        "launches": launches, "max_abs_err": plain["max_abs_err"],
        "ms": crop_ms, "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
