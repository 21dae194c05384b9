"""Benchmark harness of the PyTorch / CUDA port — one JSON line, detail on stderr.

The counterpart of ``bench.py``, with its scene, framings, metric names and
Mrays/s definition. Headline: primary rays a second on the
871,200-triangle dragon stand-in (``procgen.make_dragon_stand_in``, written
to ``data/dragon_standin.glb`` once and loaded through ``Scene.load_glb``
with the cube normalization, as the reference loads its scene) at
1920×1080, 1 primary ray a pixel, SAH clusters of K = 32. ``vs_baseline``
is against the reference's ~75 Mrays/s (BASELINE.md).

Each frame is one ``trace_tiles`` launch (K1a) from its own camera,
``cam_pos0 + (1e-4·i, 0, 0)``, and its hit count (``tri >= 0``) is summed on
the device. A stream of ``--frames`` frames is issued, the host waits once
and pulls the per-frame counts once; ms a frame is the host clock over the
stream, the median of 3 streams after a warm-up stream, with the device's
ms a frame from CUDA events beside it. Framings: sparse, camera (0, 0,
2.5), and framed, (0, 0, 1.15), whose hit rate must be ≥ 0.4; the framed
number is the headline. ``--bounded`` times
``render.trace_tiles_bounded`` (coarse probe, K1d, masked K2a repair)
instead of K1a, with the repairs of each frame in ``detail``. ``--quick``:
``make_icosphere(4)`` at 512×512 (unless ``--width`` / ``--height`` say
otherwise) with single-triangle leaves, the sparse loop only, under
``primary_rays_per_second_quick``.

Runs on the CUDA card by default and raises without one; ``--device cpu``
runs every kernel's plain version (the tests' toy runs). Nothing falls
back: the native SAH build must build (``native/bvhtool.ensure_built``
raises otherwise), and a dragon file with another triangle count is
refused. ``detail`` names the device; on a card, also its name and power
limit as ``nvidia-smi`` reports them.

Usage, from the repository root:

    python3 bench_torch.py [--quick] [--frames N] [--builder sah|lbvh] [--leaf K]
                           [--width W] [--height H] [--bounded] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DRAGON_GLB = ROOT / "data" / "dragon_standin.glb"
DRAGON_TRIANGLES = 871_200
BASELINE_MRAYS = 75.0  # reference iGPU, BASELINE.md
FOV = 70.0
QUAT = (0.0, 0.0, 0.0, 1.0)
SPARSE, FRAMED = (0.0, 0.0, 2.5), (0.0, 0.0, 1.15)
MIN_FRAMED_HIT_RATE = 0.4
REPS = 3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def resolve_device(name: str) -> torch.device:
    """The device a run asks for: a CUDA card (raises where there is none)
    or the CPU, where every kernel runs its plain version."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA device is available "
                               "(--device cpu runs the plain versions)")
        return torch.device("cuda", torch.cuda.current_device() if dev.index is None
                            else dev.index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: cuda or cpu")
    return dev


def device_detail(dev: torch.device) -> dict:
    """What ran the numbers: the device, and on a card its name and its
    name and power limit as nvidia-smi reports them."""
    if dev.type != "cuda":
        return {"device": "cpu", "card": None}
    out = subprocess.run(
        ["nvidia-smi", f"--id={dev.index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
    return {"device": torch.cuda.get_device_name(dev), "card": out.stdout.strip()}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def to_host(out):
    """A stream's outputs (a tensor or a tuple of them) on the host."""
    if isinstance(out, torch.Tensor):
        return out.cpu()
    return tuple(o.cpu() for o in out)


def time_stream(run, frames: int, dev: torch.device, reps: int = REPS) -> dict:
    """Time ``run()``, which issues ``frames`` frames and returns their
    results on the device: one warm-up call (kernel builds, caches), then
    ``reps`` calls, each ended by one pull of its results to the host. →
    ``ms`` (median host ms a frame), ``device_ms`` (median ms a frame
    between CUDA events recorded before and after the stream; None on the
    CPU), ``host_reps``, ``thread_cpu_reps`` (the issuing thread's CPU ms a
    frame in each call: near ``host_reps`` where the host's issue is the
    frame) and ``out`` (the last call's results on the host)."""
    to_host(run())
    host, cpu, device = [], [], []
    cuda = dev.type == "cuda"
    for _ in range(reps):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0, c0 = time.perf_counter(), time.thread_time()
        res = run()
        if cuda:
            end.record()
        out = to_host(res)
        host.append((time.perf_counter() - t0) / frames * 1e3)
        cpu.append((time.thread_time() - c0) / frames * 1e3)
        if cuda:
            device.append(start.elapsed_time(end) / frames)
    return {"ms": statistics.median(host), "host_reps": host, "thread_cpu_reps": cpu,
            "device_ms": statistics.median(device) if device else None, "out": out}


def profile_stream(run, frames: int, dev: torch.device, ms_per_frame: float) -> dict | None:
    """One stream under torch.profiler (a traced run apart from the timed
    ones): kernels a frame and device-busy ms a frame (the kernels' own
    times). The device's idle share is 1 − busy / ``ms_per_frame``, the
    timed streams' host ms a frame: the profiler slows the host's issue of
    the traced stream (about twice where the host issues hundreds of
    kernels a frame), so its own wall (``traced_wall_ms_per_frame``) would
    inflate the share. None on the CPU, or where the profiler records no
    device time."""
    if dev.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        to_host(run())
        traced = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / frames
    if busy == 0:
        log("[profile] the profiler recorded no device time: idle share not measured")
        return None
    return {"kernels_per_frame": sum(e.count for e in kernels) / frames,
            "busy_ms_per_frame": busy, "traced_wall_ms_per_frame": traced / frames,
            "idle_share": 1.0 - busy / ms_per_frame}


def launches_of(run, dev: torch.device) -> dict | None:
    """The kernel launches of one call of ``run()``, by name; None on the
    CPU, where the wrappers run their plain versions and count nothing."""
    from raytracer_tpu_torch.ops.cuda import traverse

    if dev.type != "cuda":
        return None
    traverse.reset_launches()
    to_host(run())
    return {k: v for k, v in traverse.LAUNCHES.items() if v}


def normalized(tris: np.ndarray):
    """A Scene of ``tris`` with the cube normalization (longest side → [-1, 1])."""
    from raytracer_tpu_torch import Scene

    scene = Scene().set_triangles(tris)
    scene._normalize_enabled, scene._normalize_mode = True, "cube"
    scene.normalize_mesh()
    return scene


def load_dragon(path: Path = DRAGON_GLB):
    """The dragon stand-in through the ingest layer: written to ``path`` once
    if missing, then ``Scene.load_glb(normalize=True, mode="cube")``.
    Raises for a file that does not hold its 871,200 triangles."""
    from raytracer_tpu_torch import Scene
    from raytracer_tpu_torch.utils import procgen

    path = Path(path)
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procgen.write_glb(path, procgen.make_dragon_stand_in())
        log(f"[bench] wrote {path} ({path.stat().st_size / 1e6:.1f} MB) in "
            f"{time.perf_counter() - t0:.1f}s (one-time)")
    t0 = time.perf_counter()
    scene = Scene().load_glb(path, normalize=True, mode="cube")
    log(f"[bench] GLB ingest (parse+de-index+normalize): {time.perf_counter() - t0:.2f}s")
    if scene.num_triangles != DRAGON_TRIANGLES:
        raise RuntimeError(f"{path} holds {scene.num_triangles} triangles, not the "
                           f"{DRAGON_TRIANGLES} of the dragon stand-in: delete it, and it is "
                           "written anew")
    return scene


def build_tracer(tris_np: np.ndarray, builder: str, leaf_k: int, dev: torch.device):
    """``bench.py``'s full build, as a user runs it: ``PathTracer(widener=
    "collapse", builder=, leaf_size=).build_bvh`` — SAH clusters (K > 1,
    ``"sah"``), Morton clusters (K > 1, ``"lbvh"``), the native SAH tree of
    single triangles (K = 1, ``"sah"``) or the Morton LBVH (K = 1,
    ``"lbvh"``), then the 4-wide device collapse and the records. The
    tracer's ``build_stats`` time the phases (``lbvh2_ms`` the host /
    native build, ``records_ms`` the collapse and records, ``total_ms``)."""
    from raytracer_tpu_torch import PathTracer

    pt = PathTracer(widener="collapse", builder=builder, leaf_size=leaf_k, device=dev)
    pt.build_bvh(tris_np)
    return pt


def make_stream(qn: torch.Tensor, pos0, width: int, height: int, leaf_k: int, frames: int,
                bounded: bool):
    """``run()`` issuing ``frames`` frames from ``pos0 + (1e-4·i, 0, 0)``,
    each one K1a launch (``bounded``: ``trace_tiles_bounded``) and a sum of
    its hits on the device → (hits a frame, repairs a frame or None)."""
    from raytracer_tpu_torch.ops.cuda.traverse import trace_tiles
    from raytracer_tpu_torch.render import trace_tiles_bounded

    cams = [(pos0[0] + 1e-4 * i, pos0[1], pos0[2]) for i in range(frames)]

    def run():
        hits, repairs = [], []
        for pos in cams:
            if bounded:
                *planes, n_repair = trace_tiles_bounded(qn, pos, QUAT, width, height, FOV,
                                                        leaf_k=leaf_k)
                repairs.append(n_repair)
            else:
                planes = trace_tiles(qn, pos, QUAT, width, height, FOV, leaf_k=leaf_k)
            hits.append((planes[4] >= 0).sum())
        return torch.stack(hits), (torch.stack(repairs) if bounded else torch.zeros(0))

    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="icosphere(4) at 512x512, single-triangle leaves, the sparse loop")
    ap.add_argument("--frames", type=int, default=128, help="frames a timed stream")
    ap.add_argument("--builder", default="sah", choices=["sah", "lbvh"],
                    help="sah = native binned SAH (clusters snapped to K); lbvh = Morton")
    ap.add_argument("--leaf", type=int, default=32,
                    help="triangles a leaf (K); 1 = single-triangle leaves")
    ap.add_argument("--width", type=int, default=None, help="default 1920 (512 with --quick)")
    ap.add_argument("--height", type=int, default=None, help="default 1080 (512 with --quick)")
    ap.add_argument("--bounded", action="store_true",
                    help="time render.trace_tiles_bounded instead of K1a")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    if args.frames < 1 or args.leaf < 1:
        raise ValueError("--frames and --leaf must be >= 1")

    from raytracer_tpu_torch.native import bvhtool
    from raytracer_tpu_torch.ops.cuda.traverse import trace_tiles
    from raytracer_tpu_torch.utils import procgen

    dev = resolve_device(args.device)
    detail_dev = device_detail(dev)
    log(f"[bench] device {json.dumps(detail_dev)} | torch {torch.__version__}")
    if args.builder == "sah":
        bvhtool.ensure_built()  # raises if the native SAH library does not build

    if args.quick:
        scene = normalized(procgen.make_icosphere(4))
        width, height, leaf_k = args.width or 512, args.height or 512, 1
    else:
        scene = load_dragon()
        width, height, leaf_k = args.width or 1920, args.height or 1080, args.leaf
    log(f"[bench] scene: {scene.num_triangles} tris, {width}x{height}, {args.builder} K={leaf_k}")

    # build: the first run, then a steady rebuild
    pt = build_tracer(scene.triangles, args.builder, leaf_k, dev)
    first = pt.build_stats
    build_s, host_build_s = first["total_ms"] / 1e3, first["lbvh2_ms"] / 1e3
    pt.build_bvh(scene.triangles)
    build_steady_s = pt.build_stats["total_ms"] / 1e3
    qn = pt._qnodes
    log(f"[bench] BVH build + records: first run {build_s:.2f}s (host/native phase "
        f"{host_build_s:.2f}s), steady {build_steady_s:.3f}s; records {tuple(qn.shape)}")

    t0 = time.perf_counter()
    tri0 = trace_tiles(qn, SPARSE, QUAT, width, height, FOV, leaf_k=leaf_k)[4].cpu()
    first_frame_s = time.perf_counter() - t0
    hit_rate = float((tri0 >= 0).float().mean())
    log(f"[bench] hit rate {hit_rate:.4f}; first frame {first_frame_s:.2f}s (kernel build)")

    sparse_run = make_stream(qn, SPARSE, width, height, leaf_k, args.frames, args.bounded)
    sparse = time_stream(sparse_run, args.frames, dev)
    hits, repairs = sparse["out"]
    if len(set(hits.tolist())) < 2 and args.frames >= 3 and hit_rate > 0:
        raise RuntimeError("every frame hit the same number of pixels: the cameras did not move")
    rays = width * height
    mrays = rays / sparse["ms"] / 1e3
    log(f"[bench] sparse: reps {[round(r, 4) for r in sparse['host_reps']]} ms/frame (median "
        f"{sparse['ms']:.4f}); device {sparse['device_ms']} ms/frame; {mrays:.2f} Mrays/s")

    detail = {**detail_dev, "resolution": [width, height],
              "num_triangles": int(scene.num_triangles), "frames": args.frames,
              "hit_rate": hit_rate, "leaf_size": leaf_k, "builder": args.builder,
              "bounded": args.bounded,
              "build_seconds_first_run": build_s, "build_seconds_host_phase": host_build_s,
              "build_seconds_steady": build_steady_s, "first_frame_seconds": first_frame_s}
    result = {"metric": "primary_rays_per_second_quick", "value": round(mrays, 2),
              "unit": "Mrays/s", "vs_baseline": round(mrays / BASELINE_MRAYS, 3)}
    if args.bounded:
        detail["repairs_per_frame"] = repairs.tolist()
    if args.quick:
        detail.update({"ms_per_frame": sparse["ms"], "device_ms_per_frame": sparse["device_ms"],
                       "fps": 1e3 / sparse["ms"]})
    else:
        # the framed view is the headline: the model fills most of the frame,
        # as it did where the reference earned its 75 Mrays/s
        framed_tri = trace_tiles(qn, FRAMED, QUAT, width, height, FOV, leaf_k=leaf_k)[4]
        framed_hit_rate = float((framed_tri >= 0).float().mean())
        if framed_hit_rate < MIN_FRAMED_HIT_RATE:
            raise RuntimeError(f"the framed camera no longer fills the frame (hit rate "
                               f"{framed_hit_rate:.3f} < {MIN_FRAMED_HIT_RATE})")
        framed_run = make_stream(qn, FRAMED, width, height, leaf_k, args.frames, args.bounded)
        framed = time_stream(framed_run, args.frames, dev)
        framed_mrays = rays / framed["ms"] / 1e3
        log(f"[bench] framed (hit rate {framed_hit_rate:.4f}): reps "
            f"{[round(r, 4) for r in framed['host_reps']]} ms/frame (median {framed['ms']:.4f}); "
            f"device {framed['device_ms']} ms/frame; {framed_mrays:.2f} Mrays/s <- headline")
        result.update({"metric": "primary_rays_per_second_dragon_class_1080p",
                       "value": round(framed_mrays, 2),
                       "vs_baseline": round(framed_mrays / BASELINE_MRAYS, 3)})
        detail.update({
            "fps": 1e3 / framed["ms"], "framed_hit_rate": framed_hit_rate,
            "framed_ms_per_frame": framed["ms"], "framed_device_ms_per_frame": framed["device_ms"],
            "framed_fps": 1e3 / framed["ms"], "framed_host_reps": framed["host_reps"],
            "sparse_mrays_per_s": mrays, "sparse_ms_per_frame": sparse["ms"],
            "sparse_device_ms_per_frame": sparse["device_ms"],
            "build_split": {"host_sah_upload_s": host_build_s,
                            "records_s": first["records_ms"] / 1e3,
                            "steady_run_s": build_steady_s}})
        if args.bounded:
            detail["framed_repairs_per_frame"] = framed["out"][1].tolist()
    headline_run = sparse_run if args.quick else framed_run
    detail["launches_per_stream"] = launches_of(headline_run, dev)
    detail["profile"] = profile_stream(headline_run, args.frames, dev,
                                       sparse["ms"] if args.quick else framed["ms"])
    result["detail"] = detail
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
