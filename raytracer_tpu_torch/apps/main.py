"""Headless app entry — the counterpart of ``apps/main.py`` (the analog of
the reference browser app, src/main.js), on the card.

Flow: construct tracer + FPS camera, load a GLB normalized to the unit
cube, one-time BVH2 artifact dump over HTTP to the sidecar API
(``raytracer_tpu_torch.server.api``; graceful on failure, as src/main.js:27-46
is), then the frame loop: camera update → camera setters → render, with a
1 Hz FPS readout and the run's total at the end. Headless differences: a
fixed number of frames, a scripted camera path instead of pointer lock, and
the last frame written as PNG.

Usage:
  python -m raytracer_tpu_torch.apps.main [--glb PATH | --scene icosphere|cornell|dragon|atrium]
      [--frames N] [--width W] [--height H] [--out out.png] [--api URL] [--orbit]
      [--builder auto|lbvh|ploc|sah] [--leaf K] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time
import urllib.request
from pathlib import Path

from .. import FPSCamera, PathTracer, Scene
from ..utils import procgen
from ..utils.config import CameraConfig, RenderConfig
from ..utils.image import write_png
from ..utils.profiling import FrameStats, sync


def _load_scene(args) -> Scene:
    if args.glb:
        return Scene().load_glb(args.glb, normalize=True, mode="cube")
    tris = {
        "icosphere": lambda: procgen.make_icosphere(5),
        "cornell": procgen.make_cornell_box,
        "dragon": procgen.make_dragon_stand_in,
        "atrium": procgen.make_sponza_atrium,
    }[args.scene]()
    s = Scene().set_triangles(tris)
    s._normalize_enabled, s._normalize_mode = True, "cube"
    s.normalize_mesh()
    return s


# where the camera starts: (0, 0, 3.5), outside the scene, but for the
# atrium, which encloses it: in the courtyard near its +z end, a fifth of
# its height up, looking along -z
_START = {"atrium": (0.0, -0.227, 0.6486)}


def _dump_bvh2(tracer: PathTracer, api_url: str) -> None:
    """One-time artifact dump (src/main.js:27-46 analog).

    Only a tree of single-triangle leaves is dumped: packed-cluster trees
    carry cluster ids in the leaf metas, which the offline BVH2.bin
    consumers would misread as triangle indices."""
    if tracer.leaf_size > 1:
        print("[app] BVH2 dump skipped (packed-cluster tree; "
              "run with --builder lbvh for the reference artifact)")
        return
    req = urllib.request.Request(
        f"{api_url}/api/write",
        data=tracer.bvh2_artifact().tobytes(),
        headers={"Content-Type": "application/octet-stream"},
    )
    try:
        with urllib.request.urlopen(req, timeout=2) as resp:
            print(f"[app] BVH2 dump: {resp.read().decode()}")
    except OSError as e:  # the reference logs and continues (main.js:42-44)
        print(f"[app] BVH2 dump skipped ({e})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--glb", default=None)
    ap.add_argument("--scene", default="icosphere",
                    choices=["icosphere", "cornell", "dragon", "atrium"])
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--out", default="data/frame.png")
    ap.add_argument("--api", default="http://127.0.0.1:3000")
    ap.add_argument("--orbit", action="store_true", help="orbit camera path")
    ap.add_argument("--builder", default="auto",
                    choices=["auto", "lbvh", "ploc", "sah"],
                    help="auto = fastest on the device (fast_build_options); "
                         "lbvh = reference-parity tree (enables the BVH2.bin "
                         "artifact dump)")
    ap.add_argument("--leaf", type=int, default=None,
                    help="triangles per BVH leaf (default: auto per device)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain torch versions)")
    args = ap.parse_args(argv)

    scene = _load_scene(args)
    print(f"[app] scene: {scene.num_triangles} triangles")

    config = RenderConfig(
        width=args.width, height=args.height,
        camera=CameraConfig(position=_START.get(args.scene, (0.0, 0.0, 3.5))),
    )
    builder = leaf = None
    if args.builder != "auto":
        builder, leaf = args.builder, 1
    if args.leaf is not None:
        leaf = args.leaf
    tracer = PathTracer.from_config(config, builder=builder, leaf_size=leaf,
                                    device=args.device)
    cam_cfg = config.camera
    camera = FPSCamera(position=cam_cfg.position,
                       move_speed=cam_cfg.move_speed,
                       sprint_mult=cam_cfg.sprint_mult,
                       look_sensitivity=cam_cfg.look_sensitivity,
                       fly=cam_cfg.fly)
    tracer.set_scene(scene)
    print(f"[app] {tracer.builder} K={tracer.leaf_size} on {tracer.device}: "
          f"build {tracer.build_stats['total_ms']:.2f} ms")
    _dump_bvh2(tracer, args.api)

    stats = FrameStats(config.width, config.height)  # 1 Hz FPS badge analog
    img = None
    t_prev = time.perf_counter()
    for frame in range(args.frames):
        now = time.perf_counter()
        dt = now - t_prev
        t_prev = now

        if args.orbit:
            camera.move_mouse(120.0 * dt / 0.002 * 0.02, 0.0)
        camera.update(dt)

        p, q = camera.position, camera.rotation
        tracer.set_camera_position(float(p[0]), float(p[1]), float(p[2]))
        tracer.set_camera_quaternion(float(q[0]), float(q[1]), float(q[2]), float(q[3]))
        tracer.set_frame_count(frame)

        img = tracer.render()
        sync(img)  # wait for the frame: honest pacing
        stats.tick()
    run = stats.summary()
    print(f"[app] {run['frames']} frames in {run['seconds']:.3f} s: {run['fps']:.2f} FPS, "
          f"{run['mrays_per_s']:.2f} Mrays/s")

    if img is not None:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        write_png(out, img.cpu().numpy())
        print(f"[app] wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
