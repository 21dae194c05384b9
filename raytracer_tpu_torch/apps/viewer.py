"""Live interactive viewer app — fly the scene from a browser against the
renderer on the card: the counterpart of ``apps/viewer.py``.

    python -m raytracer_tpu_torch.apps.viewer [--scene PATH.glb | --procgen dragon|sphere|cornell]
        [--width W] [--height H] [--port 3000] [--builder auto|lbvh|ploc|sah]
        [--leaf K] [--stream-scale S] [--device cuda|cpu]

Then open http://localhost:3000/, click the image for pointer lock, and use
WASD/QE (+Shift sprint, F fly-toggle) exactly like the reference.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..models.camera import FPSCamera
from ..models.scene import Scene
from ..pathtracer import PathTracer, fast_build_options
from ..server.viewer import run_viewer
from ..utils import procgen


def build_tracer(args) -> PathTracer:
    """The tracer of the parsed arguments, with its scene built."""
    builder, leaf = fast_build_options(args.device)
    if args.builder != "auto":
        builder, leaf = args.builder, 1
    if args.leaf is not None:
        leaf = args.leaf
    tracer = PathTracer(width=args.width, height=args.height, builder=builder,
                        leaf_size=leaf, device=args.device)
    if args.scene:
        scene = Scene().load_glb(args.scene, normalize=True, mode="cube")
    else:
        tris = {
            "sphere": lambda: procgen.make_icosphere(4),
            "dragon": procgen.make_dragon_stand_in,
            "cornell": lambda: procgen.make_cornell_box(4.0),
        }[args.procgen]()
        scene = Scene().set_triangles(np.asarray(tris, np.float32))
        scene._normalize_enabled, scene._normalize_mode = True, "cube"
        scene.normalize_mesh()
    tracer.set_scene(scene)
    return tracer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default=None, help="GLB/GLTF path")
    ap.add_argument("--procgen", default="sphere",
                    choices=["sphere", "dragon", "cornell"])
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--port", type=int, default=3000)
    ap.add_argument("--builder", default="auto",
                    choices=["auto", "lbvh", "ploc", "sah"],
                    help="auto = fastest on the device (fast_build_options: "
                         "SAH, K = 1 on the card)")
    ap.add_argument("--leaf", type=int, default=None,
                    help="triangles per BVH leaf (default: auto per device)")
    ap.add_argument("--stream-scale", type=int, default=2,
                    help="downscale factor for frames streamed while the "
                         "camera is moving (1 = always full resolution); "
                         "idle frames are always full-res")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain torch versions)")
    args = ap.parse_args(argv)

    tracer = build_tracer(args)
    camera = FPSCamera(position=[0.0, 0.0, 2.5])
    run_viewer(tracer, camera, port=args.port, stream_scale=args.stream_scale)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
