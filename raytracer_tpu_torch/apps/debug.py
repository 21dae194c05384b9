"""Debug visualizer — the counterpart of ``apps/debug.py`` (the working
replacement for the reference's broken debug surface, repo-root main.js +
debug.html), on the card.

Renders the scene, overlays the projected wireframes of BVH node AABBs
(hue-cycled by node index like the THREE.js overlay, main.js:74-106), writes
a PNG, and dumps the full BVH as JSON for external tools.

Usage:
  python -m raytracer_tpu_torch.apps.debug [--glb PATH] [--depth 4]
      [--out data/debug.png] [--json data/BVH_full.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import colorsys
import math
from pathlib import Path

import numpy as np

from .. import PathTracer, Scene
from ..io import artifacts
from ..utils import procgen
from ..utils.fp16 import unpack_bounds_u32
from ..utils.image import write_png

_EDGES = [
    (0, 1), (1, 3), (3, 2), (2, 0),
    (4, 5), (5, 7), (7, 6), (6, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def _project(points, cam_pos, width, height, fov_degrees=70.0):
    """World → pixel coords for the identity-orientation camera."""
    focal = 1.0 / math.tan(0.5 * math.radians(fov_degrees))
    aspect = width / height
    rel = points - np.asarray(cam_pos, np.float32)
    z = -rel[:, 2]
    ok = z > 1e-6
    zs = np.where(ok, z, 1.0)
    ndc_x = rel[:, 0] * focal / zs / aspect
    ndc_y = rel[:, 1] * focal / zs
    px = (ndc_x + 1.0) * 0.5 * width - 0.5
    py = (ndc_y + 1.0) * 0.5 * height - 0.5
    return np.stack([px, py], axis=1), ok


def _draw_line(img, p0, p1, color):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    ts = np.linspace(0.0, 1.0, n + 1)
    xs = np.round(p0[0] + (p1[0] - p0[0]) * ts).astype(int)
    ys = np.round(p0[1] + (p1[1] - p0[1]) * ts).astype(int)
    h, w = img.shape[:2]
    m = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[m], xs[m], :3] = color


def bvh_depths(children, num_nodes):
    depth = np.full(num_nodes, -1, np.int32)
    depth[0] = 0
    frontier = [0]
    while frontier:
        nxt = []
        for n in frontier:
            for c in children[n]:
                if c != 0xFFFFFFFF and c < num_nodes and depth[c] < 0:
                    depth[c] = depth[n] + 1
                    nxt.append(c)
        frontier = nxt
    return depth


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--glb", default=None)
    ap.add_argument("--depth", type=int, default=4, help="max BVH depth drawn")
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--out", default="data/debug.png")
    ap.add_argument("--json", default="data/BVH_full.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain torch versions)")
    args = ap.parse_args(argv)

    if args.glb:
        scene = Scene().load_glb(args.glb, normalize=True, mode="cube")
    else:
        scene = Scene().set_triangles(procgen.make_icosphere(3))

    tracer = PathTracer(width=args.width, height=args.height, device=args.device)
    tracer.set_scene(scene)
    img = tracer.render().cpu().numpy()

    buf4 = tracer.bvh4_artifact()
    b4, c4, m4 = artifacts.bvh4_from_u32(buf4)
    mn, mx = unpack_bounds_u32(b4)
    depth = bvh_depths(c4, len(m4))

    cam = tracer.camera_position
    for n in range(len(m4)):
        if depth[n] < 0 or depth[n] > args.depth:
            continue
        corners = np.array(
            [[mn[n][0] if not (i & 1) else mx[n][0],
              mn[n][1] if not (i & 2) else mx[n][1],
              mn[n][2] if not (i & 4) else mx[n][2]] for i in range(8)],
            np.float32,
        )
        pts, ok = _project(corners, cam, args.width, args.height)
        hue = (n * 0.61803) % 1.0  # hue cycle like the THREE overlay
        color = tuple(int(c * 255) for c in colorsys.hsv_to_rgb(hue, 1.0, 1.0))
        for a, b in _EDGES:
            if ok[a] and ok[b]:
                _draw_line(img, pts[a], pts[b], color)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    write_png(out, img)
    Path(args.json).parent.mkdir(parents=True, exist_ok=True)
    tracer.dump_bvh_json(args.json)
    print(f"[debug] wrote {out} and {args.json} "
          f"({len(m4)} BVH4 nodes, drawn to depth {args.depth})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
