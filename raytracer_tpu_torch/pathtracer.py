"""PathTracer — the orchestrator of the primary-ray frame, with the public
surface of ``raytracer_tpu/pathtracer.py::PathTracer``.

The main path: ``set_scene`` → native SAH build with K-triangle clusters →
BVH2→BVH4 collapse → wide nodes → supernode records on ``device`` →
``render``: the traversal kernel K1a on a CUDA device (its plain torch
version on the CPU) → Lambert shade → rgba8 → ``render_presented``'s
tonemap. Scenes of at most 8 triangles trace brute force, as in the JAX
package.

Ported so far: the SAH builder with clusters of K > 1 triangles. The other
builders (LBVH, PLOC, single-triangle leaves), progressive path tracing and
refit come with later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .io import artifacts
from .models.scene import Scene
from .ops.camera import generate_rays
from .ops.cluster import build_sah2_clustered, records_pipeline, state_from_numpy
from .ops.cuda.traverse import trace_tiles
from .ops.shade import present_frame, quantize_rgba8, shade_lambert, triangle_normals
from .ops.trace import trace_rays_brute

__all__ = ["PathTracer"]

_BRUTE_FORCE_MAX_TRIS = 8
_LATER = ("only the SAH builder with K>1 triangle clusters is ported; "
          "LBVH/PLOC builds and single-triangle leaves come with the torch "
          "build chain (slice 2)")


def _default_tetrahedron() -> np.ndarray:
    """The default 4-triangle mesh of the JAX package."""
    return np.array(
        [
            [[1, 1, 1], [-1, -1, 1], [-1, 1, -1]],
            [[1, 1, 1], [-1, 1, -1], [1, -1, -1]],
            [[1, 1, 1], [1, -1, -1], [-1, -1, 1]],
            [[-1, -1, 1], [1, -1, -1], [-1, 1, -1]],
        ],
        dtype=np.float32,
    )


class PathTracer:
    """Scene + camera + BVH state and the per-frame render entry point.

    ``device`` is where the records live and the frame is traced: a CUDA
    device runs the kernel, ``"cpu"`` the plain torch version. A CUDA device
    without a card raises here; nothing falls back."""

    def __init__(self, width: int = 1920, height: int = 1080, builder: str = "sah",
                 leaf_size: int = 32, *, device) -> None:
        if builder not in ("lbvh", "ploc", "sah"):
            raise ValueError(f"unknown builder {builder!r}")
        if leaf_size < 1:
            raise ValueError("leaf_size must be >= 1")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but no CUDA device "
                               "is available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.builder = builder
        self.leaf_size = int(leaf_size)
        self.width = int(width)
        self.height = int(height)
        self.camera_position = [0.0, 0.0, 3.5]
        self.camera_quaternion = [0.0, 0.0, 0.0, 1.0]
        self.fov_degrees = 70.0

        self.triangles_data: np.ndarray = _default_tetrahedron()
        self._tris_dev: torch.Tensor | None = None
        self._cluster = None
        self._qnodes: torch.Tensor | None = None
        self.build_stats: dict = {}

    # -- lifecycle -------------------------------------------------------------

    def initialize(self) -> "PathTracer":
        """Build acceleration data for the current (default) mesh."""
        self.build_bvh(self.triangles_data)
        return self

    def set_scene(self, scene: Scene) -> None:
        """Install a Scene and rebuild."""
        self.build_bvh(scene.get_triangles())

    # -- BVH build --------------------------------------------------------------

    def build_bvh(self, triangles) -> None:
        """Native SAH cluster build + records, with per-phase timings in
        ``build_stats`` (host clock; the records phase ends in a device
        synchronise)."""
        tris = np.asarray(triangles, dtype=np.float32)
        if tris.ndim == 1:
            tris = tris.reshape(-1, 3, 3)
        self.triangles_data = tris
        self._tris_dev = torch.from_numpy(tris).to(self.device)
        self._cluster = self._qnodes = None
        n = len(tris)
        if n <= _BRUTE_FORCE_MAX_TRIS:
            # traced brute force (_render_planes): no tree needed
            self.build_stats = {"num_triangles": n, "total_ms": 0.0}
            return
        if self.builder != "sah" or self.leaf_size < 2:
            raise NotImplementedError(_LATER)

        t0 = time.perf_counter()
        self._cluster, height = build_sah2_clustered(tris, self.leaf_size, self.device)
        t1 = time.perf_counter()
        self._records()
        t2 = time.perf_counter()
        self.build_stats = {
            "num_triangles": n,
            "num_nodes2": self._cluster.bvh2.num_nodes,
            "bvh2_height": height,
            "lbvh2_ms": (t1 - t0) * 1e3,
            "records_ms": (t2 - t1) * 1e3,
            "total_ms": (t2 - t0) * 1e3,
        }

    def _records(self) -> None:
        self._qnodes = records_pipeline(self._cluster)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- rendering ---------------------------------------------------------------

    def _render_planes(self):
        """(linear rgb (H,W,3), t (H,W), tri (H,W)) of the current frame."""
        w, h = self.width, self.height
        if len(self.triangles_data) <= _BRUTE_FORCE_MAX_TRIS:
            o, d = generate_rays(w, h, self.camera_position, self.camera_quaternion,
                                 self.fov_degrees, device=self.device)
            t, tri = trace_rays_brute(self._tris_dev, o.reshape(-1, 3), d.reshape(-1, 3))
            t, tri = t.reshape(h, w), tri.reshape(h, w)
            rgb = shade_lambert(triangle_normals(self._tris_dev, tri), tri >= 0)
            return rgb, t, tri
        if self._qnodes is None:
            raise RuntimeError("no acceleration structure: call set_scene, "
                               "build_bvh or load_checkpoint first")
        t, nx, ny, nz, tri = trace_tiles(
            self._qnodes, self.camera_position, self.camera_quaternion, w, h,
            self.fov_degrees, leaf_k=self.leaf_size)
        rgb = shade_lambert(torch.stack([nx, ny, nz], dim=-1), tri >= 0)
        return rgb, t, tri

    def render(self) -> torch.Tensor:
        """One frame → rgba8 framebuffer (H,W,4) uint8 on ``device``."""
        rgb, _, _ = self._render_planes()
        return quantize_rgba8(rgb)

    def render_presented(self) -> torch.Tensor:
        """render() + the tonemap present pass."""
        return present_frame(self.render())

    # -- camera state ----------------------------------------------------------

    def set_camera_position(self, x: float, y: float, z: float) -> None:
        self.camera_position = [x, y, z]

    def set_camera_quaternion(self, x: float, y: float, z: float, w: float) -> None:
        self.camera_quaternion = [x, y, z, w]

    # -- checkpoints -------------------------------------------------------------

    def load_checkpoint(self, path) -> None:
        """Restore a checkpoint written by ``raytracer_tpu``'s
        ``PathTracer.save_checkpoint``: triangles + the clustered BVH2 are
        loaded verbatim (no rebuild); the records are derived on ``device``."""
        data = artifacts.load_scene_npz(path)
        tris = data["triangles"].reshape(-1, 3, 3)
        if "bvh2_bounds" not in data:
            self.build_bvh(tris)
            return
        if "tri_order" not in data:
            raise NotImplementedError(_LATER)
        self.triangles_data = tris
        self._tris_dev = torch.from_numpy(np.ascontiguousarray(tris)).to(self.device)
        self._cluster = state_from_numpy(data, self.device)
        self.leaf_size = self._cluster.leaf_size
        self._records()
