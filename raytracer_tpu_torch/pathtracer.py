"""PathTracer — the orchestrator of the primary-ray frame and of progressive
path tracing, with the public surface of
``raytracer_tpu/pathtracer.py::PathTracer``.

The main path: ``set_scene`` → native SAH build with K-triangle clusters →
the widener (BVH2 → wide tree) → wide nodes → supernode records on
``device``. ``refit_bvh`` moves the triangles of that tree and keeps its
topology: refit → the collapse plan's gather → wide nodes → records, all on
``device`` (the ``"collapse"`` widener; any other rebuilds). Then:

* ``render``: the traversal kernel K1a → Lambert shade → rgba8 →
  ``render_presented``'s tonemap; ``render_stream`` box-filters the same
  frame down on the device. With ``use_tile_entries`` set (off by default,
  as in the JAX package) the frame's tiles start at the entry nodes of
  ``ops.cuda.entry.compute_tile_entries`` through K1d;
* ``render_progressive(bounces)``: one path-traced sample
  (``render_pt.pt_sample_frame``: the jittered camera wave through K1b,
  bounce waves through K2a, shadow rays through K2b) added to a running
  mean that resets when the camera moves; ``bounces=0`` accumulates
  jittered primary frames (K1b) with the Lambert shade instead;
  ``present_progressive`` tonemaps the mean.

With ``widener="collapse8"`` the records are 8-wide and the same calls run
K1e (tiles) and K2c (ray buffers): the wrappers find the width from the
records.

On a CUDA device every traversal is a kernel; on the CPU each runs its plain
torch version. Scenes of at most 8 triangles trace brute force, as in the
JAX package.

Ported so far: the SAH builder with clusters of K > 1 triangles, its refit,
and the four wideners of the JAX package: ``"collapse"`` (greedy 4-wide
collapse, the default), ``"collapse8"`` (greedy 8-wide collapse, BVH8),
``"promote"`` (index-preserving 4-wide promotion) and ``"bvh2"`` (the binary
tree in the 4-wide struct). The other builders (LBVH, PLOC, single-triangle
leaves) come with a later slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .io import artifacts
from .models.scene import Scene
from .ops.camera import generate_rays_jittered
from .ops.cluster import (build_sah2_clustered, refit_lbvh2_clustered, state_from_numpy,
                          tree_height, wide_pipeline)
from .ops.collapse import (LBVH2, bvh2_as_bvh4, collapse_apply_refit, collapse_plan,
                           promote_lbvh2_to_bvh4_wide)
from .ops.cuda.entry import compute_tile_entries
from .ops.cuda.traverse import TILE, make_qnodes, trace_tiles
from .ops.shade import (downscale_rgb8, present_frame, quantize_rgba8, shade_lambert,
                        triangle_normals)
from .ops.trace import make_wide_bvh, trace_rays_brute
from .render import render_ldr_brute
from .render_pt import accumulate, pt_sample_frame

__all__ = ["PathTracer"]

_BRUTE_FORCE_MAX_TRIS = 8
_LATER = ("only the SAH builder with K>1 triangle clusters is ported; "
          "LBVH/PLOC builds and single-triangle leaves come with a later slice "
          "of the torch build chain (ROADMAP slice 7)")


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

    def __init__(self, width: int = 1920, height: int = 1080, widener: str = "collapse",
                 builder: str = "sah", leaf_size: int = 32, *, device) -> None:
        if widener not in ("collapse", "collapse8", "promote", "bvh2"):
            raise ValueError(f"unknown widener {widener!r}")
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
        self.widener = widener
        self.builder = builder
        self.leaf_size = int(leaf_size)
        self.width = int(width)
        self.height = int(height)
        self.camera_position = [0.0, 0.0, 3.5]
        self.camera_quaternion = [0.0, 0.0, 0.0, 1.0]
        self.fov_degrees = 70.0
        self.frame_count = 0
        # start each tile of render()'s frame at its entry node (K1d)
        self.use_tile_entries = False
        self._accum: torch.Tensor | None = None
        self._accum_sig = None

        self.triangles_data: np.ndarray = _default_tetrahedron()
        self._tris_dev: torch.Tensor | None = None
        self._cluster = None
        self._bvh2_height: int | None = None
        self._collapse_plan = None
        self._qnodes: torch.Tensor | None = None
        self._wide = None  # the records' WideBVH, made when tile entries are first asked for
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
        """Native SAH cluster build + the widener's records, with per-phase
        timings in ``build_stats`` (host clock; the records phase ends in a
        device synchronise)."""
        tris = np.asarray(triangles, dtype=np.float32)
        if tris.ndim == 1:
            tris = tris.reshape(-1, 3, 3)
        self.triangles_data = tris
        self._tris_dev = torch.from_numpy(tris).to(self.device)
        self._cluster = self._qnodes = self._bvh2_height = self._wide = None
        self._collapse_plan = None  # new topology → new plan (refit_bvh)
        n = len(tris)
        if n <= _BRUTE_FORCE_MAX_TRIS:
            # traced brute force (_render_planes): no tree needed
            self.build_stats = {"num_triangles": n, "total_ms": 0.0}
            return
        if self.builder != "sah" or self.leaf_size < 2:
            raise NotImplementedError(_LATER)

        t0 = time.perf_counter()
        self._cluster, self._bvh2_height = build_sah2_clustered(tris, self.leaf_size,
                                                                self.device)
        t1 = time.perf_counter()
        self._records()
        t2 = time.perf_counter()
        self.build_stats = {
            "num_triangles": n,
            "num_nodes2": self._cluster.bvh2.num_nodes,
            "bvh2_height": self._bvh2_height,
            "lbvh2_ms": (t1 - t0) * 1e3,
            "records_ms": (t2 - t1) * 1e3,
            "total_ms": (t2 - t0) * 1e3,
        }

    def refit_bvh(self, triangles) -> None:
        """Refit the tree to deformed triangles — same count, moved vertices —
        instead of rebuilding: topology, cluster assignment and the
        BVH2→BVH4 collapse decisions all survive, so a refit is the bounds
        sweep (``refit_lbvh2_clustered``), one gather through the collapse
        plan (``collapse_apply_refit``, equal to the full collapse) and the
        records, all on ``device``. The plan is made at the first refit of a
        tree, when the tree's topology is also copied to ``device``. Falls
        back to ``build_bvh`` for another triangle count, no cluster tree,
        the brute-force scene, or any widener but ``"collapse"`` (the plan
        is the 4-wide collapse's). Adds ``plan_ms`` (first refit only) and
        ``refit_ms`` (host clock, ending in a device synchronise) to
        ``build_stats``."""
        tris = np.asarray(triangles, dtype=np.float32)
        if tris.ndim == 1:
            tris = tris.reshape(-1, 3, 3)
        if (self._cluster is None or self.widener != "collapse"
                or len(tris) != len(self.triangles_data)):
            self.build_bvh(tris)
            return
        stats = {}
        sweeps = self._bvh2_height + 2
        if self._collapse_plan is None:
            t0 = time.perf_counter()
            bvh2 = LBVH2(*(a.to(self.device) for a in self._cluster.bvh2))
            self._cluster = self._cluster._replace(bvh2=bvh2)
            self._collapse_plan = collapse_plan(bvh2, sweeps=sweeps)
            stats["plan_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        tris_dev = torch.from_numpy(np.ascontiguousarray(tris)).to(self.device)
        cs = refit_lbvh2_clustered(self._cluster, tris_dev, num_sweeps=sweeps)
        bvh4 = collapse_apply_refit(self._collapse_plan, cs.bvh2.bounds_u32)
        self._qnodes = make_qnodes(make_wide_bvh(bvh4), cs.tris_sorted, tri_ids=cs.tri_order,
                                   leaf_size=cs.leaf_size)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        stats["refit_ms"] = (time.perf_counter() - t0) * 1e3
        self._cluster = cs
        self._wide = None
        self.triangles_data = tris
        self._tris_dev = tris_dev
        self.build_stats = {**self.build_stats, **stats}

    def _widen(self, bvh2: LBVH2):
        """The index-preserving wideners, on ``device``."""
        widen = {"promote": promote_lbvh2_to_bvh4_wide, "bvh2": bvh2_as_bvh4}[self.widener]
        return widen(LBVH2(*(a.to(self.device) for a in bvh2)))

    def _make_wide(self):
        """The cluster tree through the configured widener → its WideBVH."""
        if self.widener in ("collapse", "collapse8"):
            return wide_pipeline(self._cluster, height=self._bvh2_height,
                                 width=8 if self.widener == "collapse8" else 4)
        return make_wide_bvh(self._widen(self._cluster.bvh2))

    def _records(self) -> None:
        """The records of the cluster tree through the configured widener
        (shared by ``build_bvh`` and ``load_checkpoint``)."""
        cs = self._cluster
        self._wide = None
        self._qnodes = make_qnodes(self._make_wide(), cs.tris_sorted, tri_ids=cs.tri_order,
                                   leaf_size=cs.leaf_size)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wide_bvh(self):
        """The wide tree of the current records, for the tile entries. The
        default path keeps only the records, so the tree is made again (and
        kept until the next build or refit) when entries are first asked
        for."""
        if self._wide is None:
            self._wide = self._make_wide()
        return self._wide

    # -- rendering ---------------------------------------------------------------

    def _brute(self) -> bool:
        return len(self.triangles_data) <= _BRUTE_FORCE_MAX_TRIS

    def _require_records(self) -> None:
        if not self._brute() and self._qnodes is None:
            raise RuntimeError("no acceleration structure: call set_scene, "
                               "build_bvh or load_checkpoint first")

    def _render_planes(self):
        """(linear rgb (H,W,3), t (H,W), tri (H,W)) of the current frame."""
        w, h = self.width, self.height
        self._require_records()
        if self._brute():
            return render_ldr_brute(self._tris_dev, self.camera_position,
                                    self.camera_quaternion, w, h, self.fov_degrees)
        entries = None
        if self.use_tile_entries:
            entries = compute_tile_entries(self._wide_bvh(), self.camera_position,
                                           self.camera_quaternion, w, h, tile=TILE,
                                           fov_degrees=self.fov_degrees)
        t, nx, ny, nz, tri = trace_tiles(
            self._qnodes, self.camera_position, self.camera_quaternion, w, h,
            self.fov_degrees, leaf_k=self.leaf_size, entries=entries)
        rgb = shade_lambert(torch.stack([nx, ny, nz], dim=-1), tri >= 0)
        return rgb, t, tri

    def render(self) -> torch.Tensor:
        """One frame → rgba8 framebuffer (H,W,4) uint8 on ``device``."""
        rgb, _, _ = self._render_planes()
        return quantize_rgba8(rgb)

    def render_presented(self) -> torch.Tensor:
        """render() + the tonemap present pass."""
        return present_frame(self.render())

    def render_stream(self, scale: int = 2) -> torch.Tensor:
        """One frame → (H // scale, W // scale, 3) uint8, box-filtered on
        ``device``: a viewer that pulls frames over a slow link transfers
        scale²·4/3 times fewer bytes than the rgba8 frame."""
        rgb, _, _ = self._render_planes()
        return downscale_rgb8(rgb, int(scale))

    # -- progressive path tracing --------------------------------------------------

    def render_progressive(self, bounces: int = 3) -> torch.Tensor:
        """One progressive sample added to the running-mean buffer, which
        resets (with ``frame_count``) whenever the camera has moved since
        the last call. Returns the mean linear radiance (H, W, 3) f32.

        ``bounces=0``: a jittered primary frame with the Lambert shade (the
        anti-aliasing mode). Otherwise a path-traced sample of that many
        bounces. Its random numbers come from a ``torch.Generator`` on
        ``device`` seeded with ``frame_count``: they differ from the JAX
        package's ``jax.random`` stream, so the two converge to the same
        image by different samples. Unlike the JAX package, no wave is
        compacted."""
        if bounces < 0:
            raise ValueError("bounces must be >= 0")
        self._require_records()
        cam_sig = (tuple(self.camera_position), tuple(self.camera_quaternion))
        if self._accum_sig != cam_sig or self._accum is None:
            self._accum_sig = cam_sig
            self._accum = torch.zeros((self.height, self.width, 3), dtype=torch.float32,
                                      device=self.device)
            self.frame_count = 0

        if bounces == 0:
            sample = self._primary_sample_jittered()
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.frame_count)
            brute = self._brute()
            sample = pt_sample_frame(
                None if brute else self._qnodes, self._tris_dev, self.camera_position,
                self.camera_quaternion, self.width, self.height, bounces=bounces,
                fov_degrees=self.fov_degrees, leaf_k=self.leaf_size, brute=brute,
                tile_primary=not brute, generator=gen)
        self._accum = accumulate(self._accum, sample, self.frame_count)
        self.frame_count += 1
        return self._accum

    def _primary_sample_jittered(self) -> torch.Tensor:
        """One primary frame at the ``subpixel_hash01`` offsets of seed
        ``frame_count + 1``, Lambert-shaded → linear radiance (H, W, 3)."""
        w, h, seed = self.width, self.height, self.frame_count + 1
        if self._brute():
            o, d = generate_rays_jittered(w, h, self.camera_position, self.camera_quaternion,
                                          seed, self.fov_degrees, device=self.device)
            _, tri = trace_rays_brute(self._tris_dev, o.reshape(-1, 3), d.reshape(-1, 3))
            tri = tri.reshape(h, w)
            return shade_lambert(triangle_normals(self._tris_dev, tri), tri >= 0)
        _, nx, ny, nz, tri = trace_tiles(
            self._qnodes, self.camera_position, self.camera_quaternion, w, h,
            self.fov_degrees, leaf_k=self.leaf_size, jitter=True, jitter_seed=seed)
        return shade_lambert(torch.stack([nx, ny, nz], dim=-1), tri >= 0)

    def present_progressive(self) -> torch.Tensor:
        """Tonemap the accumulation buffer → display rgba8 (H, W, 4): HDR
        Reinhard x/(x+1) and gamma 1/2.2."""
        if self._accum is None:
            raise RuntimeError("nothing accumulated: call render_progressive first")
        c = self._accum
        return quantize_rgba8(torch.pow(c / (c + 1.0), 1.0 / 2.2))

    def set_frame_count(self, frame_count: int) -> None:
        self.frame_count = frame_count

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
        # the checkpoint does not store the height, which sets the refit's sweeps
        self._bvh2_height = tree_height(self._cluster.bvh2)
        self._collapse_plan = None
        self._records()
