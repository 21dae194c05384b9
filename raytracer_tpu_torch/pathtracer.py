"""PathTracer — the orchestrator of the primary-ray frame and of progressive
path tracing, with the public surface of
``raytracer_tpu/pathtracer.py::PathTracer``.

``set_scene`` builds the BVH2 with the configured builder: the JAX
package's default, the Morton / Karras LBVH over single triangles
(``builder="lbvh", leaf_size=1``), the same over Morton runs of K triangles
(``leaf_size=K``), PLOC over single triangles (``builder="ploc"``), or the
native SAH build of single triangles (``builder="sah", leaf_size=1``) or of
K-triangle clusters (``builder="sah", leaf_size=K``, the main path's K =
32); then the widener (BVH2 → wide tree) → wide nodes → supernode records,
all on ``device`` but the native SAH builds. ``refit_bvh`` moves the
triangles of a cluster tree and keeps its topology: refit → the collapse
plan's gather → wide nodes → records, all on ``device`` (the ``"collapse"``
widener; any other, and a tree of single triangles, rebuilds). Then:

* ``render``: the traversal kernel K1a → Lambert shade → rgba8 →
  ``render_presented``'s tonemap; ``render_stream`` box-filters the same
  frame down on the device. With ``use_tile_entries`` set (off by default,
  as in the JAX package) the frame's tiles start at the entry nodes of
  ``ops.cuda.entry.compute_tile_entries`` through K1d;
* ``render_progressive(bounces)``: one path-traced sample
  (``render_pt.pt_sample_frame``: the jittered camera wave through K1b,
  bounce waves through K2a, shadow rays through K2b) added to a running
  mean that resets when the camera moves; on the card the sample and its
  update of the mean are one CUDA graph, replayed from the second sample
  of a frame size, bounce count and scene on (``render_pt.SampleGraphs``);
  ``bounces=0`` accumulates jittered primary frames (K1b) with the Lambert
  shade instead; ``present_progressive`` tonemaps the mean.

With ``widener="collapse8"`` the records are 8-wide and the same calls run
K1e (tiles) and K2c (ray buffers): the wrappers find the width from the
records.

The four wideners are the JAX package's: ``"collapse"`` (greedy 4-wide
collapse, the default), ``"collapse8"`` (greedy 8-wide collapse, BVH8),
``"promote"`` (index-preserving 4-wide promotion) and ``"bvh2"`` (the binary
tree in the 4-wide struct).

The artifacts are the JAX package's files, byte for byte: ``bvh2_artifact``
(``BVH2.bin``), ``bvh4_artifact`` (the wide tree the records were made
from), ``dump_bvh_json`` and ``save_checkpoint`` / ``load_checkpoint``, which
read and write the same npz as the JAX package's. ``from_config`` and
``fast_build_options`` are the apps' entry (``apps/main.py``).

The tracer runs on ``device``, the card (``"cuda"``) unless the caller asks
for the CPU. On a CUDA device every traversal is a kernel; on the CPU each
runs its plain torch version. Scenes of at most 8 triangles trace brute
force, as in the JAX package (they build no tree, so their artifacts are
empty and their checkpoint holds the triangles alone).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .io import artifacts
from .models.scene import Scene
from .ops.camera import generate_rays_jittered
from .ops.cluster import (build_lbvh2_clustered, build_sah2_clustered, bvh2_from_numpy,
                          refit_lbvh2_clustered, state_from_numpy, tree_height)
from .ops.collapse import BVH4, LBVH2, WIDENERS, collapse_apply_refit, collapse_plan, widen
from .ops.cuda.entry import compute_tile_entries
from .ops.cuda.traverse import TILE, make_qnodes, trace_tiles
from .ops.lbvh import build_lbvh2, build_sah2
from .ops.ploc import build_ploc2
from .ops.shade import (downscale_rgb8, present_frame, quantize_rgba8, shade_lambert,
                        triangle_normals)
from .ops.trace import make_wide_bvh, trace_rays_brute
from .render import render_ldr_brute
from .render_pt import SampleGraphs, accumulate, pt_sample_frame, sample_graph_eligible
from .utils.config import DEFAULT_CONFIG, RenderConfig
from .utils.profiling import counting, span

__all__ = ["PathTracer", "fast_build_options", "COMPACT_WAVES"]

_BRUTE_FORCE_MAX_TRIS = 8

# Whether render_progressive compacts the lanes between waves at bounces >= 2
# (pt_sample_frame(compact=True)), as the JAX package's does on its records
# path. Off: the waves gain less than the two compactions cost (0.79 ms
# each). A 3-bounce 1080p sample of the framed dragon on an NVIDIA H100 at
# 700 W (chip_smoke.py phase 33, two calls), compacted against not: SAH
# K = 32 17.0439 / 17.2946 against 16.5896 / 16.4999 ms, Morton K = 1
# 12.1525 / 11.3402 against 10.2471 / 9.6775 ms.
COMPACT_WAVES = False


def fast_build_options(device="cuda") -> tuple[str, int]:
    """(builder, leaf_size) of the fastest configuration on ``device``: on
    the CPU the single-triangle LBVH (the JAX package's rule there); on a
    CUDA card the tree whose framed 1080p dragon ``render()`` the card
    renders fastest. Measured by ``chip_smoke.py`` phase 29 on an NVIDIA
    H100 80GB HBM3 at 700 W, ms a frame (A-B-C-D-D-C-B-A in one process):
    SAH K = 1 0.7803, PLOC K = 1 0.8348, Morton LBVH K = 1 0.8659, SAH
    K = 32 1.4048 (K1a alone 0.4848 / 0.5451 / 0.5736 / 1.1131)."""
    if torch.device(device).type == "cpu":
        return "lbvh", 1
    return "sah", 1


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

    ``device`` is where the records live and the frame is traced: the card
    by default, where the kernels run; ``"cpu"`` runs their plain torch
    versions. A CUDA device without a card raises here; nothing falls
    back."""

    @classmethod
    def from_config(cls, config: RenderConfig | None = None, *, builder: str | None = None,
                    leaf_size: int | None = None, device="cuda") -> "PathTracer":
        """A tracer of ``config``'s size, widener and field of view (the
        reference's defaults without one). ``builder`` / ``leaf_size``
        default to :func:`fast_build_options` for ``device``."""
        cfg = config or DEFAULT_CONFIG
        auto_builder, auto_leaf = fast_build_options(device)
        pt = cls(cfg.width, cfg.height, cfg.widener,
                 builder if builder is not None else auto_builder,
                 leaf_size if leaf_size is not None else auto_leaf, device=device)
        pt.fov_degrees = cfg.fov_degrees
        pt.config = cfg
        return pt

    def __init__(self, width: int = 1920, height: int = 1080, widener: str = "collapse",
                 builder: str = "lbvh", leaf_size: int = 1, *, device="cuda") -> None:
        if widener not in WIDENERS:
            raise ValueError(f"unknown widener {widener!r}")
        if builder not in ("lbvh", "ploc", "sah"):
            raise ValueError(f"unknown builder {builder!r}")
        if leaf_size < 1:
            raise ValueError("leaf_size must be >= 1")
        if leaf_size > 1 and builder not in ("lbvh", "sah"):
            raise ValueError("leaf_size > 1 requires the lbvh builder (Morton-run clusters) "
                             "or the sah builder (SAH-snapped clusters)")
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
        self._sample_graphs = SampleGraphs()

        self.triangles_data: np.ndarray = _default_tetrahedron()
        self._tris_dev: torch.Tensor | None = None
        self._bvh2: LBVH2 | None = None
        self._cluster = None  # the ClusteredScene of a K > 1 tree
        self._bvh2_height: int | None = None
        self._bvh4: BVH4 | None = None  # the wide tree of the current records
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
        """The configured builder's BVH2, then the widener's records, with
        the JAX package's per-phase timings in ``build_stats`` (host clock,
        each phase ending in a device synchronise): ``lbvh2_ms`` the BVH2
        build, ``collapse_ms`` the widener (BVH2 → wide tree), ``widen_ms``
        the wide nodes and the records, ``total_ms`` their sum;
        ``records_ms`` is ``collapse_ms + widen_ms``, ``num_nodes4`` the wide
        tree's rows."""
        tris = np.asarray(triangles, dtype=np.float32)
        if tris.ndim == 1:
            tris = tris.reshape(-1, 3, 3)
        self.triangles_data = tris
        self._tris_dev = torch.from_numpy(tris).to(self.device)
        self._bvh2 = self._cluster = self._qnodes = self._bvh2_height = self._wide = None
        self._bvh4 = self._collapse_plan = None  # new topology → new plan (refit_bvh)
        n = len(tris)
        if n <= _BRUTE_FORCE_MAX_TRIS:
            # traced brute force (_render_planes): no tree needed
            self.build_stats = {"num_triangles": n, "total_ms": 0.0}
            return

        t0 = time.perf_counter()
        if self.builder == "sah" and self.leaf_size > 1:
            self._cluster, self._bvh2_height = build_sah2_clustered(tris, self.leaf_size,
                                                                    self.device)
        elif self.leaf_size > 1:
            self._cluster = build_lbvh2_clustered(self._tris_dev, self.leaf_size)
        elif self.builder == "ploc":
            self._bvh2 = build_ploc2(self._tris_dev)
        elif self.builder == "sah":
            self._bvh2, self._bvh2_height = build_sah2(tris, self.device)
        else:
            self._bvh2 = build_lbvh2(self._tris_dev)
        if self._cluster is not None:
            self._bvh2 = self._cluster.bvh2
        t1 = self._sync()
        self._bvh4 = self._widen()
        t2 = self._sync()
        self._qnodes = self._make_qnodes(make_wide_bvh(self._bvh4))
        t3 = self._sync()
        self.build_stats = {
            "num_triangles": n,
            "num_nodes2": self._bvh2.num_nodes,
            "num_nodes4": self._bvh4.num_nodes,
            "lbvh2_ms": (t1 - t0) * 1e3,
            "collapse_ms": (t2 - t1) * 1e3,
            "widen_ms": (t3 - t2) * 1e3,
            "records_ms": (t3 - t1) * 1e3,
            "total_ms": (t3 - t0) * 1e3,
        }

    def _sync(self) -> float:
        """Wait for the card (on a CUDA device); the host clock after it."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def refit_bvh(self, triangles) -> None:
        """Refit the tree to deformed triangles — same count, moved vertices —
        instead of rebuilding: topology, cluster assignment and the
        BVH2→BVH4 collapse decisions all survive, so a refit of a cluster
        tree (SAH or Morton) is the bounds
        sweep (``refit_lbvh2_clustered``), one gather through the collapse
        plan (``collapse_apply_refit``, equal to the full collapse) and the
        records, all on ``device``. The plan is made at the first refit of a
        tree, when the tree's topology is also copied to ``device``. Falls
        back to ``build_bvh`` for another triangle count, a tree of single
        triangles (as the JAX package does), the brute-force scene, or any
        widener but ``"collapse"`` (the plan
        is the 4-wide collapse's). Adds ``plan_ms`` (first refit only) to
        ``build_stats``. Nothing here waits for the card: the spans
        ``rt/refit_bvh`` and its stages ``rt/refit/upload``, ``sweeps``,
        ``gather`` and ``records`` time it when tracing is on."""
        with span("rt/refit_bvh"):
            tris = np.asarray(triangles, dtype=np.float32)
            if tris.ndim == 1:
                tris = tris.reshape(-1, 3, 3)
            if (self._cluster is None or self.widener != "collapse"
                    or len(tris) != len(self.triangles_data)):
                self.build_bvh(tris)
                return
            stats = {}
            if self._collapse_plan is None:
                t0 = time.perf_counter()
                if self._bvh2_height is None:
                    # the Morton build knows no height; the refit's sweeps need it
                    self._bvh2_height = tree_height(self._cluster.bvh2)
                bvh2 = LBVH2(*(a.to(self.device) for a in self._cluster.bvh2))
                self._cluster = self._cluster._replace(bvh2=bvh2)
                self._collapse_plan = collapse_plan(bvh2, sweeps=self._bvh2_height + 2)
                stats["plan_ms"] = (time.perf_counter() - t0) * 1e3
            with span("rt/refit/upload"):
                tris_dev = torch.from_numpy(np.ascontiguousarray(tris)).to(self.device)
            with span("rt/refit/sweeps"):
                cs = refit_lbvh2_clustered(self._cluster, tris_dev,
                                           num_sweeps=self._bvh2_height + 2)
            with span("rt/refit/gather"):
                self._bvh4 = collapse_apply_refit(self._collapse_plan, cs.bvh2.bounds_u32)
            with span("rt/refit/records"):
                self._qnodes = make_qnodes(make_wide_bvh(self._bvh4), cs.tris_sorted,
                                           tri_ids=cs.tri_order, leaf_size=cs.leaf_size)
            self._cluster = cs
            self._bvh2 = cs.bvh2
            self._wide = None
            self.triangles_data = tris
            self._tris_dev = tris_dev
            self.build_stats = {**self.build_stats, **stats}

    def _widen(self):
        """The BVH2 through the configured widener → its wide tree
        (:class:`~raytracer_tpu_torch.ops.collapse.BVH4`), on ``device``."""
        return widen(LBVH2(*(a.to(self.device) for a in self._bvh2)), self.widener,
                     self._bvh2_height)

    def _make_qnodes(self, wide) -> torch.Tensor:
        """The records of a wide tree: a cluster tree's inline its sorted
        triangles and their original ids, a tree of single triangles the
        scene's triangles (its leaves hold their indices)."""
        cs = self._cluster
        if cs is None:
            return make_qnodes(wide, self._tris_dev)
        return make_qnodes(wide, cs.tris_sorted, tri_ids=cs.tri_order, leaf_size=cs.leaf_size)

    def _records(self) -> None:
        """The records of the current BVH2 through the configured widener
        (``load_checkpoint``)."""
        self._wide = None
        self._bvh4 = self._widen()
        self._qnodes = self._make_qnodes(make_wide_bvh(self._bvh4))
        self._sync()

    def _wide_bvh(self):
        """The wide nodes of the current records, for the tile entries: made
        from the wide tree when entries are first asked for, and kept until
        the next build or refit."""
        if self._wide is None:
            self._wide = make_wide_bvh(self._bvh4)
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
        with span("rt/render"):
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
        image by different samples. The JAX package compacts the lanes
        between waves at bounces >= 2 on its records path; here
        :data:`COMPACT_WAVES` decides, off by the card's measurement.

        On the card a sample of records traced through K1b, with compaction
        and counters off, is one CUDA graph with its update of the mean
        (``render_pt.SampleGraphs``, span ``rt/pt/graph``): the same samples
        and means, word for word, for one copy and one graph launch of the
        host's. Every other sample runs its ops one by one. A mean returned
        is never changed by a later call."""
        if bounces < 0:
            raise ValueError("bounces must be >= 0")
        self._require_records()
        with span("rt/render_progressive"):
            cam_sig = (tuple(self.camera_position), tuple(self.camera_quaternion))
            if self._accum_sig != cam_sig or self._accum is None:
                self._accum_sig = cam_sig
                self._accum = None  # the mean starts anew
                self.frame_count = 0

            brute = self._brute()
            compact = COMPACT_WAVES and not brute and bounces >= 2
            if bounces > 0 and sample_graph_eligible(self.device, tile_primary=not brute,
                                                     compact=compact, counting=counting()):
                with span("rt/pt/graph"):
                    self._accum = self._sample_graphs.sample(
                        self._qnodes, self._tris_dev, self.camera_position,
                        self.camera_quaternion, self.width, self.height, bounces=bounces,
                        fov_degrees=self.fov_degrees, leaf_k=self.leaf_size,
                        frame_count=self.frame_count, accum=self._accum)
                self.frame_count += 1
                return self._accum

            if bounces == 0:
                sample = self._primary_sample_jittered()
            else:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(self.frame_count)
                sample = pt_sample_frame(
                    None if brute else self._qnodes, self._tris_dev, self.camera_position,
                    self.camera_quaternion, self.width, self.height, bounces=bounces,
                    fov_degrees=self.fov_degrees, leaf_k=self.leaf_size, brute=brute,
                    tile_primary=not brute, generator=gen, compact=compact)
            if self._accum is None:
                self._accum = torch.zeros((self.height, self.width, 3), dtype=torch.float32,
                                          device=self.device)
            with span("rt/accumulate"):
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
        with span("rt/present_progressive"):
            c = self._accum
            return quantize_rgba8(torch.pow(c / (c + 1.0), 1.0 / 2.2))

    def set_frame_count(self, frame_count: int) -> None:
        self.frame_count = frame_count

    # -- camera state ----------------------------------------------------------

    def set_camera_position(self, x: float, y: float, z: float) -> None:
        self.camera_position = [x, y, z]

    def set_camera_quaternion(self, x: float, y: float, z: float, w: float) -> None:
        self.camera_quaternion = [x, y, z, w]

    # -- artifacts and checkpoints ---------------------------------------------------

    def bvh2_artifact(self) -> np.ndarray:
        """The BVH2.bin u32 image of the current build ([0] without a tree)."""
        if self._bvh2 is None:
            return np.array([0], dtype=np.uint32)
        return artifacts.bvh2_to_u32(*(a.cpu().numpy() for a in self._bvh2[:4]))

    def bvh4_artifact(self) -> np.ndarray:
        """The wide tree's u32 image (stride 8: 3 bound words, 4 children,
        meta) of the emitted rows ([0] without a tree)."""
        if self._bvh4 is None:
            return np.array([0], dtype=np.uint32)
        n4 = self._bvh4.num_nodes
        return artifacts.bvh4_to_u32(*(a[:n4].cpu().numpy() for a in self._bvh4[:3]))

    def dump_bvh_json(self, path) -> None:
        """The BVH2 as JSON: every node's f32 box, children and leaf flag."""
        artifacts.dump_bvh_json(path, self.bvh2_artifact(), stride=6)

    def save_checkpoint(self, path) -> None:
        """Write the triangles and the BVH2 (and for a cluster tree its
        ``tri_order`` and ``leaf_size``) as the JAX package's npz, which
        either package's ``load_checkpoint`` restores without a rebuild."""
        if self._bvh2 is None:
            artifacts.save_scene_npz(path, self.triangles_data)
            return
        u32 = {k: a.cpu().numpy().astype(np.uint32) for k, a in zip(
            ("bvh2_bounds", "bvh2_left", "bvh2_right", "bvh2_meta", "bvh2_parent"), self._bvh2)}
        if self._cluster is not None:
            u32["tri_order"] = self._cluster.tri_order.cpu().numpy().astype(np.uint32)
            u32["leaf_size"] = np.asarray([self.leaf_size], np.int32)
        artifacts.save_scene_npz(path, self.triangles_data, **u32)

    def load_checkpoint(self, path) -> None:
        """Restore a checkpoint written by ``raytracer_tpu``'s
        ``PathTracer.save_checkpoint``: triangles + the BVH2 (clustered, or of
        single triangles, which sets ``leaf_size = 1``) are loaded verbatim
        (no rebuild); the records are derived on ``device``."""
        data = artifacts.load_scene_npz(path)
        tris = data["triangles"].reshape(-1, 3, 3)
        if "bvh2_bounds" not in data:
            self.build_bvh(tris)
            return
        self.triangles_data = tris
        self._tris_dev = torch.from_numpy(np.ascontiguousarray(tris)).to(self.device)
        if "tri_order" in data:
            self._cluster = state_from_numpy(data, self.device)
            self._bvh2 = self._cluster.bvh2
            self.leaf_size = self._cluster.leaf_size
        else:
            # a tree of single triangles: its leaves hold triangle indices
            self._cluster = None
            self._bvh2 = bvh2_from_numpy(data)
            self.leaf_size = 1
        # the checkpoint does not store the height, which sets a refit's sweeps
        self._bvh2_height = tree_height(self._bvh2) if self._cluster is not None else None
        self._collapse_plan = None
        self._records()
