"""Supernode records and their traversal: the CUDA kernels
K1a/K1b/K1c/K1d/K1e/K1f (``csrc/traverse_tiles.cu``) and K2a/K2b/K2c (``csrc/traverse_rays.cu``),
their wrappers and their plain torch versions.

Counterpart of ``raytracer_tpu/ops/pallas/traverse.py`` on 4-wide and 8-wide
records: :func:`make_qnodes` builds the same records byte for byte;
:func:`trace_tiles` computes what ``trace_tiles_pallas(qnodes, pos, quat, W,
H, fov, leaf_k=K, jitter=…, jitter_seed=…)[:5]`` computes for one frame
(K1a without jitter, K1b with it; K1d with ``entries=`` / ``tbounds=``, the
per-tile entry nodes and depth bounds); :func:`trace_tiles_batch` what
``trace_tiles_batch_pallas(qnodes, pos (F,3), quat (F,4), W, H, fov,
leaf_k=K, jitter=…, jitter_seeds=…)[:5]`` computes for F frames in one
launch (K1c); :func:`trace_rays` what ``trace_rays_pallas(qnodes, origins,
dirs, any_hit=…, leaf_k=K)`` computes (K2a closest hit, K2b any hit). The
wrappers recover the records' width from their row length
(:func:`infer_rec_width`): on 8-wide records the tile kernels are K1e and
the ray kernel K2c. ``stats=True`` on the tile entries adds a sixth plane,
each pixel's count of records visited (K1f, at either width).

The two options of the TPU kernels: ``trace_tiles_batch(..., raw=True)``
returns the TPU kernel's own tile layout (F, tiles, 6, 8, 128), what
``trace_tiles_batch_pallas(..., raw=True)`` returns (:func:`tiles_layout`
is its plain version); ``trace_rays(..., tree_space="hbm"|"vmem"|"smem")``
places the records as ``trace_rays_pallas(..., tree_space=…)`` names it,
in this card's terms (:data:`TREE_SPACES`), with the same planes.

K1d's tiles are the TPU kernel's: 32×32 pixels (:data:`TILE`), indexed in
the pixel coordinates of the traced window (before ``row_offset`` /
``col_offset`` move it into a larger frame). A pixel starts with the best t
``tbounds[py // 32, px // 32]`` and its stack at record ``entries[py // 32,
px // 32]``; it keeps only hits nearer than the bound, and when it finds none
it reports ``tri = −1``, a zero normal and ``t`` = the bound (1e30 where the
tile has none). All kernels
run the one per-ray traversal of ``csrc/traverse_core.cuh``, and all plain
versions the one :func:`_traverse`.

Launch counts (:data:`LAUNCHES`): a launch counts once, under the variant it
ran. A tile launch with ``stats`` counts as ``trace_tiles_k1f`` whatever its
width, jitter, bounds or frame count; without ``stats``, with ``entries`` or
``tbounds`` as ``trace_tiles_k1d`` (either width, with or without jitter);
with neither, on 8-wide records as ``trace_tiles_k1e`` (one frame or a batch, with or without jitter); on
4-wide records as ``trace_tiles_k1a`` / ``k1b`` / ``k1c``. A ray launch on
8-wide records counts as ``trace_rays_k2c`` (closest or any hit), on 4-wide
records as ``trace_rays_k2a`` / ``k2b``; with ``ordered=False`` as
``trace_rays_k2a_unordered`` / ``k2b_unordered`` / ``k2c_unordered``. A
jittered frame whose camera is a row on the device (:func:`trace_tiles_row`)
counts as ``trace_tiles_k1b`` (``k1e`` on 8-wide records), as the one frame
it traces. A batch with ``raw=True`` counts under its name with ``_raw`` added
(``trace_tiles_k1c_raw``, ``k1e_raw``, ``k1f_raw``), a ray launch with
``tree_space`` "vmem" or "smem" under its name with ``_vmem`` / ``_smem``
added (``trace_rays_k2a_vmem``, ``trace_rays_k2b_unordered_smem``, …).

Spans and counters (:mod:`raytracer_tpu_torch.utils.profiling`, off unless
a ``tracing`` block turns them on): each call of :func:`trace_tiles` and
:func:`trace_tiles_batch` is a span ``rt/k1``, each call of
:func:`trace_rays` a span ``rt/k2``, which counts its rays in ``rt/k2/lanes``
(a host int) and its active rays in ``rt/k2/active`` (the sum of
``active`` on its device, or every ray without a mask).

Record layout (f32 words, width w = 4 or 8 child slots, K triangles per leaf):
  [0 : 6w]    child AABBs (mnx,mny,mnz,mxx,mxy,mxz), +inf/−inf when empty
  [6w : 7w]   child refs as integer-valued floats: idx ≥ 0 internal node,
              −(first+1) leaf whose triangles start at row ``first``,
              −2^28 empty slot
  [7w : 8w]   triangle count (leaf) or bounding-sphere radius (internal)
  [8w + (kK+j)·12 : +12]  [v0, e1=v1−v0, e2=v2−v0, g=e1×e2] of slot k's
              j-th triangle
  [8w + 12wK + kK + j]    its original triangle id
padded to a multiple of 128 words.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...utils.profiling import count, counting, span
from ..camera import INF, camera_constants, primary_dirs, safe_inv_dir, subpixel_hash01, to_device
from ..trace import STACK_MAX, WideBVH, moller_trumbore

__all__ = ["rec_layout", "infer_rec_width", "make_qnodes", "trace_tiles",
           "trace_tiles_reference", "trace_tiles_batch", "trace_tiles_batch_reference",
           "trace_tiles_row", "camera_row", "check_camera_row", "CAMERA_ROW",
           "trace_rays", "trace_rays_reference", "launch_plan", "tile_plan", "ANY_HIT_CORE",
           "CLOSEST_HIT_CORE", "TILE_CORE", "load_kernel", "tile_warp_ids",
           "TraversalCounts", "LAUNCHES", "reset_launches", "EMPTY_REF", "TILE",
           "tiles_layout", "TREE_SPACES", "check_tree_space", "tree_space_limits", "l2_window"]

EMPTY_REF = -float(1 << 28)
_MAX_NODES = 1 << 24      # refs are exact integer-valued f32
_LEAF_BIT = 1 << 30
# rays traversed together by the plain version: bounds its (R, recw) gathers
_REFERENCE_CHUNK = 1 << 16

TILE = 32                 # pixels a side of the tile that shares a bound and an entry
_SUB = TILE * TILE // 128  # rows of 128 words in a tile plane of the raw layout
_MAX_SEED = 1 << 24       # the TPU kernel carries the jitter seed as an exact f32
_MAX_FRAMES = 65535       # K1c's frames are the grid's z dimension

# The traversal cores, as the feature masks of csrc/traverse_core.cuh that
# the launchers take: the render core (rt::kRenderCore, every launch at
# K = 1); over leaves of more than one triangle, ANY_HIT_CORE
# (rt::kAnyHitCore, the warp's leaf tests) in K2, for any hit and, as
# CLOSEST_HIT_CORE, for closest hit, and TILE_CORE (rt::kTileCore, the
# per-step choice between the warp's leaf tests and each lane's own loop)
# in K1. launch_plan (K2) and tile_plan (K1) say which one a launch runs;
# the launchers build exactly the masks the two can return.
_RENDER_CORE = 1                                   # kOrder
_UNORDERED, _SHARED_TREE, _PACK_SLOTS = 8, 16, 64  # kUnordered, kSharedTree, kPackSlots
ANY_HIT_CORE = 97                                  # kOrder | kWarpLeaves | kPackSlots
CLOSEST_HIT_CORE = ANY_HIT_CORE
TILE_CORE = 225                                    # kAnyHitCore | kTileLeaves

# Any hit over leaves of more than one triangle runs persistent warps on
# the waves that ask for them (scattered=True) only at K below this: they
# won at K = 8 and lost at K = 32 on the card (PERF.md §6).
_ANY_HIT_PERSISTENT_K = 32

# Where trace_rays' records live during a traversal, under the TPU kernel's
# names (trace_rays_pallas(tree_space=…)); trace_rays says what each is on
# this card. A name's index is the launcher's tree_space.
TREE_SPACES = ("hbm", "vmem", "smem")

# Launches of each kernel since its count was last set to 0; raised only
# where a wrapper launches that kernel. "camera_lanes" counts the launches
# of the camera wave's kernel (ops/cuda/camera.py), "wave_hit" and
# "wave_bounce" those of the sample's wave glue (ops/cuda/wave.py), one of
# each a wave. A progressive sample replayed from a CUDA graph
# (render_pt.SampleGraphs) adds the launches its capture made to each
# kernel's count, so that they count launches a sample either way;
# "sample_graph_replay" counts those replays, "sample_graph_capture" the
# captures (whose own launches count nothing: nothing runs).
LAUNCHES = {"trace_tiles_k1a": 0, "trace_tiles_k1b": 0, "trace_tiles_k1c": 0,
            "trace_tiles_k1d": 0, "trace_tiles_k1e": 0, "trace_tiles_k1f": 0,
            "trace_tiles_k1c_raw": 0, "trace_tiles_k1e_raw": 0, "trace_tiles_k1f_raw": 0,
            **{f"trace_rays_{k}{order}{space}": 0 for space in ("", "_vmem", "_smem")
               for order in ("", "_unordered") for k in ("k2a", "k2b", "k2c")},
            "camera_lanes": 0, "wave_hit": 0, "wave_bounce": 0,
            "sample_graph_replay": 0, "sample_graph_capture": 0}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def rec_layout(leaf_size: int, width: int = 4) -> tuple[int, int, int]:
    """(verts_base, ids_base, record_width) for K = leaf_size tris/leaf and
    ``width`` child slots per record."""
    vbase = 8 * width
    ibase = vbase + width * 12 * leaf_size
    return vbase, ibase, -(-(ibase + width * leaf_size) // 128) * 128


def infer_rec_width(leaf_k: int, recw: int) -> int:
    """Recover the record's child-slot count (4 or 8) from its word width."""
    for width in (4, 8):
        if rec_layout(leaf_k, width)[2] == recw:
            return width
    raise ValueError(
        f"record width {recw} matches no supported child count for "
        f"leaf_k={leaf_k} (expected {rec_layout(leaf_k, 4)[2]} for 4-wide "
        f"or {rec_layout(leaf_k, 8)[2]} for 8-wide) — pass the leaf_size "
        "the records were built with")


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 value C arithmetic would wrap it to."""
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c rounded once to f32 (a fused multiply-add), exactly.

    XLA contracts the records' cross products ``a·b − c·d`` into
    ``fma(a, b, −(c·d))`` and the sphere radius' sum of squares into a chain
    of fmas, so byte-equal records need the fused forms. The
    f32 product is exact in f64; the f64 sum is rounded to odd (from its
    TwoSum error), after which rounding to f32 is correct."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, torch.inf), torch.full_like(s, -torch.inf))
    s = torch.where((err != 0) & torch.isfinite(err) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _first_nan(value: torch.Tensor, operands: torch.Tensor) -> torch.Tensor:
    """``value``, an f32 result of ``operands`` (stacked on a last axis),
    where none of them is NaN; else the first NaN operand, made quiet. That
    is the NaN that XLA on the CPU returns from the records' differences and
    contracted cross products (read off the JAX package:
    ``tests/test_torch_nan_bounds.py``), while torch's negation flips a NaN's
    sign and CUDA returns one canonical NaN."""
    nan = torch.isnan(operands)
    first = operands.gather(-1, nan.to(torch.uint8).argmax(dim=-1, keepdim=True))[..., 0]
    quiet = (first.view(torch.int32) | 0x400000).view(torch.float32)
    return torch.where(nan.any(dim=-1), quiet, value)


def make_qnodes(wide: WideBVH, tris: torch.Tensor, tri_ids: torch.Tensor | None = None,
                leaf_size: int = 1) -> torch.Tensor:
    """WideBVH + (T,3,3) triangles → supernode records (M, recw) f32.

    Leaf refs in ``wide.cref`` are cluster indices: pass the cluster-ordered
    triangles as ``tris`` and the original-id permutation as ``tri_ids`` so
    hits report the scene's own indices."""
    m, wd = wide.cref.shape
    n_tris = tris.shape[0]
    k_sz = leaf_size
    if m >= _MAX_NODES or n_tris >= _MAX_NODES:
        raise ValueError(
            f"scene too large for the f32 ref encoding: {m} nodes / {n_tris} "
            f"triangles (max {_MAX_NODES - 1}) — indices above 2^24 lose "
            "precision as f32")
    dev = tris.device
    f32 = torch.float32
    vbase, ibase, recw = rec_layout(k_sz, wd)
    rec = torch.zeros((m, recw), dtype=f32, device=dev)
    rec[:, 0:6 * wd] = torch.cat([wide.cmn, wide.cmx], dim=-1).reshape(m, 6 * wd)

    cref = wide.cref.to(torch.int64)
    is_leaf = (cref & _LEAF_BIT) != 0
    # int32 arithmetic as in the JAX package: an empty slot (cref = −1)
    # wraps to first = −K, so its payload holds K copies of triangle 0
    first = _wrap_i32((cref & (_LEAF_BIT - 1)) * k_sz)
    if k_sz == 1 and tri_ids is not None:
        leaf_row = tri_ids[first.clamp(0, n_tris - 1)].to(f32)
    else:
        leaf_row = first.to(f32)
    enc = torch.where(cref < 0, torch.full_like(leaf_row, EMPTY_REF),
                      torch.where(is_leaf, -(leaf_row + 1.0), cref.to(f32)))
    rec[:, 6 * wd:7 * wd] = enc

    count = (n_tris - first).clamp(0, k_sz).to(f32)
    ext = wide.cmx - wide.cmn
    ex, ey, ez = ext.unbind(-1)
    # torch's f32 sqrt on the CPU can be 1 ulp off; the f64 root of an f32,
    # rounded to f32, is the correctly rounded f32 root on any device
    radius = 0.5 * torch.sqrt(_fma_f32(ez, ez, _fma_f32(ey, ey, ex * ex)).double()).float()
    radius = torch.where(torch.isfinite(radius), radius, torch.zeros_like(radius))
    rec[:, 7 * wd:8 * wd] = torch.where(is_leaf, count, radius)

    v = tris.reshape(n_tris, 3, 3)
    v0, v12 = v[:, 0:1].expand(n_tris, 2, 3), v[:, 1:3]
    e = _first_nan(v12 - v0, torch.stack([v12, v0], dim=-1))       # (T, 2, 3): e1, e2
    # g = e1 × e2, component i = a·b − c·d with a = e1[(i + 1) % 3], b =
    # e2[(i + 2) % 3], c = e1[(i + 2) % 3], d = e2[(i + 1) % 3] (rolls: an
    # index list would be copied from the host)
    e1, e2 = e[:, 0], e[:, 1]
    a, b, c, d = e1.roll(-1, 1), e2.roll(1, 1), e1.roll(1, 1), e2.roll(-1, 1)
    g = _first_nan(_fma_f32(a, b, -(c * d)), torch.stack([a, b, c, d], dim=-1))
    tri_rec = torch.cat([v[:, 0], e.reshape(n_tris, 6), g], dim=-1)  # (T, 12)
    lanes = torch.arange(k_sz, device=dev)
    for k in range(wd):
        idx = first[:, k, None] + lanes                         # (M, K)
        valid = is_leaf[:, k, None] & (idx < n_tris)
        safe = idx.clamp(0, n_tris - 1)
        v = torch.where(valid[..., None], tri_rec[safe], 0.0)   # (M, K, 12)
        vb = vbase + k * k_sz * 12
        rec[:, vb:vb + k_sz * 12] = v.reshape(m, k_sz * 12)
        ids = tri_ids[safe].to(f32) if tri_ids is not None else idx.to(f32)
        rec[:, ibase + k * k_sz:ibase + (k + 1) * k_sz] = torch.where(valid, ids, -1.0)
    return rec


def _check_qnodes(qnodes: torch.Tensor, leaf_k: int) -> tuple[torch.Tensor, int]:
    """Validate the records → (their (M, recw) view, their child-slot count)."""
    if qnodes.dtype != torch.float32:
        raise TypeError(f"qnodes must be float32, got {qnodes.dtype}")
    if not qnodes.is_contiguous():
        raise ValueError("qnodes must be contiguous")
    if qnodes.dim() < 2:
        raise ValueError(f"qnodes must be (M, recw), got shape {tuple(qnodes.shape)}")
    qn = qnodes.reshape(qnodes.shape[0], -1)
    return qn, infer_rec_width(leaf_k, qn.shape[1])


def _camera(cam_pos, cam_quat) -> tuple[list[float], list[float]]:
    pos = torch.as_tensor(cam_pos, dtype=torch.float32).reshape(3).tolist()
    quat = torch.as_tensor(cam_quat, dtype=torch.float32).reshape(4).tolist()
    return pos, quat


CAMERA_ROW = 16  # f32 words of a camera row (csrc/raygen.cuh, rt::CamCol)


def camera_row(cam_pos, cam_quat, width: int, height: int, fov_degrees: float, seed: int = 0,
               row_offset: int = 0, col_offset: int = 0) -> list[float]:
    """A row of K1c's camera table, :data:`CAMERA_ROW` values: the origin,
    the quaternion (xyzw), focal and aspect of a ``width`` × ``height`` frame
    of ``fov_degrees``, the frame's width and height, the jitter seed, the
    window's row and column offset, and two unused columns (0). Refuses a
    seed outside [0, 2^24), which f32 would not hold exactly."""
    focal, aspect = camera_constants(width, height, fov_degrees)
    return [*(float(x) for x in cam_pos), *(float(x) for x in cam_quat), focal, aspect,
            float(width), float(height), float(_check_seed(seed)), float(row_offset),
            float(col_offset),
            0.0, 0.0]


def check_camera_row(row: torch.Tensor, device) -> tuple[list, list, int] | None:
    """Refuse ``row`` unless it is a contiguous (16,) f32 camera row on
    ``device``; on the CPU → its origin, quaternion and jitter seed (checked),
    read on the host (on a card nothing is read, and the seed is not
    checked)."""
    if (row.dtype != torch.float32 or tuple(row.shape) != (CAMERA_ROW,)
            or not row.is_contiguous() or row.device != device):
        raise ValueError(f"row must be a contiguous ({CAMERA_ROW},) float32 tensor on {device}, "
                         f"got {tuple(row.shape)} {row.dtype} on {row.device}")
    if row.device.type != "cpu":
        return None
    values = row.tolist()
    return values[0:3], values[3:7], _check_seed(values[11])


def _check_seed(jitter_seed) -> int:
    seed = int(jitter_seed)
    if seed != jitter_seed or not 0 <= seed < _MAX_SEED:
        raise ValueError(f"jitter_seed must be an integer in [0, 2^24), got {jitter_seed}")
    return seed


def _check_window(width, height, raygen_size, row_offset, col_offset) -> tuple[int, int]:
    """The (W, H) of the frame whose rays the ``width`` × ``height`` window
    at (row_offset, col_offset) traces."""
    rg_w, rg_h = raygen_size if raygen_size is not None else (width, height)
    if not (width >= 1 and height >= 1 and 0 <= col_offset <= rg_w - width
            and 0 <= row_offset <= rg_h - height):
        raise ValueError(f"window {width}x{height} at ({row_offset}, {col_offset}) "
                         f"does not fit the {rg_w}x{rg_h} frame")
    return rg_w, rg_h


# traverse_tiles.cu builds as two libraries, started together: the render
# core ("traverse_tiles.cu") and TILE_CORE's forms ("traverse_tiles.cu:warp",
# with RT_TILES_WARP): as one it took 29.68 s of nvcc on the card's machine
# against traverse_rays.cu's 23.34 s (PERF.md §6).
TILE_SOURCES = ("traverse_tiles.cu", "traverse_tiles.cu:warp")

_ARGTYPES = {
    "traverse_tiles.cu": {
        "rt_trace_tiles": ([ctypes.c_void_p] + [ctypes.c_int] * 4
                           + [ctypes.c_float] * 9 + [ctypes.c_int] * 8
                           + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                           + [ctypes.c_void_p] * 7),
        "rt_trace_tiles_batch": ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                                 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 7),
        "rt_trace_tiles_batch_raw": ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                                     + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2),
    },
    "traverse_rays.cu": {
        "rt_trace_rays": ([ctypes.c_void_p] + [ctypes.c_int] * 4
                          + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                          + [ctypes.c_void_p] * 7),
        "rt_tree_space_limits": [ctypes.c_void_p],
        "rt_l2_window": [ctypes.c_void_p] * 2,
    },
}


@functools.cache
def load_kernel(source: str) -> tuple[ctypes.CDLL, str]:
    """Build (at first use) and load ``csrc/<source>`` — ``traverse_tiles.cu``
    (K1a/K1b/K1c/K1d/K1e/K1f; TILE_CORE's part ``traverse_tiles.cu:warp``,
    :data:`TILE_SOURCES`) or ``traverse_rays.cu`` (K2a/K2b/K2c); returns
    (library, nvcc log)."""
    from .build import build_library

    src, _, part = source.partition(":")
    lib, log = build_library(src, f"RT_TILES_{part.upper()}" if part else "")
    for name, argtypes in _ARGTYPES[src].items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib, log


def _tile_source(core: int) -> str:
    """The part of traverse_tiles.cu that builds ``core`` (TILE_SOURCES)."""
    return TILE_SOURCES[core != _RENDER_CORE]


def _tile_launch_name(width: int, stats: bool, plain: str, bounded: bool = False) -> str:
    """The launch count a tile launch is added to (module docstring)."""
    if stats:
        return "trace_tiles_k1f"
    if bounded:
        return "trace_tiles_k1d"
    return "trace_tiles_k1e" if width == 8 else plain


def _tile_tables(entries, tbounds, nty: int, ntx: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The (nty, ntx) tables K1d reads: ``entries`` (int32) padded with the
    root (0) and ``tbounds`` (f32) with 1e30 (no bound), as the JAX package's
    ``_tiles_call`` pads them; a missing one is all 0 / all 1e30. Both stay
    on ``device``: nothing is read back."""
    def table(a, dtype, fill, name):
        if a is None:
            return torch.full((nty, ntx), fill, dtype=dtype, device=device)
        if not isinstance(a, torch.Tensor) or a.dim() != 2:
            raise ValueError(f"{name} must be a 2-D tensor of per-tile values")
        if a.device != device:
            raise ValueError(f"{name} on {a.device}, records on {device}")
        ay, ax = a.shape
        if ay > nty or ax > ntx:
            raise ValueError(f"{name} of shape {(ay, ax)} exceeds the frame's "
                             f"{nty} x {ntx} tiles of {TILE} pixels")
        a = a.to(dtype)
        if (ay, ax) != (nty, ntx):
            a = torch.nn.functional.pad(a, (0, ntx - ax, 0, nty - ay), value=fill)
        return a.contiguous()

    return (table(entries, torch.int32, 0, "entries"),
            table(tbounds, torch.float32, INF, "tbounds"))


def trace_tiles(qnodes: torch.Tensor, cam_pos, cam_quat, width: int, height: int,
                fov_degrees: float = 70.0, leaf_k: int = 1,
                raygen_size: tuple[int, int] | None = None, row_offset: int = 0,
                col_offset: int = 0, jitter: bool = False, jitter_seed: int = 0,
                stats: bool = False, entries: torch.Tensor | None = None,
                tbounds: torch.Tensor | None = None):
    """Trace all primary rays → (t, nx, ny, nz, tri) planes of (H, W): on a
    miss the normal is 0, tri (int32) is −1 and t is 1e30, or under
    ``tbounds`` its tile's bound. ``stats``
    appends a sixth plane (f32, integer-valued): the records each pixel's
    ray visited — stack pops that passed the cull against its best t. The
    plane is defined by this kernel (one stack per ray; the TPU kernel
    counts per tile) and leaves the five others unchanged.

    ``raygen_size``/``row_offset``/``col_offset`` trace the ``width`` ×
    ``height`` window at that pixel offset of a larger (W, H) frame, with the
    frame's rays (as ``trace_tiles_pallas`` does). ``jitter`` moves each
    ray from the pixel centre to the ``subpixel_hash01`` offsets of
    ``jitter_seed`` (an int in [0, 2^24)).

    ``entries`` (int32) and ``tbounds`` (f32) are per-tile start values,
    tensors of up to (⌈H/32⌉, ⌈W/32⌉) on the records' device, smaller ones
    padded with the root (0) and no bound (1e30); giving either runs K1d.
    The pixels of tile (ty, tx) of the window start at record ``entries[ty,
    tx]`` (an index into ``qnodes``; the caller guarantees that no ray of the
    tile has its nearest hit outside that subtree) and keep only hits with
    t < ``tbounds[ty, tx]``: a hit that is found is the ray's nearest, and a
    pixel that finds none returns t = the bound, so a caller that needs the
    exact image re-traces the pixels with ``tri < 0`` under a finite bound
    (:func:`raytracer_tpu_torch.render.trace_tiles_bounded`). They are read
    on the device: no value comes back to the host.

    For records on a CUDA device launches K1a (K1b with ``jitter``) on
    4-wide records, K1e on 8-wide records, K1d with ``entries`` or
    ``tbounds``, K1f with ``stats``, with the traversal core that
    :func:`tile_plan` gives (over leaves of K > 1 the per-step choice
    between the warp's leaf tests and each lane's loop, TILE_CORE); runs the
    plain version for records on the CPU; raises for any other device."""
    with span("rt/k1"):
        qn, slots = _check_qnodes(qnodes, leaf_k)
        seed = _check_seed(jitter_seed)
        rg_w, rg_h = _check_window(width, height, raygen_size, row_offset, col_offset)
        bounded = entries is not None or tbounds is not None
        if bounded:
            entries, tbounds = _tile_tables(entries, tbounds, -(-height // TILE),
                                            -(-width // TILE), qn.device)
        if qn.device.type == "cpu":
            pixels = _window_pixels(width, height, rg_w, row_offset, col_offset)
            planes = trace_tiles_reference(qn, cam_pos, cam_quat, rg_w, rg_h, fov_degrees,
                                           leaf_k, pixels=pixels, jitter=jitter,
                                           jitter_seed=seed, stats=stats, entries=entries,
                                           tbounds=tbounds, tile_origin=(row_offset, col_offset))
            return tuple(p.reshape(height, width) for p in planes)
        if qn.device.type != "cuda":
            raise ValueError(f"trace_tiles runs on cuda or cpu tensors, got {qn.device}")
        core = tile_plan(leaf_k=leaf_k)
        lib, _ = load_kernel(_tile_source(core))
        pos, quat = _camera(cam_pos, cam_quat)
        focal, aspect = camera_constants(rg_w, rg_h, fov_degrees)
        planes = [torch.empty((height, width), dtype=torch.float32, device=qn.device)
                  for _ in range(5 if stats else 4)]
        tri = torch.empty((height, width), dtype=torch.int32, device=qn.device)
        with torch.cuda.device(qn.device):
            stream = torch.cuda.current_stream(qn.device).cuda_stream
            err = lib.rt_trace_tiles(
                qn.data_ptr(), qn.shape[0], qn.shape[1], leaf_k, slots, *pos, *quat, focal, aspect,
                rg_w, rg_h, row_offset, col_offset, width, height, int(bool(jitter)), seed,
                tbounds.data_ptr() if bounded else None, entries.data_ptr() if bounded else None,
                core, *(p.data_ptr() for p in planes[:4]), tri.data_ptr(),
                planes[4].data_ptr() if stats else None, stream)
        name = _tile_launch_name(slots, stats, "trace_tiles_k1b" if jitter else "trace_tiles_k1a",
                                 bounded)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        LAUNCHES[name] += 1
        return (*planes[:4], tri, *planes[4:])


def trace_tiles_reference(qnodes: torch.Tensor, cam_pos, cam_quat, width: int,
                          height: int, fov_degrees: float = 70.0, leaf_k: int = 1,
                          pixels: torch.Tensor | None = None, jitter: bool = False,
                          jitter_seed: int = 0, counts: "TraversalCounts | None" = None,
                          stats: bool = False, entries: torch.Tensor | None = None,
                          tbounds: torch.Tensor | None = None,
                          tile_origin: tuple[int, int] = (0, 0)):
    """The plain torch version of K1a/K1b/K1d/K1e (and of K1f with
    ``stats``): the same rays, visit order, culling and stack-drop rule,
    vectorized over chunks of rays, at either record width.

    ``pixels`` (flat indices py·W + px) traces only those pixels and returns
    (P,) planes; without it, (H, W) planes of the whole image. ``counts``
    adds up the work of the traversal (:class:`TraversalCounts`).
    ``entries`` / ``tbounds`` are K1d's per-tile start values
    (:func:`trace_tiles`); tile (0, 0) begins at pixel ``tile_origin`` (row,
    column) of the frame, the offset of the window whose tiles they are."""
    qn, _ = _check_qnodes(qnodes, leaf_k)
    seed = _check_seed(jitter_seed)
    dev = qn.device
    pix = (torch.arange(width * height, device=dev) if pixels is None
           else pixels.to(dev).long())
    pos, quat = _camera(cam_pos, cam_quat)
    px, py = pix % width, pix // width
    jx = jy = 0.5
    if jitter:
        jx, jy = subpixel_hash01(px, py, 2 * seed), subpixel_hash01(px, py, 2 * seed + 1)
    d = primary_dirs(px, py, width, height, quat, fov_degrees, jx, jy)
    o = torch.tensor(pos, dtype=torch.float32, device=dev).expand(pix.numel(), 3)
    best0 = entry = None
    if entries is not None or tbounds is not None:
        row0, col0 = tile_origin
        entries, tbounds = _tile_tables(entries, tbounds, -(-(height - row0) // TILE),
                                        -(-(width - col0) // TILE), dev)
        ty, tx = (py - row0) // TILE, (px - col0) // TILE
        best0 = tbounds[ty, tx]
        entry = entries[ty, tx].long().clamp(0, qn.shape[0] - 1)
    planes = _traverse_chunks(qn, o, d, leaf_k, False, counts, stats, best0, entry)
    if pixels is None:
        return tuple(p.reshape(height, width) for p in planes)
    return planes


def _window_pixels(width: int, height: int, rg_w: int, row_offset: int,
                   col_offset: int) -> torch.Tensor:
    """Flat indices py·W + px of a window's pixels in a frame of width rg_w."""
    rows = torch.arange(row_offset, row_offset + height)
    cols = torch.arange(col_offset, col_offset + width)
    return (rows[:, None] * rg_w + cols[None, :]).reshape(-1)


def _cameras(cam_pos, cam_quat, jitter_seeds) -> tuple[list, list, list[int]]:
    """Host lists of F positions, F quaternions and F seeds, checked."""
    pos = torch.as_tensor(cam_pos, dtype=torch.float32).cpu()
    quat = torch.as_tensor(cam_quat, dtype=torch.float32).cpu()
    if pos.dim() != 2 or pos.shape[1] != 3 or quat.shape != (pos.shape[0], 4):
        raise ValueError(f"cam_pos must be (F, 3) and cam_quat (F, 4), got "
                         f"{tuple(pos.shape)} and {tuple(quat.shape)}")
    f = pos.shape[0]
    if not 1 <= f <= _MAX_FRAMES:
        raise ValueError(f"{f} frames: a batch holds 1 to {_MAX_FRAMES}")
    if jitter_seeds is None:
        seeds = [0] * f
    else:
        raw = torch.as_tensor(jitter_seeds).cpu().reshape(-1).tolist()
        if len(raw) != f:
            raise ValueError(f"jitter_seeds must hold one seed per frame ({f}), got {len(raw)}")
        seeds = [_check_seed(x) for x in raw]
    return pos.tolist(), quat.tolist(), seeds


def trace_tiles_batch(qnodes: torch.Tensor, cam_pos, cam_quat, width: int, height: int,
                      fov_degrees: float = 70.0, leaf_k: int = 1, jitter: bool = False,
                      jitter_seeds=None, stats: bool = False, *,
                      raygen_size: tuple[int, int] | None = None, row_offset: int = 0,
                      col_offset: int = 0, raw: bool = False):
    """Trace F frames in one launch, frame f from camera ``cam_pos[f]``
    (F, 3), ``cam_quat[f]`` (F, 4) → (t, nx, ny, nz, tri) planes of (F, H, W),
    each frame equal to :func:`trace_tiles` for its camera; ``stats`` appends
    the visits plane of :func:`trace_tiles`. ``jitter``
    takes frame f's subpixel offsets from ``jitter_seeds[f]`` (integers in
    [0, 2^24)). ``raygen_size``/``row_offset``/``col_offset`` trace the same
    window of every frame, as in :func:`trace_tiles`. The cameras are host
    values (array-likes or CPU tensors): the camera table is built on the
    host and copied to the card without a synchronisation.

    ``raw=True`` returns instead one (F, ⌈H/32⌉·⌈W/32⌉, 6, 8, 128) f32
    tensor, the TPU kernel's own tile layout (what
    ``trace_tiles_batch_pallas(..., raw=True)`` returns; :func:`tiles_layout`
    of the planes): 32×32-pixel tiles row-major over the frame, each tile's
    pixels row-major in its 1,024 words, planes t, nx, ny, nz, tri as f32
    (−1.0 on a miss) and a sixth plane that is each pixel's visits with
    ``stats`` and 0 without (the TPU kernel writes its tile's visit count
    there). It needs width and height that are multiples of 32 and the whole
    frame (no ``raygen_size`` or offsets); the image planes are not made at
    all.

    For records on a CUDA device launches K1c on 4-wide records, K1e on
    8-wide records, K1f with ``stats``, with the traversal core that
    :func:`tile_plan` gives; runs the plain version for records on the CPU;
    raises for any other device."""
    with span("rt/k1"):
        qn, slots = _check_qnodes(qnodes, leaf_k)
        pos, quat, seeds = _cameras(cam_pos, cam_quat, jitter_seeds)
        rg_w, rg_h = _check_window(width, height, raygen_size, row_offset, col_offset)
        f = len(pos)
        if raw:
            _check_raw(width, height, raygen_size, row_offset, col_offset)
        if qn.device.type == "cpu":
            pixels = _window_pixels(width, height, rg_w, row_offset, col_offset)
            planes = trace_tiles_batch_reference(qn, pos, quat, rg_w, rg_h, fov_degrees, leaf_k,
                                                 pixels=pixels, jitter=jitter, jitter_seeds=seeds,
                                                 stats=stats)
            planes = tuple(p.reshape(f, height, width) for p in planes)
            return tiles_layout(planes) if raw else planes
        if qn.device.type != "cuda":
            raise ValueError(f"trace_tiles_batch runs on cuda or cpu tensors, got {qn.device}")
        core = tile_plan(leaf_k=leaf_k)
        lib, _ = load_kernel(_tile_source(core))
        table = to_device([camera_row(p, q, rg_w, rg_h, fov_degrees, s, row_offset, col_offset)
                           for p, q, s in zip(pos, quat, seeds)], qn.device)
        if raw:
            out = torch.empty((f, (height // TILE) * (width // TILE), 6, _SUB, 128),
                              dtype=torch.float32, device=qn.device)
            with torch.cuda.device(qn.device):
                stream = torch.cuda.current_stream(qn.device).cuda_stream
                err = lib.rt_trace_tiles_batch_raw(
                    qn.data_ptr(), qn.shape[1], leaf_k, slots, table.data_ptr(), f, width, height,
                    int(bool(jitter)), int(bool(stats)), core, out.data_ptr(), stream)
            name = _tile_launch_name(slots, stats, "trace_tiles_k1c") + "_raw"
            if err != 0:
                raise RuntimeError(f"{name} launch failed: cudaError {err}")
            LAUNCHES[name] += 1
            return out
        planes = [torch.empty((f, height, width), dtype=torch.float32, device=qn.device)
                  for _ in range(5 if stats else 4)]
        tri = torch.empty((f, height, width), dtype=torch.int32, device=qn.device)
        with torch.cuda.device(qn.device):
            stream = torch.cuda.current_stream(qn.device).cuda_stream
            err = lib.rt_trace_tiles_batch(
                qn.data_ptr(), qn.shape[1], leaf_k, slots, table.data_ptr(), f, width, height,
                int(bool(jitter)), core, *(p.data_ptr() for p in planes[:4]), tri.data_ptr(),
                planes[4].data_ptr() if stats else None, stream)
        name = _tile_launch_name(slots, stats, "trace_tiles_k1c")
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        LAUNCHES[name] += 1
        return (*planes[:4], tri, *planes[4:])


def trace_tiles_row(qnodes: torch.Tensor, row: torch.Tensor, width: int, height: int,
                    fov_degrees: float = 70.0, leaf_k: int = 1):
    """K1b with its camera on the device: the jittered ``width`` × ``height``
    frame whose camera and jitter seed are ``row``, a (16,) f32 camera row
    on the records' device made as :func:`camera_row` (``width``, ``height``,
    ``fov_degrees``, the seed; no offsets) makes it → the (t, nx, ny, nz, tri)
    planes of (H, W) that :func:`trace_tiles` with ``jitter=True`` gives for
    that camera and seed, word for word. Nothing of the row is read on the
    host, so a CUDA graph that holds the launch traces whatever camera the
    row holds when it runs (the seed must lie in [0, 2^24); the card cannot
    check it).

    For records on a CUDA device launches K1c's kernel over one frame with
    jitter (the same rays, traversal core and stores as K1b; counted as
    ``trace_tiles_k1b``, ``k1e`` on 8-wide records); for records on the CPU
    reads the row and runs the plain version; raises for any other device."""
    with span("rt/k1"):
        qn, slots = _check_qnodes(qnodes, leaf_k)
        camera = check_camera_row(row, qn.device)
        _check_window(width, height, None, 0, 0)
        if qn.device.type == "cpu":
            pos, quat, seed = camera
            return trace_tiles_reference(qn, pos, quat, width, height, fov_degrees, leaf_k,
                                         jitter=True, jitter_seed=seed)
        if qn.device.type != "cuda":
            raise ValueError(f"trace_tiles_row runs on cuda or cpu tensors, got {qn.device}")
        core = tile_plan(leaf_k=leaf_k)
        lib, _ = load_kernel(_tile_source(core))
        planes = [torch.empty((height, width), dtype=torch.float32, device=qn.device)
                  for _ in range(4)]
        tri = torch.empty((height, width), dtype=torch.int32, device=qn.device)
        with torch.cuda.device(qn.device):
            stream = torch.cuda.current_stream(qn.device).cuda_stream
            err = lib.rt_trace_tiles_batch(
                qn.data_ptr(), qn.shape[1], leaf_k, slots, row.data_ptr(), 1, width, height, 1,
                core, *(p.data_ptr() for p in planes), tri.data_ptr(), None, stream)
        name = _tile_launch_name(slots, False, "trace_tiles_k1b")
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        LAUNCHES[name] += 1
        return (*planes, tri)


def _check_raw(width: int, height: int, raygen_size, row_offset: int, col_offset: int) -> None:
    """Refuse the frames the raw tile layout does not take (trace_tiles_batch)."""
    if width % TILE or height % TILE:
        raise ValueError(f"raw=True needs a width and height that are multiples of {TILE}, "
                         f"got {width}x{height}")
    if raygen_size not in (None, (width, height)) or row_offset or col_offset:
        raise ValueError("raw=True traces whole frames: no raygen_size or offsets")


def tiles_layout(planes) -> torch.Tensor:
    """(F, H, W) planes (t, nx, ny, nz, tri[, visits]) of frames whose sides
    are multiples of 32 → the raw tile layout (F, (H/32)·(W/32), 6, 8, 128)
    f32 of :func:`trace_tiles_batch` (``raw=True``): tri as f32, and the
    visits, or zeros without them, as the sixth plane. The plain version of
    K1c's raw stores."""
    t = planes[0]
    f, h, w = t.shape
    if h % TILE or w % TILE:
        raise ValueError(f"the raw layout needs sides that are multiples of {TILE}, got {w}x{h}")
    sixth = planes[5] if len(planes) > 5 else torch.zeros_like(t)
    stack = torch.stack([*planes[:4], planes[4].to(torch.float32), sixth], dim=1)
    tiles = stack.reshape(f, 6, h // TILE, TILE, w // TILE, TILE).permute(0, 2, 4, 1, 3, 5)
    return tiles.reshape(f, (h // TILE) * (w // TILE), 6, _SUB, 128).contiguous()


def trace_tiles_batch_reference(qnodes: torch.Tensor, cam_pos, cam_quat, width: int,
                                height: int, fov_degrees: float = 70.0, leaf_k: int = 1,
                                pixels: torch.Tensor | None = None, jitter: bool = False,
                                jitter_seeds=None, counts: "TraversalCounts | None" = None,
                                stats: bool = False):
    """The plain torch version of a frame batch (K1c, K1e, K1f):
    :func:`trace_tiles_reference` of each frame on the same rays, stacked →
    (F, H, W) planes, or (F, P) with ``pixels``. ``counts`` adds up the work
    of all frames."""
    pos, quat, seeds = _cameras(cam_pos, cam_quat, jitter_seeds)
    frames = [trace_tiles_reference(qnodes, p, q, width, height, fov_degrees, leaf_k,
                                    pixels=pixels, jitter=jitter, jitter_seed=s, counts=counts,
                                    stats=stats)
              for p, q, s in zip(pos, quat, seeds)]
    return tuple(torch.stack(planes) for planes in zip(*frames))


def _check_rays(qn: torch.Tensor, origins: torch.Tensor, dirs: torch.Tensor,
                active: torch.Tensor | None) -> None:
    for name, a in (("origins", origins), ("dirs", dirs)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.dim() != 2 or a.shape[1] != 3:
            raise ValueError(f"{name} must be (R, 3), got shape {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if a.device != qn.device:
            raise ValueError(f"{name} on {a.device}, records on {qn.device}")
    if origins.shape != dirs.shape:
        raise ValueError(f"origins {tuple(origins.shape)} and dirs {tuple(dirs.shape)} differ")
    if origins.shape[0] >= 1 << 31:
        raise ValueError(f"{origins.shape[0]} rays: at most 2^31 - 1 per call")
    if active is not None:
        if active.dtype != torch.bool:
            raise TypeError(f"active must be bool, got {active.dtype}")
        if active.shape != origins.shape[:1] or not active.is_contiguous():
            raise ValueError(f"active must be a contiguous ({origins.shape[0]},) mask, "
                             f"got shape {tuple(active.shape)}")
        if active.device != qn.device:
            raise ValueError(f"active on {active.device}, records on {qn.device}")


def check_tree_space(nbytes: int, tree_space: str, limits: dict) -> None:
    """Raise ``ValueError`` unless records of ``nbytes`` bytes fit the
    placement ``tree_space`` on a card with these ``limits``
    (:func:`tree_space_limits`: "smem_optin", "persisting_l2",
    "access_window", in bytes). "hbm" takes any size; "vmem" needs the
    records within the largest persisting L2 carve-out and the largest
    access-policy window; "smem" within the shared memory one block may opt
    in to (the counterpart of the TPU kernel's compile error where the tree
    does not fit its memory)."""
    if tree_space not in TREE_SPACES:
        raise ValueError(f"tree_space must be hbm|vmem|smem, got {tree_space!r}")
    if tree_space == "vmem":
        room = min(limits["persisting_l2"], limits["access_window"])
        if nbytes > room:
            raise ValueError(
                f"tree_space='vmem': records of {nbytes} bytes exceed the card's persisting L2 "
                f"carve-out ({limits['persisting_l2']} bytes) or access-policy window "
                f"({limits['access_window']} bytes)")
    elif tree_space == "smem" and nbytes > limits["smem_optin"]:
        raise ValueError(f"tree_space='smem': records of {nbytes} bytes exceed one block's "
                         f"shared memory ({limits['smem_optin']} bytes)")


@functools.cache
def _limits(index: int) -> tuple[int, int, int]:
    lib, _ = load_kernel("traverse_rays.cu")
    out = (ctypes.c_longlong * 3)()
    with torch.cuda.device(index):
        err = lib.rt_tree_space_limits(out)
    if err != 0:
        raise RuntimeError(f"reading the card's limits failed: cudaError {err}")
    return tuple(out)


def tree_space_limits(device) -> dict:
    """The limits of a CUDA device that decide what fits a placement
    (:func:`check_tree_space`), in bytes, read once a device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"tree_space_limits reads a CUDA device, got {dev}")
    smem, persisting, window = _limits(dev.index if dev.index is not None
                                       else torch.cuda.current_device())
    return {"smem_optin": smem, "persisting_l2": persisting, "access_window": window}


def l2_window(device, stream: torch.cuda.Stream | None = None) -> dict:
    """What an L2 placement could leave behind, read back from the card:
    the access-policy window of ``stream`` (PyTorch's current stream by
    default) — its "base" address and "num_bytes", 0 when it has none — and
    the device's "persisting_l2" carve-out in bytes."""
    dev = torch.device(device)
    lib, _ = load_kernel("traverse_rays.cu")
    out = (ctypes.c_longlong * 3)()
    with torch.cuda.device(dev):
        s = stream if stream is not None else torch.cuda.current_stream(dev)
        err = lib.rt_l2_window(s.cuda_stream, out)
    if err != 0:
        raise RuntimeError(f"reading the stream's access-policy window failed: cudaError {err}")
    return {"base": out[0], "num_bytes": out[1], "persisting_l2": out[2]}


def _packed(core: int, leaf_k: int) -> int:
    """``core`` (ANY_HIT_CORE or TILE_CORE) as the launchers build it for
    leaves of ``leaf_k`` triangles: without its packed slots from K = 32 on,
    where a run holds one slot either way and the slots' own runs won on the
    card (PERF.md §6)."""
    return core if leaf_k < 32 else core & ~_PACK_SLOTS


def launch_plan(*, any_hit: bool, leaf_k: int, ordered: bool = True, scattered: bool = False,
                tree_space: str = "hbm") -> tuple[int, bool]:
    """What :func:`trace_rays` launches for these arguments: (the core's
    feature mask, as the launcher takes it, whether persistent warps run
    it). A pure function: no device is touched; every mask it returns is
    built at both record widths.

    K = 1 runs the render core, persistent where ``scattered``. Over leaves
    of more than one triangle, any hit runs :data:`ANY_HIT_CORE`
    (persistent where ``scattered`` and K < ``_ANY_HIT_PERSISTENT_K``) and
    closest hit :data:`CLOSEST_HIT_CORE` (persistent where ``scattered``),
    without their packed slots from K = 32 on. ``ordered=False`` adds
    rt::kUnordered, ``tree_space="smem"`` rt::kSharedTree. These cores beat
    the port's first loop, and over leaves of K > 1 the render core, on
    every wave the card measured (PERF.md §6). Raises ``ValueError`` for a
    ``tree_space`` that is not one of :data:`TREE_SPACES`."""
    if tree_space not in TREE_SPACES:
        raise ValueError(f"tree_space must be hbm|vmem|smem, got {tree_space!r}")
    if leaf_k > 1:
        core = _packed(ANY_HIT_CORE, leaf_k)
        persistent = scattered and (not any_hit or leaf_k < _ANY_HIT_PERSISTENT_K)
    else:
        core, persistent = _RENDER_CORE, scattered
    if not ordered:
        core |= _UNORDERED
    if tree_space == "smem":
        core |= _SHARED_TREE
    return core, persistent


def tile_plan(*, leaf_k: int) -> int:
    """The core's feature mask that :func:`trace_tiles` and
    :func:`trace_tiles_batch` launch, in every variant and at both widths:
    the render core at K = 1 and :data:`TILE_CORE` over leaves of more than
    one triangle, without its packed slots from K = 32 on. A pure function.
    TILE_CORE beat the render core on every K1 variant the card measured
    and stayed within 5% of the warp's leaf tests at every step (PERF.md
    §6)."""
    return _packed(TILE_CORE, leaf_k) if leaf_k > 1 else _RENDER_CORE


def _ray_launch_name(slots: int, any_hit: bool, ordered: bool, tree_space: str) -> str:
    """The launch count a ray launch is added to (module docstring)."""
    name = "trace_rays_k2c" if slots == 8 else "trace_rays_k2b" if any_hit else "trace_rays_k2a"
    if not ordered:
        name += "_unordered"
    return name if tree_space == "hbm" else f"{name}_{tree_space}"


def trace_rays(qnodes: torch.Tensor, origins: torch.Tensor, dirs: torch.Tensor, *,
               any_hit: bool = False, leaf_k: int, active: torch.Tensor | None = None,
               scattered: bool = False, ordered: bool = True, tree_space: str = "hbm"):
    """Trace a buffer of rays — origins and dirs (R, 3) f32 — → (t, nx, ny,
    nz, tri) planes of (R,): the nearest hit, with t = 1e30, a zero normal
    and tri = −1 on a miss. ``any_hit`` makes it an occlusion query: a ray
    stops at its first accepted triangle and reports t = 0 with that
    triangle's normal and id (``tri >= 0`` is the occlusion mask; which
    occluder is reported depends on the visit order). Rays where the bool
    mask ``active`` is False are not read (they may hold inf or NaN) and
    return the miss values. ``scattered`` says that the active rays are a
    scattered minority of the buffer (the waves that follow a random bounce):
    the launch then runs persistent warps that fetch and compact them;
    otherwise one thread per ray, which is faster where the active rays come
    in runs. It changes no output.

    ``ordered=False`` drops the near-first order (the TPU kernel's
    ``ordered=False``): a visit pushes the children that pass in slot order,
    each with its slab entry distance, which the pop-time cull still reads,
    and no ranking or sort is done. Closest-hit planes are the same as with
    the order (the nearest hit does not depend on the visit order, but for
    exact ties of t and drops at the 64-entry stack); any-hit masks are the
    same, the occluder reported may differ.

    Over leaves of more than one triangle the launch runs the leaf tests
    spread over the warp (each leaf slot that a lane's ray reaches is tested
    by the whole warp, a triangle a lane): any hit :data:`ANY_HIT_CORE`, and
    closest hit :data:`CLOSEST_HIT_CORE`, which serves every run of a slot
    and keeps the nearest (PERF.md §6); :func:`launch_plan` picks the core
    and its schedule. Every core writes the plain version's words.

    ``tree_space`` places the records during the traversal, under the TPU
    kernel's names (:data:`TREE_SPACES`): "hbm" (default) reads them from
    device memory through L1 and L2; "vmem" pins them in L2 for this call —
    a persisting carve-out of their size and an access-policy window over
    them given to this launch alone, the carve-out put back and the
    persisting lines reset after it, for which the call waits for its
    launch to end; "smem" copies them into each block's shared memory when
    the block starts and traverses from there, in blocks of 512 threads.
    Every placement writes the same words. Records
    that do not fit a placement raise ``ValueError`` (:func:`check_tree_space`
    with the card's :func:`tree_space_limits`); on the CPU every placement
    runs the plain version, the name checked as on the card.

    For records on a CUDA device launches K2a (K2b with ``any_hit``) on
    4-wide records and K2c on 8-wide records; runs the plain version for
    records on the CPU; raises for any other device."""
    with span("rt/k2"):
        qn, slots = _check_qnodes(qnodes, leaf_k)
        core, persistent = launch_plan(any_hit=any_hit, leaf_k=leaf_k, ordered=ordered,
                                       scattered=scattered, tree_space=tree_space)
        _check_rays(qn, origins, dirs, active)
        r = origins.shape[0]
        if counting():
            count("rt/k2/lanes", r)
            count("rt/k2/active", r if active is None else active.sum())
        if qn.device.type == "cpu":
            return trace_rays_reference(qn, origins, dirs, any_hit=any_hit, leaf_k=leaf_k,
                                        active=active, ordered=ordered)
        if qn.device.type != "cuda":
            raise ValueError(f"trace_rays runs on cuda or cpu tensors, got {qn.device}")
        lib, _ = load_kernel("traverse_rays.cu")
        if tree_space != "hbm":
            check_tree_space(qn.numel() * 4, tree_space, tree_space_limits(qn.device))
        planes = [torch.empty((r,), dtype=torch.float32, device=qn.device) for _ in range(4)]
        tri = torch.empty((r,), dtype=torch.int32, device=qn.device)
        # the persistent warps' ray counter: this launch's own 4 bytes, zeroed by
        # the launcher on this stream
        counter = torch.empty((1,), dtype=torch.int32, device=qn.device) if persistent else None
        with torch.cuda.device(qn.device):
            stream = torch.cuda.current_stream(qn.device).cuda_stream
            err = lib.rt_trace_rays(
                qn.data_ptr(), qn.shape[0], qn.shape[1], leaf_k, slots, origins.data_ptr(),
                dirs.data_ptr(), None if active is None else active.data_ptr(), r,
                int(bool(any_hit)), core, int(persistent), TREE_SPACES.index(tree_space),
                None if counter is None else counter.data_ptr(),
                *(p.data_ptr() for p in planes), tri.data_ptr(), stream)
        name = _ray_launch_name(slots, any_hit, ordered, tree_space)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        LAUNCHES[name] += 1
        return (*planes, tri)


def trace_rays_reference(qnodes: torch.Tensor, origins: torch.Tensor, dirs: torch.Tensor, *,
                         any_hit: bool = False, leaf_k: int,
                         active: torch.Tensor | None = None,
                         counts: "TraversalCounts | None" = None, ordered: bool = True):
    """The plain torch version of K2a/K2b/K2c: the same per-ray traversal,
    vectorized over chunks of the active rays, at either record width, with
    or without near-first order (``ordered``, as in :func:`trace_rays`).
    ``counts`` adds up the work of the traversal
    (:class:`TraversalCounts`)."""
    qn, _ = _check_qnodes(qnodes, leaf_k)
    _check_rays(qn, origins, dirs, active)
    if active is None:
        return _traverse_chunks(qn, origins, dirs, leaf_k, any_hit, counts, ordered=ordered)
    r = origins.shape[0]
    t = torch.full((r,), INF, dtype=torch.float32, device=qn.device)
    nrm = [torch.zeros((r,), dtype=torch.float32, device=qn.device) for _ in range(3)]
    tri = torch.full((r,), -1, dtype=torch.int32, device=qn.device)
    idx = torch.nonzero(active).squeeze(1)
    outs = _traverse_chunks(qn, origins[idx], dirs[idx], leaf_k, any_hit, counts,
                            ordered=ordered)
    for full, part in zip((t, *nrm, tri), outs):
        full[idx] = part
    return (t, *nrm, tri)


class TraversalCounts:
    """The work a plain-version traversal does, added up over its calls:
    rays, node visits (one header of 8·w words each, w the records' child
    slots), Möller–Trumbore tests (one 12-word triangle record each), and
    the distinct headers and triangle records read (the record bytes a
    traversal must move at least once); the most entries any ray's stack
    held (``max_depth``) and the pushes dropped at the 64-entry limit
    (``dropped``), which size the kernels' on-chip stack. One object counts
    records of one width (``width``, set by the first traversal).

    ``leaf_log=True`` also keeps every visit that posts a leaf slot (ray
    index over all rays counted, the visit's ordinal, its record, the
    posted slots and their triangle counts), from which
    :meth:`warp_census` prices K1's leaf stages warp step by warp step."""

    def __init__(self, leaf_log: bool = False) -> None:
        self.leaf_log: list | None = [] if leaf_log else None
        self.rays = 0
        self.visits = 0
        self.mt_tests = 0
        self.max_depth = 0
        self.dropped = 0
        self.width: int | None = None
        self._nodes: list[torch.Tensor] = []
        self._tris: list[torch.Tensor] = []

    def start(self, rays: int, width: int) -> None:
        """``rays`` more rays through records of ``width`` child slots."""
        if self.width not in (None, width):
            raise ValueError(f"counts of {self.width}-wide records cannot take {width}-wide ones")
        self.width = width
        self.rays += rays

    def add_visits(self, nodes: torch.Tensor) -> None:
        """One visit of each record in ``nodes``."""
        self.visits += nodes.numel()
        self._nodes.append(torch.unique(nodes))

    def add_tests(self, tri_slots: torch.Tensor) -> None:
        """One MT test of each triangle record in ``tri_slots`` (node·wK +
        slot·K + j)."""
        self.mt_tests += tri_slots.numel()
        self._tris.append(torch.unique(tri_slots))

    def add_pushes(self, depth: torch.Tensor, dropped: int) -> None:
        """Stacks of ``depth`` entries after a visit's pushes, ``dropped``
        pushes refused."""
        if depth.numel():
            self.max_depth = max(self.max_depth, int(depth.max()))
        self.dropped += dropped

    def add_posts(self, rays: torch.Tensor, ordinal: torch.Tensor, nodes: torch.Tensor,
                  posted: torch.Tensor, n: torch.Tensor) -> None:
        """Visits that post leaf slots (with ``leaf_log``): ray indices,
        visit ordinals (0: the ray's first visit), records, (P, w) posted
        slots and their triangle counts min(count, K)."""
        if self.leaf_log is not None:
            self.leaf_log.append((rays, ordinal, nodes, posted, n))

    def warp_census(self, warps: torch.Tensor, visits: torch.Tensor, leaf_k: int,
                    costs=(1.0, 2.0, 3.0, 4.0)) -> dict:
        """K1's leaf stages priced warp step by warp step (needs
        ``leaf_log``): ``warps`` (R,) the warp of each ray counted
        (:func:`tile_warp_ids`), ``visits`` (R,) its visits. A warp steps
        until its last lane is done (``steps``: the sum over warps of their
        lanes' most visits), and at step s every lane makes its s-th visit;
        at each step where a lane posts (``posting_steps``) the census
        counts the posting lanes and the distinct records they post, the
        lane loops' iterations m = Σ_k max over lanes of n_k and the warp's
        runs of 32, w (packed below K = 32, as the launchers run them). For
        each cost c: the share of posting steps whose rule c·w < m takes the
        warp's tests, and the steps' cost in lane-loop iterations, Σ min(m,
        c·w) by that rule (rt::Ray::tile_step)."""
        if self.leaf_log is None:
            raise ValueError("warp_census needs TraversalCounts(leaf_log=True)")
        dev = visits.device
        steps = torch.zeros(int(warps.max()) + 1 if warps.numel() else 0, dtype=torch.int64,
                            device=dev).scatter_reduce(0, warps.long(), visits.long(), "amax")
        out = {"warp_steps": int(steps.sum()), "posting_steps": 0}
        if not self.leaf_log:
            return out
        rays, ordinal, nodes, posted, n = (torch.cat(c) for c in zip(*self.leaf_log))
        key = warps.long()[rays] * (int(ordinal.max()) + 1) + ordinal
        groups, inv = torch.unique(key, return_inverse=True)
        g = groups.numel()
        lanes = torch.bincount(inv, minlength=g)
        pairs = torch.unique(inv * (int(nodes.max()) + 1) + nodes)
        distinct = torch.bincount(pairs // (int(nodes.max()) + 1), minlength=g)
        w_slots = posted.shape[1]
        most = torch.zeros((g, w_slots), dtype=torch.int64, device=dev).scatter_reduce(
            0, inv[:, None].expand(-1, w_slots), n.long(), "amax")
        m = most.sum(dim=1)
        if leaf_k < 32:
            slot = torch.arange(w_slots, device=dev)
            first = torch.where(posted, slot, w_slots).amin(dim=1)
            last = torch.where(posted, slot, -1).amax(dim=1)
            runs = ((last - first + 1) * leaf_k + 31) // 32
        else:
            runs = ((n.long() + 31) // 32).sum(dim=1)
        w = torch.bincount(inv, weights=runs.double(), minlength=g).long()
        out.update({"posting_steps": g, "lanes_posting": float(lanes.double().mean()),
                    "distinct_records": float(distinct.double().mean()),
                    "lane_iterations": int(m.sum()), "warp_runs": int(w.sum())})
        for c in costs:
            warp = c * w < m
            out[f"c={c:g}"] = {"warp_share": float(warp.double().mean()),
                               "cost": float(torch.where(warp, c * w, m).double().sum())}
        return out

    def unique_record_bytes(self) -> int:
        """Bytes of the distinct headers (32·w each) and triangle records (48
        each) read."""
        def n_unique(parts):
            return torch.unique(torch.cat(parts)).numel() if parts else 0
        return 32 * (self.width or 4) * n_unique(self._nodes) + 48 * n_unique(self._tris)


def tile_warp_ids(px: torch.Tensor, py: torch.Tensor, width: int) -> torch.Tensor:
    """The warp of the tile kernels that traces pixel (px, py) of a window of
    ``width`` columns: its blocks are 8×8 pixels and a warp is 4 rows of 8
    (the rows py // 4 of the column block px // 8)."""
    return (py // 4) * ((width + 7) // 8) + px // 8


def _traverse_chunks(qn: torch.Tensor, o: torch.Tensor, d: torch.Tensor, leaf_k: int,
                     any_hit: bool, counts: TraversalCounts | None, stats: bool = False,
                     best0: torch.Tensor | None = None, entry: torch.Tensor | None = None,
                     ordered: bool = True):
    """:func:`_traverse` over chunks of rays → (t, nx, ny, nz, tri) (R,),
    and with ``stats`` the visits (R,) as f32. ``best0`` / ``entry`` (R,):
    each ray's start values (K1d)."""
    dev = qn.device
    r = d.shape[0]
    outs = [torch.empty((r,), dtype=torch.float32, device=dev) for _ in range(4)]
    tri = torch.empty((r,), dtype=torch.int32, device=dev)
    visits = torch.empty((r,), dtype=torch.float32, device=dev)
    for a in range(0, r, _REFERENCE_CHUNK):
        b = min(a + _REFERENCE_CHUNK, r)
        t_c, n_c, tri_c, visits_c = _traverse(
            qn, o[a:b], d[a:b], leaf_k, any_hit, counts,
            None if best0 is None else best0[a:b], None if entry is None else entry[a:b],
            ordered)
        outs[0][a:b] = t_c
        outs[1][a:b], outs[2][a:b], outs[3][a:b] = n_c.unbind(-1)
        tri[a:b] = tri_c
        visits[a:b] = visits_c
    return (*outs, tri, visits) if stats else (*outs, tri)


def _traverse(qn: torch.Tensor, o: torch.Tensor, d: torch.Tensor, leaf_k: int,
              any_hit: bool = False, counts: TraversalCounts | None = None,
              best0: torch.Tensor | None = None, entry: torch.Tensor | None = None,
              ordered: bool = True):
    """Per-ray traversal of the w-wide records (w = 4 or 8, from the row
    length) from origins ``o`` and directions ``d`` (R, 3), one stack pop per
    ray and step → (t (R,), normal (R,3), tri (R,) int32, visits (R,)
    int32: the pops that passed the cull). Closest hit keeps the first
    minimum in visit order; ``any_hit`` stops a ray at its first accepted
    triangle in visit order with t = 0. A visit may push up to w entries;
    pushes beyond the 64-entry stack are dropped. A ray starts with the best
    t ``best0`` (1e30 without it: no bound) and its stack at record ``entry``
    (the root without it), pushed with key 0; t of a ray that finds no hit
    is its ``best0``. ``ordered=False`` pushes the passing children in slot
    order instead of far→near (K2's ``ordered=False``)."""
    dev = qn.device
    r = d.shape[0]
    w = infer_rec_width(leaf_k, qn.shape[1])
    wk = w * leaf_k
    vbase, ibase, _ = rec_layout(leaf_k, w)
    inv = safe_inv_dir(d)
    best = (torch.full((r,), INF, dtype=torch.float32, device=dev) if best0 is None
            else best0.to(torch.float32).clone())
    nrm = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    visits = torch.zeros((r,), dtype=torch.int32, device=dev)
    stack_n = torch.zeros((r, STACK_MAX), dtype=torch.int64, device=dev)
    stack_d = torch.zeros((r, STACK_MAX), dtype=torch.float32, device=dev)
    if entry is not None:
        stack_n[:, 0] = entry
    sp = torch.zeros((r,), dtype=torch.int64, device=dev)  # entry 0: the start record
    lanes = torch.arange(leaf_k, device=dev, dtype=torch.float32)
    base = 0
    if counts is not None:
        base = counts.rays  # this call's rays follow those counted before
        counts.start(r, w)

    while True:
        live = torch.nonzero(sp >= 0).squeeze(1)
        if live.numel() == 0:
            break
        top = sp[live]
        node, key = stack_n[live, top], stack_d[live, top]
        sp[live] = top - 1
        keep = key < best[live]
        rays, node = live[keep], node[keep]
        if rays.numel() == 0:
            continue

        visits[rays] += 1
        if counts is not None:
            counts.add_visits(node)
        hdr = qn[node, 0:8 * w]
        best0 = best[rays]
        ro, rd, ri = o[rays], d[rays], inv[rays]
        boxes = hdr[:, 0:6 * w].reshape(-1, w, 6)
        t1 = (boxes[..., 0:3] - ro[:, None, :]) * ri[:, None, :]
        t2 = (boxes[..., 3:6] - ro[:, None, :]) * ri[:, None, :]
        tmin = torch.minimum(t1, t2).amax(dim=-1)
        tmax = torch.maximum(t1, t2).amin(dim=-1)
        hit = (tmax >= tmin.clamp_min(0.0)) & (tmin < best0[:, None])
        refs, cnt = hdr[:, 6 * w:7 * w], hdr[:, 7 * w:8 * w]

        # leaf slots: every (slot, triangle) candidate at once; the first
        # minimum (closest hit) or the first accepted triangle (any hit) in
        # (slot, triangle) order is what the kernel's sequential loop keeps
        do_mt = hit & (refs < 0.0) & (refs > EMPTY_REF)
        mrow = torch.nonzero(do_mt.any(dim=1)).squeeze(1)
        if counts is not None and counts.leaf_log is not None and mrow.numel():
            n = torch.where(do_mt[mrow], torch.nan_to_num(cnt[mrow]).clamp(0, leaf_k), 0.0)
            counts.add_posts(base + rays[mrow], visits[rays[mrow]].long() - 1, node[mrow],
                             do_mt[mrow], n.long())
        done = None
        if mrow.numel() > 0:
            mnode = node[mrow]
            recs = qn[mnode, vbase:vbase + 12 * wk].reshape(-1, w, leaf_k, 12)
            gate = do_mt[mrow][:, :, None] & (lanes < cnt[mrow][:, :, None])
            tt, ok = moller_trumbore(ro[mrow][:, None, None, :], rd[mrow][:, None, None, :],
                                     recs[..., 0:3], recs[..., 3:6], recs[..., 6:9])
            cur = best0[mrow]
            ok = (gate & ok & (tt < cur[:, None, None])).reshape(-1, wk)
            tt = tt.reshape(-1, wk)
            if any_hit:
                j = torch.argmax(ok.to(torch.uint8), dim=1)
                upd = ok.any(dim=1)
                tbest = torch.zeros_like(cur)
            else:
                tt = torch.where(ok, tt, torch.full_like(tt, INF))
                j = torch.argmin(tt, dim=1)
                tbest = tt.gather(1, j[:, None])[:, 0]
                upd = tbest < cur
            if counts is not None:
                tested = gate.reshape(-1, wk)
                if any_hit:
                    # the kernel returns at the first accepted triangle and
                    # tests none after it
                    last = torch.where(upd, j, torch.full_like(j, wk - 1))
                    tested = tested & (torch.arange(wk, device=dev) <= last[:, None])
                cand = torch.nonzero(tested)
                counts.add_tests(mnode[cand[:, 0]] * wk + cand[:, 1])
            if bool(upd.any()):
                urow, uj = mrow[upd], j[upd]
                g = recs.reshape(-1, wk, 12)[upd, uj, 9:12]
                g_inv = torch.sqrt(g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1]
                                   + g[:, 2] * g[:, 2]).reciprocal()
                dst = rays[urow]
                best[dst] = tbest[upd]
                nrm[dst] = g * g_inv[:, None]
                tri[dst] = qn[node[urow], ibase + uj].to(torch.int32)
                if any_hit:
                    done = urow

        # internal slots that passed: push far→near by slab entry distance;
        # a stable descending sort keeps slot order among equal keys
        # (unordered: slot order). A ray that any-hit ends here: it pushes
        # nothing and its stack empties.
        push = hit & (refs >= 0.0)
        if done is not None:
            push[done] = False
        if ordered:
            skey = torch.where(push, tmin, torch.full_like(tmin, -torch.inf))
            _, order = torch.sort(skey, dim=1, descending=True, stable=True)
        else:
            order = torch.arange(w, device=dev).expand(push.shape[0], w)
        if counts is not None:
            n_push = push.sum(dim=1)
            room = (STACK_MAX - 1 - sp[rays]).clamp_min(0)
            counts.add_pushes(sp[rays] + 1 + torch.minimum(n_push, room),
                              int((n_push - room).clamp_min(0).sum()))
        for i in range(w):
            slot = order[:, i]
            can = push.gather(1, slot[:, None])[:, 0] & (sp[rays] < STACK_MAX - 1)
            if not bool(can.any()):
                continue
            cr, cs = rays[can], slot[can]
            top = sp[cr] + 1
            sp[cr] = top
            stack_n[cr, top] = refs[can, cs].to(torch.int64)
            stack_d[cr, top] = tmin[can, cs]
        if done is not None:
            sp[rays[done]] = -1
    return best, nrm, tri, visits
