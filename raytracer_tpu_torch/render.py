"""Frame rendering on primary rays — the torch counterpart of
``raytracer_tpu/render.py``.

* :func:`render_ldr`, :func:`render_ldr_brute`, :func:`render_frame_u8`: one
  Lambert-shaded frame from a wide tree, from the triangles alone (the
  oracle, and the path of tiny scenes), and as the rgba8 framebuffer.
* :func:`trace_tiles_bounded`: the primary-ray trace with a coarse depth
  probe, per-tile depth bounds and an exact repair pass.
* :func:`trace_tiles_temporal`: the jittered trace bounded by the previous
  sample of the same camera.

Both bounded traces return exactly what the unbounded kernel returns. They
run three launches on a CUDA device — the probe (K1a; none for the temporal
trace), the bounded pass (K1d) and the repair (K2a) — and issue without a
host-device synchronisation: bounds, the repair mask and the repair count
stay on the device.

The JAX package traces :func:`render_ldr` through its XLA while-loop
traversal, fed rays in tile order; the port traces the same frame through the
tile kernel on single-triangle-leaf records of the same tree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops.camera import INF, generate_rays, generate_rays_jittered
from .ops.cuda.traverse import TILE, make_qnodes, trace_rays, trace_tiles
from .ops.shade import quantize_rgba8, shade_lambert, triangle_normals
from .ops.trace import WideBVH, trace_rays_brute

__all__ = ["render_ldr", "render_ldr_brute", "render_frame_u8",
           "trace_tiles_bounded", "trace_tiles_temporal"]


def render_ldr(wide: WideBVH, tris: torch.Tensor, cam_pos, cam_quat, width: int, height: int,
               fov_degrees: float = 70.0):
    """A full primary-ray frame through the tree ``wide`` over the triangles
    ``tris`` (T, 3, 3), on their device → (rgb f32 (H, W, 3), t, tri). The
    tree's leaf refs are triangle indices (one triangle per leaf)."""
    qn = make_qnodes(wide, tris)
    t, _, _, _, tri = trace_tiles(qn, cam_pos, cam_quat, width, height, fov_degrees, leaf_k=1)
    rgb = shade_lambert(triangle_normals(tris, tri), tri >= 0)
    return rgb, t, tri


def render_ldr_brute(tris: torch.Tensor, cam_pos, cam_quat, width: int, height: int,
                     fov_degrees: float = 70.0):
    """The same frame by testing every ray against every triangle (ground
    truth, and the path of scenes too small for a tree)."""
    o, d = generate_rays(width, height, cam_pos, cam_quat, fov_degrees, device=tris.device)
    t, tri = trace_rays_brute(tris, o.reshape(-1, 3), d.reshape(-1, 3))
    t, tri = t.reshape(height, width), tri.reshape(height, width)
    rgb = shade_lambert(triangle_normals(tris, tri), tri >= 0)
    return rgb, t, tri


def render_frame_u8(wide: WideBVH, tris: torch.Tensor, cam_pos, cam_quat, width: int,
                    height: int, fov_degrees: float = 70.0) -> torch.Tensor:
    """The rgba8 framebuffer (H, W, 4) of :func:`render_ldr`."""
    rgb, _, _ = render_ldr(wide, tris, cam_pos, cam_quat, width, height, fov_degrees)
    return quantize_rgba8(rgb)


def _slack(pooled: torch.Tensor, scale: float, pad: float) -> torch.Tensor:
    """Per-tile far bounds from per-tile maximal depths: ``scale``·t +
    ``pad``, and no bound (1e30) where a pixel of the tile missed."""
    return torch.where(pooled >= INF, torch.full_like(pooled, INF), pooled * scale + pad)


def _coarse_bounds(qnodes: torch.Tensor, cam_pos, cam_quat, width: int, height: int,
                   fov_degrees: float, leaf_k: int, coarse_stride: int, scale: float,
                   pad: float) -> torch.Tensor:
    """Pass 1 of :func:`trace_tiles_bounded`: the coarse probe and the far
    bound of every 32-pixel tile of the frame → (⌈H/32⌉, ⌈W/32⌉) f32."""
    nty, ntx = -(-height // TILE), -(-width // TILE)
    per = TILE // coarse_stride  # coarse samples per tile side
    cw, ch = width // coarse_stride, height // coarse_stride
    ct = trace_tiles(qnodes, cam_pos, cam_quat, cw, ch, fov_degrees, leaf_k=leaf_k)[0]
    ct = F.pad(ct, (0, ntx * per - cw, 0, nty * per - ch), value=INF)
    pooled = ct.reshape(nty, per, ntx, per).amax(dim=(1, 3))
    # dilate one tile in every direction (surface slope, misalignment); the
    # frame's border counts as a miss
    dilated = F.max_pool2d(F.pad(pooled, (1, 1, 1, 1), value=INF)[None, None], 3, stride=1)[0, 0]
    return _slack(dilated, scale, pad)


def _temporal_bounds(prev_t: torch.Tensor, prev_tri: torch.Tensor) -> torch.Tensor:
    """The far bound of every 32-pixel tile from the previous sample's (H, W)
    planes: its largest depth in the tile, with the slack of the coarse
    bounds; no bound where a pixel of the tile missed."""
    height, width = prev_t.shape
    ph, pw = -(-height // TILE) * TILE, -(-width // TILE) * TILE
    tv = torch.where(prev_tri >= 0, prev_t, torch.full_like(prev_t, INF))
    # zero padding: a partial tile's bound is the largest depth of its pixels
    tv = F.pad(tv, (0, pw - width, 0, ph - height))
    pooled = tv.reshape(ph // TILE, TILE, pw // TILE, TILE).amax(dim=(1, 3))
    return _slack(pooled, 1.05, 0.02)


def _repair_unbounded(qnodes: torch.Tensor, o: torch.Tensor, d: torch.Tensor, planes,
                      repair_cap: int, leaf_k: int):
    """Re-trace, without a bound, every pixel that found no hit under a
    finite bound, and patch the (t, nx, ny, nz, tri) planes (H, W) of a
    bounded pass → (planes, the number of such pixels as a device tensor).

    Such a pixel carries ``tri < 0`` and ``t`` = its tile's bound, so the mask
    is read off the planes. ``o``, ``d`` (H, W, 3) are the frame's rays: the
    kernel's own, bit for bit. One ray-buffer launch (K2a)
    over all pixels with the mask as its ``active`` lanes repairs them all:
    a lane that is not active costs the kernel one byte read, whereas
    gathering the lanes first would need their count on the host, a
    synchronisation per frame. The JAX package loops over batches of
    ``repair_cap`` lanes because its shapes must be static; here the cap is
    only checked, and the result cannot depend on it."""
    if repair_cap <= 0:
        raise ValueError("repair_cap must be >= 1: a zero cap repairs no lane")
    t, tri = planes[0], planes[4]
    need = (tri < 0) & (t < INF)
    fixed = trace_rays(qnodes, o.reshape(-1, 3).contiguous(), d.reshape(-1, 3), leaf_k=leaf_k,
                       active=need.reshape(-1))
    # a repaired miss is 1e30, as is a miss of a tile without a bound: no
    # bound value is left in t
    out = tuple(torch.where(need, f.reshape(need.shape), p) for f, p in zip(fixed, planes))
    return out, need.sum()


def trace_tiles_bounded(qnodes: torch.Tensor, cam_pos, cam_quat, width: int, height: int,
                        fov_degrees: float = 70.0, leaf_k: int = 1,
                        entries: torch.Tensor | None = None, coarse_stride: int = 8,
                        repair_cap: int = 16384, _bound_scale: float = 1.05,
                        _bound_pad: float = 0.02):
    """Primary-ray trace with coarse depth bounds — the exact image of
    ``trace_tiles`` → ``(t, nx, ny, nz, tri, n_repair)``, t = 1e30 on misses.

    1. **Coarse**: the same frustum at 1/``coarse_stride`` of the resolution.
       Each 32-pixel tile of the frame is covered by a block of coarse
       samples; the largest hit t of the blocks of the tile and its eight
       neighbours, times 1.05 plus 0.02, is the tile's far bound. A coarse
       miss among them leaves the tile without a bound (silhouette and
       background tiles trace as usual).
    2. **Main**: the frame through K1d with the bounds (and ``entries``, if
       given) as each tile's start values: what lies behind the visible
       surface is dropped by the ordinary slab and pop culls.
    3. **Repair**: a pixel with no hit under a finite bound may hit beyond
       it (a ray through a gap the coarse grid did not see). Those pixels
       are traced again without a bound (K2a) and patched; ``n_repair``
       (a 0-d tensor on the device) counts them.

    A hit found under a bound is the true nearest, so only the repaired
    pixels could have been wrong. ``_bound_scale`` / ``_bound_pad`` are test
    knobs: a scale below 1 forces underestimates that the repair must fix."""
    bounds = _coarse_bounds(qnodes, cam_pos, cam_quat, width, height, fov_degrees, leaf_k,
                            coarse_stride, _bound_scale, _bound_pad)
    planes = trace_tiles(qnodes, cam_pos, cam_quat, width, height, fov_degrees, leaf_k=leaf_k,
                         entries=entries, tbounds=bounds)
    o, d = generate_rays(width, height, cam_pos, cam_quat, fov_degrees, device=qnodes.device)
    planes, n_repair = _repair_unbounded(qnodes, o, d, planes, repair_cap, leaf_k)
    return (*planes, n_repair)


def trace_tiles_temporal(qnodes: torch.Tensor, cam_pos, cam_quat, width: int, height: int,
                         prev_t: torch.Tensor, prev_tri: torch.Tensor, jitter_seed: int,
                         fov_degrees: float = 70.0, leaf_k: int = 1, repair_cap: int = 16384):
    """The jittered primary trace (K1b's image for ``jitter_seed``) bounded
    by the previous sample of the same camera → ``(t, nx, ny, nz, tri,
    n_repair)``.

    Successive progressive samples share the camera; only the subpixel
    offsets move. The largest depth of the previous sample in each tile
    (``prev_t``, ``prev_tri`` (H, W); a tile with a missing pixel stays
    unbounded), times 1.05 plus 0.02, bounds the tile in K1d; pixels with no
    hit under a finite bound are repaired as in :func:`trace_tiles_bounded`,
    on the rays of ``generate_rays_jittered``, which are the kernel's. No
    probe is traced: the bound comes from a frame that exists already."""
    bounds = _temporal_bounds(prev_t, prev_tri)
    planes = trace_tiles(qnodes, cam_pos, cam_quat, width, height, fov_degrees, leaf_k=leaf_k,
                         jitter=True, jitter_seed=jitter_seed, tbounds=bounds)
    o, d = generate_rays_jittered(width, height, cam_pos, cam_quat, jitter_seed, fov_degrees,
                                  device=qnodes.device)
    planes, n_repair = _repair_unbounded(qnodes, o, d, planes, repair_cap, leaf_k)
    return (*planes, n_repair)
