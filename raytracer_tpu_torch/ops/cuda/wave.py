"""The progressive sample's wave glue (``csrc/wave_glue.cu``): its
wrappers, their plain torch versions and their launch counts.

Between its traversal waves a progressive sample (``render_pt.
pt_sample_frame``) shades every lane: after each closest-hit wave it turns
the normals to face the rays, adds the miss term, and sets up the NEE
shadow ray (:func:`wave_hit`); after each shadow wave it adds the direct
light and draws the cosine-weighted bounce (:func:`wave_bounce`), or, on the
sample's last wave, adds the direct light and the sky term of the paths
still alive and returns the radiance in pixel order (:func:`wave_last`). On
CUDA tensors each is one launch of a hand-written kernel; on CPU tensors it
runs its plain version (:func:`wave_hit_reference`,
:func:`wave_bounce_reference`, :func:`wave_last_reference`), the torch ops
the sample ran before the kernels, whose numbers the kernels give bit for
bit on the card.

A launch adds 1 to ``traverse.LAUNCHES["wave_hit"]``, or to
``["wave_bounce"]`` (:func:`wave_bounce` and :func:`wave_last` alike).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..camera import to_device
from ..lanes import face, lanes_to_img
from .traverse import LAUNCHES

__all__ = ["wave_hit", "wave_hit_reference", "wave_bounce", "wave_bounce_reference",
           "wave_last", "wave_last_reference", "blocked", "cosine_sample",
           "load_wave_glue"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


@functools.cache
def load_wave_glue() -> tuple[ctypes.CDLL, str]:
    """Build (at first use) and load ``csrc/wave_glue.cu``; returns
    (library, nvcc log)."""
    from .build import build_library

    lib, log = build_library("wave_glue.cu")
    lib.rt_wave_hit.restype = _I
    lib.rt_wave_hit.argtypes = ([_I] + [_P] * 5 + [_I, _P, _I] + [_P] * 4 + [_F] * 5
                                + [_P] * 7)
    lib.rt_wave_bounce.restype = _I
    lib.rt_wave_bounce.argtypes = [_I] * 4 + [_P] * 8 + [_I] + [_P] * 3 + [_F] * 4 + [_P] * 6
    return lib, log


def _onb(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Orthonormal basis around the normals n (Frisvad-style, branchless)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + s * (nx * nx) * a, s * b, -s * nx], dim=-1)
    bt = torch.stack([b, s + (ny * ny) * a, -ny], dim=-1)
    return t, bt


def cosine_sample(n: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere directions around the normals n."""
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    t, bt = _onb(n)
    return t * x[..., None] + bt * y[..., None] + n * z[..., None]


def blocked(occ: torch.Tensor) -> torch.Tensor:
    """The shadow wave's occlusion mask from K2b's triangle plane ``occ``
    (blocked where ≥ 0); a bool ``occ`` is the mask itself (the plain
    versions take either)."""
    return occ if occ.dtype == _BOOL else occ >= 0


def _check(name: str, x: torch.Tensor, shape: tuple, dtypes, dev, strides=None) -> None:
    """Refuse ``x`` unless it has ``shape``, one of ``dtypes`` and ``dev``, and
    is contiguous, or (``strides``) has one of those strides."""
    if tuple(x.shape) != shape or x.dtype not in dtypes or x.device != dev:
        raise ValueError(f"{name} must be {shape} {dtypes[0]} on {dev}, got {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    if not (x.is_contiguous() if strides is None else x.stride() in strides):
        raise ValueError(f"{name} must be {'contiguous' if strides is None else strides}, got "
                         f"strides {x.stride()}")


def _check_lanes(occ, hit, ndotl, throughput, radiance) -> tuple[int, torch.device]:
    """The inputs that the bounce kernel reads on every wave → (R, device)."""
    dev, r = radiance.device, radiance.shape[0] if radiance.dim() else -1
    _check("radiance", radiance, (r, 3), (_F32,), dev)
    _check("throughput", throughput, (r, 3), (_F32,), dev)
    # a bool occ (the occlusion mask) only for the plain versions
    _check("occ", occ, (r,), (_I32,) if dev.type == "cuda" else (_I32, _BOOL), dev)
    _check("hit", hit, (r,), (_BOOL,), dev)
    _check("ndotl", ndotl, (r,), (_F32,), dev)
    return r, dev


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def wave_hit(t: torch.Tensor, tri: torch.Tensor, n, o: torch.Tensor, d: torch.Tensor,
             alive: torch.Tensor, throughput: torch.Tensor, radiance: torch.Tensor, *,
             sun, env: float, eps: float):
    """The shading after a closest-hit wave of R lanes: its t (R,) f32 and
    tri (R,) int32 planes and its normals ``n``, three (R,) f32 planes of
    one stride (K2a's planes, or the columns of an (R, 3) array), unturned;
    the wave's rays o (R, 3) f32 (contiguous, or one point broadcast:
    strides (0, 1)) and d (R, 3); the paths' alive (R,) bool, throughput and
    radiance (R, 3) f32; the sun's unit direction ``sun`` (3 floats), the
    miss term ``env`` and the shadow ray's offset ``eps`` →

    (n (R, 3), the normals turned to face d (ops/lanes.py::face); hit (R,)
    bool, tri ≥ 0 and alive; radiance (R, 3) plus throughput·env where a
    live lane missed; p (R, 3) = (o + d·t) + n·eps, the shadow rays'
    origins; ndotl (R,) = max(n·sun, 0); nee (R,) bool, hit and ndotl > 0:
    the lanes that cast a shadow ray).

    On CUDA tensors launches ``wave_hit_kernel``; on CPU tensors runs
    :func:`wave_hit_reference`; raises for any other device."""
    dev, r = d.device, d.shape[0] if d.dim() else -1
    _check("d", d, (r, 3), (_F32,), dev)
    _check("t", t, (r,), (_F32,), dev)
    _check("tri", tri, (r,), (_I32,), dev)
    if len(n) != 3:
        raise ValueError(f"n must be three planes (nx, ny, nz), got {len(n)}")
    for name, plane in zip(("nx", "ny", "nz"), n):
        _check(name, plane, (r,), (_F32,), dev, strides=(n[0].stride(),))
    _check("o", o, (r, 3), (_F32,), dev, strides=((3, 1), (0, 1)))
    _check("alive", alive, (r,), (_BOOL,), dev)
    _check("throughput", throughput, (r, 3), (_F32,), dev)
    _check("radiance", radiance, (r, 3), (_F32,), dev)
    if dev.type == "cpu":
        return wave_hit_reference(t, tri, n, o, d, alive, throughput, radiance, sun=sun,
                                  env=env, eps=eps)
    if dev.type != "cuda":
        raise ValueError(f"wave_hit runs on cuda or cpu tensors, got {dev}")
    lib, _ = load_wave_glue()
    n_out, rad_out, p = (torch.empty((r, 3), dtype=_F32, device=dev) for _ in range(3))
    ndotl = torch.empty((r,), dtype=_F32, device=dev)
    hit, nee = (torch.empty((r,), dtype=_BOOL, device=dev) for _ in range(2))
    with torch.cuda.device(dev):
        err = lib.rt_wave_hit(r, t.data_ptr(), tri.data_ptr(), *(c.data_ptr() for c in n),
                              n[0].stride(0), o.data_ptr(), o.stride(0), d.data_ptr(),
                              alive.data_ptr(), throughput.data_ptr(), radiance.data_ptr(),
                              *sun, env, eps, n_out.data_ptr(), hit.data_ptr(),
                              rad_out.data_ptr(), p.data_ptr(), ndotl.data_ptr(),
                              nee.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"wave_hit launch failed: cudaError {err}")
    LAUNCHES["wave_hit"] += 1
    return n_out, hit, rad_out, p, ndotl, nee


def wave_hit_reference(t, tri, n, o, d, alive, throughput, radiance, *, sun, env: float,
                       eps: float):
    """The plain torch version of :func:`wave_hit`, on the inputs' device."""
    n = face(torch.stack(n, dim=-1), d)
    hit = (tri >= 0) & alive
    miss = (tri < 0) & alive
    radiance = radiance + torch.where(miss[:, None], throughput * env, 0.0)
    p = o + d * t[:, None] + n * eps
    ndotl = torch.clamp_min((n * to_device(sun, d.device)).sum(-1), 0.0)
    nee = hit & (ndotl > 0.0)
    return n, hit, radiance, p, ndotl, nee


def wave_bounce(occ: torch.Tensor, hit: torch.Tensor, ndotl: torch.Tensor,
                throughput: torch.Tensor, radiance: torch.Tensor, n: torch.Tensor,
                p: torch.Tensor, o: torch.Tensor, d: torch.Tensor, u1: torch.Tensor,
                u2: torch.Tensor, *, base):
    """The shading after a shadow wave of R lanes that is not the sample's
    last: K2b's triangle plane ``occ`` (R,) int32 (blocked where ≥ 0), the
    wave's hit, ndotl, n and p from :func:`wave_hit`, its throughput,
    radiance, o (contiguous or broadcast) and d, the draws u1 and u2 (R,)
    f32, and the albedo ``base`` (3 floats) →

    (o, d (R, 3): where hit, p and a cosine-weighted direction around n
    (:func:`cosine_sample`), else as they were; throughput (R, 3) times
    base where hit; alive (R,) bool = hit; radiance (R, 3) plus
    throughput·(base·(ndotl·unoccluded)) where hit).

    On CUDA tensors launches ``wave_bounce_kernel``; on CPU tensors runs
    :func:`wave_bounce_reference`; raises for any other device."""
    r, dev = _check_lanes(occ, hit, ndotl, throughput, radiance)
    for name, x in (("n", n), ("p", p), ("d", d)):
        _check(name, x, (r, 3), (_F32,), dev)
    _check("o", o, (r, 3), (_F32,), dev, strides=((3, 1), (0, 1)))
    _check("u1", u1, (r,), (_F32,), dev)
    _check("u2", u2, (r,), (_F32,), dev)
    if dev.type == "cpu":
        return wave_bounce_reference(occ, hit, ndotl, throughput, radiance, n, p, o, d, u1, u2,
                                     base=base)
    if dev.type != "cuda":
        raise ValueError(f"wave_bounce runs on cuda or cpu tensors, got {dev}")
    o_out, d_out, thr_out, rad_out = (torch.empty((r, 3), dtype=_F32, device=dev)
                                      for _ in range(4))
    alive = torch.empty((r,), dtype=_BOOL, device=dev)
    _launch_bounce(r, 0, 0, 0, occ, hit, ndotl, throughput, radiance,
                   (n.data_ptr(), p.data_ptr(), o.data_ptr(), o.stride(0), d.data_ptr(),
                    u1.data_ptr(), u2.data_ptr()), base, 0.0,
                   (o_out.data_ptr(), d_out.data_ptr(), thr_out.data_ptr(), alive.data_ptr()),
                   rad_out)
    return o_out, d_out, thr_out, alive, rad_out


def wave_last(occ: torch.Tensor, hit: torch.Tensor, ndotl: torch.Tensor,
              throughput: torch.Tensor, radiance: torch.Tensor, *, base, sky: float,
              size: tuple[int, int] | None = None) -> torch.Tensor:
    """The shading after the sample's last shadow wave: as
    :func:`wave_bounce`, the direct light where hit, then the sky's
    radiance ``sky`` times the new throughput of the paths still alive
    (hit) → the sample's radiance (R, 3) in lane order, or with ``size`` =
    (W, H), R = W·H, the (H, W, 3) image (:func:`ops.lanes.lanes_to_img`
    of the lanes).

    On CUDA tensors launches ``wave_bounce_kernel`` in its last-wave form;
    on CPU tensors runs :func:`wave_last_reference`; raises for any other
    device."""
    r, dev = _check_lanes(occ, hit, ndotl, throughput, radiance)
    width, height = (0, 0) if size is None else (int(size[0]), int(size[1]))
    if size is not None and (width <= 0 or height <= 0 or width * height != r):
        raise ValueError(f"size must be (W, H) with W·H = {r} lanes, got {size}")
    if dev.type == "cpu":
        return wave_last_reference(occ, hit, ndotl, throughput, radiance, base=base, sky=sky,
                                   size=size)
    if dev.type != "cuda":
        raise ValueError(f"wave_last runs on cuda or cpu tensors, got {dev}")
    out = torch.empty((r, 3) if size is None else (height, width, 3), dtype=_F32, device=dev)
    # the last wave reads no ray, normal or draw and writes the radiance alone
    _launch_bounce(r, 1, width, height, occ, hit, ndotl, throughput, radiance,
                   (None, None, None, 3, None, None, None), base, sky, (None,) * 4, out)
    return out


def _launch_bounce(r, last, width, height, occ, hit, ndotl, throughput, radiance, rays, base,
                   sky, outs, rad_out) -> None:
    lib, _ = load_wave_glue()
    dev = radiance.device
    with torch.cuda.device(dev):
        err = lib.rt_wave_bounce(r, last, width, height, occ.data_ptr(), hit.data_ptr(),
                                 ndotl.data_ptr(), throughput.data_ptr(), radiance.data_ptr(),
                                 *rays, *base, sky, *outs, rad_out.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"wave_bounce launch failed: cudaError {err}")
    LAUNCHES["wave_bounce"] += 1


def _direct(occ, hit, ndotl, throughput, radiance, base):
    """The direct light added where hit, and the throughput of the next
    wave: the plain versions' common part."""
    base = to_device(base, radiance.device)
    direct = base * (ndotl * (~blocked(occ)).to(_F32))[:, None]
    radiance = radiance + torch.where(hit[:, None], throughput * direct, 0.0)
    return radiance, torch.where(hit[:, None], throughput * base, throughput)


def wave_bounce_reference(occ, hit, ndotl, throughput, radiance, n, p, o, d, u1, u2, *, base):
    """The plain torch version of :func:`wave_bounce`, on the inputs'
    device; ``occ`` may also be the bool occlusion mask."""
    radiance, throughput = _direct(occ, hit, ndotl, throughput, radiance, base)
    new_d = cosine_sample(n, u1, u2)
    o = torch.where(hit[:, None], p, o)
    d = torch.where(hit[:, None], new_d, d)
    return o, d, throughput, hit, radiance


def wave_last_reference(occ, hit, ndotl, throughput, radiance, *, base, sky: float,
                        size: tuple[int, int] | None = None) -> torch.Tensor:
    """The plain torch version of :func:`wave_last`, on the inputs' device;
    ``occ`` may also be the bool occlusion mask."""
    radiance, throughput = _direct(occ, hit, ndotl, throughput, radiance, base)
    radiance = radiance + torch.where(hit[:, None], throughput * sky, 0.0)
    return radiance if size is None else lanes_to_img(radiance, *size)
