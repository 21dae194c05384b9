"""The camera wave's lanes (``csrc/camera_lanes.cu``): its wrapper, its
plain torch version and its launch count.

A progressive sample traces its camera wave with the jittered tile kernel
(``traverse.trace_tiles_row``, K1b from the sample's camera row on the
device), which writes (H, W) image planes; the sample's later waves need,
lane by lane in the tile-block order of :mod:`~raytracer_tpu_torch.ops.lanes`,
each ray's direction, its hit's t and triangle, and its normal turned to
face the ray. :func:`camera_lanes` computes those four in one launch on the
card, reading the camera and the jitter seed from the same row when it runs;
its plain version :func:`camera_lanes_reference` composes
``generate_rays_jittered``, ``img_to_lanes`` and ``face``, the same numbers
bit for bit.

A launch adds 1 to ``traverse.LAUNCHES["camera_lanes"]``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..camera import generate_rays_jittered
from ..lanes import face, img_to_lanes
from .traverse import LAUNCHES, check_camera_row

__all__ = ["camera_lanes", "camera_lanes_reference", "load_camera_lanes"]

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def load_camera_lanes() -> tuple[ctypes.CDLL, str]:
    """Build (at first use) and load ``csrc/camera_lanes.cu``; returns
    (library, nvcc log)."""
    from .build import build_library

    lib, log = build_library("camera_lanes.cu")
    lib.rt_camera_lanes.restype = _I
    lib.rt_camera_lanes.argtypes = [_P] + [_I] * 2 + [_P] * 10
    return lib, log


def _check(planes, width: int, height: int) -> None:
    if len(planes) != 5:
        raise ValueError(f"camera_lanes takes K1b's five planes, got {len(planes)}")
    for i, p in enumerate(planes):
        want = torch.int32 if i == 4 else torch.float32
        if tuple(p.shape) != (height, width) or p.dtype != want:
            raise ValueError(f"plane {i} must be ({height}, {width}) {want}, got "
                             f"{tuple(p.shape)} {p.dtype}")
        if p.device != planes[0].device or not p.is_contiguous():
            raise ValueError(f"plane {i} must be contiguous on {planes[0].device}")


def camera_lanes(planes, row: torch.Tensor, width: int, height: int, fov_degrees: float
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1b's planes (t, nx, ny, nz, tri) of a whole ``width`` × ``height``
    frame traced from ``row``, the (16,) f32 camera row on the planes'
    device (``traverse.camera_row`` of the frame, ``fov_degrees`` and the
    jitter seed) → (d (R, 3) f32, t (R,) f32, tri (R,) int32, n (R, 3) f32)
    in tile-block lane order, R = H·W: each lane's jittered ray direction,
    its hit's t and triangle, and its normal turned to face d (negated where
    n·d > 0, as it is where n·d is 0).

    On CUDA planes launches ``camera_lanes_kernel``, which reads the
    quaternion, focal, aspect and seed from the row when it runs, so that a
    CUDA graph that holds the launch serves whatever camera and seed the row
    then holds (the seed must lie in [0, 2^24); the card cannot check it);
    on CPU planes reads the row and runs :func:`camera_lanes_reference`;
    raises for any other device."""
    _check(planes, width, height)
    dev = planes[0].device
    camera = check_camera_row(row, dev)
    if camera is not None:  # on the CPU
        _, quat, seed = camera
        return camera_lanes_reference(planes, quat, width, height, fov_degrees, seed)
    if dev.type != "cuda":
        raise ValueError(f"camera_lanes runs on cuda or cpu tensors, got {dev}")
    lib, _ = load_camera_lanes()
    r = width * height
    d = torch.empty((r, 3), dtype=torch.float32, device=dev)
    n = torch.empty((r, 3), dtype=torch.float32, device=dev)
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    tri = torch.empty((r,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rt_camera_lanes(row.data_ptr(), width, height,
                                  *(p.data_ptr() for p in planes), d.data_ptr(), t.data_ptr(),
                                  tri.data_ptr(), n.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"camera_lanes launch failed: cudaError {err}")
    LAUNCHES["camera_lanes"] += 1
    return d, t, tri, n


def camera_lanes_reference(planes, cam_quat, width: int, height: int, fov_degrees: float,
                           pseed: int
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain torch version of :func:`camera_lanes`, on the planes'
    device: the rays of ``generate_rays_jittered`` and the planes put in
    lane order by ``img_to_lanes``, the normals turned by ``face``."""
    # the rays' origins (the camera's position) are not an output: any will do
    d = img_to_lanes(generate_rays_jittered(width, height, (0.0, 0.0, 0.0), cam_quat, pseed,
                                            fov_degrees, device=planes[0].device)[1],
                     width, height)
    t, nx, ny, nz, tri = (img_to_lanes(p, width, height) for p in planes)
    return d, t, tri, face(torch.stack([nx, ny, nz], dim=-1), d)
