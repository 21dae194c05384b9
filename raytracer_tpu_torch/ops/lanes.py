"""The lanes of a progressive sample: the 32×32 tile-block order of a
frame's pixels, and normals turned to face the rays.

Lanes start in tile-block order: TILE×TILE blocks in row-major order, each
block's pixels row-major, partial blocks at the bottom and right edges
packing fewer lanes. It keeps a warp's rays neighbours, and it is the lane
order of the JAX package (``raytracer_tpu/render_pt.py``), so its random
numbers line up lane for lane. ``render_pt`` and the camera wave's kernel
(``ops/cuda/camera.py``) share these functions.
"""

from __future__ import annotations

import torch

__all__ = ["TILE", "lane_of_pixel", "img_to_lanes", "lanes_to_img", "face"]

TILE = 32


def lane_of_pixel(width: int, height: int, device) -> torch.Tensor:
    """(H·W,) lane of each pixel (row-major) in tile-block order. Computed
    on ``device``."""
    y = torch.arange(height, device=device)[:, None]
    x = torch.arange(width, device=device)[None, :]
    by, bx = y // TILE, x // TILE
    block_h = torch.clamp_max(height - by * TILE, TILE)
    block_w = torch.clamp_max(width - bx * TILE, TILE)
    lane = by * (TILE * width) + block_h * bx * TILE + (y % TILE) * block_w + x % TILE
    return lane.reshape(-1)


def _aligned(width: int, height: int) -> bool:
    return width % TILE == 0 and height % TILE == 0


def img_to_lanes(img: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(H, W[, C]) image → (H·W[, C]) lanes in tile-block order: a reshape
    when W and H are multiples of TILE, else a scatter."""
    ch = img.shape[2:]
    if _aligned(width, height):
        a = img.reshape(height // TILE, TILE, width // TILE, TILE, *ch)
        return a.transpose(1, 2).reshape(height * width, *ch)
    lanes = torch.empty((height * width, *ch), dtype=img.dtype, device=img.device)
    lanes[lane_of_pixel(width, height, img.device)] = img.reshape(height * width, *ch)
    return lanes


def lanes_to_img(lanes: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Inverse of :func:`img_to_lanes`: a reshape, or a gather."""
    ch = lanes.shape[1:]
    if _aligned(width, height):
        a = lanes.reshape(height // TILE, width // TILE, TILE, TILE, *ch)
        return a.transpose(1, 2).reshape(height, width, *ch)
    return lanes[lane_of_pixel(width, height, lanes.device)].reshape(height, width, *ch)


def face(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Flip the normals n to face the incoming rays d (a zero normal stays).

    n·d is summed in one stated order, (x + z) + y, on every device: the
    camera wave's kernel (csrc/camera_lanes.cu) sums it so, and where the
    sum cancels the order decides the flip. It is the order of torch's CUDA
    sum of a row of three, so the card's samples are what ``sum(-1)`` gave."""
    p = n * d
    flip = torch.sign(-((p[..., 0:1] + p[..., 2:3]) + p[..., 1:2]))
    return n * torch.where(flip == 0.0, 1.0, flip)
