"""FP16 codecs for the packed BVH bounds — NumPy on the host, torch on tensors.

The BVH stores every AABB as IEEE fp16 pairs packed into u32 words
(``[pack(mn.x,mn.y), pack(mn.z,mx.x), pack(mx.y,mx.z)]``). The NumPy decoders
are copies of ``raytracer_tpu/utils/fp16.py``; :func:`unpack_bounds` is the
torch counterpart of ``raytracer_tpu/ops/fp16_jax.py::unpack_bounds``. All
are bit-exact: fp16 → f32 is exact, so only the bit plumbing has to agree.

Torch has no full uint32 arithmetic, so tensors carry u32 words as int64.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["f16_bits_to_f32", "unpack16x2", "unpack_bounds_u32", "unpack_bounds"]


def f16_bits_to_f32(bits) -> np.ndarray:
    """f16 bit pattern → f32, handling subnormals/inf/nan."""
    bits = np.asarray(bits, dtype=np.uint16)
    return bits.view(np.float16).astype(np.float32)


def unpack16x2(u, idx: int) -> np.ndarray:
    """Extract fp16 lane ``idx`` (0=lo, 1=hi) of a packed u32 → f32."""
    u = np.asarray(u, dtype=np.uint32)
    bits = ((u >> np.uint32(16 * idx)) & np.uint32(0xFFFF)).astype(np.uint16)
    return f16_bits_to_f32(bits)


def unpack_bounds_u32(b) -> tuple[np.ndarray, np.ndarray]:
    """(..., 3) u32 → (min, max) f32 (..., 3)."""
    b = np.asarray(b, dtype=np.uint32)
    mn = np.stack(
        [unpack16x2(b[..., 0], 0), unpack16x2(b[..., 0], 1), unpack16x2(b[..., 1], 0)],
        axis=-1,
    )
    mx = np.stack(
        [unpack16x2(b[..., 1], 1), unpack16x2(b[..., 2], 0), unpack16x2(b[..., 2], 1)],
        axis=-1,
    )
    return mn, mx


def _unpack16x2_t(u: torch.Tensor, idx: int) -> torch.Tensor:
    bits = (u >> (16 * idx)) & 0xFFFF
    # to int16 without relying on the overflow behaviour of the cast
    bits = torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16)
    return bits.view(torch.float16).to(torch.float32)


def unpack_bounds(b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 3) int64 tensor of u32 words → (min, max) f32 (..., 3)."""
    mn = torch.stack(
        [_unpack16x2_t(b[..., 0], 0), _unpack16x2_t(b[..., 0], 1),
         _unpack16x2_t(b[..., 1], 0)],
        dim=-1,
    )
    mx = torch.stack(
        [_unpack16x2_t(b[..., 1], 1), _unpack16x2_t(b[..., 2], 0),
         _unpack16x2_t(b[..., 2], 1)],
        dim=-1,
    )
    return mn, mx
