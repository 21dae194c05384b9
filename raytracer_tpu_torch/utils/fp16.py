"""FP16 codecs for the packed BVH bounds — NumPy on the host, torch on tensors.

The BVH stores every AABB as IEEE fp16 pairs packed into u32 words
(``[pack(mn.x,mn.y), pack(mn.z,mx.x), pack(mx.y,mx.z)]``). The NumPy decoders
are copies of ``raytracer_tpu/utils/fp16.py``; the torch functions are the
counterparts of ``raytracer_tpu/ops/fp16_jax.py``: the decoder
:func:`unpack_bounds` and the encoders :func:`pack16x2`, :func:`pack_bounds`,
:func:`increment_f16` and :func:`pack_bounds_conservative`. All are
bit-exact: fp16 → f32 is exact, and f32 → fp16 is ``.to(torch.float16)``,
which rounds to nearest even and keeps subnormals, as XLA's convert does.

Torch has no full uint32 arithmetic, so tensors carry u32 words as int64.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["f16_bits_to_f32", "unpack16x2", "unpack_bounds_u32", "unpack_bounds",
           "f32_to_f16_bits", "pack16x2", "increment_f16", "pack_bounds",
           "pack_bounds_conservative"]


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


def _f16_bits_to_f32_t(bits: torch.Tensor) -> torch.Tensor:
    """int64 tensor of fp16 bit patterns (0..0xFFFF) → f32."""
    # to int16 without relying on the overflow behaviour of the cast
    bits = torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16)
    return bits.view(torch.float16).to(torch.float32)


def _unpack16x2_t(u: torch.Tensor, idx: int) -> torch.Tensor:
    return _f16_bits_to_f32_t((u >> (16 * idx)) & 0xFFFF)


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


def f32_to_f16_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 → fp16 bit pattern (round to nearest even) as int64 in [0, 2^16)."""
    return x.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF


def pack16x2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two f32 → one u32 word (int64): lo = fp16(a), hi = fp16(b)."""
    return f32_to_f16_bits(a) | (f32_to_f16_bits(b) << 16)


def increment_f16(value: torch.Tensor, up: bool, iterations: int = 1) -> torch.Tensor:
    """Round to fp16, step ±``iterations`` ULPs in ordered-u16 space (monotonic
    across ±0 and signs), back to f32. ``~bits`` of an int64 is negative, so
    every step is masked to 16 bits, as the JAX package masks its uint32."""
    bits = f32_to_f16_bits(value)
    sign = (bits & 0x8000) != 0
    ordv = torch.where(sign, (~bits) & 0xFFFF, bits ^ 0x8000)
    ordv = (ordv + iterations if up else ordv - iterations) & 0xFFFF
    ord_sign = (ordv & 0x8000) != 0
    bits2 = torch.where(ord_sign, ordv ^ 0x8000, (~ordv) & 0xFFFF)
    return _f16_bits_to_f32_t(bits2)


def pack_bounds(mn: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """AABB (..., 3) min/max f32 → (..., 3) u32 words (int64):
    [pack(mn.x,mn.y), pack(mn.z,mx.x), pack(mx.y,mx.z)]."""
    return torch.stack([pack16x2(mn[..., 0], mn[..., 1]), pack16x2(mn[..., 2], mx[..., 0]),
                        pack16x2(mx[..., 1], mx[..., 2])], dim=-1)


def pack_bounds_conservative(mn: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """Expand min down and max up by exactly one fp16 ULP, then pack."""
    return pack_bounds(increment_f16(mn, False, 1), increment_f16(mx, True, 1))
