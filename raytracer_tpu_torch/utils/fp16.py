"""FP16 codecs for the packed BVH bounds — NumPy on the host, torch on tensors.

The BVH stores every AABB as IEEE fp16 pairs packed into u32 words
(``[pack(mn.x,mn.y), pack(mn.z,mx.x), pack(mx.y,mx.z)]``). The NumPy codec
is a copy of ``raytracer_tpu/utils/fp16.py`` (its ``increment_f16`` is
:func:`increment_f16_np` here); the torch functions are the
counterparts of ``raytracer_tpu/ops/fp16_jax.py``: the decoder
:func:`unpack_bounds` and the encoders :func:`pack16x2`, :func:`pack_bounds`,
:func:`increment_f16` and :func:`pack_bounds_conservative`. All are
bit-exact: fp16 → f32 is exact, and f32 → fp16 is ``.to(torch.float16)``,
which rounds to nearest even and keeps subnormals, as XLA's convert does.
The decoder gives an fp16 NaN XLA's f32 bits on every device: a box
beyond the fp16 range steps its ±inf to an fp16 NaN, which the sweeps of
``ops/lbvh.py`` then carry up the tree.

Torch has no full uint32 arithmetic, so tensors carry u32 words as int64.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["f32_to_f16_bits_rne", "f32_to_f16_bits_trunc", "f16_bits_to_f32", "pack16x2_rne",
           "pack16x2_trunc", "unpack16x2", "f16_ordered_from_bits", "f16_bits_from_ordered",
           "increment_f16_np", "pack_bounds_u32", "unpack_bounds_u32", "unpack_bounds",
           "f32_to_f16_bits", "pack16x2", "increment_f16_bits", "increment_f16", "pack_bounds",
           "pack_bounds_conservative"]


def f32_to_f16_bits_rne(x) -> np.ndarray:
    """f32 → f16 bit pattern with IEEE round-to-nearest-even."""
    x = np.asarray(x, dtype=np.float32)
    return x.astype(np.float16).view(np.uint16)


def f32_to_f16_bits_trunc(x) -> np.ndarray:
    """f32 → f16 bit pattern, truncating: drop mantissa bits; exp <= 0 →
    signed zero (subnormals flush); exp >= 31 → signed infinity."""
    x = np.asarray(x, dtype=np.float32)
    u = x.view(np.uint32)
    s = ((u >> np.uint32(16)) & np.uint32(0x8000)).astype(np.uint32)
    e = ((u >> np.uint32(23)) & np.uint32(0xFF)).astype(np.int32) - 112
    m = ((u >> np.uint32(13)) & np.uint32(0x03FF)).astype(np.uint32)
    out = np.where(
        e <= 0,
        s,
        np.where(
            e >= 31,
            s | np.uint32(0x7C00),
            s | (e.astype(np.uint32) << np.uint32(10)) | m,
        ),
    )
    return out.astype(np.uint16)


def f16_bits_to_f32(bits) -> np.ndarray:
    """f16 bit pattern → f32, handling subnormals/inf/nan."""
    bits = np.asarray(bits, dtype=np.uint16)
    return bits.view(np.float16).astype(np.float32)


def pack16x2_rne(a, b) -> np.ndarray:
    """Two f32 → one u32 as (lo=a, hi=b) fp16, RNE rounding."""
    lo = f32_to_f16_bits_rne(a).astype(np.uint32)
    hi = f32_to_f16_bits_rne(b).astype(np.uint32)
    return lo | (hi << np.uint32(16))


def pack16x2_trunc(a, b) -> np.ndarray:
    """Two f32 → one u32 through the truncating codec."""
    lo = f32_to_f16_bits_trunc(a).astype(np.uint32)
    hi = f32_to_f16_bits_trunc(b).astype(np.uint32)
    return lo | (hi << np.uint32(16))


def unpack16x2(u, idx: int) -> np.ndarray:
    """Extract fp16 lane ``idx`` (0=lo, 1=hi) of a packed u32 → f32."""
    u = np.asarray(u, dtype=np.uint32)
    bits = ((u >> np.uint32(16 * idx)) & np.uint32(0xFFFF)).astype(np.uint16)
    return f16_bits_to_f32(bits)


def f16_ordered_from_bits(bits):
    """fp16 bit patterns → a monotonically ordered u16 space: negative
    values map to ~bits, positive to bits ^ 0x8000."""
    bits = np.asarray(bits, dtype=np.uint32) & np.uint32(0xFFFF)
    sign = (bits & np.uint32(0x8000)) != 0
    return np.where(sign, (~bits) & np.uint32(0xFFFF), bits ^ np.uint32(0x8000))


def f16_bits_from_ordered(ordv):
    """Inverse of :func:`f16_ordered_from_bits`."""
    ordv = np.asarray(ordv, dtype=np.uint32) & np.uint32(0xFFFF)
    ord_sign = (ordv & np.uint32(0x8000)) != 0
    return np.where(ord_sign, ordv ^ np.uint32(0x8000), (~ordv) & np.uint32(0xFFFF))


def increment_f16_np(value, up: bool, iterations: int = 1) -> np.ndarray:
    """Round f32 to fp16 (RNE), step ±``iterations`` fp16 ULPs in ordered
    space, back to f32 (NumPy; :func:`increment_f16` is the torch one)."""
    bits = f32_to_f16_bits_rne(value).astype(np.uint32)
    ordv = f16_ordered_from_bits(bits)
    step = np.asarray(iterations, dtype=np.uint32)
    ordv = (ordv + step) & np.uint32(0xFFFF) if up else (ordv - step) & np.uint32(0xFFFF)
    bits2 = f16_bits_from_ordered(ordv).astype(np.uint16)
    return f16_bits_to_f32(bits2)


def pack_bounds_u32(mn, mx, *, trunc: bool = False) -> np.ndarray:
    """AABB (min, max each (..., 3)) → 3 u32 words
    [pack(mn.x,mn.y), pack(mn.z,mx.x), pack(mx.y,mx.z)], no ULP expansion."""
    pack = pack16x2_trunc if trunc else pack16x2_rne
    mn = np.asarray(mn, dtype=np.float32)
    mx = np.asarray(mx, dtype=np.float32)
    b0 = pack(mn[..., 0], mn[..., 1])
    b1 = pack(mn[..., 2], mx[..., 0])
    b2 = pack(mx[..., 1], mx[..., 2])
    return np.stack([b0, b1, b2], axis=-1)


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


def _xla_f16_decode_table() -> np.ndarray:
    """f32 bits of every fp16 pattern as XLA converts them: values exactly,
    a NaN to the quiet f32 NaN with its sign and its payload moved up
    (0x7FC00000 | mantissa << 13). Torch's own half → float gives some NaNs
    other bits, and not the same on every device."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    table = bits.astype(np.uint16).view(np.float16).astype(np.float32).view(np.uint32)
    nan = ((bits & 0x7C00) == 0x7C00) & ((bits & 0x3FF) != 0)
    return np.where(nan, ((bits & 0x8000) << 16) | 0x7FC00000 | ((bits & 0x3FF) << 13), table)


_DECODE_TABLES: dict[torch.device, torch.Tensor] = {}


def _f16_bits_to_f32_t(bits: torch.Tensor) -> torch.Tensor:
    """int64 tensor of fp16 bit patterns (0..0xFFFF) → f32, as XLA converts
    them (:func:`_xla_f16_decode_table`): one gather from a 256 KiB table
    kept on each device."""
    table = _DECODE_TABLES.get(bits.device)
    if table is None:
        table = torch.from_numpy(_xla_f16_decode_table().view(np.int32)).to(bits.device)
        table = _DECODE_TABLES.setdefault(bits.device, table.view(torch.float32))
    return table[bits]


def _halfwords(b: torch.Tensor) -> torch.Tensor:
    """(..., 3) u32 words (int64) of packed AABBs → (..., 6) fp16 bit
    patterns [mn.x, mn.y, mn.z, mx.x, mx.y, mx.z]; :func:`_pack_halfwords`
    is the inverse."""
    return torch.stack([b, b >> 16], dim=-1).flatten(-2) & 0xFFFF


def _pack_halfwords(h: torch.Tensor) -> torch.Tensor:
    """(..., 6) fp16 bit patterns of an AABB's min and max → (..., 3) u32
    words (int64): [mn.x | mn.y << 16, mn.z | mx.x << 16, mx.y | mx.z << 16]."""
    return h[..., 0::2] | (h[..., 1::2] << 16)


def unpack_bounds(b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 3) int64 tensor of u32 words → (min, max) f32 (..., 3)."""
    f = _f16_bits_to_f32_t(_halfwords(b))
    return f[..., :3], f[..., 3:]


def f32_to_f16_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 → fp16 bit pattern (round to nearest even) as int64 in [0, 2^16)."""
    return x.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF


def pack16x2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two f32 → one u32 word (int64): lo = fp16(a), hi = fp16(b)."""
    return f32_to_f16_bits(a) | (f32_to_f16_bits(b) << 16)


def increment_f16_bits(value: torch.Tensor, up: bool, iterations: int = 1) -> torch.Tensor:
    """Round to fp16, step ±``iterations`` ULPs in ordered-u16 space (monotonic
    across ±0 and signs) → the fp16 bit patterns (int64). ``~bits`` of an
    int64 is negative, so every step is masked to 16 bits, as the JAX
    package masks its uint32. A step up from +inf (down from −inf) gives the
    signalling NaN 0x7C01 (0xFC01)."""
    bits = f32_to_f16_bits(value)
    sign = (bits & 0x8000) != 0
    ordv = torch.where(sign, (~bits) & 0xFFFF, bits ^ 0x8000)
    ordv = (ordv + iterations if up else ordv - iterations) & 0xFFFF
    ord_sign = (ordv & 0x8000) != 0
    return torch.where(ord_sign, ordv ^ 0x8000, (~ordv) & 0xFFFF)


def increment_f16(value: torch.Tensor, up: bool, iterations: int = 1) -> torch.Tensor:
    """:func:`increment_f16_bits`, back to f32."""
    return _f16_bits_to_f32_t(increment_f16_bits(value, up, iterations))


def pack_bounds(mn: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """AABB (..., 3) min/max f32 → (..., 3) u32 words (int64):
    [pack(mn.x,mn.y), pack(mn.z,mx.x), pack(mx.y,mx.z)]."""
    return _pack_halfwords(f32_to_f16_bits(torch.cat([mn, mx], dim=-1)))


def pack_bounds_conservative(mn: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """Expand min down and max up by exactly one fp16 ULP, then pack — as
    the JAX package computes it inside ``jit`` (every build and refit is
    jitted): XLA drops the fp16 → f32 → fp16 round trip between the step
    and the pack, so the stepped halfwords are packed as they are, and a
    box beyond the fp16 range keeps the signalling NaN 0x7C01 / 0xFC01
    (``fp16_jax.pack_bounds_conservative`` called op by op makes it quiet,
    0x7E01)."""
    return _pack_halfwords(torch.cat([increment_f16_bits(mn, False),
                                      increment_f16_bits(mx, True)], dim=-1))
