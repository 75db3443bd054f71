"""Quantization format descriptors.

Block formats are wire/file-compatible with the reference engine
(ref: src/quants.hpp:6-24):

  Q40: 32 values -> f16 scale + 16 packed nibble bytes  = 18 bytes
  Q80: 32 values -> f16 scale + 32 int8 bytes           = 34 bytes
"""

from __future__ import annotations

import enum

BLOCK_SIZE = 32
Q40_BLOCK_BYTES = 2 + BLOCK_SIZE // 2  # 18
Q80_BLOCK_BYTES = 2 + BLOCK_SIZE      # 34


class FloatType(enum.IntEnum):
    """On-file float types (ref: src/quants.hpp:6-11)."""

    F32 = 0
    F16 = 1
    Q40 = 2
    Q80 = 3


def numbers_per_batch(ftype: FloatType) -> int:
    """Granularity of a format (ref: src/quants.cpp:11-24)."""
    if ftype in (FloatType.F32, FloatType.F16):
        return 1
    return BLOCK_SIZE


def batch_bytes(ftype: FloatType, n: int, d: int) -> int:
    """Bytes of an (n x d) tensor in the given format (ref: src/quants.cpp:26-47)."""
    if ftype == FloatType.F32:
        return n * d * 4
    if ftype == FloatType.F16:
        return n * d * 2
    if ftype == FloatType.Q40:
        assert n % BLOCK_SIZE == 0, n
        return (n // BLOCK_SIZE) * d * Q40_BLOCK_BYTES
    if ftype == FloatType.Q80:
        assert n % BLOCK_SIZE == 0, n
        return (n // BLOCK_SIZE) * d * Q80_BLOCK_BYTES
    raise ValueError(f"unsupported float type {ftype}")


def parse_float_type(name: str) -> FloatType:
    try:
        return FloatType[name.upper()]
    except KeyError:
        raise ValueError(f"unknown float type {name!r} (expected f32/f16/q40/q80)")
