"""Host-side (numpy) Q40/Q80 block codecs.

Encoders follow the reference converter (ref: converter/writer.py:26-75) —
including the asymmetric `+8.5` offset with clamp-to-15 on Q40 — and decoders
follow the reference engine (ref: src/quants.cpp:133-180, 266-284), so bytes
produced here are loadable by the reference and vice versa.

All codecs are fully vectorized; these run at model-load time (the device-side
hot path lives in torch_codec.py / ops/matmul.py).
"""

from __future__ import annotations

import numpy as np

from .types import BLOCK_SIZE, Q40_BLOCK_BYTES, Q80_BLOCK_BYTES

_HALF = BLOCK_SIZE // 2


def quantize_q40(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f32 (..., n) -> (scales f16 (..., n/32), packed uint8 (..., n/32, 16)).

    Matches converter/writer.py:26-54: scale = max-magnitude/-8 (sign kept),
    q = trunc(clip(x/scale + 8.5, None, 15)).
    """
    x = np.asarray(x, dtype=np.float32)
    assert x.shape[-1] % BLOCK_SIZE == 0, x.shape
    groups = x.reshape(*x.shape[:-1], -1, BLOCK_SIZE)
    gmax = groups.max(axis=-1)
    gmin = groups.min(axis=-1)
    deltas = np.where(-gmin > gmax, gmin, gmax) / -8.0
    inv = np.where(deltas != 0, np.divide(1.0, deltas, where=deltas != 0), 0.0)
    q = groups * inv[..., None] + 8.5
    q = np.minimum(q, 15.0).astype(np.int32)  # trunc toward zero like int()
    lo = q[..., :_HALF] & 0xF
    hi = q[..., _HALF:] & 0xF
    packed = (lo | (hi << 4)).astype(np.uint8)
    return deltas.astype(np.float16), packed


def dequantize_q40(scales: np.ndarray, packed: np.ndarray) -> np.ndarray:
    """Inverse of quantize_q40 per the engine decoder (ref: src/quants.cpp:166-179):
    value j in [0,16) = (lo nibble - 8) * d, value j+16 = (hi nibble - 8) * d.

    Arbitrary file bytes can carry NaN/inf f16 scale patterns (fuzz /
    malformed models); they propagate into the values exactly like the
    reference's f16 LUT lookup would, without a numpy warning."""
    lo = (packed & 0xF).astype(np.int8) - 8
    hi = (packed >> 4).astype(np.int8) - 8
    vals = np.concatenate([lo, hi], axis=-1).astype(np.float32)
    with np.errstate(invalid="ignore"):
        out = vals * scales[..., None].astype(np.float32)
    return out.reshape(*out.shape[:-2], -1)


def quantize_q80(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f32 (..., n) -> (scales f16 (..., n/32), int8 (..., n/32, 32)).

    Matches converter/writer.py:56-75 (scale = absmax/127, round-half-even).
    """
    x = np.asarray(x, dtype=np.float32)
    assert x.shape[-1] % BLOCK_SIZE == 0, x.shape
    groups = x.reshape(*x.shape[:-1], -1, BLOCK_SIZE)
    absmax = np.abs(groups).max(axis=-1)
    deltas = absmax / 127.0
    inv = np.where(deltas != 0, np.divide(1.0, deltas, where=deltas != 0), 0.0)
    q = np.round(groups * inv[..., None]).astype(np.int8)
    return deltas.astype(np.float16), q


def dequantize_q80(scales: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(ref: src/quants.cpp:266-284). NaN/inf scale bit patterns from
    arbitrary file bytes propagate warning-free, same contract as
    dequantize_q40."""
    with np.errstate(invalid="ignore"):
        out = q.astype(np.float32) * scales[..., None].astype(np.float32)
    return out.reshape(*out.shape[:-2], -1)


# ---------------------------------------------------------------------------
# Raw block-stream (de)serialization — the on-file layout: per block, the f16
# scale followed by the quantized payload (ref: src/quants.hpp:16-24).
# ---------------------------------------------------------------------------

def q40_bytes_to_arrays(buf: bytes | np.ndarray, n_values: int) -> tuple[np.ndarray, np.ndarray]:
    assert n_values % BLOCK_SIZE == 0
    nb = n_values // BLOCK_SIZE
    raw = np.frombuffer(buf, dtype=np.uint8, count=nb * Q40_BLOCK_BYTES).reshape(nb, Q40_BLOCK_BYTES)
    scales = raw[:, :2].copy().view(np.float16).reshape(nb)
    packed = raw[:, 2:].copy()
    return scales, packed


def q40_arrays_to_bytes(scales: np.ndarray, packed: np.ndarray) -> bytes:
    nb = int(np.prod(scales.shape))
    raw = np.empty((nb, Q40_BLOCK_BYTES), dtype=np.uint8)
    raw[:, :2] = scales.reshape(nb, 1).view(np.uint8)
    raw[:, 2:] = packed.reshape(nb, _HALF)
    return raw.tobytes()


def q80_bytes_to_arrays(buf: bytes | np.ndarray, n_values: int) -> tuple[np.ndarray, np.ndarray]:
    assert n_values % BLOCK_SIZE == 0
    nb = n_values // BLOCK_SIZE
    raw = np.frombuffer(buf, dtype=np.uint8, count=nb * Q80_BLOCK_BYTES).reshape(nb, Q80_BLOCK_BYTES)
    scales = raw[:, :2].copy().view(np.float16).reshape(nb)
    q = raw[:, 2:].copy().view(np.int8)
    return scales, q


def q80_arrays_to_bytes(scales: np.ndarray, q: np.ndarray) -> bytes:
    nb = int(np.prod(scales.shape))
    raw = np.empty((nb, Q80_BLOCK_BYTES), dtype=np.uint8)
    raw[:, :2] = scales.reshape(nb, 1).view(np.uint8)
    raw[:, 2:] = q.reshape(nb, BLOCK_SIZE).view(np.uint8)
    return raw.tobytes()
