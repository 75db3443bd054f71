"""Device-side (torch) Q40 tensor — counterpart of quants/jax_codec.py.

`QuantizedTensor` is the card-resident form of a Q40 weight matrix: a
struct of two tensors, packed nibbles and per-block f16 scales, as in the
JAX package. Its layout differs, and is chosen for the Hopper kernel
(ops/cuda_q40.py, csrc/q40_matmul.cu):

  packed  (..., n/2) uint8 in the FILE's block-major order: the 16 bytes
          of block b sit at [b*16, b*16+16), so one 16-byte load is one
          whole block. Byte j of block b holds element b*32+j in its low
          nibble and element b*32+16+j in its high nibble.
  scales  (..., n/32) torch.float16 — the file's f16, kept 2 bytes wide.

(The JAX package stores the TPU lane order m = j*nb + b instead, picked for
Mosaic's (8,128) tiling; models/convert.py turns one into the other.)

Numerics match the reference decoder (ref: src/quants.cpp:166-179):
value = (nibble - 8) * scale.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import BLOCK_SIZE


@dataclasses.dataclass
class QuantizedTensor:
    """Q40 tensor of logical shape (..., n): packed (..., n/2) uint8 in
    block-major order + scales (..., n/32) float16."""

    packed: torch.Tensor
    scales: torch.Tensor

    @property
    def shape(self) -> tuple[int, ...]:
        s = self.scales.shape
        return (*s[:-1], s[-1] * BLOCK_SIZE)

    @property
    def device(self) -> torch.device:
        return self.packed.device

    @classmethod
    def from_host(cls, scales: np.ndarray, packed: np.ndarray,
                  device) -> "QuantizedTensor":
        """Host block-major packed (..., nb, 16) u8 + f16 scales (..., nb)
        -> device tensors. The bytes go to the device as they are: a flat
        view, no reordering, never through f32."""
        nb = packed.shape[-2]
        pk = np.ascontiguousarray(packed, dtype=np.uint8).reshape(
            *packed.shape[:-2], 16 * nb)
        sc = np.ascontiguousarray(scales).astype(np.float16, copy=False)
        return cls(torch.from_numpy(pk).to(device),
                   torch.from_numpy(sc).to(device))


def dequantize_q40_torch(t: QuantizedTensor,
                         dtype=torch.float32) -> torch.Tensor:
    """Unpack Q40 to a dense tensor of `dtype` with logical shape t.shape.
    The product (nibble - 8) * scale is taken in f32 (exact for f32, the
    same single multiply dequantize_q40_jax does) and cast once."""
    nb = t.scales.shape[-1]
    pk = t.packed.reshape(*t.packed.shape[:-1], nb, 16)
    lo = (pk & 0xF).to(torch.int16) - 8
    hi = (pk >> 4).to(torch.int16) - 8
    vals = torch.cat([lo, hi], dim=-1).to(torch.float32)   # (..., nb, 32)
    out = vals * t.scales.to(torch.float32)[..., None]
    return out.reshape(*out.shape[:-2], nb * BLOCK_SIZE).to(dtype)
