"""Bit-exact port of the reference xorshift* RNG.

The reference seeds synthetic test weights and the sampler coin flips from a
64-bit xorshift* generator (ref: src/utils.cpp:53-64). Reproducing it bit-for-
bit lets us replay the reference's golden-weight integration tests and get
identical sampling traces for a given seed.
"""

from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1
_MULT = 0x2545F4914F6CDD1D


def xorshift_u32(state: int) -> tuple[int, int]:
    """One step of xorshift*; returns (new_state, u32 sample).

    Mirrors randomU32 (ref: src/utils.cpp:53-59).
    """
    state &= _MASK64
    state ^= state >> 12
    state ^= (state << 25) & _MASK64
    state ^= state >> 27
    sample = ((state * _MULT) & _MASK64) >> 32
    return state, sample & 0xFFFFFFFF


def xorshift_f32(state: int) -> tuple[int, float]:
    """Random float32 in [0, 1) (ref: src/utils.cpp:61-64)."""
    state, u = xorshift_u32(state)
    return state, np.float32((u >> 8) / 16777216.0).item()


class XorshiftRng:
    """Stateful wrapper used for synthetic weights and sampler parity."""

    def __init__(self, seed: int):
        self.state = seed & _MASK64

    def u32(self) -> int:
        self.state, v = xorshift_u32(self.state)
        return v

    def f32(self) -> float:
        self.state, v = xorshift_f32(self.state)
        return v

    def random_f32_array(self, n: int, scale: float = 1.0, offset: float = 0.0) -> np.ndarray:
        """n floats in [offset, offset + scale) drawn sequentially."""
        out = np.empty(n, dtype=np.float32)
        state = self.state
        for i in range(n):
            state, v = xorshift_f32(state)
            out[i] = v
        self.state = state
        return out * np.float32(scale) + np.float32(offset)
