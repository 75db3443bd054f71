"""Token sampler: greedy argmax, temperature multinomial, top-p nucleus.

Behavioral port of the reference Sampler (ref: src/tokenizer.cpp:231-364)
with the same xorshift coin-flip stream, so a fixed seed reproduces the
reference's sampling decisions given identical logits. Vectorized with numpy
(the reference loops per element); the sort is stable-descending which
matches the reference qsort comparator's ordering of distinct values
(ref: src/tokenizer.cpp:257-263).

A C++ twin (the repo's native/dllama_native.cpp, held against this one in
tests/test_torch_native.py) is used when the shared library is loaded
(backend="auto"; native.py); backend="python" forces this oracle, as in
the JAX package.
"""

from __future__ import annotations

import numpy as np

from .utils.rng import xorshift_f32


def topp_nucleus(probs: np.ndarray, topp: float):
    """The reference's top-p nucleus (ref: src/tokenizer.cpp:265-306):
    cutoff pre-filter, stable-descending sort, truncation index at
    cumulative > topp INCLUDING the crossing element. Returns (order,
    cum, last) — token ids sorted by prob, float64 cumulative mass, and
    the inclusive truncation index."""
    n = probs.shape[0]
    cutoff = (1.0 - topp) / (n - 1)
    cand = np.nonzero(probs >= cutoff)[0]
    if cand.size == 0:
        # near-uniform probs with topp < 1/n can leave no candidate
        # (the reference would read out of bounds here); keep the
        # (first) argmax so the nucleus is never empty — mirrored by
        # the native twin and the device sampler
        cand = np.array([int(np.argmax(probs))])
    order = cand[np.argsort(-probs[cand], kind="stable")]
    cum = np.cumsum(probs[order].astype(np.float64))
    over = np.nonzero(cum > topp)[0]
    last = int(over[0]) if over.size else len(order) - 1
    return order, cum, last


class Sampler:
    def __init__(self, vocab_size: int, temperature: float, topp: float,
                 seed: int, backend: str = "auto"):
        self.vocab_size = vocab_size
        self.temperature = float(temperature)
        self.topp = float(topp)
        self._native = None
        if backend in ("auto", "native"):
            from . import native

            if native.available():
                self._native = native.NativeSampler(
                    vocab_size, temperature, topp, seed)
            elif backend == "native":
                raise RuntimeError("native backend requested but "
                                   "libdllama_native.so is not built")
        self._rng_state = seed & ((1 << 64) - 1)

    @property
    def rng_state(self) -> int:
        if self._native is not None:
            return self._native.rng_state
        return self._rng_state

    @rng_state.setter
    def rng_state(self, v: int) -> None:
        if self._native is not None:
            self._native.rng_state = v
        else:
            self._rng_state = v & ((1 << 64) - 1)

    def set_temp(self, temperature: float) -> None:
        self.temperature = float(temperature)
        if self._native is not None:
            self._native.set_temp(temperature)

    def set_seed(self, seed: int) -> None:
        self.rng_state = seed & ((1 << 64) - 1)

    def next_seed(self) -> int:
        """Advance the xorshift stream one step and return the new state as
        a 64-bit seed for a derived per-request RNG (the API server seeds
        a request that names no seed from it): consecutive calls give
        fresh seeds, and two samplers in the same state give the same
        one."""
        s, _ = xorshift_f32(self.rng_state)
        self.rng_state = s
        return s

    def _coin(self) -> float:
        self._rng_state, v = xorshift_f32(self._rng_state)
        return v

    def sample(self, logits: np.ndarray) -> int:
        if self._native is not None:
            return self._native.sample(logits)
        logits = np.asarray(logits, dtype=np.float32).reshape(-1)[: self.vocab_size]
        if self.temperature == 0.0:
            return int(np.argmax(logits))
        x = logits / self.temperature
        # softmax with max-subtraction (ref: src/funcs.cpp:63-92)
        x = np.exp(x - x.max())
        probs = x / x.sum()
        coin = self._coin()
        if self.topp <= 0 or self.topp >= 1:
            return self._sample_mult(probs, coin)
        return self._sample_topp(probs, coin)

    def _sample_mult(self, probs: np.ndarray, coin: float) -> int:
        # ref: src/tokenizer.cpp:244-255
        cdf = np.cumsum(probs.astype(np.float64))
        idx = int(np.searchsorted(cdf, coin, side="right"))
        return min(idx, self.vocab_size - 1)

    def _sample_topp(self, probs: np.ndarray, coin: float) -> int:
        # sample within the truncated nucleus mass
        order, cum, last = topp_nucleus(probs, self.topp)
        r = coin * cum[last]
        idx = int(np.searchsorted(cum[: last + 1], r, side="right"))
        idx = min(idx, last)
        return int(order[idx])
