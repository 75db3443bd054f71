"""Host sampling over one step's logits — the part of the JAX package's
runtime/sampling.py that the port's scheduler uses: ``FullLogitsView``,
the full (B, vocab) logits on the host, each row sampled by the request's
own host Sampler exactly as Engine.generate samples. The vocab-sharded view
and its candidate sampler wait for the tensor-parallel slice.
"""

from __future__ import annotations

import numpy as np


class FullLogitsView:
    """The (B, vocab) logits of one forward on the host, sampled row by
    row."""

    sharded = False

    def __init__(self, logits_np: np.ndarray):
        self.lg = logits_np

    def argmax(self, row: int, n_vocab: int) -> int:
        return int(np.argmax(self.lg[row, :n_vocab]))

    def sample(self, sampler, row: int) -> int:
        return int(sampler.sample(self.lg[row]))

    def row(self, row: int) -> np.ndarray:
        return self.lg[row]
