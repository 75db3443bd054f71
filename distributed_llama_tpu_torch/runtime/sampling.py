"""Host side of sampling over one step's logits — a copy of the JAX
package's runtime/sampling.py.

  * `FullLogitsView`: the (B, vocab) logits on the host, each row sampled
    by the request's host Sampler (Engine.generate's path, the parity
    oracle).
  * `ShardedLogitsView`: the vocab-sharded engine's view
    (ops/sharded_vocab.py): greedy rows read the device argmax, sampled
    rows run `sample_candidates` on the per-rank top-k candidates, and
    whatever the candidates cannot prove exact fetches ONE replicated
    (vocab,) row and samples it the oracle's way, so the distribution is
    exact in every case.
  * `sample_candidates`: the oracle's top-p nucleus walk on the merged
    candidates, exact whenever the truncation point lies strictly above
    every rank's guard (the k-th probability it kept); None otherwise.
  * `draw_coin`: one step of the sampler's xorshift stream, the coin
    Sampler.sample would flip.
"""

from __future__ import annotations

import numpy as np


def draw_coin(sampler) -> float:
    """Advance the sampler's xorshift stream one step and return the
    uniform — the same coin `Sampler.sample` would have flipped on the
    full logits (works for both the python and native backends via the
    rng_state property)."""
    from ..utils.rng import xorshift_f32

    s, v = xorshift_f32(sampler.rng_state)
    sampler.rng_state = s
    return v


def sample_candidates(sampler, cand_p: np.ndarray, cand_id: np.ndarray,
                      guard: np.ndarray, argmax_tok: int) -> int | None:
    """Sample one token from the per-shard top-k candidate summary,
    EXACTLY distributed as ``sampler.sample`` on the full logits — or
    return None when exactness cannot be proven from the candidates
    alone (the caller then falls back to the replicated row fetch).

    Exactness argument (docs/parallelism.md "Vocab sharding" carries the
    long form): every token NOT in the candidate set has prob <=
    v_guard = max over shards of that shard's k-th-largest prob. The
    oracle (sampler._sample_topp / topp_nucleus) walks tokens with
    prob >= cutoff in (prob desc, id asc) order and truncates at the
    first index whose cumulative mass crosses topp (inclusive). If the
    crossing element's prob is STRICTLY above v_guard, every token at
    or above it — ties included — is a candidate and ordered exactly as
    the oracle orders it, so the truncated set, its cumulative masses,
    and the draw within it are the oracle's. If the walk never crosses
    (the nucleus is the whole cutoff-filtered set), exactness instead
    needs v_guard < cutoff (no non-candidate passes the filter). The
    probabilities themselves are the device softmax's f32 values — the
    same real quantity the oracle computes, to rounding.

    Only the nucleus mode (0 < topp < 1) is candidate-exact; pure
    multinomial (topp <= 0 or >= 1) needs the full CDF and always
    falls back. Temperature 0 never lands here (the caller returns the
    sharded argmax, bit-identical to np.argmax)."""
    topp = float(sampler.topp)
    if topp <= 0.0 or topp >= 1.0:
        return None
    n = int(sampler.vocab_size)
    v_guard = float(np.max(guard))
    cutoff = (1.0 - topp) / (n - 1)
    keep = cand_p >= cutoff
    p = cand_p[keep]
    ids = cand_id[keep]
    if p.size == 0:
        # the oracle's empty-nucleus branch keeps the (first) argmax —
        # which the sharded argmax already pinned; exact only when no
        # hidden token passes the cutoff either
        if v_guard >= cutoff:
            return None
        draw_coin(sampler)  # the oracle consumes its coin here too
        return int(argmax_tok)
    # the oracle's stable descending sort == (prob desc, id asc)
    order = np.lexsort((ids, -p))
    p = p[order]
    ids = ids[order]
    cum = np.cumsum(p.astype(np.float64))
    over = np.nonzero(cum > topp)[0]
    exact_all = v_guard < cutoff
    if over.size:
        last = int(over[0])
        if not exact_all and not (p[last] > v_guard):
            return None  # truncation point at/below the guard: a hidden
            # token could belong above it
    else:
        if not exact_all:
            return None  # nucleus = the whole filtered set, but the
            # tail past the candidates is unknown
        last = len(ids) - 1
    coin = draw_coin(sampler)
    r = coin * cum[last]
    idx = int(np.searchsorted(cum[: last + 1], r, side="right"))
    idx = min(idx, last)
    return int(ids[idx])


class FullLogitsView:
    """The replicated parity oracle: full (B, vocab) logits on host,
    every row sampled by the host Sampler exactly as before vocab
    sharding existed."""

    sharded = False

    def __init__(self, logits_np: np.ndarray):
        self.lg = logits_np

    def argmax(self, row: int, n_vocab: int) -> int:
        return int(np.argmax(self.lg[row, :n_vocab]))

    def sample(self, sampler, row: int) -> int:
        return int(sampler.sample(self.lg[row]))

    def row(self, row: int) -> np.ndarray:
        return self.lg[row]


class ShardedLogitsView:
    """Sampling access to one step's logits WITHOUT the (B, vocab)
    fetch: greedy rows read the device argmax, sampled rows run the
    candidate scheme, and anything the candidates cannot prove exact —
    guard failures, pure-multinomial requests, foreign sampler vocabs —
    fetches ONE replicated (vocab,) row through `fetch_row` (the warmed
    parity-oracle executable) and samples the oracle way. `stats` is a
    plain dict the engine owns: {"sharded", "fallback"} counters."""

    sharded = True

    def __init__(self, amax: np.ndarray, cand_p: np.ndarray,
                 cand_id: np.ndarray, guard: np.ndarray, n_vocab: int,
                 fetch_row, stats: dict | None = None):
        self.amax = amax
        self.cand_p = cand_p
        self.cand_id = cand_id
        self.guard = guard
        self.n_vocab = int(n_vocab)
        self._fetch_row = fetch_row
        self.stats = stats if stats is not None else {}

    def _count(self, key: str) -> None:
        self.stats[key] = self.stats.get(key, 0) + 1

    def argmax(self, row: int, n_vocab: int) -> int:
        if n_vocab == self.n_vocab:
            self._count("sharded")
            return int(self.amax[row])
        self._count("fallback")
        return int(np.argmax(self._fetch_row(row)[:n_vocab]))

    def row(self, row: int) -> np.ndarray:
        return self._fetch_row(row)

    def sample(self, sampler, row: int) -> int:
        if getattr(sampler, "vocab_size", None) == self.n_vocab:
            if sampler.temperature == 0.0:
                # np.argmax parity: the device argmax is masked at the
                # same vocab and tie-breaks to the lowest index (ONE
                # greedy implementation — argmax() above)
                return self.argmax(row, self.n_vocab)
            tok = sample_candidates(sampler, self.cand_p[row],
                                    self.cand_id[row], self.guard[row],
                                    int(self.amax[row]))
            if tok is not None:
                self._count("sharded")
                return tok
        self._count("fallback")
        return int(sampler.sample(self._fetch_row(row)))
