"""Prompt-lookup speculative decoding and the rejection-resampling steps —
the port's copy of the JAX package's runtime/speculative.py (pure numpy).

A verify forward feeds the last emitted token plus k drafted tokens and
confirms the accepted prefix plus one token: decode reads every weight
once per forward, so a forward over t = 1 + k tokens costs little more
than t = 1 while it fits one tile of the product kernel. Drafts come from
the context's own n-grams (`find_draft`, the "prompt lookup" scheme) or
from a draft model (runtime/draft.py). Greedy emission is always the
model's own argmax, so the stream equals plain greedy decoding; sampled
emission goes through rejection resampling (`accept_or_resample`,
`accept_or_resample_q`), which keeps every emitted token distributed as
the host Sampler's draw on the same logits.
"""

from __future__ import annotations

import numpy as np

from ..sampler import topp_nucleus


def find_draft(
    history: np.ndarray,   # 1-D int32 token ids: prompt + emitted so far
    draft_len: int,
    max_ngram: int = 3,
    min_ngram: int = 1,
) -> list[int]:
    """Longest-suffix n-gram match: for n = max_ngram..min_ngram, find an
    earlier occurrence of the trailing n tokens and return up to draft_len
    tokens that followed it. [] when nothing matches.

    Among the occurrences of the winning n-gram, the MOST RECENT one that
    still has a full draft_len continuation wins (recency bias), falling
    back to the most recent occurrence outright. Looping text — exactly
    where lookup decoding pays — otherwise keeps matching a position a
    token or two from the end of history, yielding truncated length-1
    drafts and ~1 token/forward where a slightly older match drafts the
    whole cycle."""
    h = np.asarray(history)
    ln = h.shape[0]
    for n in range(max_ngram, min_ngram - 1, -1):
        if ln < n + 1:
            continue
        pat = h[ln - n:]
        win = np.lib.stride_tricks.sliding_window_view(h, n)
        hits = np.nonzero((win == pat).all(axis=1))[0]
        hits = hits[hits < ln - n]  # exclude the suffix itself
        if hits.size:
            full = hits[hits + n + draft_len <= ln]
            j = int(full[-1] if full.size else hits[-1]) + n
            return h[j: j + draft_len].tolist()
    return []


def target_dist(logits: np.ndarray, temperature: float, topp: float,
                vocab_size: int) -> np.ndarray:
    """The host Sampler's per-token sampling distribution, materialized:
    temperature softmax, then the reference's top-p nucleus (cutoff
    pre-filter, stable-descending sort, truncate at cumulative > topp
    INCLUDING the crossing element, renormalize — ref:
    src/tokenizer.cpp:265-306 and sampler.py:_sample_topp). Sampling from
    this vector is distribution-identical to Sampler.sample on the same
    logits, which is what makes rejection resampling exact."""
    logits = np.asarray(logits, np.float32).reshape(-1)[:vocab_size]
    x = logits / temperature
    x = np.exp(x - x.max())
    probs = x / x.sum()
    if topp <= 0 or topp >= 1:
        return probs.astype(np.float64)
    order, cum, last = topp_nucleus(probs, topp)
    out = np.zeros(probs.shape[0], np.float64)
    out[order[: last + 1]] = probs[order[: last + 1]] / cum[last]
    return out


def draw(p: np.ndarray, u: float) -> int:
    """Sample index ~ p given one uniform u in [0, 1)."""
    cdf = np.cumsum(p)
    idx = int(np.searchsorted(cdf, u * cdf[-1], side="right"))
    return min(idx, len(p) - 1)


def accept_or_resample(p: np.ndarray, d: int, u_accept: float,
                       u_res: float) -> tuple[bool, int]:
    """One rejection-resampling step against a DETERMINISTIC draft token d
    (prompt-lookup drafts are point masses, q = onehot(d), so the usual
    min(1, p/q) acceptance reduces to p(d)): accept d with probability
    p(d); on reject, sample from the residual (p with d zeroed,
    renormalized). Marginal over (u_accept, u_res) is exactly p — the
    distribution-exactness the sampled lookup mode rests on.
    Returns (accepted, token)."""
    pd = float(p[d])
    if u_accept < pd:
        return True, d
    r = p.copy()
    r[d] = 0.0
    s = r.sum()
    if s <= 0.0:  # p was a point mass at d — rejection is impossible
        return True, d
    return False, draw(r, u_res)


def accept_or_resample_q(p: np.ndarray, q: np.ndarray, d: int,
                         u_accept: float, u_res: float) -> tuple[bool, int]:
    """The GENERAL rejection-resampling step (Leviathan/Chen speculative
    sampling): the draft token d was SAMPLED from a non-point-mass
    proposal distribution q (a real draft model's own softmax — the
    self-draft's truncated-depth head, or a separate draft ``.m``), and
    the target distribution is p. Accept d with probability
    min(1, p(d)/q(d)); on reject, sample from the normalized residual
    max(p - q, 0). Marginalizing over (d ~ q, u_accept, u_res)
    reproduces p EXACTLY — the point-mass helper above is the q =
    onehot(d) special case. Returns (accepted, token)."""
    pd, qd = float(p[d]), float(q[d])
    # qd <= 0 means d cannot have been drawn from this q — certain
    # reject (min(1, p/q) is ill-defined; the residual stays exact)
    if qd > 0.0 and u_accept < min(1.0, pd / qd):
        return True, d
    r = np.maximum(p - q, 0.0)
    s = r.sum()
    if s <= 0.0:
        # p <= q pointwise means p == q (both sum to 1): the accept
        # probability was exactly p(d)/q(d) = 1 — rejection is impossible
        return True, d
    return False, draw(r / s, u_res)


def count_accepted(draft: list[int], greedy: np.ndarray) -> int:
    """How many leading draft tokens the verify forward confirmed: greedy[i]
    is the model's argmax AFTER segment position i, so draft token i (fed at
    segment position i+1) is correct iff it equals greedy[i]."""
    m = 0
    while m < len(draft) and int(greedy[m]) == draft[m]:
        m += 1
    return m
