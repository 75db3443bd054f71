"""The vocab split: the embedding gather and the head's sampling summary
over vocab-sharded tables — counterpart of the JAX package's
ops/sharded_vocab.py (vocab_shard_axes :59, embed_tokens_sharded :110,
sample_prep_local :135, sharded_sample_prep :171), over tp or, with
pipeline stages, over (pp, tp) (the `axis` argument: parallel/mesh.PP_TP,
the shard index pp_index * tp + tp_index).

  * Embedding: each rank holds rows [base, base + V/n) of tok_emb.
    The lookup is a masked local gather (a token outside the rank's rows
    gives exact zeros) and one all-reduce over tp: zeros plus the one
    real row add exactly in any float type, so the result is bit-identical
    to the replicated gather.
  * Head: wcls is row-split, so each rank holds logits for its vocab rows.
    What leaves the ranks is a summary: the local max and argmax (a global
    id, the lowest among equal maxima), and the local top-k probabilities
    of the full softmax (its max and denominator all-reduced over tp) with
    their global ids and the k-th of them, the exactness guard that
    runtime/sampling.py:sample_candidates reads. The global argmax takes
    the lowest id among the ranks holding the maximum: np.argmax's
    first-max rule, since ids grow with the rank.

Every value is computed on the device from tensors: nothing reads the host
inside, so the embedding stays inside a captured decode step.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import all_gather, all_reduce
from ..parallel.mesh import TP_AXIS


def embed_tokens_sharded(emb_local: torch.Tensor, tokens: torch.Tensor, mesh,
                         compute_dtype, axis: str = TP_AXIS) -> torch.Tensor:
    """(B, T) token ids -> (B, T, dim) from this rank's (V/n, dim) rows of
    the embedding table: masked local gather, then the sum over `axis`."""
    vloc = emb_local.shape[0]
    loc = tokens.to(torch.int64) - mesh.index(axis) * vloc
    ok = (loc >= 0) & (loc < vloc)
    x = emb_local[loc.clamp(0, vloc - 1)].to(compute_dtype)
    return all_reduce(x.masked_fill(~ok[..., None], 0), mesh, axis)


def sharded_argmax(logits: torch.Tensor, mesh, n_vocab: int,
                   axis: str = TP_AXIS) -> torch.Tensor:
    """(B,) global greedy tokens from this rank's (B, V/n) logits: the
    greedy half of the summary alone (local max and argmax, gathered),
    with the same tie-break."""
    vloc = logits.shape[-1]
    base = mesh.index(axis) * vloc
    gid = base + torch.arange(vloc, device=logits.device)
    lm = torch.where((gid < n_vocab)[None, :], logits.to(torch.float32),
                     float("-inf"))
    loc_max, loc_arg = lm.max(dim=-1)
    return _pick(all_gather(loc_max, mesh, axis).t(),
                 all_gather(base + loc_arg, mesh, axis).t())


def _pick(lmax: torch.Tensor, larg: torch.Tensor) -> torch.Tensor:
    """The lowest global id among the ranks holding a row's maximum."""
    best = lmax.max(dim=1, keepdim=True).values
    big = torch.iinfo(torch.int64).max
    return torch.where(lmax == best, larg, big).min(dim=1).values


def sample_prep_local(l_local: torch.Tensor, temps: torch.Tensor, base: int,
                      n_vocab: int, k: int, mesh, axis: str = TP_AXIS):
    """This rank's summary of its (B, V/tp) logits (JAX :135): (local max
    (B, 1), local argmax as a global id (B, 1), top-k probabilities (B, k)
    in descending order, their global ids (B, k), the k-th probability
    (B, 1)). Ids at or past n_vocab (the tokenizer's vocab) are masked out,
    as the host Sampler truncates. temps (B,) f32: a greedy row passes 1."""
    vloc = l_local.shape[-1]
    gid = base + torch.arange(vloc, device=l_local.device)
    valid = (gid < n_vocab)[None, :]
    lm = torch.where(valid, l_local.to(torch.float32), float("-inf"))
    loc_max, loc_arg = lm.max(dim=-1)     # the first maximum's index
    x = lm / temps.to(torch.float32).clamp_min(1e-6)[:, None]
    gmax = all_reduce(x.max(dim=-1).values, mesh, axis, op="max")
    e = torch.where(valid, torch.exp(x - gmax[:, None]), 0.0)
    z = all_reduce(e.sum(dim=-1), mesh, axis)
    p = e / z[:, None]
    # lax.top_k's order: probability descending, the lower index first
    top_p, top_i = torch.sort(p, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    return (loc_max[:, None], (base + loc_arg)[:, None], top_p, base + top_i,
            top_p[:, k - 1:k])


def sharded_sample_prep(logits: torch.Tensor, temps: torch.Tensor, mesh,
                        n_vocab: int, k: int, axis: str = TP_AXIS):
    """(B, V/n) logits of this rank -> the summary over every rank of
    `axis` (JAX :171): argmax (B,) int64, candidate probabilities and ids
    (B, n * k) in rank order, guards (B, n). The logits themselves are
    never gathered."""
    base = mesh.index(axis) * logits.shape[-1]
    parts = sample_prep_local(logits, temps, base, n_vocab, k, mesh, axis)
    lmax, larg, cand_p, cand_id, guard = (
        all_gather(t, mesh, axis).movedim(0, 1).flatten(1) for t in parts)
    return _pick(lmax, larg), cand_p, cand_id, guard
