"""Sequence parallelism over the mesh's sp axis — counterpart of the JAX
package's parallel/ring_attention.py (_block_attn :31, _merge :64,
ring_attention_local :76, sp_cache_attention_local :172).

The KV cache's sequence dim is sharded over sp: rank i of an sp group
holds positions [i*S/sp, (i+1)*S/sp) of every layer's cache, so the cache
memory of a rank is S/sp. Two ways attend over it:

  ring_attention_local     the ring prefill: the segment (the whole prompt
                           from position 0, padded to a multiple of sp)
                           is split into sp chunks, one a rank; K/V blocks
                           travel the ring (collectives.ring_shift, the
                           JAX lax.ppermute), the next rotation posted
                           before the block's compute, and each rank
                           merges its chunk's flash statistics block by
                           block. Every block passes every rank once, and
                           the rank writes the block's positions that fall
                           in its cache shard as it passes (`on_block`).
  sp_cache_attention_local decode and any later segment, the queries on
                           every rank of the group: local flash statistics
                           of the queries against the rank's cache shard,
                           merged exactly by an all-reduce max and two
                           all-reduce sums over sp.

These are plain torch ops in f32, as the JAX functions are jnp outside any
kernel (no Pallas kernel to port); the block layout is the JAX one: q
(B, T, H, hs), k/v (B, T, KVH, hs), GQA groups of H/KVH heads, causal
masking on absolute positions.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from .collectives import all_reduce, ring_shift
from .mesh import SP_AXIS, Mesh


def block_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_pos: torch.Tensor, k_pos: torch.Tensor, scale: float):
    """One (Tq x Tk) causal block's flash statistics (JAX _block_attn):
    acc (B, Tq, H, hs) the unnormalized softmax-weighted sum of V, m
    (B, Tq, H) the row maximum (-inf for a row with no visible key), l
    (B, Tq, H) the normalizer; all f32."""
    b, tq, h, hs = q.shape
    kvh = k.shape[2]
    qf = q.float().reshape(b, tq, kvh, h // kvh, hs)
    scores = torch.einsum("bqkgd,bskd->bqkgs", qf, k.float()) * scale
    mask = (q_pos[:, :, None] >= k_pos[:, None, :])[:, :, None, None, :]
    scores = scores.masked_fill(~mask, float("-inf"))
    m = scores.amax(dim=-1)
    # a row with no visible key in this block contributes nothing
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(scores - m_safe[..., None]).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bqkgs,bskd->bqkgd", p, v.float())
    m = torch.where(torch.isfinite(m), m, float("-inf"))
    return acc.reshape(b, tq, h, hs), m.reshape(b, tq, h), l.reshape(b, tq, h)


def merge(acc1, m1, l1, acc2, m2, l2):
    """Two flash-statistics triples merged (JAX _merge: the online
    softmax's combination)."""
    m = torch.maximum(m1, m2)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    a1 = torch.where(torch.isfinite(m1), torch.exp(m1 - m_safe), 0.0)
    a2 = torch.where(torch.isfinite(m2), torch.exp(m2 - m_safe), 0.0)
    return acc1 * a1[..., None] + acc2 * a2[..., None], m, l1 * a1 + l2 * a2


def _positions(pos0: int, t: int, b: int, device) -> torch.Tensor:
    return (pos0 + torch.arange(t, dtype=torch.int32, device=device))[None] \
        .expand(b, t)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         chunk_pos0: int, mesh: Mesh,
                         on_block: Callable | None = None) -> torch.Tensor:
    """Causal attention of this rank's query chunk against the whole
    ring-distributed K/V (JAX ring_attention_local). q, k, v: (B, T_local,
    H|KVH, hs), this rank's chunk, whose first token sits at absolute
    position chunk_pos0 (sp_index * T_local for a segment from 0). At
    step s the rank holds the block that started on rank (idx - s) mod
    sp; it posts the block's rotation to the next rank, hands the block
    and its positions to `on_block` (the cache write), computes its
    statistics and merges them. Returns (B, T_local, H, hs) in q's dtype."""
    n, idx = mesh.sp, mesh.sp_rank
    b, t, h, hs = q.shape
    scale = 1.0 / math.sqrt(hs)
    q_pos = _positions(chunk_pos0, t, b, q.device)
    acc = torch.zeros((b, t, h, hs), dtype=torch.float32, device=q.device)
    m = torch.full((b, t, h), float("-inf"), device=q.device)
    l = torch.zeros((b, t, h), dtype=torch.float32, device=q.device)
    # blocks rotate in their input dtype; block_attn works in f32
    k_cur, v_cur = k, v
    for s in range(n):
        src = (idx - s) % n
        k_pos = _positions(chunk_pos0 - idx * t + src * t, t, b, q.device)
        nxt = ring_shift([k_cur, v_cur], mesh, SP_AXIS) if s + 1 < n else None
        if on_block is not None:
            on_block(k_cur, v_cur, k_pos)
        acc, m, l = merge(acc, m, l, *block_attn(q, k_cur, v_cur, q_pos,
                                                 k_pos, scale))
        if nxt is not None:
            k_cur, v_cur = nxt.wait()
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def sp_cache_attention_local(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, q_pos: torch.Tensor,
                             mesh: Mesh) -> torch.Tensor:
    """Attention of the queries (B, T, H, hs), the same on every rank of
    the sp group, against the sequence-sharded cache (B, KVH, S/sp, hs)
    (JAX sp_cache_attention_local): this shard's flash statistics, then
    the exact merge over sp, max then two sums. Slots past a query's
    position are masked, so unwritten slots never count."""
    b, s_local = q.shape[0], k_cache.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    k_pos = _positions(mesh.sp_rank * s_local, s_local, b, q.device)
    acc, m, l = block_attn(q, k_cache.transpose(1, 2),
                           v_cache.transpose(1, 2), q_pos, k_pos, scale)
    m_max = all_reduce(m, mesh, SP_AXIS, op="max")
    m_safe = torch.where(torch.isfinite(m_max), m_max, 0.0)
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    num = all_reduce(acc * alpha[..., None], mesh, SP_AXIS)
    den = all_reduce(l * alpha, mesh, SP_AXIS)
    return (num / den.clamp_min(1e-30)[..., None]).to(q.dtype)
