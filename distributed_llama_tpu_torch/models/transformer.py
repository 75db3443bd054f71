"""Transformer forward for LLAMA / MIXTRAL / GROK1 — counterpart of the JAX
package's models/transformer.py (its single-device, non-mesh branches).

One segment-forward covers prefill chunks (T tokens) and decode (T = 1).
The per-layer dataflow reproduces the reference's blocks:

  * LLAMA dense block (ref: src/llama2-tasks.cpp:249-275): rmsnorm, fused
    wqkv, RoPE, KV-cache write, attention, wo, residual, rmsnorm, fused
    w13, SiLU*up, w2, residual;
  * MIXTRAL MoE block (ref: src/mixtral-tasks.cpp:5-51): the same with the
    FFN replaced by top-k routed experts (`_moe_ffn`);
  * GROK1 (ref: src/grok1-tasks.cpp): the MoE block between two extra
    norms, the input and logit scalings.

then the final norm and wcls. Every Q40 projection is a kernel launch on
the card: K1 (ops/cuda_q40.py) for the dense weights and for every expert
of a prefill chunk, K2 for the active experts of a decode step; every
attention a flash-kernel launch (ops/cuda_attention.py). With
activation_q80, every matmul input first goes through the Q80 round trip:
inside K1's or K2's launch at t = 1 (every Q40 projection of a decode
step), as one more launch (ops/cuda_q80.py) for the router and every
prefill input (ops/matmul.py).

Unlike the JAX package's functional update of a donated cache, the port
writes K/V into the cache tensors IN PLACE at the segment's positions.
Positions come as an int, a host sequence or a (B,) int32 tensor on the
device (the JAX forward's per_row_pos branch, transformer.py:486); every
position-dependent value (RoPE angles, cache rows, K3's pos0) is computed
on the device from that tensor, so a captured CUDA graph of the forward
(runtime/graphs.py) reads the positions afresh at every replay. A write
at a position outside [0, S) is dropped, as the JAX package's scatter
drops it (transformer.py:97 _scatter_cache_write).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from ..ops import cuda_attention
from ..ops.activations import apply_hidden_act
from ..ops.attention import decode_attention, is_narrow_cache
from ..ops.matmul import fused_expert_matmul, matmul
from ..ops.norms import rmsnorm
from ..ops.rope import apply_rope, rope_angles
from ..quants.torch_codec import take_expert
from ..utils.device import resolve_device
from .spec import ArchType, ModelSpec

GROK_INPUT_SCALE = 78.38367176906169      # ref: src/grok1-tasks.cpp:13
GROK_LOGIT_SCALE = 0.5773502691896257     # ref: src/grok1-tasks.cpp:271


class KVCache(NamedTuple):
    """Per-layer KV cache: lists of L tensors, each (B, KVH, S, hs),
    head-major (JAX transformer.py:54-83), written in place. Each tensor
    is the front of a buffer one hs-row longer: a write dropped for its
    position lands in that spare row, which nothing reads."""

    k: list
    v: list

    @classmethod
    def create(cls, spec: ModelSpec, batch: int, seq_len: int | None = None,
               dtype=torch.float32, device=None) -> "KVCache":
        """Zeroed caches on `device` (`cuda` unless told otherwise)."""
        device = resolve_device(device)
        s = seq_len or spec.seq_len
        shape = (batch, spec.n_kv_heads, s, spec.head_size)
        n = math.prod(shape)

        def buf():
            flat = torch.zeros(n + spec.head_size, dtype=dtype, device=device)
            return flat[:n].view(shape)
        return cls([buf() for _ in range(spec.n_layers)],
                   [buf() for _ in range(spec.n_layers)])


def _to_cache_dtype(x: torch.Tensor, dtype) -> torch.Tensor:
    """Cast k/v to the cache dtype; a sub-bf16 cache (fp8 e4m3) clamps to
    the format's max first, so |v| > 448 saturates instead of becoming NaN
    (JAX transformer.py:_to_cache_dtype) — whatever the cast itself does."""
    if is_narrow_cache(dtype):
        lim = float(torch.finfo(dtype).max)
        x = x.clamp(-lim, lim)
    return x.to(dtype)


class CacheWrite(NamedTuple):
    """Where a segment's K/V go: `rows` (B*KVH*T,) int64, the row of each
    (b, kvh, t) vector in a cache seen as (B*KVH*S, hs); a position outside
    [0, S) maps to row B*KVH*S, the spare row past the cache. `spare`: some
    position may be outside (always so for positions on the device)."""

    rows: torch.Tensor
    spare: bool


def cache_write(q_pos: torch.Tensor, n_kv_heads: int, seq_len: int,
                spare: bool) -> CacheWrite:
    """The rows of every layer's cache write for positions q_pos (B, T),
    computed once a forward on q_pos's device."""
    b, t = q_pos.shape
    heads = torch.arange(b * n_kv_heads, dtype=torch.int64, device=q_pos.device)
    base = (heads * seq_len).view(b, n_kv_heads, 1)
    pos = q_pos.to(torch.int64)[:, None, :]
    inside = (pos >= 0) & (pos < seq_len)
    rows = torch.where(inside, base + pos, b * n_kv_heads * seq_len)
    return CacheWrite(rows.reshape(-1), spare)


# the cache's bits as integers of its width: index_copy_ moves them as they
# are, for every cache dtype (e4m3 included)
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def _cache_rows(cache: torch.Tensor, spare: bool) -> torch.Tensor:
    """The cache as (B*KVH*S, hs) rows of integers, with the spare row past
    them if asked. The spare row must be the last of the cache's buffer
    (KVCache.create, or its last batch row): anything else there would be
    overwritten."""
    hs = cache.shape[-1]
    n = cache.numel() // hs
    if not spare:
        return cache.view(n, hs).view(_BITS[cache.element_size()])
    held = cache.untyped_storage().nbytes() // cache.element_size()
    if not cache.is_contiguous() or held != cache.storage_offset() + (n + 1) * hs:
        raise ValueError("a cache write outside [0, S) needs the spare row "
                         "that KVCache.create allocates after the cache")
    rows = torch.as_strided(cache, (n + 1, hs), (hs, 1))
    return rows.view(_BITS[cache.element_size()])


def _write_cache(k_cache, v_cache, k, v, where: CacheWrite) -> None:
    """Write (B, T, KVH, hs) K/V at their rows, in place: one index_copy_ a
    cache. A dropped write lands in the spare row, so it can never fall on
    a slot that a kept write of the same segment fills."""
    for cache, new in ((k_cache, k), (v_cache, v)):
        w = _to_cache_dtype(new.transpose(1, 2), cache.dtype)   # (B, KVH, T, hs)
        w = w.reshape(-1, w.shape[-1]).view(_BITS[cache.element_size()])
        _cache_rows(cache, where.spare).index_copy_(0, where.rows, w)


def _attention_block(x, lw, spec: ModelSpec, k_cache, v_cache, q_pos,
                     angles, where: CacheWrite, compute_dtype,
                     activation_q80: bool = False):
    """Norm -> QKV -> RoPE -> cache write -> attention -> output proj.
    Returns the wo projection, not yet added to the residual."""
    mm = dict(compute_dtype=compute_dtype, activation_q80=activation_q80)
    b, t, _ = x.shape
    h, kvh, hs = spec.n_heads, spec.n_kv_heads, spec.head_size

    xb = rmsnorm(x, lw["rms_att"])  # ref: llama2-tasks.cpp:10-21
    if "wqkv" in lw:
        qkv = matmul(xb, lw["wqkv"], **mm)
        q = qkv[..., : h * hs].reshape(b, t, h, hs)
        k = qkv[..., h * hs: (h + kvh) * hs].reshape(b, t, kvh, hs)
        v = qkv[..., (h + kvh) * hs:].reshape(b, t, kvh, hs)
    else:
        q = matmul(xb, lw["wq"], **mm).reshape(b, t, h, hs)
        k = matmul(xb, lw["wk"], **mm).reshape(b, t, kvh, hs)
        v = matmul(xb, lw["wv"], **mm).reshape(b, t, kvh, hs)

    q = apply_rope(q, angles, spec.arch)
    k = apply_rope(k, angles, spec.arch)
    _write_cache(k_cache, v_cache, k, v, where)

    if cuda_attention.flash_supported(t, h, kvh):
        att = cuda_attention.flash_attention(q, k_cache, v_cache, q_pos)
    else:
        att = decode_attention(q, k_cache, v_cache, q_pos)  # (B, T, H, hs)
    return matmul(att.reshape(b, t, h * hs), lw["wo"], **mm)


def _dense_ffn(xb, lw, spec: ModelSpec, compute_dtype,
               activation_q80: bool = False):
    """SwiGLU FFN (ref: src/llama2-tasks.cpp:158-189)."""
    mm = dict(compute_dtype=compute_dtype, activation_q80=activation_q80)
    if "w13" in lw:
        h13 = matmul(xb, lw["w13"], **mm)
        hd = h13.shape[-1] // 2
        gate, up = h13[..., :hd], h13[..., hd:]
    else:
        gate = matmul(xb, lw["w1"], **mm)
        up = matmul(xb, lw["w3"], **mm)
    hb = apply_hidden_act(gate, spec.hidden_act) * up
    return matmul(hb, lw["w2"], **mm)


def moe_route(router_logits: torch.Tensor,
              k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing (ref: grok1-tasks.cpp:99-114; JAX transformer.py:
    287-290): softmax in f32, the k largest probabilities, renormalized
    over the k. Ties go to the lower expert index, as lax.top_k breaks them
    (torch.topk does not): a stable descending sort. Returns (weights f32,
    indices int64), each (..., k), both left on the device."""
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    top_p, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_idx = top_p[..., :k], top_idx[..., :k]
    return top_p / top_p.sum(dim=-1, keepdim=True), top_idx


def _moe_ffn(xb, lw, spec: ModelSpec, compute_dtype,
             activation_q80: bool = False):
    """Top-k routed expert FFN (ref: src/grok1-tasks.cpp:56-227; JAX
    transformer.py:_moe_ffn, single device). Decode (T = B = 1) computes
    just the K active experts, through K2 with the indices on the device;
    prefill computes every expert densely and masks by the routing
    weights, expert by expert (JAX semantics)."""
    b, t, d = xb.shape
    k_active = spec.n_active_experts
    act = lambda g: apply_hidden_act(g, spec.hidden_act)  # noqa: E731
    mm = dict(compute_dtype=compute_dtype, activation_q80=activation_q80)

    router_logits = matmul(xb, lw["moe_router"], **mm)
    weights, top_idx = moe_route(router_logits, k_active)    # (B, T, K)

    if t == 1 and b == 1:
        idx = top_idx.reshape(k_active).to(torch.int32)   # K2's index type
        x1 = xb.reshape(1, d)
        gate = fused_expert_matmul(x1, lw["moe_gate"], idx, **mm)  # (K, 1, hd)
        up = fused_expert_matmul(x1, lw["moe_up"], idx, **mm)
        out = fused_expert_matmul(act(gate) * up, lw["moe_down"], idx,
                                  **mm)   # (K, 1, d)
        # JAX :343-365: experts added in routing order, each weight cast to
        # the output dtype before the multiply (JAX starts the sum from
        # zeros, which adds nothing)
        w = weights.reshape(k_active).to(out.dtype)
        acc = w[0] * out[0]
        for ae in range(1, k_active):
            acc = acc + w[ae] * out[ae]
        return acc.reshape(b, t, d).to(xb.dtype)

    # prefill: every expert densely, masked by the scattered routing weights
    e_weights = torch.zeros(router_logits.shape, dtype=torch.float32,
                            device=xb.device).scatter(-1, top_idx, weights)
    acc = torch.zeros((b, t, d), dtype=xb.dtype, device=xb.device)
    for e in range(spec.n_experts):
        gate = matmul(xb, take_expert(lw["moe_gate"], e), **mm)
        up = matmul(xb, take_expert(lw["moe_up"], e), **mm)
        out = matmul(act(gate) * up, take_expert(lw["moe_down"], e), **mm)
        acc = acc + e_weights[..., e, None].to(out.dtype) * out
    return acc


def _layer(x, lw, spec: ModelSpec, k_cache, v_cache, q_pos, angles,
           where: CacheWrite, compute_dtype, activation_q80: bool = False):
    """One block (JAX transformer.py:_layer): attention, then the dense or
    MoE FFN with the arch's norms and residuals."""
    attn = _attention_block(x, lw, spec, k_cache, v_cache, q_pos, angles,
                            where, compute_dtype, activation_q80)
    if spec.arch == ArchType.GROK1:
        # post-attention norm BEFORE the residual add (ref: grok1-tasks.cpp:16-41)
        x = x + rmsnorm(attn, lw["rms_ffn"]).to(x.dtype)
        xb = rmsnorm(x, lw["rms_moe"])              # ref: grok1-tasks.cpp:43-54
        moe = rmsnorm(_moe_ffn(xb, lw, spec, compute_dtype, activation_q80),
                      lw["rms_ffn2"])               # ref: grok1-tasks.cpp:244-256
        return x + moe.to(x.dtype)
    x = x + attn.to(x.dtype)                        # ref: llama2-tasks.cpp:125-131
    xb = rmsnorm(x, lw["rms_ffn"])
    if spec.arch == ArchType.MIXTRAL:
        return x + _moe_ffn(xb, lw, spec, compute_dtype, activation_q80).to(x.dtype)
    return x + _dense_ffn(xb, lw, spec, compute_dtype, activation_q80).to(x.dtype)


def forward(
    params: dict,
    spec: ModelSpec,
    tokens: torch.Tensor,          # (B, T) integer token ids
    pos0: int | Sequence[int] | torch.Tensor,   # shared, per row, or (B,) on the device
    cache: KVCache,
    *,
    compute_dtype=torch.float32,
    logits_for_all: bool = False,
    logit_index: int | Sequence[int] | torch.Tensor | None = None,
    activation_q80: bool = False,
) -> torch.Tensor:
    """Run T tokens through the model, writing their K/V into `cache`.
    activation_q80 sends every matmul input (router and wcls included)
    through the Q80 round trip, as the JAX forward's cfg does.

    pos0: an int, a host sequence of B ints, or a (B,) integer tensor
    (int32 on tokens' device reads no host value: the form a captured
    graph takes). Row b's token r sits at pos0[b] + r; a position outside
    [0, S) writes nothing (its logits mean nothing, as in the JAX slot
    steps), so a row at pos0 == S leaves its cache untouched.

    Returns f32 logits (B, vocab) for the last token (or position
    `logit_index`: an int, a host sequence or a (B,) tensor, for a
    right-padded segment), or (B, T, vocab) if logits_for_all."""
    b, t = tokens.shape
    dev = tokens.device
    s = cache.k[0].shape[2]
    if isinstance(pos0, torch.Tensor):
        pos_t = pos0.to(device=dev, dtype=torch.int32).reshape(-1).expand(b)
        spare = True    # the device's positions are not read here
    else:
        rows = [int(pos0)] * b if isinstance(pos0, int) else [int(p) for p in pos0]
        if len(rows) != b:
            raise ValueError(f"pos0 has {len(rows)} rows, tokens {b}")
        pos_t = torch.tensor(rows, dtype=torch.int32, device=dev)
        spare = any(p < 0 or p + t > s for p in rows)
    q_pos = pos_t[:, None] + torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    where = cache_write(q_pos, spec.n_kv_heads, s, spare)

    angles = rope_angles(q_pos, spec.head_size, spec.rope_theta)
    x = params["tok_emb"][tokens.long()].to(compute_dtype)  # ref: tasks.cpp:202-203
    if spec.arch == ArchType.GROK1:
        x = x * GROK_INPUT_SCALE
    for l in range(spec.n_layers):
        x = _layer(x, params["layers"][l], spec, cache.k[l], cache.v[l],
                   q_pos, angles, where, compute_dtype, activation_q80)

    x = rmsnorm(x, params["rms_final"])         # ref: llama2-tasks.cpp:222-234
    if not logits_for_all:
        if logit_index is None:
            x = x[:, -1, :]
        else:
            idx = torch.as_tensor(logit_index, device=dev).reshape(-1).expand(b)
            x = x[torch.arange(b, device=dev), idx.long()]
    logits = matmul(x, params["wcls"], compute_dtype=compute_dtype,
                    activation_q80=activation_q80).to(torch.float32)
    if spec.arch == ArchType.GROK1:
        logits = logits * GROK_LOGIT_SCALE          # ref: grok1-tasks.cpp:269-272
    return logits
