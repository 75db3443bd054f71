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
attention a flash-kernel launch (ops/cuda_attention.py).

Unlike the JAX package's functional update of a donated cache, the port
writes K/V into the cache tensors IN PLACE at the segment's positions.
"""

from __future__ import annotations

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
    head-major (JAX transformer.py:54-83), written in place."""

    k: list
    v: list

    @classmethod
    def create(cls, spec: ModelSpec, batch: int, seq_len: int | None = None,
               dtype=torch.float32, device=None) -> "KVCache":
        """Zeroed caches on `device` (`cuda` unless told otherwise)."""
        device = resolve_device(device)
        s = seq_len or spec.seq_len
        shape = (batch, spec.n_kv_heads, s, spec.head_size)
        return cls([torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(spec.n_layers)],
                   [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(spec.n_layers)])


def _to_cache_dtype(x: torch.Tensor, dtype) -> torch.Tensor:
    """Cast k/v to the cache dtype; a sub-bf16 cache (fp8 e4m3) clamps to
    the format's max first, so |v| > 448 saturates instead of becoming NaN
    (JAX transformer.py:_to_cache_dtype) — whatever the cast itself does."""
    if is_narrow_cache(dtype):
        lim = float(torch.finfo(dtype).max)
        x = x.clamp(-lim, lim)
    return x.to(dtype)


def _write_cache(k_cache, v_cache, k, v, pos0: Sequence[int]) -> None:
    """Write (B, T, KVH, hs) K/V at rows' positions pos0[b]..pos0[b]+T."""
    t = k.shape[1]
    k_w = _to_cache_dtype(k.transpose(1, 2), k_cache.dtype)
    v_w = _to_cache_dtype(v.transpose(1, 2), v_cache.dtype)
    if len(set(pos0)) == 1:
        p = pos0[0]
        k_cache[:, :, p:p + t] = k_w
        v_cache[:, :, p:p + t] = v_w
        return
    for b, p in enumerate(pos0):
        k_cache[b, :, p:p + t] = k_w[b]
        v_cache[b, :, p:p + t] = v_w[b]


def _attention_block(x, lw, spec: ModelSpec, k_cache, v_cache, q_pos,
                     angles, pos0: Sequence[int], compute_dtype):
    """Norm -> QKV -> RoPE -> cache write -> attention -> output proj.
    Returns the wo projection, not yet added to the residual."""
    b, t, _ = x.shape
    h, kvh, hs = spec.n_heads, spec.n_kv_heads, spec.head_size

    xb = rmsnorm(x, lw["rms_att"])  # ref: llama2-tasks.cpp:10-21
    if "wqkv" in lw:
        qkv = matmul(xb, lw["wqkv"], compute_dtype=compute_dtype)
        q = qkv[..., : h * hs].reshape(b, t, h, hs)
        k = qkv[..., h * hs: (h + kvh) * hs].reshape(b, t, kvh, hs)
        v = qkv[..., (h + kvh) * hs:].reshape(b, t, kvh, hs)
    else:
        q = matmul(xb, lw["wq"], compute_dtype=compute_dtype).reshape(b, t, h, hs)
        k = matmul(xb, lw["wk"], compute_dtype=compute_dtype).reshape(b, t, kvh, hs)
        v = matmul(xb, lw["wv"], compute_dtype=compute_dtype).reshape(b, t, kvh, hs)

    q = apply_rope(q, angles, spec.arch)
    k = apply_rope(k, angles, spec.arch)
    _write_cache(k_cache, v_cache, k, v, pos0)

    if cuda_attention.flash_supported(t, h, kvh):
        att = cuda_attention.flash_attention(q, k_cache, v_cache, q_pos)
    else:
        att = decode_attention(q, k_cache, v_cache, q_pos)  # (B, T, H, hs)
    return matmul(att.reshape(b, t, h * hs), lw["wo"],
                  compute_dtype=compute_dtype)


def _dense_ffn(xb, lw, spec: ModelSpec, compute_dtype):
    """SwiGLU FFN (ref: src/llama2-tasks.cpp:158-189)."""
    if "w13" in lw:
        h13 = matmul(xb, lw["w13"], compute_dtype=compute_dtype)
        hd = h13.shape[-1] // 2
        gate, up = h13[..., :hd], h13[..., hd:]
    else:
        gate = matmul(xb, lw["w1"], compute_dtype=compute_dtype)
        up = matmul(xb, lw["w3"], compute_dtype=compute_dtype)
    hb = apply_hidden_act(gate, spec.hidden_act) * up
    return matmul(hb, lw["w2"], compute_dtype=compute_dtype)


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


def _moe_ffn(xb, lw, spec: ModelSpec, compute_dtype):
    """Top-k routed expert FFN (ref: src/grok1-tasks.cpp:56-227; JAX
    transformer.py:_moe_ffn, single device). Decode (T = B = 1) computes
    just the K active experts, through K2 with the indices on the device;
    prefill computes every expert densely and masks by the routing
    weights, expert by expert (JAX semantics)."""
    b, t, d = xb.shape
    k_active = spec.n_active_experts
    act = lambda g: apply_hidden_act(g, spec.hidden_act)  # noqa: E731

    router_logits = matmul(xb, lw["moe_router"], compute_dtype=compute_dtype)
    weights, top_idx = moe_route(router_logits, k_active)    # (B, T, K)

    if t == 1 and b == 1:
        idx = top_idx.reshape(k_active).to(torch.int32)   # K2's index type
        x1 = xb.reshape(1, d)
        gate = fused_expert_matmul(x1, lw["moe_gate"], idx,
                                   compute_dtype=compute_dtype)  # (K, 1, hd)
        up = fused_expert_matmul(x1, lw["moe_up"], idx,
                                 compute_dtype=compute_dtype)
        out = fused_expert_matmul(act(gate) * up, lw["moe_down"], idx,
                                  compute_dtype=compute_dtype)   # (K, 1, d)
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
        gate = matmul(xb, take_expert(lw["moe_gate"], e),
                      compute_dtype=compute_dtype)
        up = matmul(xb, take_expert(lw["moe_up"], e),
                    compute_dtype=compute_dtype)
        out = matmul(act(gate) * up, take_expert(lw["moe_down"], e),
                     compute_dtype=compute_dtype)
        acc = acc + e_weights[..., e, None].to(out.dtype) * out
    return acc


def _layer(x, lw, spec: ModelSpec, k_cache, v_cache, q_pos, angles,
           pos0: Sequence[int], compute_dtype):
    """One block (JAX transformer.py:_layer): attention, then the dense or
    MoE FFN with the arch's norms and residuals."""
    attn = _attention_block(x, lw, spec, k_cache, v_cache, q_pos, angles,
                            pos0, compute_dtype)
    if spec.arch == ArchType.GROK1:
        # post-attention norm BEFORE the residual add (ref: grok1-tasks.cpp:16-41)
        x = x + rmsnorm(attn, lw["rms_ffn"]).to(x.dtype)
        xb = rmsnorm(x, lw["rms_moe"])              # ref: grok1-tasks.cpp:43-54
        moe = rmsnorm(_moe_ffn(xb, lw, spec, compute_dtype),
                      lw["rms_ffn2"])               # ref: grok1-tasks.cpp:244-256
        return x + moe.to(x.dtype)
    x = x + attn.to(x.dtype)                        # ref: llama2-tasks.cpp:125-131
    xb = rmsnorm(x, lw["rms_ffn"])
    if spec.arch == ArchType.MIXTRAL:
        return x + _moe_ffn(xb, lw, spec, compute_dtype).to(x.dtype)
    return x + _dense_ffn(xb, lw, spec, compute_dtype).to(x.dtype)


def forward(
    params: dict,
    spec: ModelSpec,
    tokens: torch.Tensor,          # (B, T) integer token ids
    pos0: int | Sequence[int],     # first position: shared, or one per row
    cache: KVCache,
    *,
    compute_dtype=torch.float32,
    logits_for_all: bool = False,
    logit_index: int | Sequence[int] | None = None,
) -> torch.Tensor:
    """Run T tokens through the model, writing their K/V into `cache`.

    Returns f32 logits (B, vocab) for the last token (or position
    `logit_index`, shared or per row, for a right-padded segment), or
    (B, T, vocab) if logits_for_all."""
    b, t = tokens.shape
    pos0 = [int(pos0)] * b if isinstance(pos0, int) else [int(p) for p in pos0]
    if len(pos0) != b:
        raise ValueError(f"pos0 has {len(pos0)} rows, tokens {b}")
    dev = tokens.device
    q_pos = (torch.tensor(pos0, dtype=torch.int32, device=dev)[:, None]
             + torch.arange(t, dtype=torch.int32, device=dev)[None, :])

    angles = rope_angles(q_pos, spec.head_size, spec.rope_theta)
    x = params["tok_emb"][tokens.long()].to(compute_dtype)  # ref: tasks.cpp:202-203
    if spec.arch == ArchType.GROK1:
        x = x * GROK_INPUT_SCALE
    for l in range(spec.n_layers):
        x = _layer(x, params["layers"][l], spec, cache.k[l], cache.v[l],
                   q_pos, angles, pos0, compute_dtype)

    x = rmsnorm(x, params["rms_final"])         # ref: llama2-tasks.cpp:222-234
    if not logits_for_all:
        if logit_index is None:
            x = x[:, -1, :]
        else:
            idx = torch.as_tensor(logit_index, device=dev).reshape(-1).expand(b)
            x = x[torch.arange(b, device=dev), idx.long()]
    logits = matmul(x, params["wcls"], compute_dtype=compute_dtype).to(torch.float32)
    if spec.arch == ArchType.GROK1:
        logits = logits * GROK_LOGIT_SCALE          # ref: grok1-tasks.cpp:269-272
    return logits
