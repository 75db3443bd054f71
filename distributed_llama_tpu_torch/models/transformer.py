"""Transformer forward, LLAMA arch — counterpart of the JAX package's
models/transformer.py (its single-device, non-mesh branches).

One segment-forward covers prefill chunks (T tokens) and decode (T = 1).
Each layer reproduces the reference's dense block (ref:
src/llama2-tasks.cpp:249-275): rmsnorm, fused wqkv, RoPE, KV-cache write,
attention, wo, residual, rmsnorm, fused w13, SiLU*up, w2, residual; then
the final norm and wcls. Every projection is a Q40 kernel launch
(ops/cuda_q40.py) and every attention a flash-kernel launch
(ops/cuda_attention.py) on the card.

Unlike the JAX package's functional update of a donated cache, the port
writes K/V into the cache tensors IN PLACE at the segment's positions.

MIXTRAL and GROK1 are not ported yet (ROADMAP slice 2, MoE on one GPU).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..ops import cuda_attention
from ..ops.activations import apply_hidden_act
from ..ops.attention import decode_attention
from ..ops.matmul import matmul
from ..ops.norms import rmsnorm
from ..ops.rope import apply_rope, rope_angles
from .spec import ArchType, ModelSpec


class KVCache(NamedTuple):
    """Per-layer KV cache: lists of L tensors, each (B, KVH, S, hs),
    head-major (JAX transformer.py:54-83), written in place."""

    k: list
    v: list

    @classmethod
    def create(cls, spec: ModelSpec, batch: int, seq_len: int | None = None,
               dtype=torch.float32, device="cpu") -> "KVCache":
        s = seq_len or spec.seq_len
        shape = (batch, spec.n_kv_heads, s, spec.head_size)
        return cls([torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(spec.n_layers)],
                   [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(spec.n_layers)])


def _write_cache(k_cache, v_cache, k, v, pos0: Sequence[int]) -> None:
    """Write (B, T, KVH, hs) K/V at rows' positions pos0[b]..pos0[b]+T."""
    t = k.shape[1]
    k_w = k.transpose(1, 2).to(k_cache.dtype)
    v_w = v.transpose(1, 2).to(v_cache.dtype)
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
    if spec.arch != ArchType.LLAMA:
        raise NotImplementedError(
            f"{spec.arch.name}: the MoE forward is ROADMAP slice 2 of the "
            "port (MoE on one GPU, with the expert kernel K2)")
    b, t = tokens.shape
    pos0 = [int(pos0)] * b if isinstance(pos0, int) else [int(p) for p in pos0]
    if len(pos0) != b:
        raise ValueError(f"pos0 has {len(pos0)} rows, tokens {b}")
    dev = tokens.device
    q_pos = (torch.tensor(pos0, dtype=torch.int32, device=dev)[:, None]
             + torch.arange(t, dtype=torch.int32, device=dev)[None, :])

    angles = rope_angles(q_pos, spec.head_size, spec.rope_theta)
    x = params["tok_emb"][tokens.long()].to(compute_dtype)  # ref: tasks.cpp:202-203
    for l in range(spec.n_layers):
        lw = params["layers"][l]
        attn = _attention_block(x, lw, spec, cache.k[l], cache.v[l], q_pos,
                                angles, pos0, compute_dtype)
        x = x + attn.to(x.dtype)                # ref: llama2-tasks.cpp:125-131
        xb = rmsnorm(x, lw["rms_ffn"])
        x = x + _dense_ffn(xb, lw, spec, compute_dtype).to(x.dtype)

    x = rmsnorm(x, params["rms_final"])         # ref: llama2-tasks.cpp:222-234
    if not logits_for_all:
        if logit_index is None:
            x = x[:, -1, :]
        else:
            idx = torch.as_tensor(logit_index, device=dev).reshape(-1).expand(b)
            x = x[torch.arange(b, device=dev), idx.long()]
    return matmul(x, params["wcls"], compute_dtype=compute_dtype).to(torch.float32)
