"""Dense attention over a pre-filled KV cache — counterpart of the JAX
package's ops/attention.py.

The plain path: one masked score tensor (B, T, KVH, G, S) in f32. The
engine takes it where the flash kernel does not apply (T*G > 1024 query
rows per kv head, ops/cuda_attention.flash_supported), and it is the math
the kernel's plain version repeats. GQA reshapes query heads into
(kv_head, group) blocks (ref kvMul: src/llama2-tasks.cpp:60).

Numerics match the reference: scores = q.k / sqrt(head_size), softmax with
max-subtraction over positions s <= pos, f32 accumulation.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention(
    q: torch.Tensor,        # (B, T, H, hs) — rotated queries
    k_cache: torch.Tensor,  # (B, KVH, S, hs) — already updated at q_pos
    v_cache: torch.Tensor,  # (B, KVH, S, hs)
    q_pos: torch.Tensor,    # (B, T) absolute position of each query token
) -> torch.Tensor:
    """Causal attention of T query tokens against the whole cache, in f32;
    returns (B, T, H, hs) in q's dtype."""
    b, t, h, hs = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    qg = q.to(torch.float32).reshape(b, t, kvh, h // kvh, hs)
    kf = k_cache.to(torch.float32)
    vf = v_cache.to(torch.float32)
    scores = torch.einsum("btkgh,bksh->btkgs", qg, kf) / (hs ** 0.5)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, None, :] <= q_pos[..., None]            # (B, T, S)
    scores = torch.where(mask[:, :, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("btkgs,bksh->btkgh", probs, vf)
    return out.reshape(b, t, h, hs).to(q.dtype)
