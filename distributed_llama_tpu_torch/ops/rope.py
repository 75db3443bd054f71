"""Rotary position embeddings, both reference styles — counterpart of the
JAX package's ops/rope.py.

* `rope_llama` — interleaved adjacent-pair rotation within each head with
  angles pos * theta^(-2j/head_size) (ref: src/transformer.cpp:98-135
  LlamaRopeSlice). Used by LLAMA-arch models.

* `rope_falcon` — half-rotation within each head: element j pairs with
  j + head_size/2 (ref: src/transformer.cpp:137-159 FalconRopeSlice).
  Used by GROK1/MIXTRAL-arch models.

Angles are computed in f32. `rope_angles` computes them once per segment;
the forward shares them between q and k of every layer (the JAX package
recomputes them inside each call and leaves XLA to hoist them). They are
made on pos's device from the positions there, with no copy from the host,
so a captured decode step (runtime/graphs.py) recomputes them at replay. Functions
take x shaped (..., n_heads, head_size) and angles for positions
broadcastable to x.shape[:-2].
"""

from __future__ import annotations

import torch

from ..models.spec import ArchType


def rope_angles(pos: torch.Tensor, head_size: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of pos * theta^(-2j/head_size) for j in [0, head_size/2).
    pos: (...,) -> (..., head_size/2) each."""
    j = torch.arange(head_size // 2, dtype=torch.float32, device=pos.device)
    base = torch.full((), theta, dtype=torch.float32, device=pos.device)
    freq = 1.0 / torch.pow(base, 2.0 * j / head_size)
    val = pos.to(torch.float32)[..., None] * freq
    return torch.cos(val), torch.sin(val)


def rope_llama(x: torch.Tensor, angles) -> torch.Tensor:
    """Interleaved rotation: pairs (2j, 2j+1) within each head."""
    *lead, h, hs = x.shape
    fcr, fci = angles[0][..., None, :], angles[1][..., None, :]
    xf = x.to(torch.float32).reshape(*lead, h, hs // 2, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    r0 = x0 * fcr - x1 * fci
    r1 = x0 * fci + x1 * fcr
    return torch.stack([r0, r1], dim=-1).reshape(*lead, h, hs).to(x.dtype)


def rope_falcon(x: torch.Tensor, angles) -> torch.Tensor:
    """Half-rotation: element j pairs with j + hs/2 within each head."""
    hs = x.shape[-1]
    fcr, fci = angles[0][..., None, :], angles[1][..., None, :]
    xf = x.to(torch.float32)
    x0, x1 = xf[..., : hs // 2], xf[..., hs // 2:]
    r0 = x0 * fcr - x1 * fci
    r1 = x0 * fci + x1 * fcr
    return torch.cat([r0, r1], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, angles, arch: ArchType) -> torch.Tensor:
    """Arch dispatch (ref: src/transformer.cpp:391-395); angles from
    rope_angles(pos, head_size, theta)."""
    if arch == ArchType.LLAMA:
        return rope_llama(x, angles)
    return rope_falcon(x, angles)
