"""Hidden activations, matching the reference's exact formulas
(ref: src/funcs.cpp:490-506) — counterpart of the JAX package's
ops/activations.py."""

from __future__ import annotations

import torch

from ..models.spec import HiddenAct

_SQRT_2_OVER_PI = 0.79788456080286535587989211986876
_GELU_COEF_A = 0.044715


def silu(x: torch.Tensor) -> torch.Tensor:
    # x / (1 + exp(-x)) in f32 (ref: src/funcs.cpp:498-506)
    xf = x.to(torch.float32)
    return (xf / (1.0 + torch.exp(-xf))).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # tanh approximation (ref: src/funcs.cpp:487-496)
    xf = x.to(torch.float32)
    out = 0.5 * xf * (1.0 + torch.tanh(
        _SQRT_2_OVER_PI * xf * (1.0 + _GELU_COEF_A * xf * xf)))
    return out.to(x.dtype)


def apply_hidden_act(x: torch.Tensor, act: HiddenAct) -> torch.Tensor:
    if act == HiddenAct.SILU:
        return silu(x)
    if act == HiddenAct.GELU:
        return gelu_tanh(x)
    raise ValueError(act)
