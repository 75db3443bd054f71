"""RMS normalization — counterpart of the JAX package's ops/norms.py.

Same math as the reference (ref: src/funcs.cpp:94-145): inv = 1/sqrt(mean(x^2)
+ 1e-5), o = w * (inv * x). The 1e-5 epsilon is added AFTER the mean, matching
the reference exactly. Computed in f32 regardless of the activation dtype.
"""

from __future__ import annotations

import torch

RMS_EPS = 1e-5


def rms_inv(x: torch.Tensor) -> torch.Tensor:
    """1/rms over the last axis, keepdims. (ref: src/funcs.cpp:94-123)"""
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return torch.rsqrt(ms + RMS_EPS)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """o = weight * (x / rms(x)) in f32, cast back to x.dtype.
    (ref: src/funcs.cpp:125-145)"""
    xf = x.to(torch.float32)
    out = weight.to(torch.float32) * (rms_inv(xf) * xf)
    return out.to(x.dtype)
