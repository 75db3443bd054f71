"""Weight-format-dispatching matmul — counterpart of the JAX package's
ops/matmul.py (local_matmul / matmul, single device, as one function).

Convention matches the reference (ref: src/funcs.cpp:413-454): weight W has
logical shape (d, n) (d output rows), activations are (..., n), output is
(..., d) = x @ W^T. Weights are dense tensors or packed Q40
`QuantizedTensor`s:

  * Q40 with at most MAX_T = 256 tokens -> kernel K1 (ops/cuda_q40.py);
  * Q40 with more tokens -> dequantize, then torch.matmul (the JAX package
    leaves that product to XLA outside any Pallas kernel too);
  * dense -> torch.matmul in the compute dtype.

`fused_expert_matmul` is the MoE decode step's product against the active
experts of a stacked (E, d, n) weight: kernel K2 for Q40 stacks.

Both take `activation_q80`: the input goes through the Q80 round trip
before the product, as the JAX package's matmul and fused_expert_matmul do
(ops/matmul.py:93-95, :165-167), where XLA fuses it into the Q40 kernel's
operand read. Here a Q40 weight at t = 1 (`cuda_q40.fuses_q80`: every
projection of a decode step) gets it inside K1's or K2's own launch, with
x passed raw; every other input (t >= 2, the dense router weight, the
dequantize path above MAX_T) goes through the standalone kernel
(ops/cuda_q80.py), one more launch a matmul call. The tensor-parallel
weight wrappers are not ported yet.
"""

from __future__ import annotations

from typing import Union

import torch

from ..quants.torch_codec import QuantizedTensor, dequantize_q40_torch
from . import cuda_q40, cuda_q80

WeightFormat = Union[torch.Tensor, QuantizedTensor]


def _input(x: torch.Tensor, compute_dtype, activation_q80: bool):
    """x in compute_dtype, through the Q80 round trip if asked."""
    if activation_q80:
        return cuda_q80.q80_roundtrip(x, compute_dtype)
    return x.to(compute_dtype)


def matmul(x: torch.Tensor, w: WeightFormat, *,
           compute_dtype=torch.float32,
           activation_q80: bool = False) -> torch.Tensor:
    """y[..., d] = sum_n x[..., n] * W[d, n] in compute_dtype: the Q40
    kernel when it applies, the dequantize-then-matmul path otherwise (the
    JAX package's local_matmul; the port has no mesh wrappers around it)."""
    if isinstance(w, QuantizedTensor):
        t = x.numel() // x.shape[-1]
        if cuda_q40.supports_kernel(w, t):
            fused = activation_q80 and cuda_q40.fuses_q80(w, t)
            if not fused:
                x = _input(x, compute_dtype, activation_q80)
            return cuda_q40.q40_matmul(x, w, out_dtype=compute_dtype,
                                       activation_q80=fused)
        wd = dequantize_q40_torch(w, compute_dtype)
    else:
        wd = w.to(compute_dtype)
    return torch.matmul(_input(x, compute_dtype, activation_q80), wd.t())


def fused_expert_matmul(x: torch.Tensor, w: WeightFormat, idx: torch.Tensor,
                        *, compute_dtype=torch.float32,
                        activation_q80: bool = False) -> torch.Tensor:
    """y[k, t, d] = sum_n x[(k,) t, n] * W[idx[k], d, n] in compute_dtype —
    the JAX package's fused_expert_matmul, for all K active experts at once.
    x is (t, n), shared by the experts, or (K, t, n); W a stacked (E, d, n)
    weight; idx (K,) on the device. A Q40 stack goes to kernel K2 (its
    plain version on the CPU); on the card it launches K2 or raises, and
    never gathers the experts' bytes instead. A dense stack (the
    dense-weight mode, which has no kernel) is gathered and multiplied."""
    if isinstance(w, QuantizedTensor):
        fused = activation_q80 and cuda_q40.fuses_q80(w, x.shape[-2])
        if not fused:
            x = _input(x, compute_dtype, activation_q80)
        return cuda_q40.q40_expert_matmul(x, w, idx, out_dtype=compute_dtype,
                                          activation_q80=fused)
    wd = w.index_select(0, idx.to(torch.long)).to(compute_dtype)  # (K, d, n)
    return torch.matmul(_input(x, compute_dtype, activation_q80),
                        wd.transpose(-1, -2))
