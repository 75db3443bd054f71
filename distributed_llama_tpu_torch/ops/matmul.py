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

The Q80 activation round trip and the tensor-parallel weight wrappers are
not ported yet.
"""

from __future__ import annotations

from typing import Union

import torch

from ..quants.torch_codec import QuantizedTensor, dequantize_q40_torch
from . import cuda_q40

WeightFormat = Union[torch.Tensor, QuantizedTensor]


def matmul(x: torch.Tensor, w: WeightFormat, *,
           compute_dtype=torch.float32) -> torch.Tensor:
    """y[..., d] = sum_n x[..., n] * W[d, n] in compute_dtype: the Q40
    kernel when it applies, the dequantize-then-matmul path otherwise (the
    JAX package's local_matmul; the port has no mesh wrappers around it)."""
    x = x.to(compute_dtype)
    if isinstance(w, QuantizedTensor):
        t = x.numel() // x.shape[-1]
        if cuda_q40.supports_kernel(w, t):
            return cuda_q40.q40_matmul(x, w, out_dtype=compute_dtype)
        wd = dequantize_q40_torch(w, compute_dtype)
    else:
        wd = w.to(compute_dtype)
    return torch.matmul(x, wd.t())


def fused_expert_matmul(x: torch.Tensor, w: WeightFormat, idx: torch.Tensor,
                        *, compute_dtype=torch.float32) -> torch.Tensor:
    """y[k, t, d] = sum_n x[(k,) t, n] * W[idx[k], d, n] in compute_dtype —
    the JAX package's fused_expert_matmul, for all K active experts at once.
    x is (t, n), shared by the experts, or (K, t, n); W a stacked (E, d, n)
    weight; idx (K,) on the device. A Q40 stack goes to kernel K2 (its
    plain version on the CPU); on the card it launches K2 or raises, and
    never gathers the experts' bytes instead. A dense stack (the
    dense-weight mode, which has no kernel) is gathered and multiplied."""
    x = x.to(compute_dtype)
    if isinstance(w, QuantizedTensor):
        return cuda_q40.q40_expert_matmul(x, w, idx, out_dtype=compute_dtype)
    wd = w.index_select(0, idx.to(torch.long)).to(compute_dtype)  # (K, d, n)
    return torch.matmul(x, wd.transpose(-1, -2))
