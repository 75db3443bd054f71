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
