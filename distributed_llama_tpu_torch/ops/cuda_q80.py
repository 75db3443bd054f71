"""The Q80 activation round trip — counterpart of the round trip the JAX
package's ops/matmul.py applies to every matmul input when activation_q80
is set (quantize_q80_jax, then dequantize_q80_jax to the compute dtype).

`q80_roundtrip(x, dtype)` returns dequantize_q80(quantize_q80(x)) in
`dtype`: per 32-value block of the last axis, x rounded to int8 steps of
absmax/127. On a CUDA tensor it launches csrc/q80_roundtrip.cu, one launch
per call, bit-equal to the plain version; on a CPU tensor it runs
`q80_roundtrip_reference` (quants/torch_codec.py's codec). Any other device
raises. `q80_roundtrip.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..quants.torch_codec import dequantize_q80_torch, quantize_q80_torch
from ..quants.types import BLOCK_SIZE
from . import cuda_build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def q80_roundtrip_reference(x: torch.Tensor, dtype) -> torch.Tensor:
    """Plain version: the codec's quantize, then dequantize to dtype."""
    q, s = quantize_q80_torch(x)
    return dequantize_q80_torch(q, s, dtype)


@functools.cache
def _lib():
    fn = cuda_build.load("q80_roundtrip").q80_roundtrip_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def q80_roundtrip(x: torch.Tensor, dtype) -> torch.Tensor:
    """x (..., n), n a multiple of 32, f32 or bf16 -> the same shape in
    dtype (f32 or bf16), every 32-value block through Q80 and back."""
    if x.shape[-1] % BLOCK_SIZE:
        raise ValueError(f"q80_roundtrip: last axis {x.shape[-1]} is not a "
                         f"multiple of {BLOCK_SIZE}")
    if x.device.type == "cpu":
        return q80_roundtrip_reference(x, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"q80_roundtrip: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODE or dtype not in _DTYPE_CODE:
        raise TypeError(f"q80_roundtrip kernel takes f32/bf16, got {x.dtype} "
                        f"-> {dtype}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    if x.numel():
        rc = _lib()(x.data_ptr(), _DTYPE_CODE[x.dtype], out.data_ptr(),
                    _DTYPE_CODE[dtype], x.numel(),
                    torch.cuda.current_stream(x.device).cuda_stream)
        cuda_build.check(rc, "q80_roundtrip")
        q80_roundtrip.launches += 1
    return out


q80_roundtrip.launches = 0
