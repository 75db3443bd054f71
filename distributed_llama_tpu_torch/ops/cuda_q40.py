"""Q40 matmul kernel K1 — counterpart of the JAX package's ops/pallas_q40.py
q40_matmul.

`q40_matmul(x, w, out_dtype)` computes y[..., d] = sum_n x[..., n] * W[d, n]
with W a packed Q40 `QuantizedTensor` (quants/torch_codec.py), accumulated
in f32. On a CUDA tensor it launches the hand-written Hopper kernel
csrc/q40_matmul.cu (design and bound in the source's header); on a CPU
tensor it runs `q40_matmul_reference`, the plain PyTorch version of the same
function — the CPU tests' path and the kernel's oracle on the card. Any
other device raises. There is no fallback from the kernel to the plain
version.

`q40_matmul.launches` counts kernel launches (plain-version calls do not
count), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..quants.torch_codec import QuantizedTensor, dequantize_q40_torch
from . import cuda_build

# the JAX package's MAX_T (pallas_q40.py:72): larger token counts are
# FLOP-amortized and take the dequantize-then-matmul path (ops/matmul.py)
MAX_T = 256
# bf16 launches with at least this many tokens take the kernel's tensor-core
# path, fewer its GEMV path: where the two paths' times, summed over one
# Llama-2-7B layer's projections, cross on an H100 (chip_smoke.py times
# both). The GEMV path pays one weight pass per 8 tokens, so from t = 9 on
# it makes two and loses to the tensor-core path.
TC_MIN_T = 9
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def supports_kernel(w: QuantizedTensor, t: int) -> bool:
    """Kernel preconditions: a 2D (d, n/2) weight and at most MAX_T tokens."""
    return w.packed.dim() == 2 and t <= MAX_T


def q40_matmul_reference(x: torch.Tensor, w: QuantizedTensor,
                         out_dtype=torch.float32) -> torch.Tensor:
    """Plain version: dequantize to f32, one f32 product, cast once."""
    wd = dequantize_q40_torch(w, torch.float32)
    y = torch.matmul(x.to(torch.float32), wd.t())
    return y.to(out_dtype)


@functools.cache
def _lib():
    """The C entry point, loaded and typed once at first launch."""
    lib = cuda_build.load("q40_matmul")
    fn = lib.q40_matmul_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x2: torch.Tensor, w: QuantizedTensor, out_dtype,
            tc_min_t: int = TC_MIN_T) -> torch.Tensor:
    t, n = x2.shape
    d = w.packed.shape[0]
    if x2.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"q40_matmul kernel takes f32/bf16, got x "
                        f"{x2.dtype} -> {out_dtype}")
    if n % 32 or tuple(w.packed.shape) != (d, n // 2) or \
            tuple(w.scales.shape) != (d, n // 32):
        raise ValueError(f"q40_matmul: x {tuple(x2.shape)} does not fit "
                         f"packed {tuple(w.packed.shape)} / scales "
                         f"{tuple(w.scales.shape)}")
    if w.packed.dtype != torch.uint8 or w.scales.dtype != torch.float16:
        raise TypeError("q40_matmul: packed must be uint8, scales float16")
    if not (w.packed.is_contiguous() and w.scales.is_contiguous()):
        raise ValueError("q40_matmul: weight tensors must be contiguous")
    if w.packed.data_ptr() % 16:
        raise ValueError("q40_matmul: packed must be 16-byte aligned")
    if not (x2.device == w.packed.device == w.scales.device):
        raise ValueError("q40_matmul: x and weight on different devices")
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:  # the kernel reads x 16 bytes at a time
        x2 = x2.clone()
    out = torch.empty((t, d), dtype=out_dtype, device=x2.device)
    fn = _lib()
    rc = fn(x2.data_ptr(), _DTYPE_CODE[x2.dtype], w.packed.data_ptr(),
            w.scales.data_ptr(), out.data_ptr(), _DTYPE_CODE[out_dtype],
            t, n, d, tc_min_t, torch.cuda.current_stream(x2.device).cuda_stream)
    cuda_build.check(rc, "q40_matmul")
    q40_matmul.launches += 1
    return out


def q40_matmul(x: torch.Tensor, w: QuantizedTensor,
               out_dtype=torch.float32) -> torch.Tensor:
    """y[..., d] = sum_n x[..., n] * W[d, n]; x may have leading dims whose
    product is at most MAX_T."""
    lead = x.shape[:-1]
    d = w.packed.shape[0]
    if x.device.type == "cpu":
        return q40_matmul_reference(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"q40_matmul: no kernel for device {x.device}")
    t = x.numel() // x.shape[-1]
    if not supports_kernel(w, t):
        raise ValueError(f"q40_matmul kernel takes t <= {MAX_T} tokens and "
                         f"a 2D weight, got t={t}")
    return _launch(x.reshape(t, x.shape[-1]), w, out_dtype).reshape(*lead, d)


q40_matmul.launches = 0
