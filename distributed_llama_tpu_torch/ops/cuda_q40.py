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

`q40_expert_matmul(x, w, idx, out_dtype)` is kernel K2, the counterpart of
the JAX package's q40_expert_matmul: the same product against the K experts
idx[0..K-1] of a stacked (E, d, n) Q40 weight, in one launch, with the
indices left on the device (the kernel reads them). Its plain version is
`q40_expert_matmul_reference`; it counts its own `launches`.
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
# K2 has only the GEMV path: the MoE decode step calls it at t = 1 (the JAX
# package's fused expert path runs at t = b = 1 alone)
EXPERT_MAX_T = 8
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


@functools.cache
def _expert_lib():
    """K2's C entry point, in the same library as K1's."""
    fn = cuda_build.load("q40_matmul").q40_expert_matmul_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _checked_x(name: str, x: torch.Tensor, w: QuantizedTensor,
               out_dtype) -> torch.Tensor:
    """What K1 and K2 take: f32/bf16 in and out; a contiguous, 16-byte
    aligned Q40 weight (d, n/2) or stack (E, d, n/2) that fits x's n, on
    x's device. Returns x contiguous and 16-byte aligned (the kernels read
    x 16 bytes at a time); raises on anything else."""
    n, lead = x.shape[-1], tuple(w.packed.shape[:-1])
    if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} kernel takes f32/bf16, got x {x.dtype} -> "
                        f"{out_dtype}")
    if n % 32 or w.packed.shape[-1] != n // 2 or \
            tuple(w.scales.shape) != (*lead, n // 32):
        raise ValueError(f"{name}: x {tuple(x.shape)} does not fit packed "
                         f"{tuple(w.packed.shape)} / scales "
                         f"{tuple(w.scales.shape)}")
    if w.packed.dtype != torch.uint8 or w.scales.dtype != torch.float16:
        raise TypeError(f"{name}: packed must be uint8, scales float16")
    if not (w.packed.is_contiguous() and w.scales.is_contiguous()):
        raise ValueError(f"{name}: weight tensors must be contiguous")
    if w.packed.data_ptr() % 16:
        raise ValueError(f"{name}: packed must be 16-byte aligned")
    if not (x.device == w.packed.device == w.scales.device):
        raise ValueError(f"{name}: x and weight on different devices")
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _launch(x2: torch.Tensor, w: QuantizedTensor, out_dtype,
            tc_min_t: int = TC_MIN_T) -> torch.Tensor:
    x2 = _checked_x("q40_matmul", x2, w, out_dtype)
    t, n = x2.shape
    d = w.packed.shape[0]
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


def q40_expert_matmul_reference(x: torch.Tensor, w: QuantizedTensor,
                                idx: torch.Tensor,
                                out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of K2: gather the K experts' packed bytes and scales
    on the device (indices clamped into range, as the kernel and the JAX
    package's dynamic index clamp them), dequantize to f32, one f32
    product per expert, cast once. x (t, n) or (K, t, n) -> (K, t, d)."""
    sel = idx.to(device=w.packed.device, dtype=torch.long).clamp(
        0, w.packed.shape[0] - 1)
    wd = dequantize_q40_torch(QuantizedTensor(w.packed.index_select(0, sel),
                                              w.scales.index_select(0, sel)),
                              torch.float32)                 # (K, d, n)
    y = torch.matmul(x.to(torch.float32), wd.transpose(-1, -2))
    return y.to(out_dtype)


def _expert_launch(x: torch.Tensor, w: QuantizedTensor, idx: torch.Tensor,
                   out_dtype) -> torch.Tensor:
    k = idx.numel()
    n_e, d, _ = w.packed.shape
    n = x.shape[-1]
    if x.dim() == 2:
        t, stride = x.shape[0], 0
    elif x.dim() == 3 and x.shape[0] == k:
        t, stride = x.shape[1], x.shape[1] * n
    else:
        raise ValueError(f"q40_expert_matmul: x {tuple(x.shape)} is neither "
                         f"(t, n) nor ({k}, t, n)")
    if t > EXPERT_MAX_T:
        raise ValueError(f"q40_expert_matmul kernel takes t <= "
                         f"{EXPERT_MAX_T} tokens, got t={t}")
    x = _checked_x("q40_expert_matmul", x, w, out_dtype)
    if idx.device != x.device:
        raise ValueError("q40_expert_matmul: idx and x on different devices")
    # a cast and a copy on the device: the indices never reach the host
    idx = idx.reshape(k).to(torch.int32).contiguous()
    out = torch.empty((k, t, d), dtype=out_dtype, device=x.device)
    rc = _expert_lib()(
        x.data_ptr(), _DTYPE_CODE[x.dtype], stride, idx.data_ptr(), k, n_e,
        w.packed.data_ptr(), w.scales.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[out_dtype], t, n, d,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(rc, "q40_expert_matmul")
    q40_expert_matmul.launches += 1
    return out


def q40_expert_matmul(x: torch.Tensor, w: QuantizedTensor,
                      idx: torch.Tensor,
                      out_dtype=torch.float32) -> torch.Tensor:
    """y[k, t, d] = sum_n x[(k,) t, n] * W[idx[k], d, n]: x (t, n) shared by
    the K experts or (K, t, n) one per expert, W a stacked (E, d, n) Q40
    weight, idx (K,) expert indices on x's device. Returns (K, t, d)."""
    if w.packed.dim() != 3:
        raise ValueError(f"q40_expert_matmul takes a stacked (E, d, n/2) "
                         f"weight, got packed {tuple(w.packed.shape)}")
    if x.device.type == "cpu":
        return q40_expert_matmul_reference(x, w, idx, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"q40_expert_matmul: no kernel for device "
                         f"{x.device}")
    return _expert_launch(x, w, idx, out_dtype)


q40_expert_matmul.launches = 0
