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
K1 takes one of four kernels by a stated rule (`k1_path`): the t = 1
GEMV, the small-batch GEMV on the tensor cores (bf16, 2 <= t <= 8), the
tensor-core path (bf16 chunks) or the older GEMV (f32, or operands
that are not 16-byte aligned, at t >= 2);
`q40_gemv_mma.launches` counts the launches that took the small-batch
GEMV (each also counts in `q40_matmul.launches`).

`q40_expert_matmul(x, w, idx, out_dtype)` is kernel K2, the counterpart of
the JAX package's q40_expert_matmul: the same product against the K experts
idx[0..K-1] of a stacked (E, d, n) Q40 weight, in one launch, with the
indices left on the device (the kernel reads them). Its plain version is
`q40_expert_matmul_reference`; it counts its own `launches`.

Both take `activation_q80`: x arrives raw (f32 or bf16) and goes through
the Q80 round trip to out_dtype first, as the JAX package's matmul applies
quantize_q80_jax / dequantize_q80_jax to its operand (XLA fuses those into
the Q40 kernel's read). On the card the round trip runs inside the t = 1
GEMV, in the same launch (csrc/q40_matmul.cu q80_store: once a CTA, into
shared memory), bit for bit the standalone Q80 kernel (ops/cuda_q80.py)
followed by the GEMV; the plain
version is the codec's round trip followed by the product. It exists at
t = 1 only (`fuses_q80`): at t >= 2 both wrappers raise, on every device,
and never skip the round trip. `q80_fused.launches` counts the launches
with the round trip fused in (each also counts in its wrapper's own).
"""

from __future__ import annotations

import ctypes
import functools
import types

import torch

from ..quants.torch_codec import QuantizedTensor, dequantize_q40_torch
from . import cuda_build
from . import launch_scope
from .cuda_q80 import q80_roundtrip_reference

# the JAX package's MAX_T (pallas_q40.py:72): larger token counts are
# FLOP-amortized and take the dequantize-then-matmul path (ops/matmul.py)
MAX_T = 256
# bf16 launches of 2 <= t <= MMA_MAX_T tokens take the small-batch GEMV on
# the tensor cores (mma.sync, one weight pass for all t tokens), more
# tokens the tensor-core path (wgmma, 64-token tiles)
MMA_MAX_T = 8
# bf16 launches with at least this many tokens take the tensor-core path:
# MMA_MAX_T + 1, where the small-batch GEMV stops. chip_smoke.py times the
# small-batch GEMV, the tensor-core path and the older GEMV side by side
# (PERF.md): the wgmma path costs the same from t = 2 to 64 (one 64-token
# tile) and the small-batch GEMV, reading the weight once for up to 8
# tokens, is faster at every t it takes; at 9-16 tokens it is untried
TC_MIN_T = 9
# the tensor-core path's geometry (csrc/q40_matmul.cu): 128 weight rows a
# CTA, 64, 128 or 256 tokens, the n axis in groups of 256 values, one wave
# = 132 CTAs (one a streaming multiprocessor); the plan's cost model, in
# 10 ns of one wave's time: a fixed cost a wave and a cost a group growing
# with the tile (fitted to the timing of every plan on the H100, PERF.md)
TC_ROWS, TC_TOKENS, TC_GROUP, TC_SMS = 128, (64, 128, 256), 256, 132
TC_WAVE_FIXED = 1360
# the small-batch GEMV's geometry (csrc/q40_matmul.cu): items of 16 rows x
# 256 values of n, a CTA's rows a multiple of 16 and at most 128, two CTAs
# a streaming multiprocessor
MMA_ROWS, MMA_CHUNK, MMA_MAX_ROWS = 16, 256, 128
# K2 has only the GEMV path: the MoE decode step calls it at t = 1 (the JAX
# package's fused expert path runs at t = b = 1 alone)
EXPERT_MAX_T = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def supports_kernel(w: QuantizedTensor, t: int) -> bool:
    """Kernel preconditions: a 2D (d, n/2) weight and at most MAX_T tokens."""
    return w.packed.dim() == 2 and t <= MAX_T


def fuses_q80(w, t: int) -> bool:
    """Whether a product of t tokens against w takes the Q80 round trip
    inside the kernel's launch: a Q40 weight (K1's (d, n) or K2's stacked
    (E, d, n)) at t = 1, the t = 1 GEMV. Everything else (t >= 2, dense
    weights) keeps the standalone round trip (ops/cuda_q80.py)."""
    return isinstance(w, QuantizedTensor) and t == 1


def _refuse_unfused(name: str, t: int, activation_q80: bool) -> None:
    if activation_q80 and t != 1:
        raise ValueError(f"{name}: the Q80 round trip is fused in at t = 1 only, "
                         f"got t={t}")


def _tc_group_cost(bn: int) -> int:
    return 86 + bn * 3 // 4


def tc_plan(t: int, n: int, d: int) -> tuple[int, int]:
    """The tensor-core path's plan, from the shapes alone: (BN, split),
    the tokens a CTA and the 2-CTA cluster split of the n axis (1 or 2).
    The least modelled time: waves of TC_SMS CTAs, each a fixed cost plus
    its groups' cost (a partial last group counts whole); ties to fewer
    splits, then to the narrower tile. csrc/q40_matmul.cu tc_plan is the
    same rule."""
    groups, row_tiles = -(-n // TC_GROUP), -(-d // TC_ROWS)
    best = None
    for split in (1, 2):
        if split > groups:
            break
        for bn in TC_TOKENS:
            ctas = -(-t // bn) * row_tiles * split
            cost = -(-ctas // TC_SMS) * (
                TC_WAVE_FIXED + -(-groups // split) * _tc_group_cost(bn))
            if best is None or cost < best[0]:
                best = (cost, bn, split)
    return best[1:]


def tc_ctas(t: int, n: int, d: int) -> int:
    """CTAs of one tensor-core launch under tc_plan."""
    bn, split = tc_plan(t, n, d)
    return -(-t // bn) * -(-d // TC_ROWS) * split


def uses_tc_path(x_dtype, out_dtype, t: int, n: int, aligned: bool = True,
                 tc_min_t: int = TC_MIN_T) -> bool:
    """The rule that sends a launch to the tensor-core path, as the C entry
    point applies it: bf16 in and out, t >= tc_min_t, n a multiple of 32
    (every width K1 takes: the TMA maps' 16-byte row strides; a partial
    last group of 256 values is loaded zero-filled), x, packed and scales
    16-byte aligned (the wrapper aligns x; every model width and expert
    slab keeps the weight aligned). Anything else takes a GEMV path."""
    return (x_dtype == out_dtype == torch.bfloat16 and t >= tc_min_t
            and n % 32 == 0 and aligned)


def k1_path(x_dtype, out_dtype, t: int, n: int, aligned: bool = True,
            tc_min_t: int = TC_MIN_T, mma_max_t: int = MMA_MAX_T) -> str:
    """The kernel a K1 launch takes, as the C entry point routes it:
    "tc" (uses_tc_path), else "mma" (the small-batch GEMV on the tensor
    cores: bf16 in and out, 2 <= t <= min(mma_max_t, MMA_MAX_T), operands
    16-byte aligned as for "tc": it copies a row's scales in pieces of up
    to 16 bytes), else "gemv1" at t = 1 and "gemv" (the older GEMV: f32
    operands, or unaligned ones) above.
    tc_min_t and mma_max_t are the private arguments chip_smoke.py forces
    a path with."""
    if uses_tc_path(x_dtype, out_dtype, t, n, aligned, tc_min_t):
        return "tc"
    if (x_dtype == out_dtype == torch.bfloat16 and 2 <= t <= min(mma_max_t, MMA_MAX_T)
            and aligned):
        return "mma"
    return "gemv1" if t == 1 else "gemv"


def mma_rows(d: int, sms: int = TC_SMS) -> int:
    """The small-batch GEMV's plan, rows a CTA (every n is cut into items
    of MMA_CHUNK values): one wave of equal CTAs at two a streaming
    multiprocessor, d / (2 x sms) rounded up to MMA_ROWS, at most
    MMA_MAX_ROWS. csrc/q40_matmul.cu mma_rows is the same rule (exported
    as q40_matmul_mma_rows, with the card's own SM count)."""
    per = -(-d // (2 * max(sms, 1)))   # rows a CTA over one wave
    rows = -(-per // MMA_ROWS) * MMA_ROWS
    return min(max(rows, MMA_ROWS), MMA_MAX_ROWS)


def mma_ctas(d: int, sms: int = TC_SMS) -> int:
    """CTAs of one small-batch GEMV launch under mma_rows."""
    return -(-d // mma_rows(d, sms))


def q40_matmul_reference(x: torch.Tensor, w: QuantizedTensor,
                         out_dtype=torch.float32,
                         activation_q80: bool = False) -> torch.Tensor:
    """Plain version: (the codec's Q80 round trip to out_dtype,) dequantize
    to f32, one f32 product, cast once."""
    if activation_q80:
        x = q80_roundtrip_reference(x, out_dtype)
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
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
                   ctypes.c_int, ctypes.c_void_p]
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
            tc_min_t: int = TC_MIN_T, activation_q80: bool = False,
            mma_max_t: int = MMA_MAX_T) -> torch.Tensor:
    t = x2.shape[0]
    _refuse_unfused("q40_matmul", t, activation_q80)
    x2 = _checked_x("q40_matmul", x2, w, out_dtype)
    n, d = x2.shape[1], w.packed.shape[0]
    out = torch.empty((t, d), dtype=out_dtype, device=x2.device)
    aligned = (x2.data_ptr() | w.packed.data_ptr() | w.scales.data_ptr()) % 16 == 0
    path = k1_path(x2.dtype, out_dtype, t, n, aligned, tc_min_t, mma_max_t)
    fn = _lib()
    rc = fn(x2.data_ptr(), _DTYPE_CODE[x2.dtype], w.packed.data_ptr(),
            w.scales.data_ptr(), out.data_ptr(), _DTYPE_CODE[out_dtype],
            t, n, d, tc_min_t, mma_max_t, int(activation_q80),
            torch.cuda.current_stream(x2.device).cuda_stream)
    cuda_build.check(rc, "q40_matmul")
    launch_scope.count(q40_matmul, "q40_matmul")
    launch_scope.count(q80_fused, "q80_fused", int(activation_q80))
    launch_scope.count(q40_gemv_mma, "q40_gemv_mma", int(path == "mma"))
    return out


def q40_matmul(x: torch.Tensor, w: QuantizedTensor,
               out_dtype=torch.float32, activation_q80: bool = False) -> torch.Tensor:
    """y[..., d] = sum_n x[..., n] * W[d, n]; x may have leading dims whose
    product is at most MAX_T. activation_q80: x through the Q80 round trip
    to out_dtype first, in the same launch (t = 1 only)."""
    lead = x.shape[:-1]
    d = w.packed.shape[0]
    t = x.numel() // x.shape[-1]
    _refuse_unfused("q40_matmul", t, activation_q80)
    if x.device.type == "cpu":
        return q40_matmul_reference(x, w, out_dtype, activation_q80)
    if x.device.type != "cuda":
        raise ValueError(f"q40_matmul: no kernel for device {x.device}")
    if not supports_kernel(w, t):
        raise ValueError(f"q40_matmul kernel takes t <= {MAX_T} tokens and "
                         f"a 2D weight, got t={t}")
    return _launch(x.reshape(t, x.shape[-1]), w, out_dtype,
                   activation_q80=activation_q80).reshape(*lead, d)


q40_matmul.launches = 0
# launches of K1 and K2 with the Q80 round trip fused in
q80_fused = types.SimpleNamespace(launches=0)
# launches of K1 that took the small-batch GEMV on the tensor cores
q40_gemv_mma = types.SimpleNamespace(launches=0)


def q40_expert_matmul_reference(x: torch.Tensor, w: QuantizedTensor,
                                idx: torch.Tensor,
                                out_dtype=torch.float32,
                                activation_q80: bool = False) -> torch.Tensor:
    """Plain version of K2: (the codec's Q80 round trip of x to out_dtype,)
    gather the K experts' packed bytes and scales on the device (indices
    clamped into range, as the kernel and the JAX package's dynamic index
    clamp them), dequantize to f32, one f32 product per expert, cast once.
    x (t, n) or (K, t, n) -> (K, t, d)."""
    if activation_q80:
        x = q80_roundtrip_reference(x, out_dtype)
    sel = idx.to(device=w.packed.device, dtype=torch.long).clamp(
        0, w.packed.shape[0] - 1)
    wd = dequantize_q40_torch(QuantizedTensor(w.packed.index_select(0, sel),
                                              w.scales.index_select(0, sel)),
                              torch.float32)                 # (K, d, n)
    y = torch.matmul(x.to(torch.float32), wd.transpose(-1, -2))
    return y.to(out_dtype)


def _expert_launch(x: torch.Tensor, w: QuantizedTensor, idx: torch.Tensor,
                   out_dtype, activation_q80: bool = False) -> torch.Tensor:
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
    _refuse_unfused("q40_expert_matmul", t, activation_q80)
    x = _checked_x("q40_expert_matmul", x, w, out_dtype)
    if idx.device != x.device:
        raise ValueError("q40_expert_matmul: idx and x on different devices")
    # a cast and a copy on the device: the indices never reach the host
    idx = idx.reshape(k).to(torch.int32).contiguous()
    out = torch.empty((k, t, d), dtype=out_dtype, device=x.device)
    rc = _expert_lib()(
        x.data_ptr(), _DTYPE_CODE[x.dtype], stride, idx.data_ptr(), k, n_e,
        w.packed.data_ptr(), w.scales.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[out_dtype], t, n, d, int(activation_q80),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(rc, "q40_expert_matmul")
    launch_scope.count(q40_expert_matmul, "q40_expert_matmul")
    launch_scope.count(q80_fused, "q80_fused", int(activation_q80))
    return out


def q40_expert_matmul(x: torch.Tensor, w: QuantizedTensor,
                      idx: torch.Tensor,
                      out_dtype=torch.float32,
                      activation_q80: bool = False) -> torch.Tensor:
    """y[k, t, d] = sum_n x[(k,) t, n] * W[idx[k], d, n]: x (t, n) shared by
    the K experts or (K, t, n) one per expert, W a stacked (E, d, n) Q40
    weight, idx (K,) expert indices on x's device. Returns (K, t, d).
    activation_q80: x through the Q80 round trip to out_dtype first, in the
    same launch (t = 1 only)."""
    if w.packed.dim() != 3:
        raise ValueError(f"q40_expert_matmul takes a stacked (E, d, n/2) "
                         f"weight, got packed {tuple(w.packed.shape)}")
    _refuse_unfused("q40_expert_matmul", x.shape[-2], activation_q80)
    if x.device.type == "cpu":
        return q40_expert_matmul_reference(x, w, idx, out_dtype, activation_q80)
    if x.device.type != "cuda":
        raise ValueError(f"q40_expert_matmul: no kernel for device "
                         f"{x.device}")
    return _expert_launch(x, w, idx, out_dtype, activation_q80)


q40_expert_matmul.launches = 0
