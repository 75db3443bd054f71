"""The Q40 decode-GEMV design probes — counterparts of the Pallas probes in
the JAX repository's tools/ (kernel_ladder.py, kernel_experiments.py,
exp_int8_dot.py), as hand-written Hopper kernels in csrc/q40_probes.cu
(design and bound in the source's header).

  q40_ladder(stage, x, w)  the cost ladder, one stage of STAGES per launch
  q40_matmul_a(x, w)       the dequantized weight in bf16, -8 inside
  q40_matmul_b(x, w)       unsigned nibbles in bf16, -8 as an f32 correction
  int8_gemv(xq, pk, sc)    int4 widened to int8, integer dot, row scale

The Q40 probes take the port's block-major packed bytes (d, n/2) uint8 with
**f32** scales (d, n/32), as the TPU probes' kernels read them. Each wrapper
runs its plain PyTorch version (`*_reference`) on a CPU tensor, launches
its kernel on a CUDA tensor, and raises on any other device: there is no
fallback from a kernel to its plain version. Each wrapper's `launches`
counts its kernel launches; plain-version calls do not count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..quants.torch_codec import QuantizedTensor
from . import cuda_build

STAGES = ("read", "unpack", "convert", "mul", "dot")
# xq is staged whole in shared memory without an opt-in: at most 48 KB
INT8_MAX_K = 49152


def _nibbles(w: QuantizedTensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) nibbles of a block-major Q40 weight as (d, nb, 16) int32:
    byte j of block b holds element b*32+j (lo) and b*32+16+j (hi)."""
    nb = w.scales.shape[-1]
    pk = w.packed.reshape(*w.packed.shape[:-1], nb, 16).to(torch.int32)
    return pk & 0xF, pk >> 4


def _xor_reduce(v: torch.Tensor) -> torch.Tensor:
    """XOR over the last dim of an integer tensor."""
    while v.shape[-1] > 1:
        if v.shape[-1] % 2:
            v = torch.cat([v[..., :1] ^ v[..., -1:], v[..., 1:-1]], dim=-1)
        h = v.shape[-1] // 2
        v = v[..., :h] ^ v[..., h:]
    return v[..., 0]


def q40_ladder_reference(stage: str, x: torch.Tensor,
                         w: QuantizedTensor) -> torch.Tensor:
    """Plain version of one ladder stage: (1, d), int32 for read and unpack,
    f32 for convert, mul and dot (sums in f32)."""
    lo, hi = _nibbles(w)
    sbits = _xor_reduce(w.scales.contiguous().view(torch.int32))
    if stage == "read":
        words = w.packed.contiguous().view(torch.int32)
        y = _xor_reduce(words) ^ sbits
    elif stage == "unpack":
        y = (lo + hi).sum(dim=(-2, -1)).to(torch.int32) ^ sbits
    elif stage == "convert":
        y = (lo + hi).to(torch.float32).sum(dim=(-2, -1)) + w.scales.sum(-1)
    else:
        s = w.scales[..., None]
        wlo, whi = lo.to(torch.float32) * s, hi.to(torch.float32) * s
        if stage == "mul":
            y = (wlo + whi).sum(dim=(-2, -1))
        else:  # dot: x . (nib * s), no -8
            wd = torch.cat([wlo, whi], dim=-1).reshape(w.packed.shape[0], -1)
            return torch.matmul(x.to(torch.float32), wd.t())
    return y[None, :]


def _bf16_weight(w: QuantizedTensor, minus8: bool) -> torch.Tensor:
    """The dequantized weight of A (minus8) or B, (d, n) bf16-exact f32:
    bf16(bf16(nib - 8) * bf16(s)), or bf16(nib * bf16(s)) for B."""
    lo, hi = _nibbles(w)
    nib = torch.cat([lo, hi], dim=-1) - (8 if minus8 else 0)    # (d, nb, 32)
    sb = w.scales.to(torch.bfloat16)[..., None]
    wd = nib.to(torch.bfloat16) * sb                             # one bf16 rounding
    return wd.reshape(w.packed.shape[0], -1).to(torch.float32)


def q40_matmul_a_reference(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """Plain version of A: (t, n) bf16 x the bf16 weight, in f32 -> (t, d) f32."""
    return torch.matmul(x.to(torch.float32), _bf16_weight(w, True).t())


def q40_matmul_b_reference(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """Plain version of B: x . bf16(nib * bf16(s)) - 8 sum_b s[d, b] xsum[t, b]
    with the f32 scales, xsum[t, b] the sum of block b of x, in f32."""
    xf = x.to(torch.float32)
    xsum = xf.reshape(xf.shape[0], -1, 32).sum(-1)               # (t, nb)
    return (torch.matmul(xf, _bf16_weight(w, False).t())
            - 8.0 * torch.matmul(xsum, w.scales.to(torch.float32).t()))


def int8_gemv_reference(xq: torch.Tensor, pk: torch.Tensor,
                        sc: torch.Tensor) -> torch.Tensor:
    """Plain version of the int8 probe: exact integer sums, one f32 multiply
    per row. xq (1, K) int8, pk (D, K/2) u8 column-split, sc (D, 1) f32."""
    half = pk.shape[-1]
    p = pk.to(torch.int32)
    x = xq.to(torch.int32)
    acc = (((p & 0xF) - 8) * x[:, :half]).sum(-1) + \
        (((p >> 4) - 8) * x[:, half:]).sum(-1)                   # (D,)
    return (acc.to(torch.float32) * sc[:, 0])[None, :]


@functools.cache
def _fn(entry: str, argtypes: tuple):
    """A C entry point of the probes' library, loaded and typed once."""
    fn = getattr(cuda_build.load("q40_probes"), entry)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int
_Q40_ARGS = (_P, _P, _P, _P, _I, _I, _I, _P)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (the kernels read 16 bytes at a time)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _device_of(name: str, *ts: torch.Tensor) -> str:
    """'cpu' or 'cuda' for tensors all on one device; raises otherwise."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on different devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev.type


def _checked_q40(name: str, x: torch.Tensor, w: QuantizedTensor, x_dtype,
                 max_t: int) -> torch.Tensor:
    """What the Q40 probes take: x (t, n) of x_dtype with t <= max_t, a
    block-major (d, n/2) u8 weight with (d, n/32) f32 scales, n % 32 == 0.
    Returns x contiguous and 16-byte aligned; raises on anything else."""
    if x.dim() != 2 or not 1 <= x.shape[0] <= max_t:
        raise ValueError(f"{name}: x must be (t, n) with 1 <= t <= {max_t}, "
                         f"got {tuple(x.shape)}")
    if x.dtype != x_dtype:
        raise TypeError(f"{name}: x must be {x_dtype}, got {x.dtype}")
    n = x.shape[1]
    if n % 32 or w.packed.dim() != 2 or w.packed.shape[1] != n // 2 or \
            tuple(w.scales.shape) != (w.packed.shape[0], n // 32):
        raise ValueError(f"{name}: x {tuple(x.shape)} does not fit packed "
                         f"{tuple(w.packed.shape)} / scales {tuple(w.scales.shape)}")
    if w.packed.dtype != torch.uint8 or w.scales.dtype != torch.float32:
        raise TypeError(f"{name}: packed must be uint8, scales float32")
    if not (w.packed.is_contiguous() and w.scales.is_contiguous()):
        raise ValueError(f"{name}: weight tensors must be contiguous")
    if w.packed.data_ptr() % 16:
        raise ValueError(f"{name}: packed must be 16-byte aligned")
    return _aligned(x)


def q40_ladder(stage: str, x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """One stage of the cost ladder over a (d, n) Q40 weight with f32 scales
    and x (1, n) f32 (read by `dot` only) -> (1, d): int32 for read and
    unpack, f32 for convert, mul and dot."""
    if stage not in STAGES:
        raise ValueError(f"q40_ladder: stage {stage!r} is not one of {STAGES}")
    if _device_of("q40_ladder", x, w.packed, w.scales) == "cpu":
        return q40_ladder_reference(stage, x, w)
    x = _checked_q40("q40_ladder", x, w, torch.float32, 1)
    d, n = w.packed.shape[0], x.shape[1]
    dtype = torch.int32 if stage in ("read", "unpack") else torch.float32
    out = torch.empty((1, d), dtype=dtype, device=x.device)
    rc = _fn("q40_ladder_launch", (_I,) + _Q40_ARGS[:4] + (_I, _I, _P))(
        STAGES.index(stage), x.data_ptr(), w.packed.data_ptr(),
        w.scales.data_ptr(), out.data_ptr(), n, d, _stream(x))
    cuda_build.check(rc, "q40_ladder")
    q40_ladder.launches += 1
    return out


q40_ladder.launches = 0


def _bf16_launch(name: str, entry: str, x: torch.Tensor,
                 w: QuantizedTensor) -> torch.Tensor:
    x = _checked_q40(name, x, w, torch.bfloat16, 65535)
    (t, n), d = x.shape, w.packed.shape[0]
    out = torch.empty((t, d), dtype=torch.float32, device=x.device)
    rc = _fn(entry, _Q40_ARGS)(x.data_ptr(), w.packed.data_ptr(),
                               w.scales.data_ptr(), out.data_ptr(), t, n, d,
                               _stream(x))
    cuda_build.check(rc, name)
    return out


def q40_matmul_a(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """y (t, d) f32 = x (t, n) bf16 . W, W dequantized as
    bf16(bf16(nib - 8) * bf16(s)), products summed in f32."""
    if _device_of("q40_matmul_a", x, w.packed, w.scales) == "cpu":
        return q40_matmul_a_reference(x, w)
    out = _bf16_launch("q40_matmul_a", "q40_matmul_a_launch", x, w)
    q40_matmul_a.launches += 1
    return out


q40_matmul_a.launches = 0


def q40_matmul_b(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """y (t, d) f32 = x . bf16(nib * bf16(s)) - 8 sum_b s[d, b] xsum[t, b]:
    A's product with the -8 folded out of the dequantize."""
    if _device_of("q40_matmul_b", x, w.packed, w.scales) == "cpu":
        return q40_matmul_b_reference(x, w)
    out = _bf16_launch("q40_matmul_b", "q40_matmul_b_launch", x, w)
    q40_matmul_b.launches += 1
    return out


q40_matmul_b.launches = 0


def int8_gemv(xq: torch.Tensor, pk: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """y (1, D) f32 = (sum_j xq[j] (lo[d, j] - 8) + xq[K/2 + j] (hi[d, j] - 8))
    * sc[d]: xq (1, K) int8, pk (D, K/2) u8 whose byte j holds column j (lo)
    and column K/2 + j (hi), sc (D, 1) f32."""
    if _device_of("int8_gemv", xq, pk, sc) == "cpu":
        return int8_gemv_reference(xq, pk, sc)
    if xq.dim() != 2 or xq.shape[0] != 1 or xq.dtype != torch.int8:
        raise ValueError(f"int8_gemv: xq must be (1, K) int8, got "
                         f"{tuple(xq.shape)} {xq.dtype}")
    k = xq.shape[1]
    d = pk.shape[0]
    if k % 32 or k > INT8_MAX_K or pk.dim() != 2 or pk.shape[1] != k // 2 \
            or tuple(sc.shape) != (d, 1):
        raise ValueError(f"int8_gemv: xq {tuple(xq.shape)}, pk {tuple(pk.shape)}, "
                         f"sc {tuple(sc.shape)} do not fit (K % 32 == 0, K <= "
                         f"{INT8_MAX_K})")
    if pk.dtype != torch.uint8 or sc.dtype != torch.float32:
        raise TypeError("int8_gemv: pk must be uint8, sc float32")
    if not (pk.is_contiguous() and sc.is_contiguous()) or pk.data_ptr() % 16:
        raise ValueError("int8_gemv: pk and sc must be contiguous, pk 16-byte aligned")
    xq = _aligned(xq)
    out = torch.empty((1, d), dtype=torch.float32, device=xq.device)
    rc = _fn("int8_gemv_launch", (_P, _P, _P, _P, _I, _I, _P))(
        xq.data_ptr(), pk.data_ptr(), sc.data_ptr(), out.data_ptr(), k, d,
        _stream(xq))
    cuda_build.check(rc, "int8_gemv")
    int8_gemv.launches += 1
    return out


int8_gemv.launches = 0
