"""The design probes — counterparts of the Pallas probes in the JAX
repository's tools/ (kernel_ladder.py, kernel_experiments.py,
exp_int8_dot.py in csrc/q40_probes.cu; exp_pk_decode.py, exp_scale_f16.py
in csrc/q40_gemv1_probes.cu; exp_f8_flash.py in csrc/f8_flash_probe.cu;
exp_unpack_overlap.py in csrc/q40_prefill_probe.cu), as hand-written Hopper
kernels (design and bound in each source's header).

  q40_ladder(stage, x, w)          the cost ladder, one stage of STAGES per launch
  q40_matmul_a(x, w)               the dequantized weight in bf16, -8 inside
  q40_matmul_b(x, w)               unsigned nibbles in bf16, -8 as an f32 correction
  int8_gemv(xq, pk, sc)            int4 widened to int8, integer dot, row scale
  f8_flash_decode(mode, pos, q, k, v)  flash decode over a bf16 or e4m3 cache,
                                   one of F8_MODES of converting it; S split
                                   by f8_split_plan (f8_flash_decode_split:
                                   at a given split, for sweeps)
  q40_pk_gemv(mode, x1, x2, xs, w) the GEMV with or without the `& 0xF`
                                   (PK_MODES: lo = pk - 16 hi folded into x2)
  q40_matmul_scales(x, w)          the GEMV with u16 (f16 bits) or f32 scales
  q40_gemv1_probe(mode, body, rows, xa, xb, xs, w, pdl)  P3 or P5's kernel
                                   with another body (GEMV1_BODIES), rows a
                                   CTA or as a dependent launch, for sweeps
  q40_matmul_sub(x, w, n_sub, td)  a prefill chunk on the tensor cores, the
                                   dequantize overlapped (n_sub > 1) or not

The ladder, A, B and the scales probe take the port's block-major packed
bytes (d, n/2) uint8 with **f32** scales (d, n/32), as the TPU probes'
kernels read them (the scales probe also u16); the pk and overlap probes
take float16 scales, as K1 does. Each wrapper runs its plain PyTorch
version (`*_reference`) on a CPU tensor, launches its kernel on a CUDA
tensor, and raises on any other device: there is no fallback from a kernel
to its plain version. `kernel_attrs` reads a P2, P3/P5 or P6 kernel's
registers and local (spill) bytes as built. Each wrapper's `launches` counts its calls that
launched the kernel (f8_flash_decode may launch two kernels per call, the
split pass and the merge, q40_matmul_sub two, the block sums of x and the
product; f8_flash_decode_split counts on f8_flash_decode, q40_gemv1_probe
on q40_pk_gemv or q40_matmul_scales); plain-version calls do not count.
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
def _fn(entry: str, argtypes: tuple, lib: str = "q40_probes"):
    """A C entry point of a probes' library, loaded and typed once."""
    fn = getattr(cuda_build.load(lib), entry)
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
                 max_t: int, scale_dtypes=(torch.float32,)) -> torch.Tensor:
    """What the Q40 probes take: x (t, n) of x_dtype with t <= max_t, a
    block-major (d, n/2) u8 weight with (d, n/32) scales of scale_dtypes
    (f32 unless told otherwise), n % 32 == 0. Returns x contiguous and
    16-byte aligned; raises on anything else."""
    if x.dim() != 2 or not 1 <= x.shape[0] <= max_t:
        raise ValueError(f"{name}: x must be (t, n) with 1 <= t <= {max_t}, "
                         f"got {tuple(x.shape)}")
    if x.dtype != x_dtype:
        raise TypeError(f"{name}: x must be {x_dtype}, got {x.dtype}")
    _checked_weight(name, w, x.shape[1], scale_dtypes)
    return _aligned(x)


def _checked_weight(name: str, w: QuantizedTensor, n: int, scale_dtypes) -> None:
    """A contiguous block-major (d, n/2) u8 weight, 16-byte aligned, with
    (d, n/32) scales of scale_dtypes, n % 32 == 0; raises otherwise."""
    if n % 32 or w.packed.dim() != 2 or w.packed.shape[1] != n // 2 or \
            tuple(w.scales.shape) != (w.packed.shape[0], n // 32):
        raise ValueError(f"{name}: n = {n} does not fit packed "
                         f"{tuple(w.packed.shape)} / scales {tuple(w.scales.shape)}")
    if w.packed.dtype != torch.uint8 or w.scales.dtype not in scale_dtypes:
        raise TypeError(f"{name}: packed must be uint8, scales one of {scale_dtypes}, "
                        f"got {w.packed.dtype}, {w.scales.dtype}")
    if not (w.packed.is_contiguous() and w.scales.is_contiguous()):
        raise ValueError(f"{name}: weight tensors must be contiguous")
    if w.packed.data_ptr() % 16:
        raise ValueError(f"{name}: packed must be 16-byte aligned")


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


# ---------------------------------------------------------------------------
# P2: flash decode over an fp8 cache (tools/exp_f8_flash.py)

F8_MODES = ("plain", "astype", "bits", "bitsflush")
F8_HS = 128                 # the kernel's head size
# csrc/f8_flash_probe.cu: kSms, kWarps (a slot range each), kStg (slots a
# stage), blocks an SM by cache type (kBpsBf16, kBpsF8)
F8_SMS, F8_WARPS, F8_STAGE = 132, 4, 16
F8_BLOCKS_PER_SM = {"bf16": 1, "e4m3": 4}
_F8_CACHE = {"plain": torch.bfloat16, "astype": torch.float8_e4m3fn,
             "bits": torch.uint8, "bitsflush": torch.uint8}


def f8_split_plan(rows: int, s_len: int, mode: str) -> int:
    """Blocks a row of the split pass, from the shapes and the mode's cache
    type alone (f8_plan in csrc/f8_flash_probe.cu): as many as keep rows x
    n_split within one wave of F8_BLOCKS_PER_SM blocks an SM, at least 1,
    at most one 16-slot stage a warp of S."""
    most = -(-s_len // (F8_WARPS * F8_STAGE))
    per_sm = F8_BLOCKS_PER_SM["bf16" if mode == "plain" else "e4m3"]
    return max(1, min(F8_SMS * per_sm // rows, most))


def f8_split_ranges(pos: torch.Tensor, kvh: int, s_len: int,
                    n_split: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(start, count), each (rows, n_split * F8_WARPS) int64: the slots of
    every warp of the split pass, as each block derives them from pos on
    the device. Row i's fill = min(pos[i // kvh], S - 1) + 1 visible slots
    are cut into n_split * F8_WARPS ranges of ceil(fill / units) slots;
    warp u of the row (block u // F8_WARPS) takes [start, start + count)."""
    units = n_split * F8_WARPS
    fill = pos.to(torch.int64).clamp(max=s_len - 1).repeat_interleave(kvh) + 1
    per = (fill + units - 1) // units
    u = torch.arange(units, device=pos.device)
    start = torch.minimum(u[None, :] * per[:, None], fill[:, None])
    return start, torch.minimum(per[:, None], fill[:, None] - start)


def f8_split_partials(mode: str, pos: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, n_split: int):
    """The split pass in plain PyTorch: for every warp range of
    f8_split_ranges the partial (m, l, acc) in f32, m the range's max score,
    l the sum of p = exp(s - m) and acc the sum of bf16(p) v; an empty range
    gives m = -1e30, l = 0, acc = 0. m, l (rows, units), acc (rows, units,
    128)."""
    rows, s_len, hs = k.shape
    start, count = f8_split_ranges(pos, rows // pos.numel(), s_len, n_split)
    kf = f8_cache_bf16(mode, k).to(torch.float32)
    vf = f8_cache_bf16(mode, v).to(torch.float32)
    scores = torch.matmul(q.to(torch.float32), kf.transpose(1, 2)) * (1.0 / hs ** 0.5)
    slot = torch.arange(s_len, device=k.device)
    inside = (slot >= start[..., None]) & (slot < (start + count)[..., None])
    s = torch.where(inside, scores, torch.full_like(scores, -1e30))   # (rows, units, S)
    m = s.amax(-1)
    p = torch.where(inside, torch.exp(s - m[..., None]), torch.zeros_like(s))
    return m, p.sum(-1), torch.matmul(p.to(torch.bfloat16).to(torch.float32), vf)


def f8_merge_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Partials (m, l, acc) over a row's ranges -> (rows, 1, 128) bf16:
    each weighed by exp(m - the row's max), summed in range order."""
    w = torch.exp(m - m.amax(-1, keepdim=True))
    out = (acc * w[..., None]).sum(1) / (l * w).sum(-1, keepdim=True)
    return out.to(torch.bfloat16)[:, None, :]


def f8_bits_to_bf16(u8: torch.Tensor, flush: bool) -> torch.Tensor:
    """e4m3fn bits (uint8) -> bf16 as the JAX tool's _f8_bits_to_bf16 does,
    by f32 bit reassembly: normals sign<<31 | (exp+120)<<23 | mant<<20,
    magnitudes below 8 (subnormals) mant * 2^-9, or signed zero with flush.
    The NaN magnitude 0x7F comes out as 480."""
    i = u8.to(torch.int32)
    sign = (i & 0x80) << 24
    mag = i & 0x7F
    normal = (mag << 20) + (120 << 23)
    if flush:
        sub = torch.zeros_like(mag)
    else:
        sub = (mag.to(torch.float32) * 2.0 ** -9).view(torch.int32)
    bits = torch.where(mag < 8, sub, normal) | sign
    return bits.view(torch.float32).to(torch.bfloat16)


def f8_cache_bf16(mode: str, c: torch.Tensor) -> torch.Tensor:
    """A cache of `mode`'s dtype as bf16, by that mode's conversion."""
    if mode == "plain":
        return c
    if mode == "astype":
        return c.to(torch.bfloat16)
    return f8_bits_to_bf16(c, mode == "bitsflush")


def f8_flash_decode_reference(mode: str, pos: torch.Tensor, q: torch.Tensor,
                              k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: the cache in bf16 by the mode's conversion, dense
    masked scores in f32, p = exp(s - max) rounded to bf16 before P.V, sums
    in f32, the output in bf16. Row i sees slot s iff s <= pos[i // kvh]."""
    rows, s_len, hs = k.shape
    kvh = rows // pos.numel()
    kf = f8_cache_bf16(mode, k).to(torch.float32)
    vf = f8_cache_bf16(mode, v).to(torch.float32)
    scores = torch.matmul(q.to(torch.float32), kf.transpose(1, 2)) * (1.0 / hs ** 0.5)
    lim = pos.to(torch.long).repeat_interleave(kvh)
    seen = torch.arange(s_len, device=k.device)[None, None, :] <= lim[:, None, None]
    scores = torch.where(seen, scores, torch.full_like(scores, -1e30))
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    pv = torch.matmul(p.to(torch.bfloat16).to(torch.float32), vf)
    return (pv / p.sum(-1, keepdim=True)).to(torch.bfloat16)


def f8_flash_decode(mode: str, pos: torch.Tensor, q: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One decode step of attention, q (R, 1, 128) bf16 against k, v
    (R, S, 128) — bf16 for `plain`, float8_e4m3fn for `astype`, uint8 e4m3
    bits for `bits` and `bitsflush` — with pos (b,) int32 >= 0, R = b * kvh.
    Returns (R, 1, 128) bf16. The kernel splits S by f8_split_plan."""
    if mode not in F8_MODES:
        raise ValueError(f"f8_flash_decode: mode {mode!r} is not one of {F8_MODES}")
    if _device_of("f8_flash_decode", pos, q, k, v) == "cpu":
        return f8_flash_decode_reference(mode, pos, q, k, v)
    return _f8_launch(mode, pos, q, k, v, 0)


def f8_flash_decode_split(mode: str, pos: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, n_split: int) -> torch.Tensor:
    """f8_flash_decode with n_split blocks a row instead of the plan's, for
    timing split counts against each other. On the CPU: the split pass's
    plain version (f8_split_partials, then f8_merge_partials)."""
    if mode not in F8_MODES or n_split < 1:
        raise ValueError(f"f8_flash_decode_split: mode {mode!r} not in {F8_MODES} "
                         f"or n_split {n_split} < 1")
    if _device_of("f8_flash_decode_split", pos, q, k, v) == "cpu":
        return f8_merge_partials(*f8_split_partials(mode, pos, q, k, v, n_split))
    return _f8_launch(mode, pos, q, k, v, n_split)


def _f8_launch(mode: str, pos: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, n_split: int) -> torch.Tensor:
    """Check the operands and launch the kernel (n_split 0: the plan's);
    counts on f8_flash_decode.launches."""
    if k.dim() != 3 or k.shape != v.shape or k.shape[2] != F8_HS or \
            tuple(q.shape) != (k.shape[0], 1, F8_HS) or pos.dim() != 1 or \
            pos.numel() < 1 or k.shape[0] % pos.numel():
        raise ValueError(f"f8_flash_decode: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, pos {tuple(pos.shape)} do not fit "
                         f"(R, 1, {F8_HS}), (R, S, {F8_HS}), (b,) with R % b == 0")
    want = _F8_CACHE[mode]
    if k.dtype != want or v.dtype != want or q.dtype != torch.bfloat16 or \
            pos.dtype != torch.int32:
        raise TypeError(f"f8_flash_decode {mode}: wants q bf16, k and v {want}, pos "
                        f"int32; got {q.dtype}, {k.dtype}, {v.dtype}, {pos.dtype}")
    if not (k.is_contiguous() and v.is_contiguous()) or k.data_ptr() % 16 \
            or v.data_ptr() % 16:
        raise ValueError("f8_flash_decode: k and v must be contiguous and 16-byte aligned")
    rows, s_len, _ = k.shape
    q, pos = q.contiguous(), pos.contiguous()
    n = n_split or f8_split_plan(rows, s_len, mode)
    # the split pass's partial (m, l, acc) per row and block (unread at n = 1)
    part_m = torch.empty((rows, n), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((rows, n, F8_HS), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    rc = _fn("f8_flash_decode_launch", (_I,) + (_P,) * 8 + (_I, _I, _I, _I, _P),
             "f8_flash_probe")(
        F8_MODES.index(mode), q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
        rows, rows // pos.numel(), s_len, n, _stream(q))
    cuda_build.check(rc, "f8_flash_decode")
    f8_flash_decode.launches += 1
    return out


f8_flash_decode.launches = 0


def f8_flash_plan_kernel(rows: int, s_len: int, mode: str) -> int:
    """The split count the kernel's own plan gives (must equal
    f8_split_plan); loads the library."""
    return _fn("f8_flash_plan", (_I, _I, _I), "f8_flash_probe")(rows, s_len, F8_MODES.index(mode))


def kernel_attrs(kind: str, *variant: int) -> dict:
    """A probe kernel as compiled, from cudaFuncGetAttributes: registers a
    thread, local (spill) bytes a thread, static and dynamic shared bytes,
    threads a block. kind "f8" with (mode index,), "sub" with (td, n_sub),
    or "gemv1" with (GEMV1_MODES index, GEMV1_BODIES index)."""
    entry, lib = {"f8": ("f8_flash_decode_attrs", "f8_flash_probe"),
                  "sub": ("q40_matmul_sub_attrs", "q40_prefill_probe"),
                  "gemv1": ("q40_gemv1_probe_attrs", "q40_gemv1_probes")}[kind]
    vals = (ctypes.c_int * 5)()
    rc = _fn(entry, (_I,) * len(variant) + (_P,), lib)(*variant, ctypes.addressof(vals))
    cuda_build.check(rc, entry)
    return dict(zip(("regs", "local_bytes", "static_smem", "dynamic_smem", "threads"), vals))


# ---------------------------------------------------------------------------
# P3 and P5: one kernel on the design of K1's t = 1 GEMV (csrc/q40_gemv1_probes.cu)

PK_MODES = ("base", "pk")
GEMV1_MODES = ("base", "pk", "u16", "f32")     # the C entry's mode index
# the product (as kept; with the mode's other item loop; with the FMA form
# of the dequantize), the loads alone, no loads
GEMV1_BODIES = ("full", "other_loop", "fma", "loads", "empty")
_PRODUCT_BODIES = ("full", "other_loop", "fma")
# csrc/q40_gemv1_probes.cu: warps a CTA, rows an item (a chunk is 32 Q40
# blocks, one a lane), partial-sum bytes a CTA, rows a CTA at most
GEMV1_WARPS, GEMV1_ITEM_ROWS = 8, 4
GEMV1_SMEM_MAX, GEMV1_MAX_ROWS = 48 * 1024, 256
# the f32 2^23: an operand v at bit p of a word OR'd into it is 2^23 + v 2^p
MAGIC = 0x4B000000
# the bit positions of the operands in the kernel's words: a word's bytes 0
# and 1 (2 and 3 after a shift by 16) hold lo at 0 and 8, hi at 4 and 12;
# pk's whole byte sits at 0
NIBBLE_PS = (0, 4, 8, 12)


def magic_operand(v: torch.Tensor, p: int) -> torch.Tensor:
    """v as the kernel's kept arithmetic forms it, with no int-to-float
    convert: v (an integer tensor of nibbles, or bytes at p = 0) at bit p OR'd
    into the f32 2^(23-p) (its last mantissa bit worth 2^-p) is 2^(23-p) + v;
    one f32 subtraction of 2^(23-p) leaves v."""
    f = ((v.to(torch.int32) << p) | (MAGIC - (p << 23))).view(torch.float32)
    return f - 2.0 ** (23 - p)


def magic_times_scale(v: torch.Tensor, s: torch.Tensor, p: int) -> torch.Tensor:
    """v * s as the kernel's "fma" body forms it, with no int-to-float
    convert: v (an integer tensor of nibbles, or bytes at p = 0) shifted to
    bit p and OR'd into MAGIC is the f32 f = 2^23 + v 2^p; one FMA f * (s 2^-p)
    - 2^(23-p) s (both constants s times a power of two), here in f64 and
    rounded to f32 once, as the card's FMA rounds. v and s broadcast; s is
    f32."""
    f = ((v.to(torch.int32) << p) | MAGIC).view(torch.float32)
    sp, cp = s * 2.0 ** -p, s * -(2.0 ** (23 - p))
    return (f.double() * sp.double() + cp.double()).to(torch.float32)


def gemv1_rows(n: int, d: int, resident: int) -> int:
    """Rows a CTA of the P3/P5 kernel (the kernel's gemv1_rows): about one
    wave of `resident` equal CTAs, a multiple of GEMV1_ITEM_ROWS, at most
    GEMV1_MAX_ROWS, its partial sums within GEMV1_SMEM_MAX; 0 if n is too
    wide for even one item's rows."""
    chunks = -(-(n // 32) // 32)
    cap = min(GEMV1_MAX_ROWS, GEMV1_SMEM_MAX // (4 * chunks)) \
        // GEMV1_ITEM_ROWS * GEMV1_ITEM_ROWS
    if cap < GEMV1_ITEM_ROWS:
        return 0
    per_cta = -(-d // max(1, resident))
    return min(-(-per_cta // GEMV1_ITEM_ROWS) * GEMV1_ITEM_ROWS, cap)


def gemv1_items(n: int, d: int, rows: int):
    """The kernel's work, item by item: (cta, warp, chunk, row0) for every
    item of GEMV1_ITEM_ROWS rows x one chunk a warp computes, dealt
    chunk-major in contiguous runs; a row past d is read but never written."""
    chunks = -(-(n // 32) // 32)
    per_cta = chunks * (rows // GEMV1_ITEM_ROWS)
    for cta in range(-(-d // rows)):
        for warp in range(GEMV1_WARPS):
            for i in range(warp * per_cta // GEMV1_WARPS, (warp + 1) * per_cta // GEMV1_WARPS):
                c, g = divmod(i, rows // GEMV1_ITEM_ROWS)
                yield cta, warp, c, cta * rows + g * GEMV1_ITEM_ROWS


def q40_pk_gemv_reference(mode: str, x1: torch.Tensor, x2: torch.Tensor,
                          xs: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """Plain version: per block b of row d, sum_j x1[b*16+j] A + x2[b*16+j]
    hi in f32 (A = lo for base, the whole byte pk for pk), times s[d, b],
    summed over b, minus 8 sum_b xs[b] s[d, b]. -> (1, d) f32."""
    d, nb = w.scales.shape
    pk = w.packed.reshape(d, nb, 16).to(torch.int32)
    a = pk if mode == "pk" else pk & 0xF
    hi = pk >> 4
    s = w.scales.to(torch.float32)
    blk = (a.to(torch.float32) * x1.reshape(nb, 16)).sum(-1) + \
        (hi.to(torch.float32) * x2.reshape(nb, 16)).sum(-1)      # (d, nb)
    return ((blk * s).sum(-1) - 8.0 * (s * xs.reshape(nb)).sum(-1))[None, :]


def _pk_checked(x1: torch.Tensor, x2: torch.Tensor, xs: torch.Tensor, w: QuantizedTensor):
    """x1, x2 (1, n/2) and xs (1, n/32) f32 and w with f16 scales, as the
    kernel takes them; raises otherwise."""
    m = x1.shape[-1]
    if tuple(x1.shape) != (1, m) or x2.shape != x1.shape or \
            tuple(xs.shape) != (1, m // 16) or m % 16:
        raise ValueError(f"q40_pk_gemv: x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}, "
                         f"xs {tuple(xs.shape)} must be (1, n/2), (1, n/2), (1, n/32)")
    if not (x1.dtype == x2.dtype == xs.dtype == torch.float32):
        raise TypeError("q40_pk_gemv: x1, x2 and xs must be float32")
    _checked_weight("q40_pk_gemv", w, 2 * m, (torch.float16,))
    return _aligned(x1), _aligned(x2), xs.contiguous()


def q40_pk_gemv(mode: str, x1: torch.Tensor, x2: torch.Tensor, xs: torch.Tensor,
                w: QuantizedTensor) -> torch.Tensor:
    """y (1, d) f32 = sum over the bytes of x1 (A s) + x2 (hi s) - 8 sum_b
    xs[b] s: x1, x2 (1, n/2) f32 in the weight's byte order (element b*16 +
    j for byte j of block b), xs (1, n/32) f32, w block-major with float16
    scales. base: A = lo, x2 = x_hi; pk: A = the byte, x2 = x_hi - 16 x_lo."""
    if mode not in PK_MODES:
        raise ValueError(f"q40_pk_gemv: mode {mode!r} is not one of {PK_MODES}")
    if _device_of("q40_pk_gemv", x1, x2, xs, w.packed, w.scales) == "cpu":
        return q40_pk_gemv_reference(mode, x1, x2, xs, w)
    x1, x2, xs = _pk_checked(x1, x2, xs, w)
    d = w.packed.shape[0]
    out = torch.empty((1, d), dtype=torch.float32, device=x1.device)
    rc = _fn("q40_pk_gemv_launch", (_I,) + (_P,) * 6 + (_I, _I, _P), "q40_gemv1_probes")(
        PK_MODES.index(mode), x1.data_ptr(), x2.data_ptr(), xs.data_ptr(),
        w.packed.data_ptr(), w.scales.data_ptr(), out.data_ptr(), 2 * x1.shape[1], d,
        _stream(x1))
    cuda_build.check(rc, "q40_pk_gemv")
    q40_pk_gemv.launches += 1
    return out


q40_pk_gemv.launches = 0


# ---------------------------------------------------------------------------
# P5: f16-bit scales decoded in the kernel (tools/exp_scale_f16.py)

def f16_bits_to_f32(u: torch.Tensor) -> torch.Tensor:
    """f16 bit patterns (uint16, or any integer tensor holding them) -> f32
    with integer ops, as the JAX package's _f16_bits_to_f32 does: exact for
    every finite pattern, normals and subnormals."""
    if u.dtype == torch.uint16:
        u = u.view(torch.int16)
    u = u.to(torch.int32) & 0xFFFF
    sign = (u & 0x8000) << 16
    e = (u >> 10) & 0x1F
    m = u & 0x3FF
    normal = (sign | ((e + 112) << 23) | (m << 13)).view(torch.float32)
    sub = torch.where(sign != 0, -1.0, 1.0) * (m.to(torch.float32) * 2.0 ** -24)
    return torch.where(e == 0, sub, normal)


def q40_matmul_scales_reference(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """Plain version: per block, sum_j x nib in f32, times the block's
    scale (u16 decoded by f16_bits_to_f32, or f32), summed over blocks,
    minus 8 sum_b s xsum[b] (xsum the f32 sum of block b of x)."""
    s = f16_bits_to_f32(w.scales) if w.scales.dtype == torch.uint16 \
        else w.scales.to(torch.float32)
    lo, hi = _nibbles(w)
    xb = x.to(torch.float32).reshape(-1, 32)                      # (nb, 32)
    blk = (lo.to(torch.float32) * xb[:, :16]).sum(-1) + \
        (hi.to(torch.float32) * xb[:, 16:]).sum(-1)              # (d, nb)
    return ((blk * s).sum(-1) - 8.0 * (s * xb.sum(-1)).sum(-1))[None, :]


def q40_matmul_scales(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """y (1, d) f32 = x (1, n) f32 . W, W a block-major Q40 weight whose
    (d, n/32) scales are uint16 f16 bits (decoded in the kernel by integer
    ops) or float32."""
    if _device_of("q40_matmul_scales", x, w.packed, w.scales) == "cpu":
        return q40_matmul_scales_reference(x, w)
    x = _checked_q40("q40_matmul_scales", x, w, torch.float32, 1,
                     (torch.uint16, torch.float32))
    d, n = w.packed.shape[0], x.shape[1]
    out = torch.empty((1, d), dtype=torch.float32, device=x.device)
    rc = _fn("q40_matmul_scales_launch", (_I,) + (_P,) * 4 + (_I, _I, _P), "q40_gemv1_probes")(
        int(w.scales.dtype == torch.uint16), x.data_ptr(), w.packed.data_ptr(),
        w.scales.data_ptr(), out.data_ptr(), n, d, _stream(x))
    cuda_build.check(rc, "q40_matmul_scales")
    q40_matmul_scales.launches += 1
    return out


q40_matmul_scales.launches = 0


def q40_gemv1_probe(mode: str, body: str, rows: int, xa: torch.Tensor, xb, xs,
                    w: QuantizedTensor, pdl: bool = False) -> torch.Tensor:
    """P3 or P5's kernel (mode of GEMV1_MODES: base and pk take q40_pk_gemv's
    operands xa = x1, xb = x2, xs; u16 and f32 take q40_matmul_scales's x as
    xa, xb and xs None) with another body of GEMV1_BODIES or `rows` a CTA
    (0: the plan), for timing them against each other. "loads" and "empty"
    compute nothing (their output is not y). pdl ("full", "loads", "empty"):
    a programmatic dependent launch, whose first weight loads overlap the
    tail of the kernel before it on the stream, so w must not be that
    kernel's output. On the CPU, the product bodies run the plain version
    and the others raise. Counts on q40_pk_gemv (base, pk) or
    q40_matmul_scales (u16, f32)."""
    if mode not in GEMV1_MODES or body not in GEMV1_BODIES or \
            (pdl and body not in ("full", "loads", "empty")):
        raise ValueError(f"q40_gemv1_probe: mode {mode!r} not in {GEMV1_MODES} or body "
                         f"{body!r} not in {GEMV1_BODIES} (pdl: full, loads, empty)")
    pk = mode in PK_MODES
    ops = (xa, xb, xs) if pk else (xa,)
    if _device_of("q40_gemv1_probe", *ops, w.packed, w.scales) == "cpu":
        if body not in _PRODUCT_BODIES:
            raise ValueError(f"q40_gemv1_probe: body {body!r} has no plain version")
        return q40_pk_gemv_reference(mode, xa, xb, xs, w) if pk \
            else q40_matmul_scales_reference(xa, w)
    if pk:
        xa, xb, xs = _pk_checked(xa, xb, xs, w)
        n = 2 * xa.shape[1]
    else:
        want = torch.uint16 if mode == "u16" else torch.float32
        xa = _checked_q40("q40_gemv1_probe", xa, w, torch.float32, 1, (want,))
        n = xa.shape[1]
    d = w.packed.shape[0]
    out = torch.empty((1, d), dtype=torch.float32, device=xa.device)
    rc = _fn("q40_gemv1_probe_launch", (_I, _I, _I) + (_P,) * 6 + (_I, _I, _I, _P),
             "q40_gemv1_probes")(
        GEMV1_MODES.index(mode), GEMV1_BODIES.index(body), int(pdl), xa.data_ptr(),
        xb.data_ptr() if pk else None, xs.data_ptr() if pk else None,
        w.packed.data_ptr(), w.scales.data_ptr(), out.data_ptr(), n, d, rows, _stream(xa))
    cuda_build.check(rc, "q40_gemv1_probe")
    (q40_pk_gemv if pk else q40_matmul_scales).launches += 1
    return out


def gemv1_plan_kernel(mode: str, n: int, d: int) -> tuple[int, int, int]:
    """(rows a CTA, CTAs, resident CTAs) as the kernel plans a launch of
    `mode` at (n, d); rows must equal gemv1_rows(n, d, resident). Loads the
    library."""
    vals = (ctypes.c_int * 3)()
    rc = _fn("q40_gemv1_probe_plan", (_I, _I, _I, _P), "q40_gemv1_probes")(
        GEMV1_MODES.index(mode), n, d, ctypes.addressof(vals))
    cuda_build.check(rc, "q40_gemv1_probe_plan")
    return tuple(vals)


# ---------------------------------------------------------------------------
# P6: unpack/MMA overlap for a prefill chunk (tools/exp_unpack_overlap.py)

SUB_TDS = (64, 128)         # weight rows a CTA: 1 or 2 MMA warpgroups of 64 rows
SUB_NS = (1, 2, 4, 8)       # sub-tiles a 128-value chunk of n (the A ring's buffers)


def q40_matmul_sub_reference(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """Plain version: x (t, n) bf16 . bf16(nib * s) in f32, minus 8 sum_b
    xsum[t, b] s[d, b] (xsum the f32 block sums of x), cast to bf16 once.
    n_sub and td change how the kernel walks the product, not its value."""
    lo, hi = _nibbles(w)
    s = w.scales.to(torch.float32)
    wd = (torch.cat([lo, hi], dim=-1).to(torch.float32) * s[..., None]).to(torch.bfloat16)
    xf = x.to(torch.float32)
    xsum = xf.reshape(xf.shape[0], -1, 32).sum(-1)               # (t, nb)
    y = torch.matmul(xf, wd.reshape(w.packed.shape[0], -1).to(torch.float32).t()) \
        - 8.0 * torch.matmul(xsum, s.t())
    return y.to(torch.bfloat16)


def q40_matmul_sub(x: torch.Tensor, w: QuantizedTensor, n_sub: int, td: int) -> torch.Tensor:
    """y (t, d) bf16 = bf16 x (t, n) . bf16(nib * s) - 8 xsum . s, f32 sums,
    on the tensor cores: CTAs of td weight rows (SUB_TDS) x 256 tokens, a
    dequantize warpgroup writing each 128-value chunk of n as bf16 in n_sub
    sub-tiles (SUB_NS) that the MMA warpgroups consume with wgmma,
    overlapped with the MMAs when n_sub > 1. w has float16 scales; d % td
    == 0, n % 256 == 0, the scales 16-byte aligned."""
    if n_sub not in SUB_NS or td not in SUB_TDS:
        raise ValueError(f"q40_matmul_sub: n_sub {n_sub} not in {SUB_NS} or td {td} "
                         f"not in {SUB_TDS}")
    if _device_of("q40_matmul_sub", x, w.packed, w.scales) == "cpu":
        return q40_matmul_sub_reference(x, w)
    x = _checked_q40("q40_matmul_sub", x, w, torch.bfloat16, 1 << 20, (torch.float16,))
    (t, n), d = x.shape, w.packed.shape[0]
    if n % 256 or d % td:
        raise ValueError(f"q40_matmul_sub: n {n} must be a multiple of 256 and d {d} "
                         f"of td {td}")
    if w.scales.data_ptr() % 16:
        raise ValueError("q40_matmul_sub: scales must be 16-byte aligned")
    xsum = torch.empty((t, n // 32), dtype=torch.float32, device=x.device)
    out = torch.empty((t, d), dtype=torch.bfloat16, device=x.device)
    rc = _fn("q40_matmul_sub_launch", (_P,) * 5 + (_I,) * 5 + (_P,), "q40_prefill_probe")(
        x.data_ptr(), w.packed.data_ptr(), w.scales.data_ptr(), xsum.data_ptr(),
        out.data_ptr(), t, n, d, n_sub, td, _stream(x))
    cuda_build.check(rc, "q40_matmul_sub")
    q40_matmul_sub.launches += 1
    return out


q40_matmul_sub.launches = 0
