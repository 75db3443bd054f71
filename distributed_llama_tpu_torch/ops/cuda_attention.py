"""Flash attention kernel K3 — counterpart of the JAX package's
ops/pallas_attention.py flash_attention.

`flash_attention(q, k_cache, v_cache, q_pos)` is causal GQA attention of T
query tokens against the head-major KV cache: q (B, T, H, hs), k/v
(B, KVH, S, hs), q_pos (B, T) with each row's positions contiguous from
pos0[b] = q_pos[b, 0] (pos0 may differ per row). Query token t of row b
sees cache slot s iff s <= pos0[b] + t. As in the JAX kernel, q is cast to
a wider-or-equal cache dtype (f32 or bf16) first, so the output takes the
cache dtype; an fp8 (e4m3) cache never narrows q: the kernel upcasts the
cache in registers and the output keeps q's dtype (f32 or bf16).

On a CUDA tensor it launches csrc/flash_attention.cu (design and bound in
the source's header); on a CPU tensor it runs `flash_attention_reference`,
the plain PyTorch version; any other device raises. `flash_attention.launches`
counts kernel launches only.

`f8_bits_to` and `saturate_f8_nan_codes` are the JAX package's e4m3 bit
helpers (pallas_attention.py:_f8_bits_to, saturate_f8_nan_codes): the
decode oracle, and the guard a cache-seeding path applies to bytes from
outside a forward, since the hardware decodes the magnitude code 0x7F as
NaN (the JAX decode gives 480).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .attention import decode_attention, is_narrow_cache

# cap on T*G query rows per kv head (pallas_attention.py:112): longer
# prefill segments take the dense path in the engine
MAX_Q_ROWS = 1024
HEAD_SIZES = (16, 32, 64, 128)
F8_DTYPE = torch.float8_e4m3fn
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, F8_DTYPE: 2}


def flash_supported(t: int, h: int, kvh: int) -> bool:
    """The engine's routing rule (pallas_attention.py:187-190): decode
    always, prefill while T*G <= MAX_Q_ROWS."""
    return t * (h // kvh) <= MAX_Q_ROWS


def f8_bits_to(u8: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """e4m3fn bit patterns (uint8) -> out_dtype by f32 bit reassembly, as
    the JAX kernel decodes them: normals sign<<31 | (exp+120)<<23 |
    mant<<20, subnormals (magnitude < 8) mant * 2^-9. The NaN magnitude
    0x7F comes out as 480.0 here."""
    i = u8.to(torch.int32)
    sign = (i & 0x80) << 24
    mag = i & 0x7F
    normal = (mag << 20) + (120 << 23)
    sub = (mag.to(torch.float32) * (2.0 ** -9)).view(torch.int32)
    f = (torch.where(mag < 8, sub, normal) | sign).view(torch.float32)
    return f if out_dtype == torch.float32 else f.to(out_dtype)


def saturate_f8_nan_codes(x: torch.Tensor) -> torch.Tensor:
    """Map e4m3fn NaN bit patterns (magnitude 0x7F) to the saturated max
    (+-448); every other code, and any non-f8 tensor, passes unchanged."""
    if x.dtype != F8_DTYPE:
        return x
    bits = x.view(torch.uint8)
    fixed = torch.where((bits & 0x7F) == 0x7F, (bits & 0x80) | 0x7E, bits)
    return fixed.to(torch.uint8).view(F8_DTYPE)


def flash_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor,
                              q_pos: torch.Tensor) -> torch.Tensor:
    """Plain version: the dense masked attention in f32 at the kernel's
    positions (pos0 + arange(T) per row). Output in the cache dtype, or in
    q's dtype for an fp8 cache (upcast whole to q's dtype, JAX
    ops/attention.py:50-52)."""
    t = q.shape[1]
    pos = q_pos[:, :1] + torch.arange(t, device=q.device)[None, :]
    if not is_narrow_cache(k_cache.dtype):
        q = q.to(k_cache.dtype)
    return decode_attention(q, k_cache, v_cache, pos)


@functools.cache
def _lib():
    """The C entry point, loaded and typed once at first launch."""
    lib = cuda_build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k_cache, v_cache, q_pos) -> torch.Tensor:
    b, t, h, hs = q.shape
    _, kvh, s, _ = k_cache.shape
    dt = k_cache.dtype
    if dt not in _DTYPE_CODE or v_cache.dtype != dt:
        raise TypeError(f"flash_attention kernel takes f32/bf16/e4m3 caches, "
                        f"got {k_cache.dtype}/{v_cache.dtype}")
    if hs not in HEAD_SIZES or h % kvh or \
            tuple(k_cache.shape) != (b, kvh, s, hs) or \
            v_cache.shape != k_cache.shape or tuple(q_pos.shape) != (b, t):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}, q_pos {tuple(q_pos.shape)}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash_attention: caches must be contiguous")
    if not is_narrow_cache(dt):
        q = q.to(dt)
    elif q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: an e4m3 cache takes f32/bf16 q, "
                        f"got {q.dtype}")
    q = q.contiguous()
    pos0 = q_pos[:, 0].to(torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = _lib()
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos0.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[dt], b, t, h, kvh, s, hs,
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor,
                    q_pos: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_reference(q, k_cache, v_cache, q_pos)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _launch(q, k_cache, v_cache, q_pos)


flash_attention.launches = 0
