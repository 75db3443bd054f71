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
counts one per call that launches the kernel, whether its merge of the
split-S partials is a second launch or not.

The kernel splits the cache's slots across blocks (flash-decoding):
`split_plan(b, kvh, s, t, g)` fixes the grid from the shapes alone (never
from a position, so a launch can sit in a CUDA graph), and each block finds
its slots on the device from pos0 by `split_len`. `split_partials` and
`merge_partials` are that split-and-merge math in plain PyTorch.

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
from . import launch_scope
from .attention import NEG_INF, decode_attention, is_narrow_cache

# cap on T*G query rows per kv head (pallas_attention.py:112): longer
# prefill segments take the dense path in the engine
MAX_Q_ROWS = 1024
HEAD_SIZES = (16, 32, 64, 128)
# the kernel's split-S plan: splits are whole 64-slot tiles, and a launch
# fills one wave of two blocks on each of the H100's 132 SMs
TILE = 64
N_SM = 132
# query rows a block: (decode, prefill) of the tensor-core path (bf16 q)
# and of the exact f32 path
BLOCK_ROWS = {False: (16, 64), True: (4, 16)}
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


def split_plan(b: int, kvh: int, s: int, t: int, g: int,
               exact: bool = False) -> tuple[int, int]:
    """(query rows a block, n_split) of a launch: a function of the shapes
    only. `exact` is the f32-q path. Decode (T*G at most a decode block's
    rows) takes the small row block, prefill the large one; n_split is the
    most that keeps the blocks within 2 * N_SM (one wave at two blocks an
    SM: a second, part-filled wave would double the time), at least 1, at
    most S / TILE."""
    rows = t * g
    small, large = BLOCK_ROWS[exact]
    block_rows = small if rows <= small else large
    blocks = -(-rows // block_rows) * b * kvh
    return block_rows, max(1, min(2 * N_SM // blocks, -(-s // TILE)))


def split_len(fill, n_split: int):
    """Slots per split for a row filled to `fill` = min(pos0 + T, S):
    ceil(fill / n_split) rounded up to TILE (csrc/flash_attention.cu
    split_len). Works on ints and on integer tensors alike."""
    per = (fill + n_split - 1) // n_split
    return (per + TILE - 1) // TILE * TILE


def split_partials(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, q_pos: torch.Tensor,
                   n_split: int):
    """The kernel's split pass in plain PyTorch, in f32: for each split c
    the partial softmax state of every query row over the slots of c that
    the row sees. p enters P.V rounded to the value dtype (bf16 under bf16
    q), as in the kernel and the JAX kernel (pallas_attention.py:168); l
    sums it unrounded. Returns (m, l, acc, used): m, l (n_split, B, T, KVH, G),
    acc (n_split, B, T, KVH, G, hs), m = NEG_INF and l = 0 where a row sees
    no slot of the split; used (n_split, B, T), the splits the merge reads
    (c <= the row's last slot // split_len)."""
    b, t, h, hs = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    if not is_narrow_cache(k_cache.dtype):
        q = q.to(k_cache.dtype)
    kf = k_cache.to(q.dtype).to(torch.float32)
    vf = v_cache.to(q.dtype).to(torch.float32)
    qg = q.to(torch.float32).reshape(b, t, kvh, h // kvh, hs)
    scores = torch.einsum("btkgh,bksh->btkgs", qg, kf) / (hs ** 0.5)
    pos0 = q_pos[:, 0].to(torch.int64)
    slots = torch.arange(s, device=q.device)
    last = torch.clamp(pos0[:, None] + torch.arange(t, device=q.device),
                       max=s - 1)                                     # (B, T)
    length = split_len(torch.clamp(pos0 + t, max=s), n_split)         # (B,)
    split_of = slots[None, :] // length[:, None]                      # (B, S)
    seen = slots[None, None, :] <= last[:, :, None]                   # (B, T, S)
    ms, ls, accs = [], [], []
    for c in range(n_split):
        inside = (seen & (split_of == c)[:, None, :])[:, :, None, None, :]
        sc = torch.where(inside, scores, torch.full_like(scores, NEG_INF))
        m = sc.amax(-1)
        p = torch.where(inside, torch.exp(sc - m[..., None]), torch.zeros_like(sc))
        ms.append(m)
        ls.append(p.sum(-1))
        pv = p.to(q.dtype).to(torch.float32)     # q.dtype: the value dtype as upcast
        accs.append(torch.einsum("btkgs,bksh->btkgh", pv, vf))
    used = (torch.arange(n_split, device=q.device)[:, None, None]
            <= (last // length[:, None])[None])
    return torch.stack(ms), torch.stack(ls), torch.stack(accs), used


def merge_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                   used: torch.Tensor) -> torch.Tensor:
    """The kernel's merge: each row's used splits weighed by exp(m_c -
    max m), acc and l summed, acc / l. Returns (B, T, KVH, G, hs) f32."""
    u = used[:, :, :, None, None]                                     # (C, B, T, 1, 1)
    mx = torch.where(u, m, torch.full_like(m, NEG_INF)).amax(0)
    w = torch.where(u, torch.exp(m - mx), torch.zeros_like(m))
    return (w[..., None] * acc).sum(0) / (w * l).sum(0)[..., None]


def flash_attention_split_reference(q: torch.Tensor, k_cache: torch.Tensor,
                                    v_cache: torch.Tensor, q_pos: torch.Tensor,
                                    n_split: int) -> torch.Tensor:
    """The split-and-merge math end to end, in the output dtype of
    `flash_attention_reference`."""
    b, t, h, hs = q.shape
    out = merge_partials(*split_partials(q, k_cache, v_cache, q_pos, n_split))
    dtype = q.dtype if is_narrow_cache(k_cache.dtype) else k_cache.dtype
    return out.reshape(b, t, h, hs).to(dtype)


@functools.cache
def _lib():
    """The C entry point, loaded and typed once at first launch."""
    lib = cuda_build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k_cache, v_cache, q_pos) -> torch.Tensor:
    """One call of the kernel: the split pass, and the merge if it splits."""
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
    rows = t * (h // kvh)
    block_rows, n_split = split_plan(b, kvh, s, t, h // kvh, q.dtype == torch.float32)
    part_ml = part_acc = None
    if n_split > 1:     # the split pass's partial (m, l) and acc, f32 scratch
        part_ml = torch.empty((b * kvh, n_split, rows, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((b * kvh, n_split, rows, hs), dtype=torch.float32,
                               device=q.device)
    fn = _lib()
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos0.data_ptr(), out.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[dt], b, t, h, kvh, s, hs,
            block_rows, n_split, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(rc, "flash_attention")
    launch_scope.count(flash_attention, "flash_attention")
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
