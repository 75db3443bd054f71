"""Design ablations of K1's small-batch GEMV on the tensor cores, timed on
the card.

Each variant is csrc/q40_matmul.cu with a few lines replaced (VARIANTS):
other ring depths, items of 16 blocks, CTAs of 32 rows, the other load
design (whole blocks into registers an item ahead, quad shuffles into
fragment layout, in place of the cp.async ring and ldmatrix), and two cost
ablations whose products are wrong on purpose (no x loads: x is zero; no
dequantize: the raw weight words go to the tensor cores). Every variant is
built with nvcc into its own library beside the kernels' (build/kernels/
ablations/), and launched through its q40_matmul_launch with the
tensor-core path switched off, so that bf16 launches of 2-8 tokens take
the small-batch GEMV. At the Llama-2-7B projection shapes and a tp = 2 w2
shard, t = 2 and 8, each variant is timed against weights rotated past
the L2 cache; one line per (shape, t) gives every variant's microseconds
and share of the bound (the weight bytes at 3.35 TB/s). A variant that
computes the product (all but WRONG) is first held against the plain
version, within 2^-7 of its largest magnitude, and raises if it differs.

    python -m distributed_llama_tpu_torch.tools.k1_mma_ablations [variant ...]

It needs the card and nvcc; a variant whose lines no longer match the
source raises.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from ..ops import cuda_build
from ..ops.cuda_q40 import q40_matmul_reference
from ..quants.torch_codec import QuantizedTensor
from ..utils.device import resolve_device
from .timing import bound_ms, rotating, time_ms

SHAPES = {"wqkv": (12288, 4096), "wo": (4096, 4096), "w13": (22016, 4096),
          "w2": (4096, 11008), "wcls": (32000, 4096), "w2_tp2": (4096, 5504)}
TS = (2, 8)
_STAGES = "constexpr int kMmaStages = 2; "
_RING_START = "  // the first kMmaStages - 1 items in flight; a group committed every\n"
_RING_END = "    __syncwarp();   // item i's stage is read: the next step refills it\n  }\n"
# the shuffle design's main loop, run in place of the ring's (which stays
# compiled behind `if constexpr (false)`): lane (g, q) loads rows g and
# g + 8, blocks q and q + 4 of the chunk, and the scales of blocks 2q,
# 2q + 1 of both rows, an item ahead of the one it consumes
_SHUFFLE = r"""  {
    // a 4 x 4 transpose of 32-bit words across a quad: m[j] = word j of
    // row q on entry, word q of row j on exit (two butterfly stages)
    auto quad_transpose = [&](uint32_t (&m)[4]) {
      const bool b2 = q & 2, b1 = q & 1;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t r = __shfl_xor_sync(0xffffffffu, b2 ? m[i] : m[i + 2], 2);
        m[i] = b2 ? r : m[i];
        m[i + 2] = b2 ? m[i + 2] : r;
      }
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const uint32_t r = __shfl_xor_sync(0xffffffffu, b1 ? m[i] : m[i + 1], 1);
        m[i] = b1 ? r : m[i];
        m[i + 1] = b1 ? m[i + 1] : r;
      }
    };
    struct Item {
      uint4 w[4];   // row g block q, row g block q + 4, row g + 8 block q, row g + 8 block q + 4
      uint32_t s[2];
    };
    auto load = [&](Item& it, int i) {
      const int c = i / G, rt = i - c * G;
      const int rg = min(row0 + rt * kMmaRows + g, d - 1), r8 = min(row0 + rt * kMmaRows + g + 8, d - 1);
      const int b0 = c * kMmaChunk;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int blk = min(b0 + q + 4 * h, nb - 1);
        it.w[h] = __ldg(pw + (size_t)rg * nb + blk);
        it.w[2 + h] = __ldg(pw + (size_t)r8 * nb + blk);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const unsigned short* srow = ps + (size_t)(r ? r8 : rg) * nb;
        const int j = b0 + 2 * q;
        const uint32_t lo = j < nb ? __ldg(srow + j) : 0u, hi = j + 1 < nb ? __ldg(srow + j + 1) : 0u;
        it.s[r] = lo | hi << 16;
      }
    };
    auto use = [&](const Item& it, int i) {
      uint32_t wg[kMmaChunk], w8[kMmaChunk], sg[kMmaChunk / 2], s8[kMmaChunk / 2];
      uint32_t m[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        m[k][0] = it.w[k].x;
        m[k][1] = it.w[k].y;
        m[k][2] = it.w[k].z;
        m[k][3] = it.w[k].w;
        quad_transpose(m[k]);   // m[k][j] = word q of block j (+ 4 for k odd)
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wg[j] = m[0][j];
        wg[j + 4] = m[1][j];
        w8[j] = m[2][j];
        w8[j + 4] = m[3][j];
        sg[j] = __shfl_sync(0xffffffffu, it.s[0], (lane & ~3) | j);
        s8[j] = __shfl_sync(0xffffffffu, it.s[1], (lane & ~3) | j);
      }
      consume(i, wg, w8, sg, s8);
    };
    Item A, B;
    if (i0 < i1) load(A, i0);
    for (int i = i0; i < i1; i += 2) {   // two items in flight
      if (i + 1 < i1) load(B, i + 1);
      chunk_x(i);
      use(A, i);
      if (i + 1 >= i1) break;
      if (i + 2 < i1) load(A, i + 2);
      chunk_x(i + 1);
      use(B, i + 1);
    }
  }
  if constexpr (false) {
"""
_ROWS = ("const int r = ((d + resident - 1) / resident + kMmaRows - 1) / kMmaRows "
         "* kMmaRows;")
# name: [(text of csrc/q40_matmul.cu, its replacement), ...]
VARIANTS = {
    "ring": [],
    "stages3": [(_STAGES, "constexpr int kMmaStages = 3; ")],
    "stages4": [(_STAGES, "constexpr int kMmaStages = 4; ")],
    "chunk16": [("constexpr int kMmaChunk = 8; ", "constexpr int kMmaChunk = 16; ")],
    "shuffle": [(_RING_START, _SHUFFLE + _RING_START), (_RING_END, _RING_END + "  }\n")],
    "rows32": [(_ROWS, "const int r = ((d + resident - 1) / resident + 31) / 32 * 32;")],
    "no_x": [("const bool in = live && c * kMmaChunk + j < nb;", "const bool in = false;")],
    "no_dequant": [
        ("  const uint32_t A1[4] = {nib2_bf16(a, mask, magic, one, m136), "
         "nib2_bf16(b, mask, magic, one, m136),\n"
         "                          nib2_bf16(a >> 8, mask, magic, one, m136), "
         "nib2_bf16(b >> 8, mask, magic, one, m136)};",
         "  const uint32_t A1[4] = {a, b, a >> 8, b >> 8};"),
        ("  const uint32_t A2[4] = {nib2_bf16(a >> 4, mask, magic, one, m136), "
         "nib2_bf16(b >> 4, mask, magic, one, m136),\n"
         "                          nib2_bf16(a >> 12, mask, magic, one, m136),\n"
         "                          nib2_bf16(b >> 12, mask, magic, one, m136)};",
         "  const uint32_t A2[4] = {a >> 4, b >> 4, a >> 12, b >> 12};")],
}


# the cost ablations, whose products are wrong on purpose
WRONG = ("no_x", "no_dequant")


def variant_source(name: str, src: str | None = None) -> str:
    """csrc/q40_matmul.cu with variant `name`'s lines replaced; each must
    occur exactly once."""
    src = (cuda_build.CSRC / "q40_matmul.cu").read_text() if src is None else src
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old[:60]!r} occurs {src.count(old)} times")
        src = src.replace(old, new)
    return src


def build(names) -> dict:
    """Each variant's library, built in parallel: {name: ctypes entry}."""
    out_dir = cuda_build.BUILD_DIR / "ablations"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"q40_matmul_{name}.cu"
        cu.write_text(variant_source(name))
        lib = out_dir / f"libq40_matmul_{name}.so"
        procs[name] = (subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                                         str(lib), str(cu)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    entries = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        fn = ctypes.CDLL(str(lib)).q40_matmul_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main(argv=None) -> int:
    names = list(argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    dev = resolve_device(None)
    if dev.type != "cuda":
        raise SystemExit("k1_mma_ablations needs the card: the variants exist only as CUDA")
    entries = build(names)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    card = torch.cuda.get_device_name(dev)
    for shape, (d, n) in SHAPES.items():
        wbytes = d * n // 2 + d * n // 32 * 2
        ws = rotating(lambda: QuantizedTensor(
            torch.randint(0, 256, (d, n // 2), generator=gen, device=dev, dtype=torch.uint8),
            (torch.rand((d, n // 32), generator=gen, device=dev) * 0.004 + 0.001
             ).to(torch.float16)), wbytes)
        for t in TS:
            x = torch.randn((t, n), generator=gen, device=dev).to(torch.bfloat16)
            out = torch.empty((t, d), dtype=torch.bfloat16, device=dev)
            bms, _ = bound_ms(wbytes, 2.0 * t * d * n, torch.bfloat16)
            cells = []
            w0 = ws()
            want = q40_matmul_reference(x, w0, torch.bfloat16).float()
            for name, fn in entries.items():
                def call(fn=fn, w=None):
                    w = ws() if w is None else w
                    # tc_min_t past MAX_T: the small-batch GEMV takes t <= 8
                    cuda_build.check(fn(x.data_ptr(), 1, w.packed.data_ptr(), w.scales.data_ptr(),
                                        out.data_ptr(), 1, t, n, d, 257, 8, 0,
                                        torch.cuda.current_stream(dev).cuda_stream), name)
                if name not in WRONG:
                    call(w=w0)
                    err = (out.float() - want).abs().max().item()
                    if not err <= 2.0 ** -7 * want.abs().max().item():
                        raise SystemExit(f"variant {name} {shape} t={t}: max err {err:.3g}")
                us = time_ms(call, budget_ms=20.0) * 1e3
                cells.append(f"{name} {us:.2f} us ({bms * 1e3 / us:.2f})")
            print(f"[mma-ablation] {shape} {d}x{n} t={t}, bound {bms * 1e3:.2f} us: "
                  + ", ".join(cells) + f" [{card}]", flush=True)
        del ws
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
