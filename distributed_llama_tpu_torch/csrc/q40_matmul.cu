// Q40 weight x activation matmul for Hopper (sm_90a): y[t, d] = sum_n
// x[t, n] * (nib[d, n] - 8) * s[d, n / 32], accumulated in f32.
//
// Replaces: distributed_llama_tpu/ops/pallas_q40.py q40_matmul (the
// pallas_call at pallas_q40.py:258), the kernel behind every projection of
// the Llama path (wqkv, wo, w13, w2 per layer, and wcls).
//
// What bounds it on the H100: at decode (t = 1) the weight bytes. One
// 7B token reads 3.30 GB of packed nibbles plus 0.41 GB of f16 scales,
// 1.11 ms at 3.35 TB/s; activations and outputs are kilobytes. For a
// prefill chunk (t = 256) the operations: 2*t*d*n multiply-adds, 3.38 TFLOP
// per 7B chunk, 3.4 ms at the tensor cores' 989 TFLOP/s in bf16.
//
// Three kernels, chosen per launch like the TPU kernel's operand rule:
//
// GEMV at t = 1 (q40_gemv1_kernel), the whole decode path of K1 and K2.
// What bounds it on the H100: the weight bytes (1.11 ms a 7B step), and
// close behind them the instructions that unpack them. At 2 values a byte,
// the weights at 3.35 TB/s are 6.7e12 values/s against 33.8e12 thread
// instructions/s (132 SMs x 128 lanes x the 1.98 GHz boost clock), so 4
// instructions a value already take 80% of the memory time. The
// design, against the three things that held the earlier GEMV (below, kept
// for 2 <= t <= 8) at ~45% of the bound:
//  * x is read once a warp-chunk, not staged per 8-row CTA. A chunk is
//    1024 values of n, one 32-value Q40 block a lane; the lane holds its
//    32 x values in registers as f32 (bf16 widened by a shift) for every
//    row its warp takes in that chunk. A CTA owns R rows, cut into items of
//    4 rows x one chunk; the items, chunk-major, are dealt to the 8 warps
//    in contiguous runs, so a warp reloads x (from L2) only when its run
//    crosses a chunk: x is read 1-2 times a CTA (2 at n = 4096, 1.55 at
//    w2's 11008). A new chunk's bf16 x is loaded at the top of its item's
//    step, before the other item's weight loads are issued, while that
//    buffer is free: one item's weights and 16 registers of x are live at
//    the load, so the 128 registers leave the dot room (PERF.md, PR 9:
//    faster at every bf16 shape of 7B, Mixtral and Grok-1 but wo). f32 x
//    (32 registers at the load) keeps the load after the next item's
//    weights, where it timed faster.
//  * No int-to-float convert: a nibble masked at bits 8-11 or 12-15 and
//    OR'd into 0x4B000000 (one LOP3; written in PTX, because the compiler
//    splits (v & mask) | magic into two around its immediates) is the f32
//    2^23 + nib * 2^p, and one FMA with s * 2^-p and -(2^(23-p) + 8) * s
//    (both exact) gives (nib - 8) * s exactly: the plain version's f32
//    weight, then one FMA into the sum: with 3 shifts a 32-bit word, 3.4
//    instructions a value before the scale, the loads and the reduction
//    (the earlier GEMV: shift, mask, convert, subtract, multiply, FMA).
//  * Loads in flight: each warp issues its next item's 4 rows (4 x 16
//    bytes and an f16 scale a lane) before it consumes the current one;
//    2 CTAs of 8 warps an SM. A ring of 4 items a warp in shared memory
//    (cp.async), which put 3 items in flight, was slower (PERF.md):
//    with the weights out of registers the loop issued more instructions,
//    and the kernel is bound by issue more than by bytes in flight.
//  * A deterministic split of n: a row's chunks are summed by different
//    warps. Each item's 4 row sums are reduced across the warp by shuffles
//    in a fixed pattern and written to shared memory, part[chunk][row]; after
//    one barrier the CTA adds each row's partials in chunk order and rounds
//    once to the output type. No atomics: two launches give the same bits.
//  * The grid is one wave of equal CTAs: R = d / (the CTAs the card holds
//    at once / k), rounded up to 4 rows (7B: wo and w2 16, wqkv 48, w13 84,
//    wcls 124; Mixtral's experts 112 and 32). 128 registers a thread (the
//    cap of __launch_bounds__(256, 2)), no spills (chip_smoke.py prints
//    the library's resource usage), so 2 CTAs (16 warps) an SM; the
//    partials take C x R x 4 bytes of shared memory (1.3 KB at w13).
//  * The Q80 activation round trip fused in (the Q80 template switch; the
//    C entry points' q80 argument): x arrives raw, f32 or bf16, and the
//    CTA round-trips all of it once, before its items, into shared memory
//    (q80_store: csrc/q80_roundtrip.cu's per-block math, bit for bit, a
//    32-value Q80 block a thread, rounded to the output type, which is the
//    caller's compute type: ops/matmul.py passes out_dtype=compute_dtype;
//    two threads a block, or two blocks' loads in flight, timed no faster).
//    One barrier, then the loop reads each chunk from there (load_xs)
//    instead of from L2. So the launch gives bit for bit what the
//    standalone kernel and then this GEMV give. x' takes 80 (bf16) or 144 (f32) bytes a block of shared memory,
//    counted in the CTAs an SM holds. Every CTA round-trips the whole of x,
//    about 4.5 instructions a value (absmax, multiply, the add of the
//    round-half-even shift, one FMA, a paired convert, the loads and
//    stores), which is what the fused launch adds to the GEMV: K2's fused
//    launches run 16-warp CTAs, one an SM (the same 128 registers a
//    thread), so an SM round-trips x once, not twice; K1's keep 8-warp
//    CTAs, two an SM, which timed faster at most 7B shapes. Tried and
//    slower (PERF.md, PR 9): the round trip in each lane's registers where
//    it loads a chunk (lane-local, no barrier): its absmax and scale at a
//    chunk change raised the loop's register pressure and slowed every
//    dot, whether or not a chunk changed at run time.
//
// GEMV for 2 <= t <= 8, and f32 operands at any t > 1 (q40_matmul_kernel):
//  * The weight stays packed in device memory in the file's block-major
//    order (quants/torch_codec.py): one lane loads one whole 32-value block
//    with a single 16-byte load plus its 2-byte f16 scale, and a warp's 32
//    lanes read 512 contiguous bytes of one row. Nothing is dequantized to
//    device memory.
//  * One warp owns one output row; eight warps per block. Each lane keeps a
//    running f32 sum per token and the warp reduces with shuffles at the end.
//  * Activations are staged in shared memory as f32 with 16-byte loads, one
//    chunk of the n axis at a time, 36 floats per 32-value block (4 of
//    padding), so the lanes' 16-byte reads of their own block hit 32
//    distinct banks. The chunk's weight loads are issued first, so they are
//    in flight while the activations are staged.
//  * Tokens go in groups of TT (4 or 8): a lane unpacks its block once
//    into 32 registers and uses it for every token of the group, so one
//    weight read serves TT tokens. Token groups run along gridDim.x, the
//    fastest-varying block index, so the groups that re-read one row block
//    run close together and find it in the 50 MB L2.
//
// Tensor-core path (bf16 in and out, t >= tc_min_t, n % 256 == 0, 16-byte
// aligned operands), for prefill chunks: see q40_matmul_wgmma_kernel below
// — warp-specialised wgmma with the weight dequantized into registers, fed
// by a TMA ring. The caller passes tc_min_t, the token count from which
// this path beats the GEMV path on the card (ops/cuda_q40.py TC_MIN_T,
// measured by chip_smoke.py); a shape that misses the other preconditions
// takes the GEMV path by the same rule as ops/cuda_q40.py uses_tc_path.
//
// The TPU kernel's x_lo/x_hi pre-split, lane-tile scale repeat, -8 fold and
// sub-tiling exist for Mosaic's tiling and VPU; none of them carries over.
//
// K2, the expert-indexed product (q40_expert_matmul_launch below):
// y_k[t, d] = sum_n x_k[t, n] * W[idx[k], d, n] for the K active experts of
// a stacked (E, d, n) Q40 weight, the MoE decode step's gate, up and down.
//
// Replaces: distributed_llama_tpu/ops/pallas_q40.py q40_expert_matmul (the
// pallas_call at pallas_q40.py:319, def at :283).
//
// It is K1's GEMV with one more grid dimension, the active expert k, and
// each block reads idx[k] from device memory itself
// (the TPU kernel's scalar prefetch), so the host never learns the routing
// and one launch covers all K experts. Only the weight base moves, to
// packed + idx[k]*d*n/2 and scales + idx[k]*d*n/32: the active experts'
// bytes are read in place, never gathered. x is one (t, n) shared by the
// experts (gate, up) or one per expert (down, x_kstride = t*n).
//
// What bounds it on the H100: the weight bytes. At Mixtral widths a launch
// reads 2 experts x 14336 x 4096 x 18/32 bytes = 66.1 MB, 19.7 us at
// 3.35 TB/s; a decode step's 96 launches read 6.34 GB, 1.89 ms. GEMV paths
// only (t <= 8): the JAX package calls its kernel at t = b = 1 alone, which
// takes the t = 1 GEMV with the expert on blockIdx.y; t = 2-8 the older one
// with the expert on blockIdx.z.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kPad = 36;  // floats per staged 32-value block

__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// idx == nullptr: K1, one weight (d, n/2). Otherwise K2: blockIdx.z is the
// active expert k, the weight is expert idx[k] of an (n_experts, d, n/2)
// stack (an index out of range is clamped, as the JAX package's dynamic
// index is), x_k starts x_kstride elements after x_(k-1), and out_k is the
// k-th (t, d) slab of the output.
template <typename TI, typename TO, int TT, int U>
__global__ void __launch_bounds__(kWarps * 32)
q40_matmul_kernel(const TI* __restrict__ x, const uint8_t* __restrict__ packed,
                  const __half* __restrict__ scales, TO* __restrict__ out,
                  int t, int n, int d, const int* __restrict__ idx, int n_experts,
                  long long x_kstride) {
  constexpr int CB = 32 * U;  // blocks per chunk: U per lane
  __shared__ __align__(16) float xs[TT][CB * kPad];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.y * kWarps + warp;
  const int t0 = blockIdx.x * TT;
  const int nb = n / 32;
  const bool live = row < d;
  if (idx != nullptr) {
    const int k = blockIdx.z;
    const int e = min(max(idx[k], 0), n_experts - 1);
    x += (size_t)k * x_kstride;
    out += (size_t)k * t * d;
    packed += (size_t)e * d * (n / 2);
    scales += (size_t)e * d * nb;
  }
  const uint4* prow = reinterpret_cast<const uint4*>(packed) + (size_t)(live ? row : 0) * nb;
  const __half* srow = scales + (size_t)(live ? row : 0) * nb;

  float acc[TT];
#pragma unroll
  for (int i = 0; i < TT; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < nb; c0 += CB) {
    // this chunk's weight loads first: U blocks per lane in flight while
    // the activations are staged
    uint4 pk[U];
    float sc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int blk = c0 + u * 32 + lane;
      if (live && blk < nb) {
        pk[u] = __ldg(prow + blk);
        sc[u] = __half2float(srow[blk]);
      } else {
        pk[u] = make_uint4(0x88888888u, 0x88888888u, 0x88888888u, 0x88888888u);
        sc[u] = 0.f;
      }
    }
    __syncthreads();  // the previous chunk is consumed
    // 16 bytes of x per load, all of a thread's loads issued together
    constexpr int VEC = 16 / sizeof(TI);
    constexpr int PER_TOKEN = CB * 32 / VEC;
#pragma unroll
    for (int i = threadIdx.x; i < TT * PER_TOKEN; i += kWarps * 32) {
      const int tt = i / PER_TOKEN, e = (i % PER_TOKEN) * VEC;
      const int col = c0 * 32 + e, tok = t0 + tt;
      float v[VEC];
      if (tok < t && col < n) {  // n % 32 == 0: a vector is all in or all out
        load16(x + (size_t)tok * n + col, v);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[j] = 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(&xs[tt][(e >> 5) * kPad + (e & 31)]);
#pragma unroll
      for (int j = 0; j < VEC / 4; ++j) dst[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
    __syncthreads();
    if (!live) continue;

#pragma unroll
    for (int u = 0; u < U; ++u) {
      float w[32];
      const uint32_t words[4] = {pk[u].x, pk[u].y, pk[u].z, pk[u].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const uint32_t byte = (words[q] >> (8 * bb)) & 0xFFu;
          w[q * 4 + bb] = (float)((int)(byte & 0xFu) - 8) * sc[u];
          w[16 + q * 4 + bb] = (float)((int)(byte >> 4) - 8) * sc[u];
        }
      }
      const int slot = (u * 32 + lane) * kPad;
#pragma unroll
      for (int tt = 0; tt < TT; ++tt) {
        const float4* xv = reinterpret_cast<const float4*>(&xs[tt][slot]);
        float a = 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 f = xv[q];
          a = fmaf(f.x, w[4 * q + 0], a);
          a = fmaf(f.y, w[4 * q + 1], a);
          a = fmaf(f.z, w[4 * q + 2], a);
          a = fmaf(f.w, w[4 * q + 3], a);
        }
        acc[tt] += a;
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int tt = 0; tt < TT; ++tt) {
    float a = acc[tt];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    const int tok = t0 + tt;
    if (lane == 0 && tok < t) store(out + (size_t)tok * d + row, a);
  }
}

// ---------------------------------------------------------------------------
// The decode GEMV (t = 1), K1 and K2: see the header's "GEMV at t = 1".

constexpr int kG1Warps = 8;
constexpr int kG1Threads = kG1Warps * 32;

constexpr int kG1Rows = 4;                  // rows an item
constexpr int kG1SmemMax = 48 * 1024;       // bytes of partial sums, without an opt-in

// the 32 x values of one lane's block, as f32 (0 for a block past n)
__device__ __forceinline__ void load_x32(const float* p, bool live, float* xr) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 f = live ? __ldg(reinterpret_cast<const float4*>(p) + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    xr[4 * j] = f.x; xr[4 * j + 1] = f.y; xr[4 * j + 2] = f.z; xr[4 * j + 3] = f.w;
  }
}
__device__ __forceinline__ void load_x32(const __nv_bfloat16* p, bool live, float* xr) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4 u = live ? __ldg(reinterpret_cast<const uint4*>(p) + j) : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {   // a bf16 is the top half of its f32
      xr[8 * j + 2 * q] = __uint_as_float(w[q] << 16);
      xr[8 * j + 2 * q + 1] = __uint_as_float(w[q] & 0xFFFF0000u);
    }
  }
}

// max that returns NaN if either operand is NaN (fmaxf returns the other)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The Q80 round trip of one 32-value block, bit for bit csrc/q80_roundtrip.cu's
// per-block math (and so the plain codec's). absmax with max.NaN, so a NaN
// block gives a NaN scale and 32 NaNs; scale = absmax * f32(1/127); s =
// f32(f16(scale)) (bf16 output: f32(bf16(f16(scale)))); inv = 1 / scale
// (IEEE) where s > 0, else 0 (the standalone kernel tests scale > 0; where
// the scale is positive but below f16's range, s is 0 and every value comes
// out 0 either way, and 1 / scale may overflow, so inv = 0 keeps the
// products finite); q = round-half-even(y = x * inv), as (y + M) - M with
// M = 1.5 * 2^23, exact for |y| < 2^22 (|y| <= 127) and equal to
// __float2int_rn on every finite y, in full-rate adds instead of two
// quarter-rate converts; x' = q * s, rounded once to the output type.
// Where s is finite, the last subtract and the multiply are one FMA,
// (y + M) * s - M * s: M * s is exact (13 significant bits), so the FMA's
// single rounding of the exact q * s (at most 18 bits) is q * s itself.
// Where s is NaN or inf (a block holding a NaN or +-inf, or an absmax past
// f16's range) the plain steps run, as in the standalone kernel: 0 * inf
// is NaN there, q * inf with q != 0 is +-inf. Every other product and add
// is explicitly rounded, so nothing contracts into an FMA.
template <typename TO>
__device__ __forceinline__ void q80_values(float* v) {
  constexpr float kM = 12582912.0f;   // 1.5 * 2^23
  float m[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) m[c] = fabsf(v[c]);
#pragma unroll
  for (int j = 4; j < 32; ++j) m[j & 3] = max_nan(m[j & 3], fabsf(v[j]));
  const float am = max_nan(max_nan(m[0], m[1]), max_nan(m[2], m[3]));
  const float scale = __fmul_rn(am, 1.0f / 127.0f);
  float s = __half2float(__float2half_rn(scale));
  if constexpr (!std::is_same<TO, float>::value) s = __bfloat162float(__float2bfloat16_rn(s));
  const float inv = s > 0.f ? __frcp_rn(scale) : 0.f;
  if (__builtin_expect(isfinite(s), 1)) {   // a branch, not a select: one side runs
    const float ms = __fmul_rn(-kM, s);
#pragma unroll
    for (int j = 0; j < 32; ++j) v[j] = __fmaf_rn(__fadd_rn(__fmul_rn(v[j], inv), kM), s, ms);
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) v[j] = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(v[j], inv), kM), -kM), s);
  }
}

// A round-tripped block in shared memory, 32-bit words a block: f32, 32
// values and 4 of padding; bf16, 16 pairs and 4 of padding (a lane's
// 16-byte reads of its own block then hit distinct banks).
template <typename TO>
__host__ __device__ constexpr int xs_words() { return std::is_same<TO, float>::value ? 36 : 20; }

// v (one block of x, as f32) round-tripped and stored in TO at dst
template <typename TO>
__device__ __forceinline__ void q80_store(uint32_t* dst, float* v) {
  q80_values<TO>(v);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  if constexpr (std::is_same<TO, float>::value) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      d4[j] = make_uint4(__float_as_uint(v[4 * j]), __float_as_uint(v[4 * j + 1]),
                         __float_as_uint(v[4 * j + 2]), __float_as_uint(v[4 * j + 3]));
  } else {
    uint32_t w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {   // bf16 pairs, each rounded once: element 2j low, 2j + 1 high
      const __nv_bfloat162 p2 = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&p2);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) d4[j] = make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
  }
}

// the 32 round-tripped values of one lane's block as f32 (0 for a block
// past n), from shared memory
template <typename TO>
__device__ __forceinline__ void load_xs(const uint32_t* src, bool live, float* xr) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  if constexpr (std::is_same<TO, float>::value) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint4 u = live ? s4[j] : make_uint4(0u, 0u, 0u, 0u);
      xr[4 * j] = __uint_as_float(u.x); xr[4 * j + 1] = __uint_as_float(u.y);
      xr[4 * j + 2] = __uint_as_float(u.z); xr[4 * j + 3] = __uint_as_float(u.w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 u = live ? s4[j] : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {   // a bf16 is the top half of its f32
        xr[8 * j + 2 * q] = __uint_as_float(w[q] << 16);
        xr[8 * j + 2 * q + 1] = __uint_as_float(w[q] & 0xFFFF0000u);
      }
    }
  }
}

// 2^23 + nibble * 2^p as an f32, the nibble already at bits p..p+3 of v
// under mask (p = 8 or 12): (v & mask) | magic in one LOP3 (the compiler
// would split it into two around its immediates), no int-to-float convert
__device__ __forceinline__ float nib_f(uint32_t v, uint32_t mask, uint32_t magic) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(r) : "r"(v), "r"(mask), "r"(magic));
  return __uint_as_float(r);
}

// One item's weights: kG1Rows rows of one lane's block, 16 bytes and an
// f16 scale a row, loaded together before the previous item is consumed.
struct G1Item {
  uint4 w[kG1Rows];
  __half s[kG1Rows];
};

// x . (one row's block), exactly as the plain version's f32 products: each
// nibble becomes (nib - 8) * s by one exact FMA, f * s*2^-p - (2^(23-p) + 8) * s,
// where both constants are exact in f32 for p = 8 and 12 (13 and 9
// significant bits times the f16 scale's 11), and (nib - 8) * s itself
// needs 15 bits. Word q of the block holds bytes 4q..4q+3; byte j's low
// nibble is element j, its high nibble element j + 16.
__device__ __forceinline__ float dot_block(const uint4& blk, __half s16, const float* xr,
                                           uint32_t m8, uint32_t m12, uint32_t magic) {
  const float s = __half2float(s16);
  const float sp8 = s * (1.0f / 256.0f), cp8 = s * -32776.0f;   // 2^15 + 8
  const float sp12 = s * (1.0f / 4096.0f), cp12 = s * -2056.0f;  // 2^11 + 8
  const uint32_t words[4] = {blk.x, blk.y, blk.z, blk.w};
  float a = 0.f, b = 0.f;   // elements 0-15 and 16-31: two chains
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t w = words[q];
    const uint32_t v[4] = {w << 8, w, w >> 8, w >> 16};   // byte bb's nibbles at bits 8-15
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      a = fmaf(xr[4 * q + bb], __fmaf_rn(nib_f(v[bb], m8, magic), sp8, cp8), a);
      b = fmaf(xr[16 + 4 * q + bb], __fmaf_rn(nib_f(v[bb], m12, magic), sp12, cp12), b);
    }
  }
  return a + b;
}

// The RI row sums of a warp, each spread over its 32 lanes, reduced so that
// lane group r (RI groups of 32/RI lanes, by the lane's top bits) holds row
// r's total: log2(RI) halving steps, each lane sending the half it gives
// up, then a butterfly inside the group. Returns the lane's row total;
// *row gets its row. The order of the adds depends on nothing but the lane.
template <int RI>
__device__ __forceinline__ float warp_rows_reduce(float* a, int lane, int* row) {
  int r = 0;
  int off = 16;
#pragma unroll
  for (int cnt = RI; cnt > 1; cnt >>= 1, off >>= 1) {
    const int half = cnt / 2;
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? a[i] : a[i + half];
      const float keep = up ? a[i + half] : a[i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    if (up) r += half;
  }
#pragma unroll
  for (; off > 0; off >>= 1) a[0] += __shfl_xor_sync(0xffffffffu, a[0], off);
  *row = r;
  return a[0];
}

// A CTA owns rows [row0, row0 + R) of one weight (K2: of expert idx[k],
// blockIdx.y = k), cut into items of kG1Rows rows x one chunk of n. The C x G
// items, chunk-major, are dealt to the 8 warps in contiguous runs, so a
// warp loads a chunk of x into registers once and keeps it for every row
// of its run in that chunk. Each item's row sums go to shared memory
// (part[c][row]); the CTA then adds each row's C partials in chunk order
// and rounds once to the output type. Q80: x is raw; the CTA round-trips
// it once into shared memory (xs, after the partials) before its items.
template <typename TI, typename TO, bool Q80, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, kG1Warps * 2 / WARPS)
q40_gemv1_kernel(const TI* __restrict__ x, const uint8_t* __restrict__ packed,
                 const __half* __restrict__ scales, TO* __restrict__ out, int n, int d, int R,
                 const int* __restrict__ idx, int n_experts, long long x_kstride) {
  constexpr int RI = kG1Rows;
  extern __shared__ float part[];   // C x R partial sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = n / 32;
  const int C = (nb + 31) / 32, G = R / RI;
  const int row0 = blockIdx.x * R;
  if (idx != nullptr) {
    const int k = blockIdx.y;
    const int e = min(max(idx[k], 0), n_experts - 1);
    x += (size_t)k * x_kstride;
    out += (size_t)k * d;
    packed += (size_t)e * d * (n / 2);
    scales += (size_t)e * d * nb;
  }
  const int items = C * G;
  constexpr int THREADS = 32 * WARPS;
  const int i0 = (int)((long long)warp * items / WARPS);
  const int i1 = (int)((long long)(warp + 1) * items / WARPS);
  // this CTA's rows; a row past d reads row d - 1 (never written), a lane
  // past the last block reads the last block against x = 0
  const uint4* pw = reinterpret_cast<const uint4*>(packed) + (size_t)row0 * nb;
  const __half* ps = scales + (size_t)row0 * nb;
  const int rlast = d - 1 - row0;
  // the LOP3's operands, kept in registers
  uint32_t m8 = 0xF00u, m12 = 0xF000u, magic = 0x4B000000u;
  asm volatile("" : "+r"(m8), "+r"(m12), "+r"(magic));

  auto load = [&](G1Item& it, int i) {
    const int c = i / G, g = i - c * G;
    const int blk = min(c * 32 + lane, nb - 1);
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      const int o = min(g * RI + r, rlast) * nb + blk;
      it.w[r] = __ldg(pw + o);
      it.s[r] = __ldg(ps + o);
    }
  };
  float xr[32];
  int cx = -1;
  uint32_t* xs = reinterpret_cast<uint32_t*>(part + C * R);   // Q80: nb blocks (R % 4 == 0: aligned)
  auto chunk = [&](int i) {   // x of item i's chunk into xr, if it is a new chunk
    const int c = i / G;
    if (c != cx) {
      const int blk = c * 32 + lane;
      if constexpr (Q80) {
        load_xs<TO>(xs + (size_t)blk * xs_words<TO>(), blk < nb, xr);
      } else {
        load_x32(x + (size_t)blk * 32, blk < nb, xr);   // from L2
      }
      cx = c;
    }
  };
  auto dot = [&](const G1Item& it, int i) {
    const int c = i / G, g = i - c * G;
    float a[RI];
#pragma unroll
    for (int r = 0; r < RI; ++r) a[r] = dot_block(it.w[r], it.s[r], xr, m8, m12, magic);
    int r;
    const float v = warp_rows_reduce<RI>(a, lane, &r);
    if ((lane & (32 / RI - 1)) == 0) part[c * R + g * RI + r] = v;   // R % RI == 0
  };

  // two items' loads in flight: item i + 1's are issued before item i is
  // consumed. A new chunk's x that arrives as 16-bit values (bf16 x, or
  // Q80's bf16 x') is loaded before the other item's weight loads, f32 x
  // (twice the registers at the load) after them (PERF.md, PR 9: each the
  // faster for its type at most shapes).
  constexpr bool EARLY = !std::is_same<std::conditional_t<Q80, TO, TI>, float>::value;
  G1Item A, B;
  if constexpr (!Q80 && !EARLY) {
    if (i0 < i1) chunk(i0);   // x ahead of the first weights
  }
  if (i0 < i1) load(A, i0);
  if constexpr (Q80) {   // the round trip, behind the first item's loads
    for (int b = threadIdx.x; b < nb; b += THREADS) {   // a block a thread
      float v[32];
      load_x32(x + (size_t)b * 32, true, v);
      q80_store<TO>(xs + (size_t)b * xs_words<TO>(), v);
    }
    __syncthreads();
  }
  for (int i = i0; i < i1; i += 2) {
    if constexpr (EARLY) chunk(i);
    if (i + 1 < i1) load(B, i + 1);
    if constexpr (!EARLY) chunk(i);
    dot(A, i);
    if (i + 1 >= i1) break;
    if constexpr (EARLY) chunk(i + 1);
    if (i + 2 < i1) load(A, i + 2);
    if constexpr (!EARLY) chunk(i + 1);
    dot(B, i + 1);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < R; j += THREADS) {
    const int row = row0 + j;
    if (row >= d) break;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc += part[c * R + j];
    store(out + row, acc);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path for multi-token chunks (bf16 x and out, t >= tc_min_t,
// n % 256 == 0, x / packed / scales 16-byte aligned): wgmma with the weight
// dequantized into registers, fed by a TMA ring.
//
// A CTA computes a 128-row x BN-token output tile (BN 64, 128 or 256) over
// its share of the n axis. 384 threads, three warpgroups:
//  * warpgroup 2, the producer: one thread keeps a ring of up to 8 stages
//    in flight with TMA (full/empty mbarrier pairs). A stage is 64 values
//    of the n axis: the x tile, BN tokens x 128 bytes with the 128-byte
//    swizzle (wgmma's B operand reads it through a descriptor), and the
//    packed weight tile, 128 rows x 2 Q40 blocks x 16 bytes. Rows of x past
//    t and rows of the weight past d arrive as zeros (TMA's out-of-bounds
//    fill). setmaxnreg moves its registers to the consumers.
//  * warpgroups 0 and 1, the consumers: each owns 64 weight rows (wgmma's
//    M) and issues one wgmma.mma_async m64nBNk16 (f32 += bf16 x bf16) a
//    k16 step, A from registers (the RS form), B = x from shared memory;
//    one instruction as wide as the tile, not BN/64 of width 64, so A
//    crosses from the registers once a step. A Q40 block
//    is two k16 steps: step one is its 16 bytes' low nibbles, step two
//    their high nibbles (byte j holds elements j and j + 16). A thread's A
//    fragment for rows g and g + 8 of its warp's 16 holds k = 2q, 2q+1,
//    2q+8, 2q+9: bytes 2q, 2q+1, 2q+8, 2q+9 of each row's block, two
//    32-bit shared loads a row. Each nibble becomes (nib - 8) * s in f32
//    without a convert: a mask into 0x4B000000 and one exact FMA (dq2),
//    then rounded once to bf16 (cvt.rn), as the plain version and the TPU
//    kernel round their dequantized tiles. Block b + 1
//    is dequantized while block b's wgmmas run (two register sets,
//    wgmma.wait_group 1). The f16 scales come straight from device memory,
//    8 blocks (16 bytes) a row at a time, one group of 256 values ahead
//    (a TMA box needs 16 bytes a row; the stage's 4 do not make one).
//  * split K (deterministic, no atomics): for weights with few row tiles a
//    2-CTA cluster splits the n axis; rank 1 pushes its f32 partial sums
//    into rank 0's shared memory (distributed shared memory), rank 0 adds
//    them in a fixed order and writes the tile. One launch a projection
//    either way.
//  * epilogue: the accumulators are rows x tokens and out is (t, d), so
//    each consumer transposes its tile through shared memory and writes
//    16-byte pieces of each token's rows.
//
// The plan (BN, split) comes from the shapes alone, the same integer
// rule as ops/cuda_q40.py tc_plan: the least modelled time, waves of 132
// CTAs times a CTA's fixed cost plus its groups' cost, the model fitted to
// timings of every plan on the H100 (PERF.md).
//
// What bounds it: the tensor cores (2*t*d*n flop; a 7B 256-token chunk
// 3.37 ms at 989 TFLOP/s). Every CTA reads its whole x tile from L2, 128
// flop per L2 byte, ~7.7 TB/s at the bf16 peak. Tried and slower at every
// 7B shape (PERF.md): 256-row tiles (two M tiles a consumer), and a pair of
// row tiles sharing each x tile through a TMA multicast in a 2-CTA cluster.

constexpr int kTcK = 64;             // n values a stage: 2 Q40 blocks, one 128-byte swizzle row
constexpr int kTcGroup = 256;        // the n axis is planned in groups of 256 values
constexpr int kTcThreads = 384;
constexpr int kTcSms = 132;
constexpr int kTcSmemMax = 227 * 1024;  // dynamic shared memory a block can have

template <int BN>
struct TcCfg {
  static constexpr int BM = 128;                   // weight rows a CTA: 64 a consumer warpgroup
  static constexpr int XBYTES = BN * kTcK * 2;     // x tile, 128-byte swizzled rows
  static constexpr int WBYTES = BM * kTcK / 2;     // packed weight tile
  static constexpr int STAGE = XBYTES + WBYTES;
  static constexpr int STAGES = (kTcSmemMax - 2048) / STAGE < 8 ? (kTcSmemMax - 2048) / STAGE : 8;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = RING + 2 * STAGES * 8 + 1024;  // + barriers, + alignment slack
  static_assert(BN / 2 * 256 * 4 <= RING, "split partials fit the ring");
  static_assert(2 * BN * 72 * 2 <= RING, "the epilogue's transpose fits the ring");
};

// The plan's cost model, in units of 10 ns of one wave's time, fitted to
// the timing of every plan at the 7B shapes on the H100 (PERF.md):
// a fixed cost a wave, and a cost a 256-value group that grows with the
// tile.
constexpr long long kTcWaveFixed = 1360;
__host__ __device__ inline long long tc_group_cost(int bn) { return 86 + bn * 3 / 4; }

// the plan: tokens a CTA and the split of the n axis, from the shapes
// alone (ops/cuda_q40.py tc_plan is the same rule)
__host__ __device__ inline void tc_plan(int t, int n, int d, int* bn_out, int* split_out) {
  const int groups = n / kTcGroup, row_tiles = (d + 127) / 128;
  long long best = -1;
  int best_bn = 256, best_split = 1;
  for (int split = 1; split <= 2; ++split) {
    if (split > groups) break;
    for (int bn = 64; bn <= 256; bn *= 2) {
      const long long ctas = (long long)((t + bn - 1) / bn) * row_tiles * split;
      const long long waves = (ctas + kTcSms - 1) / kTcSms;
      const long long cost = waves * (kTcWaveFixed + (long long)((groups + split - 1) / split) * tc_group_cost(bn));
      if (best < 0 || cost < best) {
        best = cost;
        best_bn = bn;
        best_split = split;
      }
    }
  }
  *bn_out = best_bn;
  *split_out = best_split;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// B descriptor of a K-major bf16 tile written by TMA with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d[64 x 64] += A[64 x 16] (registers) * B[16 x 64] (shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[64 x 128] += A[64 x 16] (registers) * B[16 x 128] (shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[64 x 256] += A[64 x 16] (registers) * B[16 x 256] (shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Nibble -> bf16 without a convert. A byte rotated to bits 8-15 has its
// low nibble n at bit 8 (mask 0xF00) and its high nibble at bit 12
// (0xF000); OR'd into 0x4B000000 that is the f32 2^23 + n * 2^p exactly.
// One FMA with sp = s * 2^-p and cp = -(2^(23-p) + 8) * s, both exact in
// f32, gives (n - 8) * s exactly (15 significant bits at most), which one
// cvt.rn rounds to bf16: the plain version's (nib - 8) * s in f32, rounded
// once. dq2 makes the bf16 pair (element of byte lo, element of byte hi).
__device__ __forceinline__ uint32_t dq2(uint32_t lo, uint32_t hi, uint32_t mask, float sp, float cp) {
  const float f0 = __fmaf_rn(__int_as_float(0x4B000000u | (lo & mask)), sp, cp);
  const float f1 = __fmaf_rn(__int_as_float(0x4B000000u | (hi & mask)), sp, cp);
  const __nv_bfloat162 v = __floats2bfloat162_rn(f0, f1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int BN>
__global__ void __launch_bounds__(kTcThreads, 1)
q40_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap w_map,
                        const __half* __restrict__ scales, __nv_bfloat16* __restrict__ out,
                        int t, int n, int d, int split) {
  using C = TcCfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment for the 128-byte swizzle's pattern
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t xs0 = sbase;                               // STAGES x tiles
  const uint32_t ws0 = sbase + C::STAGES * C::XBYTES;       // STAGES weight tiles
  const uint32_t full0 = sbase + C::RING, empty0 = full0 + C::STAGES * 8;
  const uint8_t* ws_gen = smem + C::STAGES * C::XBYTES;

  const int tok0 = blockIdx.x * BN, row0 = blockIdx.y * C::BM, rank = blockIdx.z;
  const int groups = n / kTcGroup, per = (groups + split - 1) / split;
  const int g0 = rank * per, g1 = min(groups, g0 + per);
  const int n_stages = (g1 > g0 ? g1 - g0 : 0) * (kTcGroup / kTcK);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int it = 0; it < n_stages; ++it) {
        const int s = it % C::STAGES;
        mbar_wait(empty0 + 8 * s, ((it / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, C::XBYTES + C::WBYTES);
        const int k = g0 * kTcGroup + it * kTcK;  // first n value of the stage
        tma_load_2d(xs0 + s * C::XBYTES, &x_map, full0 + 8 * s, k, tok0);
        tma_load_2d(ws0 + s * C::WBYTES, &w_map, full0 + 8 * s, k / 2, row0);
      }
    }
    if (split > 1) {
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows row0 + 64 wg .. + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int rl = 64 * wg + 16 * warp + g;  // this thread's first row in the tile (second: + 8)
  // rotations that bring byte 2q (ra) and byte 2q + 1 (rb) of a 32-bit
  // word to bits 8-15
  const uint32_t ra = (q & 1) ? 24u : 8u, rb = (q & 1) ? 16u : 0u;
  const int nb = n / 32;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // f16 scales of a group's 8 blocks for rows rl and rl + 8, one group ahead
  auto load_scales = [&](int grp, uint4 (&sc)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + rl + 8 * r;
      sc[r] = (grp < g1 && row < d)
                  ? __ldg(reinterpret_cast<const uint4*>(scales + (size_t)row * nb + (size_t)grp * 8))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  uint4 sc_next[2];
  load_scales(g0, sc_next);

  uint32_t a[2][2][4];  // [register set][k16 step][fragment]
  int it = 0;           // stage counter
  for (int grp = g0; grp < g1; ++grp) {
    uint4 sc[2] = {sc_next[0], sc_next[1]};
    load_scales(grp + 1, sc_next);
#pragma unroll
    for (int st = 0; st < kTcGroup / kTcK; ++st, ++it) {
      const int s = it % C::STAGES;
      mbar_wait(full0 + 8 * s, (it / C::STAGES) & 1);
      const uint8_t* wrow = ws_gen + s * C::WBYTES + rl * (kTcK / 2);
#pragma unroll
      for (int bi = 0; bi < 2; ++bi) {
        const int blk = 2 * st + bi;  // block within the group: compile-time
        // rows rl and rl + 8: bytes 2q, 2q+1 ([r][0]) and 2q+8, 2q+9 ([r][1])
        // of the block, each at bits 8-15 of its own word (lo, hi); the
        // scale's two FMA operands for each nibble position
        uint32_t lo[2][2], hi[2][2];
        float sp[2][2], cp[2][2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t* p = reinterpret_cast<const uint32_t*>(wrow + r * 8 * (kTcK / 2) + bi * 16);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t word = p[2 * h + (q >> 1)];
            lo[r][h] = __funnelshift_l(word, word, ra);
            hi[r][h] = __funnelshift_l(word, word, rb);
          }
          const uint32_t sw = (&sc[r].x)[blk / 2];
          const float s = __half2float(__ushort_as_half((unsigned short)(sw >> (16 * (blk & 1)))));
          sp[r][0] = s * 0.00390625f;   // 2^-8: the low nibbles, at bit 8
          cp[r][0] = s * -32776.f;      // -(2^15 + 8)
          sp[r][1] = s * 0.000244140625f;  // 2^-12: the high nibbles, at bit 12
          cp[r][1] = s * -2056.f;       // -(2^11 + 8)
        }
        // the wgmmas that last read this register set (block b - 2) are
        // done, and so is the stage before this one: release it
        wgmma_wait<1>();
        if (bi == 1 && it >= 1 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % C::STAGES));
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {  // low nibbles, then high nibbles
          const uint32_t mask = kk ? 0xF000u : 0xF00u;
          a[bi][kk][0] = dq2(lo[0][0], hi[0][0], mask, sp[0][kk], cp[0][kk]);
          a[bi][kk][1] = dq2(lo[1][0], hi[1][0], mask, sp[1][kk], cp[1][kk]);
          a[bi][kk][2] = dq2(lo[0][1], hi[0][1], mask, sp[0][kk], cp[0][kk]);
          a[bi][kk][3] = dq2(lo[1][1], hi[1][1], mask, sp[1][kk], cp[1][kk]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_rs(acc, a[bi][kk], b_desc(xs0 + s * C::XBYTES + (bi * 32 + kk * 16) * 2));
        wgmma_commit();
      }
    }
  }
  wgmma_wait<0>();

  named_sync(1, 256);  // both consumers are done with the ring
  if (split > 1) {
    // rank 1 pushes its partial sums into rank 0's shared memory (remote
    // 16-byte stores, nothing waits on them); rank 0 adds them, always in
    // this order. [i / 4][thread][i % 4]: a thread's 4 floats together,
    // neighbouring threads 16 bytes apart.
    float4* part = reinterpret_cast<float4*>(smem);
    const int ctid = threadIdx.x;  // 0..255
    cluster_sync();                // rank 0's ring is free
    if (rank == 1) {
      uint32_t remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(remote) : "r"(smem_u32(part)));
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
        asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
                     :: "r"(remote + 16u * (i * 256 + ctid)), "f"(acc[4 * i]), "f"(acc[4 * i + 1]),
                        "f"(acc[4 * i + 2]), "f"(acc[4 * i + 3])
                     : "memory");
    }
    cluster_sync();                // the pushes have landed
    if (rank != 0) return;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const float4 v = part[i * 256 + ctid];
      acc[4 * i] += v.x;
      acc[4 * i + 1] += v.y;
      acc[4 * i + 2] += v.z;
      acc[4 * i + 3] += v.w;
    }
    named_sync(1, 256);            // every partial is read before the transpose reuses it
  }

  // epilogue: this warpgroup's 64 rows x BN tokens, transposed through
  // shared memory to [token][64 rows] (72-element rows: no bank conflicts)
  constexpr int LD = 72;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(smem) + wg * BN * LD;
  const int r0 = 16 * warp + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int tk = 8 * j + 2 * q;
    o[tk * LD + r0] = __float2bfloat16_rn(acc[4 * j + 0]);
    o[(tk + 1) * LD + r0] = __float2bfloat16_rn(acc[4 * j + 1]);
    o[tk * LD + r0 + 8] = __float2bfloat16_rn(acc[4 * j + 2]);
    o[(tk + 1) * LD + r0 + 8] = __float2bfloat16_rn(acc[4 * j + 3]);
  }
  named_sync(2 + wg, 128);
  const int piece = tid % 8, rbase = row0 + 64 * wg + piece * 8;
  for (int tk = tid / 8; tk < BN; tk += 16) {
    const int tok = tok0 + tk;
    if (tok >= t) break;
    const __nv_bfloat16* src = o + tk * LD + piece * 8;
    __nv_bfloat16* dst = out + (size_t)tok * d + rbase;
    if (rbase + 8 <= d && (d & 7) == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && rbase + e < d; ++e) dst[e] = src[e];
    }
  }
}

// cuTensorMapEncodeTiled, libcuda's entry point, fetched once through the
// runtime (no -lcuda at link time)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D map over a row-major (rows, cols) tensor, box (box_rows, box_cols)
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base, int rows,
              int cols, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
cudaError_t launch_wgmma_tile(const __nv_bfloat16* x, const uint8_t* packed, const __half* scales,
                              __nv_bfloat16* out, int t, int n, int d, int split, cudaStream_t stream) {
  using C = TcCfg<BN>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(q40_matmul_wgmma_kernel<BN>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  CUtensorMap xm, wm;
  if (!make_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, t, n, BN, kTcK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, packed, d, n / 2, C::BM, kTcK / 2,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((t + BN - 1) / BN), (unsigned)((d + C::BM - 1) / C::BM), (unsigned)split);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = (unsigned)split;
  cfg.attrs = at;
  cfg.numAttrs = split > 1 ? 1 : 0;   // a split runs as one 2-CTA cluster
  const cudaError_t e = cudaLaunchKernelEx(&cfg, q40_matmul_wgmma_kernel<BN>, xm, wm, scales, out, t, n, d, split);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// the tensor-core path's preconditions; anything else takes the GEMV path
bool tc_eligible(const void* x, const void* packed, const void* scales, int t, int n, int tc_min_t) {
  return t >= tc_min_t && n % kTcGroup == 0 && ((uintptr_t)x | (uintptr_t)packed | (uintptr_t)scales) % 16 == 0;
}

cudaError_t launch_wgmma(const __nv_bfloat16* x, const uint8_t* packed, const __half* scales,
                         __nv_bfloat16* out, int t, int n, int d, cudaStream_t stream, int bn = 0,
                         int split = 0) {
  if (bn == 0) tc_plan(t, n, d, &bn, &split);
  if (split < 1 || split > 2 || split > n / kTcGroup) return cudaErrorInvalidValue;
  if (bn == 64) return launch_wgmma_tile<64>(x, packed, scales, out, t, n, d, split, stream);
  if (bn == 128) return launch_wgmma_tile<128>(x, packed, scales, out, t, n, d, split, stream);
  if (bn == 256) return launch_wgmma_tile<256>(x, packed, scales, out, t, n, d, split, stream);
  return cudaErrorInvalidValue;
}

// The t = 1 GEMV's plan: rows a CTA, from the shapes and the CTAs the card
// holds at once (resident), so that one launch is about one wave of equal
// CTAs; a multiple of kG1Rows, at most 256, and its partial sums (C x R
// floats) within kG1SmemMax. 0 if n is too wide for even kG1Rows rows.
inline int gemv1_rows(int n, int d, int k, int resident, int max_rows = 256) {
  const int chunks = (n / 32 + 31) / 32;
  const int cap = std::min(max_rows, kG1SmemMax / (4 * chunks)) / kG1Rows * kG1Rows;
  if (cap < kG1Rows) return 0;
  const int per = std::max(1, resident / k);   // CTAs an expert
  const int r = ((d + per - 1) / per + kG1Rows - 1) / kG1Rows * kG1Rows;
  return std::min(r, cap);
}

template <typename TI, typename TO, bool Q80, int WARPS>
cudaError_t launch_gemv1(const TI* xp, const uint8_t* pp, const __half* sp, TO* op, int n, int d,
                         const int* idx, int n_experts, long long x_kstride, int k,
                         cudaStream_t stream) {
  // asked once (the same card every launch): the SMs, the CTAs an SM holds
  // by registers, the shared memory an SM has and a CTA may opt into
  struct Card { int sms, occ, smem_sm, smem_cta; };
  static const Card card = [] {
    int dev = 0;
    Card c{1, 1, 0, 0};
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.occ, q40_gemv1_kernel<TI, TO, Q80, WARPS>, 32 * WARPS,
                                                  8192);
    cudaDeviceGetAttribute(&c.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaDeviceGetAttribute(&c.smem_cta, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (Q80) cudaFuncSetAttribute(q40_gemv1_kernel<TI, TO, Q80, WARPS>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem_cta);
    return c;
  }();
  const int nb = n / 32, chunks = (nb + 31) / 32;
  // Q80: the round-tripped x, which every CTA holds whole; the plan takes
  // as many CTAs an SM as its registers allow and its shared memory holds
  // (with the runtime's 1 KB a CTA)
  const size_t xs_bytes = Q80 ? (size_t)nb * xs_words<TO>() * 4 : 0;
  int per_sm = std::max(1, card.occ), rows = 0;
  size_t smem = 0;
  for (;; --per_sm) {
    rows = gemv1_rows(n, d, k, std::max(1, card.sms) * per_sm, 32 * WARPS);
    smem = (size_t)chunks * rows * 4 + xs_bytes;
    if (!Q80 || per_sm == 1 || (size_t)per_sm * (smem + 1024) <= (size_t)card.smem_sm) break;
  }
  if (rows == 0 || smem > (size_t)std::max(card.smem_cta, kG1SmemMax)) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((d + rows - 1) / rows), (unsigned)k);
  q40_gemv1_kernel<TI, TO, Q80, WARPS><<<grid, 32 * WARPS, smem, stream>>>(
      xp, pp, sp, op, n, d, rows, idx, n_experts, x_kstride);
  return cudaGetLastError();
}

// The GEMV path: k experts along gridDim.z (k = 1 and idx = nullptr for K1);
// t = 1 takes the decode GEMV above, with the Q80 round trip fused in if
// q80 is set. q80 at t > 1 is refused: only the t = 1 GEMV has it.
template <typename TI, typename TO>
cudaError_t launch_gemv(const TI* xp, const uint8_t* pp, const __half* sp, TO* op, int t, int n, int d,
                        const int* idx, int n_experts, long long x_kstride, int k, bool q80,
                        cudaStream_t stream) {
  // K2 with the round trip fused runs 16-warp CTAs, one an SM (the same
  // 128 registers a thread): measured faster at every expert shape, and
  // slower at most of K1's (PERF.md, PR 9)
  if (t == 1 && q80 && idx != nullptr)
    return launch_gemv1<TI, TO, true, 2 * kG1Warps>(xp, pp, sp, op, n, d, idx, n_experts, x_kstride, k, stream);
  if (t == 1 && q80)
    return launch_gemv1<TI, TO, true, kG1Warps>(xp, pp, sp, op, n, d, idx, n_experts, x_kstride, k, stream);
  if (t == 1) return launch_gemv1<TI, TO, false, kG1Warps>(xp, pp, sp, op, n, d, idx, n_experts, x_kstride, k, stream);
  if (q80) return cudaErrorInvalidValue;
  const dim3 block(kWarps * 32);
  const unsigned rows = (unsigned)((d + kWarps - 1) / kWarps);
  const unsigned kz = (unsigned)k;
  if (t <= 4) {
    q40_matmul_kernel<TI, TO, 4, 2><<<dim3(1, rows, kz), block, 0, stream>>>(
        xp, pp, sp, op, t, n, d, idx, n_experts, x_kstride);
  } else {
    const unsigned groups = (unsigned)((t + 7) / 8);
    q40_matmul_kernel<TI, TO, 8, 1><<<dim3(groups, rows, kz), block, 0, stream>>>(
        xp, pp, sp, op, t, n, d, idx, n_experts, x_kstride);
  }
  return cudaGetLastError();
}

template <typename TI, typename TO>
cudaError_t launch(const void* x, const void* packed, const void* scales, void* out,
                   int t, int n, int d, int tc_min_t, bool q80, cudaStream_t stream) {
  const TI* xp = static_cast<const TI*>(x);
  const uint8_t* pp = static_cast<const uint8_t*>(packed);
  const __half* sp = static_cast<const __half*>(scales);
  TO* op = static_cast<TO*>(out);
  if constexpr (std::is_same<TI, __nv_bfloat16>::value && std::is_same<TO, __nv_bfloat16>::value) {
    if (tc_eligible(x, packed, scales, t, n, tc_min_t))   // the tensor-core path has no round trip
      return q80 ? cudaErrorInvalidValue : launch_wgmma(xp, pp, sp, op, t, n, d, stream);
  }
  return launch_gemv<TI, TO>(xp, pp, sp, op, t, n, d, nullptr, 1, 0, 1, q80, stream);
}

template <typename TI, typename TO>
cudaError_t launch_experts(const void* x, long long x_kstride, const int* idx, int k, int n_experts,
                           const void* packed, const void* scales, void* out, int t, int n, int d,
                           bool q80, cudaStream_t stream) {
  return launch_gemv<TI, TO>(static_cast<const TI*>(x), static_cast<const uint8_t*>(packed),
                             static_cast<const __half*>(scales), static_cast<TO*>(out), t, n, d,
                             idx, n_experts, x_kstride, k, q80, stream);
}

}  // namespace

// x: (t, n) f32 (x_dtype 0) or bf16 (1); packed: (d, n/2) u8 block-major;
// scales: (d, n/32) f16; out: (t, d) f32 (out_dtype 0) or bf16 (1).
// bf16 in and out with t >= tc_min_t, n % 256 == 0 and 16-byte aligned x,
// packed and scales takes the tensor-core path. q80 = 1: x is raw and the
// kernel applies the Q80 round trip to it first, rounded to the output type
// (the caller's compute type); t = 1 only, the t = 1 GEMV's path: anything
// else returns cudaErrorInvalidValue, never a launch without the round
// trip. Returns the launch's cudaError_t.
extern "C" int q40_matmul_launch(const void* x, int x_dtype, const void* packed,
                                 const void* scales, void* out, int out_dtype,
                                 int t, int n, int d, int tc_min_t, int q80, void* stream) {
  if (q80 != 0 && t != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f = q80 != 0;
  if (x_dtype == 0 && out_dtype == 0) return launch<float, float>(x, packed, scales, out, t, n, d, tc_min_t, f, s);
  if (x_dtype == 0 && out_dtype == 1) return launch<float, __nv_bfloat16>(x, packed, scales, out, t, n, d, tc_min_t, f, s);
  if (x_dtype == 1 && out_dtype == 0) return launch<__nv_bfloat16, float>(x, packed, scales, out, t, n, d, tc_min_t, f, s);
  if (x_dtype == 1 && out_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(x, packed, scales, out, t, n, d, tc_min_t, f, s);
  return (int)cudaErrorInvalidValue;
}

// K2. x: (t, n), shared by the experts (x_kstride 0), or (k, t, n) one per
// expert (x_kstride t*n), f32 (x_dtype 0) or bf16 (1); idx: (k,) int32 on the
// device, read by the kernel; packed: (n_experts, d, n/2) u8 block-major;
// scales: (n_experts, d, n/32) f16; out: (k, t, d) f32 (out_dtype 0) or
// bf16 (1). t <= 8 (the GEMV path). q80 = 1: the Q80 round trip fused in,
// as for q40_matmul_launch, at t = 1 only. Returns the launch's cudaError_t.
extern "C" int q40_expert_matmul_launch(const void* x, int x_dtype, long long x_kstride,
                                        const void* idx, int k, int n_experts,
                                        const void* packed, const void* scales, void* out,
                                        int out_dtype, int t, int n, int d, int q80, void* stream) {
  if (t < 1 || t > 8 || k < 1 || n_experts < 1) return (int)cudaErrorInvalidValue;
  if (q80 != 0 && t != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const bool f = q80 != 0;
  if (x_dtype == 0 && out_dtype == 0)
    return launch_experts<float, float>(x, x_kstride, ip, k, n_experts, packed, scales, out, t, n, d, f, s);
  if (x_dtype == 0 && out_dtype == 1)
    return launch_experts<float, __nv_bfloat16>(x, x_kstride, ip, k, n_experts, packed, scales, out, t, n, d, f, s);
  if (x_dtype == 1 && out_dtype == 0)
    return launch_experts<__nv_bfloat16, float>(x, x_kstride, ip, k, n_experts, packed, scales, out, t, n, d, f, s);
  if (x_dtype == 1 && out_dtype == 1)
    return launch_experts<__nv_bfloat16, __nv_bfloat16>(x, x_kstride, ip, k, n_experts, packed, scales, out, t, n, d, f, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core path's plan for (t, n, d): tokens a CTA (64, 128 or
// 256) and the split of the n axis (1 or 2). Returns 0.
extern "C" int q40_matmul_tc_plan(int t, int n, int d, int* bn, int* split) {
  tc_plan(t, n, d, bn, split);
  return 0;
}

// The tensor-core path at a given plan, for timing the plans against each
// other; bf16 x and out, the same preconditions as the planned path.
// Returns the launch's cudaError_t.
extern "C" int q40_matmul_tc_launch(const void* x, const void* packed, const void* scales, void* out,
                                    int t, int n, int d, int bn, int split, void* stream) {
  if (!tc_eligible(x, packed, scales, t, n, 1) || bn == 0) return (int)cudaErrorInvalidValue;
  return launch_wgmma(static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
                      static_cast<const __half*>(scales), static_cast<__nv_bfloat16*>(out), t, n, d,
                      static_cast<cudaStream_t>(stream), bn, split);
}
