// The decode-GEMV probes P3 and P5 for Hopper (sm_90a), on the design of
// K1's t = 1 GEMV (csrc/q40_matmul.cu q40_gemv1_kernel). One kernel
// template computes, for one row d of a block-major Q40 weight,
//
//   y[0, d] = sum_b s[d, b] * (sum_j A[d, b, j] xa[b, j] + hi[d, b, j] xb[b, j])
//             - 8 sum_b s[d, b] xsum[b]
//
// in f32 with f32 out; byte j of block b holds the low nibble lo and the high
// nibble hi. It replaces two Pallas probes of the JAX repository's tools/:
//
//  * P3, tools/exp_pk_decode.py build (the pallas_call at :79), the
//    packed-byte substitution. base: A = lo, xa = x1 = x_lo, xb = x2 = x_hi;
//    pk: A = the whole byte and x2 = x_hi - 16 x_lo (lo = pk - 16 hi folded
//    into the activations outside the kernel), so the low operand needs no
//    nibble mask. x1, x2 (n/2) f32 come in the weight's byte order, xsum
//    (n/32) f32 is given, the scales are f16.
//  * P5, tools/exp_scale_f16.py q40_matmul_u16 (:60): A = lo, x (n) f32
//    split into each block's first and last 16 values, xsum computed here;
//    the scales are 2-byte f16 bits decoded by integer ops (u16), or 4-byte
//    f32 read as they are.
//
// What bounds it on the H100: the weight bytes. P3 at w1 (22016 x 4096)
// reads 50.8 MB, 15.2 us at 3.35 TB/s; at attn (4096 x 4096) 9.5 MB, 2.83
// us. P5's pass of 32 x 22016 x 4096 reads 1,626.7 MB with u16 scales
// (0.486 ms) and 1,807.1 MB with f32 (0.539 ms). At 2 values a byte the
// card's issue rate leaves ~5 thread instructions a value at that rate, so
// the kernel is bound by issue nearly as much as by bytes, as K1 is.
//
// The design is K1's (the earlier ladder layout staged x into shared memory
// once per 8-row CTA behind barriers, so x's traffic equalled the weight's):
//  * x stays in registers. A chunk is 1024 values of n, one 32-value Q40
//    block a lane: the lane holds its block's 16 xa and 16 xb values and
//    -8 xsum for every row its warp takes in that chunk. P5 sums its block
//    of x in the lane, once a chunk; nothing goes through shared memory.
//  * Items of 4 rows x one chunk, dealt chunk-major in contiguous runs to
//    8 warps; each warp issues its next item's loads (4 x 16 bytes and a
//    scale a lane) before it consumes the current one.
//  * One wave of equal CTAs: rows a CTA from the occupancy query, as K1's
//    gemv1_rows; 128 registers a thread, 2 CTAs an SM.
//  * No int-to-float convert: the operand v at bit p of a word, OR'd by one
//    LOP3 into the f32 2^(23-p) (whose last mantissa bit is worth 2^-p), is
//    2^(23-p) + v, and one FADD of -2^(23-p) leaves v exactly; one FMA puts
//    x * v into its chain, and the block's sum, with -8 xsum, is scaled by
//    s once, as the plain version scales a block. A word's bytes 0 and 1
//    hold their nibbles at p = 0, 4, 8, 12; one shift by 16 brings bytes 2
//    and 3 there, so a word costs one shift, 8 LOP3s, 8 FADDs and 8 FMAs.
//    pk's whole byte goes into 2^23's low byte by one PRMT (p = 0, no shift,
//    no mask), so its low operand costs what a nibble does.
//    The form the design first named, 2^23 + v 2^p into one exact FMA with
//    s 2^-p and -2^(23-p) s giving v s (7 scale constants a row and block),
//    is kept as the body kFma: it timed slower (PERF.md).
//  * The item loop steps a (chunk, row group) cursor, with no division an
//    item; where a chunk's x is loaded differs between P3 and P5 (the loops
//    below: all loads wait on one scoreboard).
//  * Deterministic: each item's 4 row sums are reduced by shuffles in a
//    fixed pattern into part[chunk][row]; after one barrier each row's
//    partials are added in chunk order. No atomics.
//  * The u16 scale decode is the JAX package's _f16_bits_to_f32 (integer
//    ops and a select, never __half2float); P3's f16 scales take the
//    hardware convert, as K1's do.
//
// The body switch (q40_gemv1_probe_launch's `body`): the product as kept
// (kFull), with the mode's other item loop (kOtherLoop, below), or with the
// FMA form of the dequantize (kFma); the loads alone with their bits folded
// so that none is dropped (kLoads); no loads at all, zeros written
// (kEmpty). The last two, on the full kernel's grid, split a short launch's
// time into its fixed cost, its loads and its arithmetic. The entry's pdl
// switch launches kFull, kLoads or kEmpty as a programmatic dependent
// launch: a launch's first weight loads then overlap the tail of the one
// before it (what back-to-back GEMVs of a decode step could gain).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

enum Mode { kBase = 0, kPk = 1, kU16 = 2, kF32 = 3 };
enum Body { kFull = 0, kOtherLoop = 1, kFma = 2, kLoads = 3, kEmpty = 4 };

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                  // rows an item
constexpr int kSmemMax = 48 * 1024;       // bytes of partial sums, without an opt-in
constexpr uint32_t kMagic = 0x4B000000u;  // the f32 2^23

template <int MODE>
struct ScaleOf { using T = unsigned short; };   // f16 bits
template <>
struct ScaleOf<kF32> { using T = float; };

// f16 bits -> f32 with integer ops, exact for every finite pattern (the JAX
// package's _f16_bits_to_f32)
__device__ __forceinline__ float f16_bits_to_f32(uint32_t u) {
  const uint32_t sign = (u & 0x8000u) << 16, e = (u >> 10) & 0x1Fu, m = u & 0x3FFu;
  const float normal = __uint_as_float(sign | ((e + 112u) << 23) | (m << 13));
  const float sub = __uint_as_float(__float_as_uint((float)m * 5.9604644775390625e-08f) | sign);
  return e == 0u ? sub : normal;
}

template <int MODE>
__device__ __forceinline__ float scale_f32(typename ScaleOf<MODE>::T s) {
  if constexpr (MODE == kF32) {
    return s;
  } else if constexpr (MODE == kU16) {
    return f16_bits_to_f32(s);
  } else {
    return __half2float(__ushort_as_half(s));
  }
}

// 2^23 + nibble * 2^p as an f32, the nibble at bits p..p+3 of v under mask:
// (v & mask) | magic in one LOP3 (from csrc/q40_matmul.cu nib_f)
__device__ __forceinline__ float nib_f(uint32_t v, uint32_t mask, uint32_t magic) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(r) : "r"(v), "r"(mask), "r"(magic));
  return __uint_as_float(r);
}

// 2^23 + byte K of w as an f32: the byte into the magic constant's low byte,
// one PRMT
template <int K>
__device__ __forceinline__ float byte_f(uint32_t w, uint32_t magic) {
  return __uint_as_float(__byte_perm(w, magic, 0x7650u | K));
}

// One item's weights: kRows rows of one lane's block, 16 bytes and a scale a
// row, loaded together before the previous item is consumed.
template <int MODE>
struct Item {
  uint4 w[kRows];
  typename ScaleOf<MODE>::T s[kRows];
};

// One lane's x in a chunk: its block's 16 low-operand and 16 high-operand
// values and -8 xsum (0 for a block past n).
struct XBlock {
  float a[16], b[16];
  float m8xs;
};

template <int MODE>
__device__ __forceinline__ void load_xblock(const float* xa, const float* xb, const float* xsum, int blk,
                                            bool live, XBlock& x) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (MODE == kU16 || MODE == kF32) {   // x: the block's 32 values
    const float4* p = reinterpret_cast<const float4*>(xa + (size_t)blk * 32);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 f = live ? __ldg(p + j) : z, h = live ? __ldg(p + 4 + j) : z;
      x.a[4 * j] = f.x; x.a[4 * j + 1] = f.y; x.a[4 * j + 2] = f.z; x.a[4 * j + 3] = f.w;
      x.b[4 * j] = h.x; x.b[4 * j + 1] = h.y; x.b[4 * j + 2] = h.z; x.b[4 * j + 3] = h.w;
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) s += x.a[j];
#pragma unroll
    for (int j = 0; j < 16; ++j) s += x.b[j];
    x.m8xs = -8.f * s;
  } else {   // x1, x2: 16 values a block each, and the given block sum
    const float4* pa = reinterpret_cast<const float4*>(xa + (size_t)blk * 16);
    const float4* pb = reinterpret_cast<const float4*>(xb + (size_t)blk * 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 f = live ? __ldg(pa + j) : z, h = live ? __ldg(pb + j) : z;
      x.a[4 * j] = f.x; x.a[4 * j + 1] = f.y; x.a[4 * j + 2] = f.z; x.a[4 * j + 3] = f.w;
      x.b[4 * j] = h.x; x.b[4 * j + 1] = h.y; x.b[4 * j + 2] = h.z; x.b[4 * j + 3] = h.w;
    }
    x.m8xs = live ? -8.f * __ldg(xsum + blk) : 0.f;
  }
}

// The masks, and 2^23 for the PRMT and the FMA body, kept in registers: the
// compiler would fold them into immediates and split a LOP3 with two of
// them in two (one immediate, the magic constant of nib_i, fits)
struct Consts {
  uint32_t m0, m4, m8, m12, magic;
};

// 2^(23-p) + nibble as an f32, the nibble at bits p..p+3 of v under mask:
// (v & mask) | MAGIC in one LOP3, MAGIC the f32 2^(23-p) (whose last
// mantissa bit is worth 2^-p), so no scale by 2^-p is left to undo
template <uint32_t MAGIC>
__device__ __forceinline__ float nib_i(uint32_t v, uint32_t mask) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(r) : "r"(v), "r"(mask), "n"(MAGIC));
  return __uint_as_float(r);
}

// x . (one row's block) - 8 s xsum. Word q holds bytes 4q..4q+3; byte j's
// low operand pairs with a[j], its high nibble with b[j]. Two chains, the
// low operands' products and the high nibbles'.
//  * FMA false (the kept arithmetic): each operand v exactly, as one FADD of
//    2^(23-p) + v less 2^(23-p) (an immediate); the block's two sums and
//    -8 xsum times s once, as the plain version scales a block.
//  * FMA true: v * s by one exact FMA of 2^23 + v 2^p with s 2^-p and
//    -2^(23-p) s (7 constants a row and block), then one FMA into its
//    chain; timed slower (PERF.md).
template <int MODE, bool FMA>
__device__ __forceinline__ float dot_block(const uint4& blk, float s, const XBlock& x, const Consts& k) {
  const uint32_t words[4] = {blk.x, blk.y, blk.z, blk.w};
  float a = 0.f, b = 0.f;
  if constexpr (!FMA) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t w = words[q], u = w >> 16;   // bytes 4q + 2, 4q + 3 at bits 0-15 of u
      if constexpr (MODE == kPk) {
        a = fmaf(x.a[4 * q], byte_f<0>(w, k.magic) - 8388608.0f, a);
        a = fmaf(x.a[4 * q + 1], byte_f<1>(w, k.magic) - 8388608.0f, a);
        a = fmaf(x.a[4 * q + 2], byte_f<2>(w, k.magic) - 8388608.0f, a);
        a = fmaf(x.a[4 * q + 3], byte_f<3>(w, k.magic) - 8388608.0f, a);
      } else {
        a = fmaf(x.a[4 * q], nib_i<0x4B000000u>(w, k.m0) - 8388608.0f, a);     // p 0: 2^23
        a = fmaf(x.a[4 * q + 1], nib_i<0x47000000u>(w, k.m8) - 32768.0f, a);   // p 8: 2^15
        a = fmaf(x.a[4 * q + 2], nib_i<0x4B000000u>(u, k.m0) - 8388608.0f, a);
        a = fmaf(x.a[4 * q + 3], nib_i<0x47000000u>(u, k.m8) - 32768.0f, a);
      }
      b = fmaf(x.b[4 * q], nib_i<0x49000000u>(w, k.m4) - 524288.0f, b);      // p 4: 2^19
      b = fmaf(x.b[4 * q + 1], nib_i<0x45000000u>(w, k.m12) - 2048.0f, b);   // p 12: 2^11
      b = fmaf(x.b[4 * q + 2], nib_i<0x49000000u>(u, k.m4) - 524288.0f, b);
      b = fmaf(x.b[4 * q + 3], nib_i<0x45000000u>(u, k.m12) - 2048.0f, b);
    }
    return ((a + b) + x.m8xs) * s;
  } else {
    const float sp4 = s * 0.0625f, sp8 = s * 0.00390625f, sp12 = s * 0.000244140625f;
    const float cp0 = s * -8388608.0f, cp4 = s * -524288.0f, cp8 = s * -32768.0f, cp12 = s * -2048.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t w = words[q], u = w >> 16;
      if constexpr (MODE == kPk) {
        a = fmaf(x.a[4 * q], __fmaf_rn(byte_f<0>(w, k.magic), s, cp0), a);
        a = fmaf(x.a[4 * q + 1], __fmaf_rn(byte_f<1>(w, k.magic), s, cp0), a);
        a = fmaf(x.a[4 * q + 2], __fmaf_rn(byte_f<2>(w, k.magic), s, cp0), a);
        a = fmaf(x.a[4 * q + 3], __fmaf_rn(byte_f<3>(w, k.magic), s, cp0), a);
      } else {
        a = fmaf(x.a[4 * q], __fmaf_rn(nib_f(w, k.m0, k.magic), s, cp0), a);
        a = fmaf(x.a[4 * q + 1], __fmaf_rn(nib_f(w, k.m8, k.magic), sp8, cp8), a);
        a = fmaf(x.a[4 * q + 2], __fmaf_rn(nib_f(u, k.m0, k.magic), s, cp0), a);
        a = fmaf(x.a[4 * q + 3], __fmaf_rn(nib_f(u, k.m8, k.magic), sp8, cp8), a);
      }
      b = fmaf(x.b[4 * q], __fmaf_rn(nib_f(w, k.m4, k.magic), sp4, cp4), b);
      b = fmaf(x.b[4 * q + 1], __fmaf_rn(nib_f(w, k.m12, k.magic), sp12, cp12), b);
      b = fmaf(x.b[4 * q + 2], __fmaf_rn(nib_f(u, k.m4, k.magic), sp4, cp4), b);
      b = fmaf(x.b[4 * q + 3], __fmaf_rn(nib_f(u, k.m12, k.magic), sp12, cp12), b);
    }
    return fmaf(s, x.m8xs, a + b);
  }
}

// The RI row sums of a warp, each spread over its 32 lanes, reduced so that
// lane group r (by the lane's top bits) holds row r's total; the order of
// the adds depends on nothing but the lane (from csrc/q40_matmul.cu
// warp_rows_reduce).
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

// A CTA owns rows [row0, row0 + R), cut into items of kRows rows x one chunk
// of n; the C x G items, chunk-major, are dealt to the 8 warps in contiguous
// runs (from csrc/q40_matmul.cu q40_gemv1_kernel's item loop and
// part[chunk][row] reduction). xb is unread for P5 (x's blocks hold both
// halves); xsum is unread for P5.
// The wait for the grid before this one on the stream (programmatic
// dependent launch): its writes are visible after it.
__device__ __forceinline__ void grid_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

template <int MODE, int BODY, bool PDL>
__global__ void __launch_bounds__(kThreads, 2)
q40_gemv1_probe_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                       const float* __restrict__ xsum, const uint8_t* __restrict__ packed,
                       const typename ScaleOf<MODE>::T* __restrict__ scales, float* __restrict__ out,
                       int n, int d, int R) {
  extern __shared__ float part[];   // C x R partial sums
  const int row0 = blockIdx.x * R;
  if constexpr (PDL) asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if constexpr (BODY == kEmpty) {
    if constexpr (PDL) grid_wait();
    __syncthreads();
    for (int j = threadIdx.x; j < R && row0 + j < d; j += kThreads) out[row0 + j] = 0.f;
    return;
  } else {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nb = n / 32;
    const int C = (nb + 31) / 32, G = R / kRows;
    const int items = C * G;
    const int i0 = (int)((long long)warp * items / kWarps);
    const int i1 = (int)((long long)(warp + 1) * items / kWarps);
    // this CTA's rows; a row past d reads row d - 1 (never written), a lane
    // past the last block reads the last block against x = 0
    const uint4* pw = reinterpret_cast<const uint4*>(packed) + (size_t)row0 * nb;
    const typename ScaleOf<MODE>::T* ps = scales + (size_t)row0 * nb;
    const int rlast = d - 1 - row0;
    Consts k{0xFu, 0xF0u, 0xF00u, 0xF000u, kMagic};
    asm volatile("" : "+r"(k.m0), "+r"(k.m4), "+r"(k.m8), "+r"(k.m12), "+r"(k.magic));

    // an item as (chunk c, 4-row group g): one division a warp, then a step
    // an item (a division by G is ~20 instructions; an item took 2-3)
    struct At {
      int c, g;
    };
    auto step = [&](At u) {
      if (++u.g == G) {
        u.g = 0;
        ++u.c;
      }
      return u;
    };
    auto load = [&](Item<MODE>& it, At u) {
      const int g4 = u.g * kRows;
      const size_t o = (size_t)g4 * nb + min(u.c * 32 + lane, nb - 1);
      const uint4* w = pw + o;
      const typename ScaleOf<MODE>::T* sc = ps + o;
      const int lim = rlast - g4;   // rows past it read row rlast
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int off = min(r, lim) * nb;
        it.w[r] = __ldg(w + off);
        it.s[r] = __ldg(sc + off);
      }
    };
    XBlock x;
    auto chunk = [&](At u) {   // x of u's chunk into registers
      const int blk = u.c * 32 + lane;
      load_xblock<MODE>(xa, xb, xsum, blk, blk < nb, x);
      if constexpr (BODY == kLoads) {   // every value's bits kept live
        uint32_t f = __float_as_uint(x.m8xs);
#pragma unroll
        for (int j = 0; j < 16; ++j) f ^= __float_as_uint(x.a[j]) ^ __float_as_uint(x.b[j]);
        x.m8xs = __uint_as_float(f);
      }
    };
    auto dot = [&](const Item<MODE>& it, At u) {
      float a[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float sr = scale_f32<MODE>(it.s[r]);
        if constexpr (BODY == kLoads) {   // the loaded bits, folded into a finite value
          const uint32_t f = it.w[r].x ^ it.w[r].y ^ it.w[r].z ^ it.w[r].w ^
                             __float_as_uint(x.m8xs) ^ __float_as_uint(sr);
          a[r] = __uint_as_float(f & 0x3F7FFFFFu);
        } else {
          a[r] = dot_block<MODE, BODY == kFma>(it.w[r], sr, x, k);
        }
      }
      int r;
      const float v = warp_rows_reduce<kRows>(a, lane, &r);
      if ((lane & (32 / kRows - 1)) == 0) part[u.c * R + u.g * kRows + r] = v;   // R % kRows == 0
    };

    // Two items' loads in flight: item i + 1's are issued before item i is
    // consumed. Two loops, which differ in where a chunk's x is loaded:
    //  * by chunk (P3): x, after the chunk's first item's loads are issued,
    //    then the chunk's items, so the item loop holds no x load;
    //  * flat (P5): one loop over the run, a new chunk's x loaded inside it,
    //    after the next item's loads are issued (as K1 loads f32 x).
    // Each timed faster for its modes at every shape (PERF.md);
    // kOtherLoop runs the other one. The compiler puts all these loads on one
    // scoreboard, so where x's wait falls decides which item loads it waits
    // for too: P3's given block sum, loaded with x inside the flat loop, had
    // every item wait for the next item's loads.
    constexpr bool BY_CHUNK = (MODE == kBase || MODE == kPk) != (BODY == kOtherLoop);
    Item<MODE> A, B;
    At ua{i0 / G, i0 % G}, ub;
    if constexpr (BY_CHUNK) {
      for (int i = i0; i < i1;) {   // ua: the chunk's first item of the run
        const int c = ua.c, iend = min(i1, (c + 1) * G);
        load(A, ua);
        if constexpr (PDL) {
          if (i == i0) grid_wait();   // the weights are in flight; x may be the last grid's
        }
        chunk(ua);
        for (; i < iend; i += 2) {
          ub = step(ua);
          if (i + 1 < iend) load(B, ub);
          dot(A, ua);
          if (i + 1 >= iend) break;
          ua = step(ub);
          if (i + 2 < iend) load(A, ua);
          dot(B, ub);
        }
        i = iend;
        ua = At{c + 1, 0};
      }
    } else {
      int cx = -1;
      auto chunk_of = [&](At u) {   // x of u's chunk, if it is a new one
        if (u.c != cx) {
          chunk(u);
          cx = u.c;
        }
      };
      if constexpr (PDL) {   // the weights first, x once the last grid is done
        if (i0 < i1) load(A, ua);
        grid_wait();
        if (i0 < i1) chunk_of(ua);
      } else {
        if (i0 < i1) chunk_of(ua);   // x ahead of the first weights
        if (i0 < i1) load(A, ua);
      }
      for (int i = i0; i < i1; i += 2) {
        ub = step(ua);
        if (i + 1 < i1) load(B, ub);
        chunk_of(ua);
        dot(A, ua);
        if (i + 1 >= i1) break;
        ua = step(ub);
        if (i + 2 < i1) load(A, ua);
        chunk_of(ub);
        dot(B, ub);
      }
    }
    if constexpr (PDL) grid_wait();   // out, for warps that had no items
    __syncthreads();
    for (int j = threadIdx.x; j < R; j += kThreads) {
      const int row = row0 + j;
      if (row >= d) break;
      float acc = 0.f;
      for (int c = 0; c < C; ++c) acc += part[c * R + j];
      out[row] = acc;
    }
  }
}

// The plan: rows a CTA, from the shapes and the CTAs the card holds at once
// (resident), so that one launch is about one wave of equal CTAs; a
// multiple of kRows, at most 256, its partial sums (C x R floats) within
// kSmemMax. 0 if n is too wide for even kRows rows. (csrc/q40_matmul.cu
// gemv1_rows at k = 1; ops/cuda_probes.py gemv1_rows is its Python twin.)
inline int gemv1_rows(int n, int d, int resident) {
  const int chunks = (n / 32 + 31) / 32;
  const int cap = std::min(256, kSmemMax / (4 * chunks)) / kRows * kRows;
  if (cap < kRows) return 0;
  const int per = std::max(1, resident);
  const int r = ((d + per - 1) / per + kRows - 1) / kRows * kRows;
  return std::min(r, cap);
}

// The CTAs the card holds at once for the mode's product kernel: SMs times
// its occupancy (asked once; the same card every launch). The other bodies
// run on the product's plan, so that they time the same grid.
template <int MODE>
int resident() {
  static const int r = [] {
    int dev = 0, sms = 1, occ = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, q40_gemv1_probe_kernel<MODE, kFull, false>, kThreads,
                                                  8192);
    return std::max(1, sms) * std::max(1, occ);
  }();
  return r;
}

int mode_resident(int mode) {
  switch (mode) {
    case kBase: return resident<kBase>();
    case kPk: return resident<kPk>();
    case kU16: return resident<kU16>();
    default: return resident<kF32>();
  }
}

// PDL: launched with programmatic stream serialization, so that it may start
// while the grid before it on the stream finishes; it loads its first
// weights, then waits for that grid (grid_wait) before it reads x or
// writes out. Only for weights that grid did not write.
template <int MODE, int BODY, bool PDL>
cudaError_t launch(const void* xa, const void* xb, const void* xsum, const void* packed, const void* scales,
                   void* out, int n, int d, int rows, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((d + rows - 1) / rows));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)((n / 32 + 31) / 32) * rows * 4;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = PDL ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, q40_gemv1_probe_kernel<MODE, BODY, PDL>, static_cast<const float*>(xa),
      static_cast<const float*>(xb), static_cast<const float*>(xsum), static_cast<const uint8_t*>(packed),
      static_cast<const typename ScaleOf<MODE>::T*>(scales), static_cast<float*>(out), n, d, rows);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int MODE>
cudaError_t launch_body(int body, bool pdl, const void* xa, const void* xb, const void* xsum, const void* packed,
                        const void* scales, void* out, int n, int d, int rows, cudaStream_t s) {
  if (pdl) {   // the product, the loads alone and the empty launch
    switch (body) {
      case kFull: return launch<MODE, kFull, true>(xa, xb, xsum, packed, scales, out, n, d, rows, s);
      case kLoads: return launch<MODE, kLoads, true>(xa, xb, xsum, packed, scales, out, n, d, rows, s);
      case kEmpty: return launch<MODE, kEmpty, true>(xa, xb, xsum, packed, scales, out, n, d, rows, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (body) {
    case kFull: return launch<MODE, kFull, false>(xa, xb, xsum, packed, scales, out, n, d, rows, s);
    case kOtherLoop: return launch<MODE, kOtherLoop, false>(xa, xb, xsum, packed, scales, out, n, d, rows, s);
    case kFma: return launch<MODE, kFma, false>(xa, xb, xsum, packed, scales, out, n, d, rows, s);
    case kLoads: return launch<MODE, kLoads, false>(xa, xb, xsum, packed, scales, out, n, d, rows, s);
    case kEmpty: return launch<MODE, kEmpty, false>(xa, xb, xsum, packed, scales, out, n, d, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int MODE>
const void* kernel_of(int body) {
  switch (body) {
    case kFull: return (const void*)q40_gemv1_probe_kernel<MODE, kFull, false>;
    case kOtherLoop: return (const void*)q40_gemv1_probe_kernel<MODE, kOtherLoop, false>;
    case kFma: return (const void*)q40_gemv1_probe_kernel<MODE, kFma, false>;
    case kLoads: return (const void*)q40_gemv1_probe_kernel<MODE, kLoads, false>;
    case kEmpty: return (const void*)q40_gemv1_probe_kernel<MODE, kEmpty, false>;
    default: return nullptr;
  }
}

}  // namespace

// The probe kernel with any body and rows a CTA. mode 0 base, 1 pk (P3: xa,
// xb = x1, x2 (n/2) f32, xsum (n/32) f32, f16 scales), 2 u16, 3 f32 (P5:
// xa = x (n) f32, xb and xsum unread, u16 f16-bit or f32 scales); body 0-4
// as Body; pdl 1: launched as a programmatic dependent launch (kFull,
// kLoads, kEmpty only; for weights the grid before it did not write);
// packed (d, n/2) u8 block-major, scales (d, n/32); out (d) f32. rows 0
// takes the plan (q40_gemv1_probe_plan), else a multiple of 4 up to 256
// whose partial sums fit 48 KB. Returns the launch's cudaError_t.
extern "C" int q40_gemv1_probe_launch(int mode, int body, int pdl, const void* xa, const void* xb,
                                      const void* xsum, const void* packed, const void* scales, void* out,
                                      int n, int d, int rows, void* stream) {
  if (n < 32 || n % 32 || d < 1 || mode < kBase || mode > kF32) return (int)cudaErrorInvalidValue;
  if (rows == 0) rows = gemv1_rows(n, d, mode_resident(mode));
  const int chunks = (n / 32 + 31) / 32;
  if (rows < kRows || rows % kRows || rows > 256 || (size_t)chunks * rows * 4 > (size_t)kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kBase: return (int)launch_body<kBase>(body, pdl != 0, xa, xb, xsum, packed, scales, out, n, d, rows, s);
    case kPk: return (int)launch_body<kPk>(body, pdl != 0, xa, xb, xsum, packed, scales, out, n, d, rows, s);
    case kU16: return (int)launch_body<kU16>(body, pdl != 0, xa, xb, xsum, packed, scales, out, n, d, rows, s);
    default: return (int)launch_body<kF32>(body, pdl != 0, xa, xb, xsum, packed, scales, out, n, d, rows, s);
  }
}

// P3. pk 0 (base) or 1 (pk). x1, x2: (n/2) f32 in the weight's byte order
// (x1 = x_lo; x2 = x_hi, or x_hi - 16 x_lo for pk); xsum: (n/32) f32;
// packed: (d, n/2) u8 block-major; scales: (d, n/32) f16; out: (d) f32.
// Returns the launch's cudaError_t.
extern "C" int q40_pk_gemv_launch(int pk, const void* x1, const void* x2, const void* xsum, const void* packed,
                                  const void* scales, void* out, int n, int d, void* stream) {
  if (pk != 0 && pk != 1) return (int)cudaErrorInvalidValue;
  return q40_gemv1_probe_launch(pk ? kPk : kBase, kFull, 0, x1, x2, xsum, packed, scales, out, n, d, 0, stream);
}

// P5. u16 1: scales are (d, n/32) u16 f16 bits; u16 0: f32. x: (n) f32;
// packed: (d, n/2) u8 block-major; out: (d) f32. Returns the launch's
// cudaError_t.
extern "C" int q40_matmul_scales_launch(int u16, const void* x, const void* packed, const void* scales, void* out,
                                        int n, int d, void* stream) {
  if (u16 != 0 && u16 != 1) return (int)cudaErrorInvalidValue;
  return q40_gemv1_probe_launch(u16 ? kU16 : kF32, kFull, 0, x, nullptr, nullptr, packed, scales, out, n, d, 0,
                                stream);
}

// The plan a launch of the mode takes at (n, d): out[0..2] = rows a CTA
// (0 if n is too wide), CTAs, and the CTAs the card holds at once that the
// plan was made for. Returns a cudaError_t.
extern "C" int q40_gemv1_probe_plan(int mode, int n, int d, int* out) {
  if (n < 32 || n % 32 || d < 1 || mode < kBase || mode > kF32) return (int)cudaErrorInvalidValue;
  out[2] = mode_resident(mode);
  out[0] = gemv1_rows(n, d, out[2]);
  out[1] = out[0] ? (d + out[0] - 1) / out[0] : 0;
  return 0;
}

// A mode and body's kernel as compiled: out[0..4] = registers a thread,
// local (spill) bytes a thread, static shared bytes, 0 for the dynamic
// shared bytes (the plan's C x R partial sums), threads a block. Returns a
// cudaError_t.
extern "C" int q40_gemv1_probe_attrs(int mode, int body, int* out) {
  const void* kf = mode == kBase ? kernel_of<kBase>(body)
                 : mode == kPk   ? kernel_of<kPk>(body)
                 : mode == kU16  ? kernel_of<kU16>(body)
                 : mode == kF32  ? kernel_of<kF32>(body)
                                 : nullptr;
  if (kf == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kf);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = 0;
  out[4] = kThreads;
  return 0;
}
