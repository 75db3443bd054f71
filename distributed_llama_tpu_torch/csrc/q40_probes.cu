// Q40 decode-GEMV design probes for Hopper (sm_90a): four kernels that take
// the t = 1 Q40 GEMV of K1/K2 (csrc/q40_matmul.cu) apart, to find what holds
// it below the card's memory rate. Each replaces one Pallas probe of the JAX
// repository's tools/:
//
//  * q40_ladder_kernel<STAGE>: tools/kernel_ladder.py run_stage (the
//    pallas_call at kernel_ladder.py:92), the cost ladder. One stage more
//    work per step: read -> unpack -> convert -> mul -> dot.
//  * q40_bf16_kernel<false>: tools/kernel_experiments.py q40_matmul_a (the
//    pallas_call at :80), the dequantized weight in bf16 with the -8 inside.
//  * q40_bf16_kernel<true>: kernel_experiments.py q40_matmul_b (:126),
//    unsigned nibbles in bf16 and the -8 folded out into a correction.
//  * int8_gemv_kernel: tools/exp_int8_dot.py int8_gemv (:56), int4 widened
//    to int8 and an integer dot (__dp4a), one f32 scale per row.
//
// The probes P3 (tools/exp_pk_decode.py) and P5 (tools/exp_scale_f16.py) are
// in csrc/q40_gemv1_probes.cu, on the design of K1's t = 1 GEMV.
//
// What bounds them on the H100: the weight bytes. At the probes' shape
// (11008 x 4096, t = 1) a ladder, A or B launch reads 22.5 MB of nibbles
// and 5.6 MB of f32 scales, 8.4 us at 3.35 TB/s; an int8 launch reads
// 22.5 MB and 44 KB, 6.7 us. The arithmetic is far below the card's peaks,
// so each probe asks how many instructions per weight byte the card can
// run before it falls behind its memory.
//
// The layout is K1's GEMV path, so a stage's cost carries over to it: one
// warp per output row, eight warps per block, and each lane loads whole
// 16-byte pieces of its row (a Q40 block for the ladder and A/B: 32
// values), four of them in flight at once. Activations are staged in shared
// memory as f32, 36 floats per 32-value block so the lanes' 16-byte reads
// hit distinct banks. A lane keeps its sum in registers and the warp
// reduces with shuffles.
//
// The TPU stages before `dot` wrote one element broadcast over the tile and
// relied on a DMA that cannot be elided. On a GPU the compiler removes loads
// whose values reach no output, so every stage here consumes every byte of
// the weight, packed bytes and scales, and ends in the cheapest reduction
// that keeps them live:
//   read     XOR of the row's 32-bit words and its scales' bits
//   unpack   the row's nibbles summed as integers, XOR the scales' bits
//   convert  the nibbles summed in f32, plus the scales
//   mul      sum of nib * s
//   dot      sum of x * nib * s, no -8 (the TPU stage's function)
//
// A and B dequantize pairs of weights with bf16x2 arithmetic: two nibbles
// masked into the mantissas of the bf16 pair 128.0 (0x4300, whose ulp is 1)
// are 128 + nib exactly. A subtracts 136 and multiplies by bf16(s): two
// instructions per pair, bf16(bf16(nib - 8) * bf16(s)). B takes one fused
// multiply-add, (128 + nib) * bf16(s) - 128 * bf16(s) = bf16(nib * bf16(s))
// exactly (the -128 * bf16(s) is exact), and adds -8 * sum_b s[d, b] *
// xsum[b] with the f32 scales, where xsum[b] is the sum of the activations
// of block b, computed once per block of threads. Products with x are f32
// FMAs in both, so only the dequantized weights round to bf16.
//
// The int8 probe keeps its tool's column-split packing: byte j of a row
// holds column j (low nibble) and column K/2 + j (high nibble), so a 16-byte
// piece widens to two int8 words of 16 columns each with a mask, an add and
// an XOR per 4 weights ((nib + 0x78) ^ 0x80 is nib - 8 as int8) and feeds
// __dp4a against the int8 activations. The integer sum is exact, so the
// result equals the plain version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;     // one output row per warp
constexpr int kU = 4;         // 16-byte weight loads in flight per lane
constexpr int kCB = 32 * kU;  // 16-byte pieces of a row per chunk
constexpr int kPad = 36;      // floats per staged 32-value block

enum Stage { kRead = 0, kUnpack = 1, kConvert = 2, kMul = 3, kDot = 4 };

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
  return a;
}
__device__ __forceinline__ int warp_sum(int a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
  return a;
}
__device__ __forceinline__ uint32_t warp_xor(uint32_t a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a ^= __shfl_xor_sync(0xffffffffu, a, off);
  return a;
}

// ---------------------------------------------------------------------------
// The ladder. x: (n) f32, read by the dot stage only; packed: (d, n/2) u8
// block-major; scales: (d, n/32) f32; out: (d) int32 (read, unpack) or f32.
template <int STAGE>
__global__ void __launch_bounds__(kWarps * 32)
q40_ladder_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                  const float* __restrict__ scales, void* __restrict__ out, int n, int d) {
  __shared__ __align__(16) float xs[STAGE == kDot ? kCB * kPad : 4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  const int nb = n / 32;
  const bool live = row < d;
  const uint4* prow = reinterpret_cast<const uint4*>(packed) + (size_t)(live ? row : 0) * nb;
  const float* srow = scales + (size_t)(live ? row : 0) * nb;

  uint32_t bits = 0;  // read: every word and scale; unpack: the scales
  int isum = 0;       // unpack
  float acc = 0.f;    // convert, mul, dot

  for (int c0 = 0; c0 < nb; c0 += kCB) {
    // a missing block reads as zero bytes and a zero scale: it adds nothing
    // to any stage's reduction
    uint4 pk[kU];
    float sc[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int blk = c0 + u * 32 + lane;
      const bool in = live && blk < nb;
      pk[u] = in ? __ldg(prow + blk) : make_uint4(0u, 0u, 0u, 0u);
      sc[u] = in ? __ldg(srow + blk) : 0.f;
    }
    if constexpr (STAGE == kDot) {
      __syncthreads();  // the previous chunk is consumed
      for (int i = threadIdx.x; i < kCB * 8; i += kWarps * 32) {
        const int col = c0 * 32 + i * 4;
        const float4 v = col < n ? __ldg(reinterpret_cast<const float4*>(x + col))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(&xs[(i >> 3) * kPad + (i & 7) * 4]) = v;
      }
      __syncthreads();
    }
    if (!live) continue;

#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const uint32_t words[4] = {pk[u].x, pk[u].y, pk[u].z, pk[u].w};
      if constexpr (STAGE == kRead) {
        bits ^= words[0] ^ words[1] ^ words[2] ^ words[3] ^ __float_as_uint(sc[u]);
      } else if constexpr (STAGE == kUnpack) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const uint32_t byte = (words[q] >> (8 * bb)) & 0xFFu;
            isum += (int)(byte & 0xFu) + (int)(byte >> 4);
          }
        bits ^= __float_as_uint(sc[u]);
      } else if constexpr (STAGE == kConvert) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const uint32_t byte = (words[q] >> (8 * bb)) & 0xFFu;
            acc += (float)(byte & 0xFu);
            acc += (float)(byte >> 4);
          }
        acc += sc[u];
      } else if constexpr (STAGE == kMul) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const uint32_t byte = (words[q] >> (8 * bb)) & 0xFFu;
            acc = fmaf((float)(byte & 0xFu), sc[u], acc);
            acc = fmaf((float)(byte >> 4), sc[u], acc);
          }
      } else {  // kDot: K1's dequantize-then-FMA, without its -8
        float w[32];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const uint32_t byte = (words[q] >> (8 * bb)) & 0xFFu;
            w[q * 4 + bb] = (float)(byte & 0xFu) * sc[u];
            w[16 + q * 4 + bb] = (float)(byte >> 4) * sc[u];
          }
        const float4* xv = reinterpret_cast<const float4*>(&xs[(u * 32 + lane) * kPad]);
        float a = 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 f = xv[q];
          a = fmaf(f.x, w[4 * q + 0], a);
          a = fmaf(f.y, w[4 * q + 1], a);
          a = fmaf(f.z, w[4 * q + 2], a);
          a = fmaf(f.w, w[4 * q + 3], a);
        }
        acc += a;
      }
    }
  }

  if (!live) return;
  if constexpr (STAGE == kRead) {
    bits = warp_xor(bits);
    if (lane == 0) static_cast<uint32_t*>(out)[row] = bits;
  } else if constexpr (STAGE == kUnpack) {
    isum = warp_sum(isum);
    bits = warp_xor(bits);
    if (lane == 0) static_cast<uint32_t*>(out)[row] = (uint32_t)isum ^ bits;
  } else {
    acc = warp_sum(acc);
    if (lane == 0) static_cast<float*>(out)[row] = acc;
  }
}

// ---------------------------------------------------------------------------
// A and B. x: (t, n) bf16; packed: (d, n/2) u8 block-major; scales: (d, n/32)
// f32; out: (t, d) f32. blockIdx.y is the token.
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

template <bool kFoldB>
__global__ void __launch_bounds__(kWarps * 32)
q40_bf16_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                const float* __restrict__ scales, float* __restrict__ out, int n, int d) {
  __shared__ __align__(16) float xs[kCB * kPad];
  __shared__ float xsum[kFoldB ? kCB : 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  const int nb = n / 32;
  const bool live = row < d;
  x += (size_t)blockIdx.y * n;
  out += (size_t)blockIdx.y * d;
  const uint4* prow = reinterpret_cast<const uint4*>(packed) + (size_t)(live ? row : 0) * nb;
  const float* srow = scales + (size_t)(live ? row : 0) * nb;
  const __nv_bfloat162 c136 = __float2bfloat162_rn(136.f);

  float acc = 0.f, corr = 0.f;
  for (int c0 = 0; c0 < nb; c0 += kCB) {
    uint4 pk[kU];
    float sc[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int blk = c0 + u * 32 + lane;
      const bool in = live && blk < nb;
      // a missing block: nibbles 8 (A's -8 makes them 0) and scale 0
      pk[u] = in ? __ldg(prow + blk) : make_uint4(0x88888888u, 0x88888888u, 0x88888888u, 0x88888888u);
      sc[u] = in ? __ldg(srow + blk) : 0.f;
    }
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < kCB * 4; i += kWarps * 32) {
      const int col = c0 * 32 + i * 8;
      const uint4 raw = col < n ? __ldg(reinterpret_cast<const uint4*>(x + col)) : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t h[4] = {raw.x, raw.y, raw.z, raw.w};
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(as_bf162(h[j]));
        v[2 * j] = f.x;
        v[2 * j + 1] = f.y;
      }
      float4* dst = reinterpret_cast<float4*>(&xs[(i >> 2) * kPad + (i & 3) * 8]);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();
    if constexpr (kFoldB) {
      if (threadIdx.x < kCB) {  // one block's activation sum per thread
        const float* b = &xs[threadIdx.x * kPad];
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) s += b[j] + b[16 + j];
        xsum[threadIdx.x] = s;
      }
      __syncthreads();
    }
    if (!live) continue;

#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const __nv_bfloat16 sb = __float2bfloat16_rn(sc[u]);
      const __nv_bfloat162 s2 = __bfloat162bfloat162(sb);
      const __nv_bfloat162 off2 = __bfloat162bfloat162(__float2bfloat16_rn(-128.f * __bfloat162float(sb)));
      auto deq = [&](uint32_t pair) {  // bf16x2 of 128 + nibble -> dequantized f32 pair
        __nv_bfloat162 r;
        if constexpr (kFoldB) {
          r = __hfma2(as_bf162(pair), s2, off2);
        } else {
          r = __hmul2(__hsub2(as_bf162(pair), c136), s2);
        }
        return __bfloat1622float2(r);
      };
      const uint32_t words[4] = {pk[u].x, pk[u].y, pk[u].z, pk[u].w};
      const float* xb = &xs[(u * 32 + lane) * kPad];
      float a = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t w = words[q];
        const float4 xl = *reinterpret_cast<const float4*>(xb + 4 * q);       // x[4q .. 4q+3]
        const float4 xh = *reinterpret_cast<const float4*>(xb + 16 + 4 * q);  // x[16+4q ..]
        float2 f = deq((w & 0x000F000Fu) | 0x43004300u);  // low nibbles of bytes 0, 2
        a = fmaf(xl.x, f.x, a);
        a = fmaf(xl.z, f.y, a);
        f = deq(((w >> 4) & 0x000F000Fu) | 0x43004300u);  // high nibbles of bytes 0, 2
        a = fmaf(xh.x, f.x, a);
        a = fmaf(xh.z, f.y, a);
        f = deq(((w >> 8) & 0x000F000Fu) | 0x43004300u);  // low nibbles of bytes 1, 3
        a = fmaf(xl.y, f.x, a);
        a = fmaf(xl.w, f.y, a);
        f = deq(((w >> 12) & 0x000F000Fu) | 0x43004300u);  // high nibbles of bytes 1, 3
        a = fmaf(xh.y, f.x, a);
        a = fmaf(xh.w, f.y, a);
      }
      acc += a;
      if constexpr (kFoldB) corr = fmaf(sc[u], xsum[u * 32 + lane], corr);
    }
  }

  if (!live) return;
  const float y = warp_sum(kFoldB ? fmaf(-8.f, corr, acc) : acc);
  if (lane == 0) out[row] = y;
}

// ---------------------------------------------------------------------------
// int8. xq: (k) int8; pk: (d, k/2) u8, column-split; sc: (d) f32; out: (d)
// f32. Dynamic shared memory: k bytes, all of xq.
__global__ void __launch_bounds__(kWarps * 32)
int8_gemv_kernel(const int8_t* __restrict__ xq, const uint8_t* __restrict__ pk,
                 const float* __restrict__ sc, float* __restrict__ out, int k, int d) {
  extern __shared__ __align__(16) int8_t x8[];
  for (int i = threadIdx.x; i < k / 16; i += kWarps * 32)
    reinterpret_cast<uint4*>(x8)[i] = __ldg(reinterpret_cast<const uint4*>(xq) + i);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= d) return;
  const int nv = k / 32;  // 16-byte pieces per row
  const uint4* prow = reinterpret_cast<const uint4*>(pk) + (size_t)row * nv;
  const uint4* xlo = reinterpret_cast<const uint4*>(x8);
  const uint4* xhi = reinterpret_cast<const uint4*>(x8 + k / 2);

  int acc = 0;
  for (int c0 = 0; c0 < nv; c0 += kCB) {
    uint4 w[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int c = c0 + u * 32 + lane;
      w[u] = c < nv ? __ldg(prow + c) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int c = c0 + u * 32 + lane;
      if (c >= nv) continue;
      const uint4 a = xlo[c], b = xhi[c];
      const uint32_t words[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
      const uint32_t xl[4] = {a.x, a.y, a.z, a.w};
      const uint32_t xh[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t lo = ((words[q] & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;
        const uint32_t hi = (((words[q] >> 4) & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;
        acc = __dp4a((int)lo, (int)xl[q], acc);
        acc = __dp4a((int)hi, (int)xh[q], acc);
      }
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) out[row] = (float)acc * __ldg(sc + row);
}

template <int STAGE>
cudaError_t launch_ladder(const void* x, const void* packed, const void* scales, void* out, int n, int d,
                          cudaStream_t stream) {
  const unsigned rows = (unsigned)((d + kWarps - 1) / kWarps);
  q40_ladder_kernel<STAGE><<<rows, kWarps * 32, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(packed), static_cast<const float*>(scales), out, n, d);
  return cudaGetLastError();
}

template <bool kFoldB>
cudaError_t launch_bf16(const void* x, const void* packed, const void* scales, void* out, int t, int n, int d,
                        cudaStream_t stream) {
  if (t < 1 || t > 65535 || n % 32) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((d + kWarps - 1) / kWarps), (unsigned)t);
  q40_bf16_kernel<kFoldB><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<float*>(out), n, d);
  return cudaGetLastError();
}

}  // namespace

// P7. stage 0..4 = read, unpack, convert, mul, dot. x: (n) f32; packed:
// (d, n/2) u8 block-major; scales: (d, n/32) f32; out: (d) int32 for read
// and unpack, f32 for the rest. Returns the launch's cudaError_t.
extern "C" int q40_ladder_launch(int stage, const void* x, const void* packed, const void* scales, void* out,
                                 int n, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n % 32) return (int)cudaErrorInvalidValue;
  switch (stage) {
    case kRead: return launch_ladder<kRead>(x, packed, scales, out, n, d, s);
    case kUnpack: return launch_ladder<kUnpack>(x, packed, scales, out, n, d, s);
    case kConvert: return launch_ladder<kConvert>(x, packed, scales, out, n, d, s);
    case kMul: return launch_ladder<kMul>(x, packed, scales, out, n, d, s);
    case kDot: return launch_ladder<kDot>(x, packed, scales, out, n, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// P4 A. x: (t, n) bf16; packed: (d, n/2) u8 block-major; scales: (d, n/32)
// f32; out: (t, d) f32. Returns the launch's cudaError_t.
extern "C" int q40_matmul_a_launch(const void* x, const void* packed, const void* scales, void* out,
                                   int t, int n, int d, void* stream) {
  return (int)launch_bf16<false>(x, packed, scales, out, t, n, d, static_cast<cudaStream_t>(stream));
}

// P4 B. The same arguments as A.
extern "C" int q40_matmul_b_launch(const void* x, const void* packed, const void* scales, void* out,
                                   int t, int n, int d, void* stream) {
  return (int)launch_bf16<true>(x, packed, scales, out, t, n, d, static_cast<cudaStream_t>(stream));
}

// P1. xq: (k) int8; pk: (d, k/2) u8, byte j = column j (low nibble) and
// column k/2 + j (high nibble); sc: (d) f32; out: (d) f32. k % 32 == 0 and
// k <= 49152 (xq is staged whole in shared memory). Returns the launch's
// cudaError_t.
extern "C" int int8_gemv_launch(const void* xq, const void* pk, const void* sc, void* out, int k, int d,
                                void* stream) {
  if (k % 32 || k > 49152) return (int)cudaErrorInvalidValue;
  const unsigned rows = (unsigned)((d + kWarps - 1) / kWarps);
  int8_gemv_kernel<<<rows, kWarps * 32, (size_t)k, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const uint8_t*>(pk), static_cast<const float*>(sc),
      static_cast<float*>(out), k, d);
  return (int)cudaGetLastError();
}
