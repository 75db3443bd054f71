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
// Two paths, chosen per launch like the TPU kernel's operand rule:
//
// GEMV path (t < tc_min_t, or any f32 operand), for the decode bound:
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
//  * Tokens go in groups of TT (1, 4 or 8): a lane unpacks its block once
//    into 32 registers and uses it for every token of the group, so one
//    weight read serves TT tokens. Token groups run along gridDim.x, the
//    fastest-varying block index, so the groups that re-read one row block
//    run close together and find it in the 50 MB L2.
//  * At t = 1 each lane holds U = 4 blocks' loads in flight per chunk.
//
// Tensor-core path (bf16 in and out, t >= tc_min_t), for prefill chunks:
// see q40_matmul_tc_kernel below — dequantize in shared memory, mma.sync.
// The caller passes tc_min_t, the token count from which this path beats
// the GEMV path on the card (ops/cuda_q40.py TC_MIN_T, measured by
// chip_smoke.py).
//
// The TPU kernel's x_lo/x_hi pre-split, lane-tile scale repeat, -8 fold and
// sub-tiling exist for Mosaic's tiling and VPU; none of them carries over.
// Not yet here: wgmma, TMA and a pipelined producer warp.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename TI, typename TO, int TT, int U>
__global__ void __launch_bounds__(kWarps * 32)
q40_matmul_kernel(const TI* __restrict__ x, const uint8_t* __restrict__ packed,
                  const __half* __restrict__ scales, TO* __restrict__ out,
                  int t, int n, int d) {
  constexpr int CB = 32 * U;  // blocks per chunk: U per lane
  __shared__ __align__(16) float xs[TT][CB * kPad];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.y * kWarps + warp;
  const int t0 = blockIdx.x * TT;
  const int nb = n / 32;
  const bool live = row < d;
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
// Tensor-core path for multi-token chunks: bf16 x, bf16 out and t at least
// the caller's tc_min_t. A block computes a 128-row x 64-token tile of the
// output; per Q40 block (k = 32) its 128 threads each dequantize one weight
// row into shared memory as bf16 ((nibble - 8) * scale, rounded once, as the
// TPU kernel rounds its dequantized tiles), stage the 64 tokens' 32 x values,
// and 4 warps issue mma.sync m16n8k16 (bf16 in, f32 accumulate), each warp
// owning 32 rows x 64 tokens. Rows are padded to 40 bf16 so the fragment
// loads and the 16-byte stores hit distinct banks. Loads for the next Q40
// block are issued before the barrier that ends the current one.

constexpr int kTcRows = 128;
constexpr int kTcTokens = 64;
constexpr int kTcLd = 40;  // bf16 per padded shared-memory row

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(128)
q40_matmul_tc_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                     const __half* __restrict__ scales, __nv_bfloat16* __restrict__ out,
                     int t, int n, int d) {
  __shared__ __align__(16) __nv_bfloat16 ws[kTcRows][kTcLd];
  __shared__ __align__(16) __nv_bfloat16 xs[kTcTokens][kTcLd];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;  // mma fragment coordinates
  const int row0 = blockIdx.y * kTcRows, tok0 = blockIdx.x * kTcTokens;
  const int nb = n / 32;
  const int my_row = row0 + threadIdx.x;  // the weight row this thread dequantizes

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  uint4 pk;
  float sc;
  uint4 xv[2];  // 64 tokens x 64 bytes = 256 16-byte pieces, 2 per thread
  auto fetch = [&](int b) {
    pk = make_uint4(0x88888888u, 0x88888888u, 0x88888888u, 0x88888888u);
    sc = 0.f;
    if (my_row < d) {
      pk = __ldg(reinterpret_cast<const uint4*>(packed) + (size_t)my_row * nb + b);
      sc = __half2float(scales[(size_t)my_row * nb + b]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = threadIdx.x + j * 128, tok = tok0 + (c >> 2);
      xv[j] = tok < t ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)tok * n + b * 32) + (c & 3))
                      : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  fetch(0);
  for (int b = 0; b < nb; ++b) {
    __syncthreads();  // the previous block's fragments are read
    {
      const uint32_t words[4] = {pk.x, pk.y, pk.z, pk.w};
      uint32_t lo[8], hi[8];  // bf16 pairs: elements (2i, 2i+1) and (16+2i, 17+2i)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t w = words[i >> 1] >> (16 * (i & 1));
        const int b0 = w & 0xFF, b1 = (w >> 8) & 0xFF;
        lo[i] = pack_bf16((float)((b0 & 0xF) - 8) * sc, (float)((b1 & 0xF) - 8) * sc);
        hi[i] = pack_bf16((float)((b0 >> 4) - 8) * sc, (float)((b1 >> 4) - 8) * sc);
      }
      uint4* dst = reinterpret_cast<uint4*>(&ws[threadIdx.x][0]);
      dst[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      dst[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      dst[2] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dst[3] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = threadIdx.x + j * 128;
        *reinterpret_cast<uint4*>(&xs[c >> 2][(c & 3) * 8]) = xv[j];
      }
    }
    __syncthreads();
    if (b + 1 < nb) fetch(b + 1);

#pragma unroll
    for (int kk = 0; kk < 32; kk += 16) {
      uint32_t a[2][4], bf[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = warp * 32 + mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&ws[r][kk + q * 2]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&ws[r + 8][kk + q * 2]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&ws[r][kk + q * 2 + 8]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&ws[r + 8][kk + q * 2 + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(&xs[ni * 8 + g][kk + q * 2]);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(&xs[ni * 8 + g][kk + q * 2 + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], a[mi], bf[ni]);
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int r = row0 + warp * 32 + mi * 16 + g;
      const int tk = tok0 + ni * 8 + q * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = r + (e >> 1) * 8, tt = tk + (e & 1);
        if (rr < d && tt < t) out[(size_t)tt * d + rr] = __float2bfloat16(acc[mi][ni][e]);
      }
    }
  }
}

template <typename TI, typename TO>
cudaError_t launch(const void* x, const void* packed, const void* scales, void* out,
                   int t, int n, int d, int tc_min_t, cudaStream_t stream) {
  const dim3 block(kWarps * 32);
  const unsigned rows = (unsigned)((d + kWarps - 1) / kWarps);
  const TI* xp = static_cast<const TI*>(x);
  const uint8_t* pp = static_cast<const uint8_t*>(packed);
  const __half* sp = static_cast<const __half*>(scales);
  TO* op = static_cast<TO*>(out);
  if constexpr (std::is_same<TI, __nv_bfloat16>::value && std::is_same<TO, __nv_bfloat16>::value) {
    if (t >= tc_min_t) {
      const dim3 grid((unsigned)((t + kTcTokens - 1) / kTcTokens), (unsigned)((d + kTcRows - 1) / kTcRows));
      q40_matmul_tc_kernel<<<grid, 128, 0, stream>>>(xp, pp, sp, op, t, n, d);
      return cudaGetLastError();
    }
  }
  if (t == 1) {
    q40_matmul_kernel<TI, TO, 1, 4><<<dim3(1, rows), block, 0, stream>>>(xp, pp, sp, op, t, n, d);
  } else if (t <= 4) {
    q40_matmul_kernel<TI, TO, 4, 2><<<dim3(1, rows), block, 0, stream>>>(xp, pp, sp, op, t, n, d);
  } else {
    const unsigned groups = (unsigned)((t + 7) / 8);
    q40_matmul_kernel<TI, TO, 8, 1><<<dim3(groups, rows), block, 0, stream>>>(xp, pp, sp, op, t, n, d);
  }
  return cudaGetLastError();
}

}  // namespace

// x: (t, n) f32 (x_dtype 0) or bf16 (1); packed: (d, n/2) u8 block-major;
// scales: (d, n/32) f16; out: (t, d) f32 (out_dtype 0) or bf16 (1).
// bf16 in and out with t >= tc_min_t takes the tensor-core path.
// Returns the launch's cudaError_t.
extern "C" int q40_matmul_launch(const void* x, int x_dtype, const void* packed,
                                 const void* scales, void* out, int out_dtype,
                                 int t, int n, int d, int tc_min_t, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && out_dtype == 0) return launch<float, float>(x, packed, scales, out, t, n, d, tc_min_t, s);
  if (x_dtype == 0 && out_dtype == 1) return launch<float, __nv_bfloat16>(x, packed, scales, out, t, n, d, tc_min_t, s);
  if (x_dtype == 1 && out_dtype == 0) return launch<__nv_bfloat16, float>(x, packed, scales, out, t, n, d, tc_min_t, s);
  if (x_dtype == 1 && out_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(x, packed, scales, out, t, n, d, tc_min_t, s);
  return (int)cudaErrorInvalidValue;
}
