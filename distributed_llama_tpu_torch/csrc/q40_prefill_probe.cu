// Q40 prefill-chunk matmul with the dequantize and the tensor-core product
// overlapped or not, for Hopper (sm_90a): the unpack/MMA overlap probe.
//
// Replaces: tools/exp_unpack_overlap.py matmul_sub (the pallas_call at
// exp_unpack_overlap.py:86), the probe behind the JAX package's sub-tiled
// prefill path (ops/pallas_q40.py _n_sub). Its question on this card:
// does dequantizing one piece of the weight tile while the tensor cores
// consume the previous piece pay off against dequantize-then-multiply.
//
// Function (the TPU tool's): y[t, d] = sum_n bf16(x[t, n]) * bf16(nib[d, n]
// * s[d, n/32]) - 8 * sum_b xsum[t, b] * s[d, b], f32 sums, out bf16; nib is
// the unsigned nibble, xsum[t, b] the f32 sum of block b of x. x (T, N)
// bf16, packed (D, N/2) u8 block-major, scales (D, N/32) f16.
//
// What bounds it on the H100: the operations. At 11008 x 4096, T = 256 it
// is 23.08 GFLOP, 23.3 us at 989 TFLOP/s in bf16; the bytes (33 MB) need
// 9.9 us.
//
// Design. A block of 4 warps owns td = 64 * MI weight rows and 64 tokens;
// each warp keeps its 16 * MI rows x 64 tokens of f32 sums in registers and
// issues mma.sync m16n8k16 (bf16 in, f32 accumulate), as K1's tensor-core
// path does (csrc/q40_matmul.cu). The block walks N in chunks of 128 values
// (4 Q40 blocks); a chunk is cut along N into n_sub sub-tiles of 128 /
// n_sub values (n_sub = 8: half of each Q40 block, its low or high
// nibbles). On the TPU a sub-tile was a slice of rows; here the rows' sums
// live in the warps' registers, and a row slice would idle the warps that
// do not own it, so the cut runs along N. For each sub-tile the block
// dequantizes its rows' weights into shared memory as bf16 (one thread per
// row and Q40 block: one 16-byte load and its f16 scale, bf16(nib * s)
// rounded once) and copies the tokens' x into shared memory with cp.async.
//  * n_sub = 1: dequantize the whole chunk, one barrier, then the MMAs; a
//    second barrier before the next chunk's dequantize. The next chunk's
//    loads are in flight during the MMAs, as on the TPU, where the grid
//    pipeline overlaps the DMA; the dequantize does not overlap.
//  * n_sub > 1: two buffers of sub-tiles. In the same barrier interval the
//    block dequantizes sub-tile i+1 into one buffer and runs the MMAs of
//    sub-tile i from the other; the loads run one sub-tile further ahead.
//    One barrier per sub-tile.
// Shared-memory rows are padded by 8 bf16, so fragment loads of 8 rows hit
// distinct banks. The -8 correction, a (td x N/32) by (N/32 x 64) product,
// runs after the main loop as tf32 mma.sync m16n8k8 into the same sums:
// -8 s is exact in tf32 (an f16 scale has 11 significant bits) and xsum
// rounds to tf32 (2^-11 relative). xsum comes from a first, small kernel
// of the same call.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kTN = 64;        // tokens per block
constexpr int kKC = 128;       // N values per chunk: 4 Q40 blocks

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(f));
  return r;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes to shared memory without passing through registers; an invalid
// source fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// bf16 pairs of a Q40 block's 16 bytes: low nibbles (values 2i, 2i+1) or
// high nibbles (16 + 2i, 17 + 2i), each bf16(nib * s)
template <bool HI>
__device__ __forceinline__ void nibble_pairs(const uint4& pk, float s, uint32_t (&out)[8]) {
  const uint32_t words[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t w = words[i >> 1] >> (16 * (i & 1));
    const uint32_t b0 = w & 0xFFu, b1 = (w >> 8) & 0xFFu;
    out[i] = HI ? pack_bf16((float)(b0 >> 4) * s, (float)(b1 >> 4) * s)
                : pack_bf16((float)(b0 & 0xFu) * s, (float)(b1 & 0xFu) * s);
  }
}

// xsum[t, b] = sum of x[t, 32b .. 32b + 31] in f32, one thread each
__global__ void __launch_bounds__(256)
xsum_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ xsum, int t, int n) {
  const int nb = n / 32;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= t * nb) return;
  const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)(i / nb) * n + (i % nb) * 32);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4 raw = __ldg(src + j);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      s += f.x;
      s += f.y;
    }
  }
  xsum[i] = s;
}

template <int MI, int NSUB>
__global__ void __launch_bounds__(kThreads)
q40_sub_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
               const __half* __restrict__ scales, const float* __restrict__ xsum, __nv_bfloat16* __restrict__ out,
               int t, int n, int d) {
  constexpr int TD = 64 * MI;
  constexpr int KS = kKC / NSUB;      // N values per sub-tile
  constexpr int LD = KS + 8;          // bf16 per padded shared-memory row
  constexpr bool PIPE = NSUB > 1;
  constexpr int WBUF = PIPE ? 2 : 1;
  constexpr bool HALF = KS < 32;      // a sub-tile is half of each Q40 block
  constexpr int BPS = HALF ? 1 : KS / 32;  // Q40 blocks per row per sub-tile
  constexpr int UNITS = TD * BPS;     // (row, Q40 block) pieces per sub-tile
  constexpr int UPT = (UNITS + kThreads - 1) / kThreads;
  constexpr int XROW = KS / 8;        // 16-byte pieces of one token's x
  constexpr int XPT = kTN * XROW / kThreads;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [WBUF][TD][LD]
  __nv_bfloat16* xs = ws + WBUF * TD * LD;                       // [2][kTN][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;  // mma fragment coordinates
  const int tok0 = blockIdx.x * kTN, row0 = blockIdx.y * TD;
  const int nb = n / 32;
  const int n_tiles = (n / kKC) * NSUB;
  const uint4* pk4 = reinterpret_cast<const uint4*>(packed);

  float acc[MI][8][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  uint4 pk[UPT];
  float sc[UPT];
  auto fetch_w = [&](int gi) {
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int u = threadIdx.x + i * kThreads;
      if (u < UNITS) {
        const int kb = HALF ? gi / 2 : gi * BPS + u / TD;
        const size_t off = (size_t)(row0 + u % TD) * nb + kb;
        pk[i] = __ldg(pk4 + off);
        sc[i] = __half2float(scales[off]);
      }
    }
  };
  auto dequant = [&](int gi, __nv_bfloat16* wb) {
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int u = threadIdx.x + i * kThreads;
      if (u < UNITS) {
        uint4* dst = reinterpret_cast<uint4*>(wb + (u % TD) * LD + (u / TD) * 32);
        uint32_t v[8];
        if (!HALF || (gi & 1) == 0) {
          nibble_pairs<false>(pk[i], sc[i], v);
          dst[0] = make_uint4(v[0], v[1], v[2], v[3]);
          dst[1] = make_uint4(v[4], v[5], v[6], v[7]);
        }
        if (!HALF || (gi & 1) == 1) {
          nibble_pairs<true>(pk[i], sc[i], v);
          uint4* h = HALF ? dst : dst + 2;
          h[0] = make_uint4(v[0], v[1], v[2], v[3]);
          h[1] = make_uint4(v[4], v[5], v[6], v[7]);
        }
      }
    }
  };
  auto stage_x = [&](int gi, __nv_bfloat16* xb) {
    const int k0 = gi * KS;
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int tk = c / XROW, col = (c % XROW) * 8;
      const bool valid = tok0 + tk < t;
      cp_async16(xb + tk * LD + col, valid ? x + (size_t)(tok0 + tk) * n + k0 + col : x, valid);
    }
    cp_async_commit();
  };
  auto mma_tile = [&](const __nv_bfloat16* wb, const __nv_bfloat16* xb) {
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t a[MI][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const __nv_bfloat16* r = wb + (warp * 16 * MI + mi * 16 + g) * LD + kk + q * 2;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(r);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(r + 8 * LD);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(r + 8);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(r + 8 * LD + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const __nv_bfloat16* c = xb + (ni * 8 + g) * LD + kk + q * 2;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(c);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(c + 8);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
  };

  if constexpr (!PIPE) {
    fetch_w(0);
    stage_x(0, xs);
    for (int gi = 0; gi < n_tiles; ++gi) {
      __syncthreads();  // the previous chunk's MMAs are done with ws
      dequant(gi, ws);
      if (gi + 1 < n_tiles) {
        fetch_w(gi + 1);  // in flight during the MMAs below
        stage_x(gi + 1, xs + ((gi + 1) & 1) * kTN * LD);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      mma_tile(ws, xs + (gi & 1) * kTN * LD);
    }
  } else {
    fetch_w(0);
    stage_x(0, xs);
    dequant(0, ws);
    if (n_tiles > 1) fetch_w(1);
    cp_async_wait<0>();
    __syncthreads();
    for (int gi = 0; gi < n_tiles; ++gi) {
      if (gi + 1 < n_tiles) {  // sub-tile i+1 into the other buffers, issued before i's MMAs
        stage_x(gi + 1, xs + ((gi + 1) & 1) * kTN * LD);
        dequant(gi + 1, ws + ((gi + 1) & 1) * TD * LD);
        if (gi + 2 < n_tiles) fetch_w(gi + 2);
      }
      mma_tile(ws + (gi & 1) * TD * LD, xs + (gi & 1) * kTN * LD);
      cp_async_wait<0>();
      __syncthreads();
    }
  }

  // -8 * sum_b s[d, b] xsum[t, b], as tf32 products into the same sums
  for (int kb = 0; kb < nb; kb += 8) {
    uint32_t a[MI][4], b[8][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const __half* s = scales + (size_t)(row0 + warp * 16 * MI + mi * 16 + g) * nb + kb + q;
      a[mi][0] = to_tf32(-8.f * __half2float(s[0]));
      a[mi][1] = to_tf32(-8.f * __half2float(s[8 * nb]));
      a[mi][2] = to_tf32(-8.f * __half2float(s[4]));
      a[mi][3] = to_tf32(-8.f * __half2float(s[8 * nb + 4]));
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int tk = tok0 + ni * 8 + g;
      const float* xr = xsum + (size_t)tk * nb + kb + q;
      b[ni][0] = tk < t ? to_tf32(xr[0]) : 0u;
      b[ni][1] = tk < t ? to_tf32(xr[4]) : 0u;
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) mma_tf32(acc[mi][ni], a[mi], b[ni]);
  }

#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int r = row0 + warp * 16 * MI + mi * 16 + g;
      const int tk = tok0 + ni * 8 + q * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = r + (e >> 1) * 8, tt = tk + (e & 1);
        if (tt < t) out[(size_t)tt * d + rr] = __float2bfloat16(acc[mi][ni][e]);
      }
    }
  }
}

template <int MI, int NSUB>
cudaError_t launch_sub(const void* x, const void* packed, const void* scales, const float* xsum, void* out, int t,
                       int n, int d, cudaStream_t stream) {
  constexpr int TD = 64 * MI, LD = kKC / NSUB + 8, WBUF = NSUB > 1 ? 2 : 1;
  constexpr size_t kSmem = (size_t)(WBUF * TD + 2 * kTN) * LD * sizeof(__nv_bfloat16);
  static bool configured = false;  // above 48 KB a kernel must opt in
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(q40_sub_kernel<MI, NSUB>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((unsigned)((t + kTN - 1) / kTN), (unsigned)(d / TD));
  q40_sub_kernel<MI, NSUB><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed), static_cast<const __half*>(scales),
      xsum, static_cast<__nv_bfloat16*>(out), t, n, d);
  return cudaGetLastError();
}

template <int MI>
cudaError_t launch_td(int n_sub, const void* x, const void* packed, const void* scales, const float* xsum, void* out,
                      int t, int n, int d, cudaStream_t stream) {
  switch (n_sub) {
    case 1: return launch_sub<MI, 1>(x, packed, scales, xsum, out, t, n, d, stream);
    case 2: return launch_sub<MI, 2>(x, packed, scales, xsum, out, t, n, d, stream);
    case 4: return launch_sub<MI, 4>(x, packed, scales, xsum, out, t, n, d, stream);
    case 8: return launch_sub<MI, 8>(x, packed, scales, xsum, out, t, n, d, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// P6. x: (t, n) bf16; packed: (d, n/2) u8 block-major; scales: (d, n/32)
// f16; xsum: (t, n/32) f32 scratch; out: (t, d) bf16. td in {64, 128} with
// d % td == 0, n_sub in {1, 2, 4, 8}, n % 256 == 0. Two launches: the
// block sums of x, then the product. Returns the first failing launch's
// cudaError_t, else 0.
extern "C" int q40_matmul_sub_launch(const void* x, const void* packed, const void* scales, void* xsum, void* out,
                                     int t, int n, int d, int n_sub, int td, void* stream) {
  if (t < 1 || n % 256 || (td != 64 && td != 128) || d % td) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xs = static_cast<float*>(xsum);
  const int pieces = t * (n / 32);
  xsum_kernel<<<(unsigned)((pieces + 255) / 256), 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x), xs, t, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = td == 64 ? launch_td<1>(n_sub, x, packed, scales, xs, out, t, n, d, s)
                 : launch_td<2>(n_sub, x, packed, scales, xs, out, t, n, d, s);
  return (int)err;
}
