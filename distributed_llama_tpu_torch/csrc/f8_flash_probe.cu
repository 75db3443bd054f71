// fp8-cache flash decode probe for Hopper (sm_90a): one decode step (t = 1,
// one query row per kv head) of causal attention against a KV cache stored
// in bf16 or in e4m3, with four ways of turning the cache into bf16.
//
// Replaces: tools/exp_f8_flash.py build (the pallas_call at
// exp_f8_flash.py:117), the probe behind the JAX package's e4m3 decode
// (ops/pallas_attention.py _f8_bits_to). Its question on this card: which
// e4m3 -> bf16 conversion should K3 (csrc/flash_attention.cu) use.
//
// Modes, one kernel templated on each (the skeleton is the same, only the
// conversion of a loaded 16-byte piece differs):
//   plain      the cache is bf16 and is copied as it is (the baseline);
//   astype     e4m3 converted by the hardware, two at a time
//              (cvt e4m3x2 -> f16x2, then f32 -> bf16x2), as K3 does today;
//   bits       e4m3 bits rebuilt as bf16 with integer ops in 16-bit halves of
//              32-bit words: sign << 8 | ((mag << 4) + 0x3C00) for normals,
//              and for a magnitude below 8 (subnormal) mag * 2^-9, converted
//              exactly, under a branch taken only by pieces that hold one;
//   bitsflush  bits with the subnormals set to signed zero (no branch).
// bits equals astype bit for bit on every code but the NaN magnitude 0x7F,
// which cache writes never produce (they saturate at +-448).
//
// Semantics (the TPU tool's): q (R, 1, 128) bf16 with R = b * kvh, k and v
// (R, S, 128), pos (b,) int32; row i sees slot s iff s <= pos[i / kvh].
// Scores q.k in f32 times 1/sqrt(128), online softmax in f32, p rounded to
// bf16 before P.V (the TPU casts p to the value dtype), sums in f32, output
// bf16.
//
// What bounds it on the H100: the cache bytes. At the tool's shape (32 rows,
// fill 7680, so 7681 visible slots) bf16 K+V is 125.9 MB, 37.6 us at 3.35
// TB/s; e4m3 62.9 MB, 18.8 us. The operations are negligible.
//
// Design. The TPU grid walks S in order on one core; here 32 rows would
// leave 100 of 132 SMs idle, and the probe would measure the SM count, not
// the conversion. So S is split (flash-decoding): block (c, i) takes slots
// [256c, 256c + 256) of row i, up to pos, and writes its partial (m, l,
// acc); a second launch merges a row's partials. Blocks whose slots all lie
// past pos return at once, so bytes read grow with the fill.
//  * A block of 128 threads walks its slots in tiles of 64. Each thread
//    keeps the next tile's 16-byte loads in registers while the block works
//    on the current one; staging converts them to bf16 in shared memory
//    (K rows padded to 144 bf16 so the score reads hit distinct banks).
//  * Scores: two threads per slot, each a 64-dimension half (alternating
//    16-byte pieces) against q in shared memory as f32, one shuffle.
//  * Softmax: every thread takes the tile's max from shared memory; the
//    first 64 threads take one exp each; then thread d owns output
//    dimension d and accumulates sum_s bf16(p_s) * v[s][d] in f32.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kPlain = 0, kAstype = 1, kBits = 2, kBitsFlush = 3 };

constexpr int kHS = 128;        // head size: the probe's
constexpr int kThreads = 128;   // one output dimension per thread
constexpr int kTile = 64;       // slots per tile
constexpr int kSplit = 256;     // slots per block
constexpr int kLdK = kHS + 16;  // bf16 per staged K row (288 bytes)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// four e4m3 bytes -> two bf16x2 words (bytes 0, 1 and bytes 2, 3)
template <int MODE>
__device__ __forceinline__ void f8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  if constexpr (MODE == kAstype) {
    const __half2 h0(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w & 0xFFFFu), __NV_E4M3));
    const __half2 h1(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w >> 16), __NV_E4M3));
    lo = bf2_bits(__float22bfloat162_rn(__half22float2(h0)));
    hi = bf2_bits(__float22bfloat162_rn(__half22float2(h1)));
  } else {
    uint32_t r[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t x = __byte_perm(w, 0u, j ? 0x4342u : 0x4140u);  // bytes in 16-bit halves
      const uint32_t sign = (x & 0x00800080u) << 8;
      const uint32_t mag = x & 0x007F007Fu;
      const uint32_t sub = __vcmpltu2(mag, 0x00080008u);  // 0xFFFF where mag < 8
      uint32_t v = ((mag << 4) + 0x3C003C00u) | sign;
      if constexpr (MODE == kBitsFlush) {
        v = (v & ~sub) | sign;
      } else {
        if (sub) {  // mag * 2^-9, exact in f32 and in bf16
          const uint32_t f = bf2_bits(__floats2bfloat162_rn((float)(mag & 0xFFFFu) * 0.001953125f,
                                                           (float)(mag >> 16) * 0.001953125f));
          v = (v & ~sub) | (f & sub) | sign;
        }
      }
      r[j] = v;
    }
    lo = r[0];
    hi = r[1];
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
f8_flash_split_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k,
                      const uint8_t* __restrict__ v, const int* __restrict__ pos, float* __restrict__ part_m,
                      float* __restrict__ part_l, float* __restrict__ part_acc, int kvh, int s_len, int n_split,
                      float scale) {
  constexpr int CSIZE = MODE == kPlain ? 2 : 1;  // cache bytes per value
  constexpr int VEC = 16 / CSIZE;                // values per 16-byte load
  constexpr int ROW_CHUNKS = kHS / VEC;
  constexpr int PER = kTile * ROW_CHUNKS / kThreads;  // loads per thread per tile, each of K and V
  __shared__ __align__(16) float q_s[kHS];
  __shared__ __align__(16) __nv_bfloat16 k_s[kTile][kLdK];
  __shared__ __align__(16) __nv_bfloat16 v_s[kTile][kHS];
  __shared__ __align__(16) float sc_s[kTile];
  __shared__ __align__(16) float p_s[kTile];
  __shared__ __align__(16) float pb_s[kTile];

  const int tid = threadIdx.x;
  const int c = blockIdx.x, row = blockIdx.y;
  const int pr = min(pos[row / kvh], s_len - 1);
  const int s_begin = c * kSplit;
  if (s_begin > pr) return;
  const int s_end = min(s_begin + kSplit - 1, pr);  // inclusive

  q_s[tid] = __bfloat162float(q[(size_t)row * kHS + tid]);
  const size_t base = (size_t)row * s_len * kHS * CSIZE;  // bytes

  uint4 kr[PER], vr[PER];
  auto fetch = [&](int s0) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int ch = tid + j * kThreads;
      const int s = s0 + ch / ROW_CHUNKS;
      const size_t off = base + ((size_t)s * kHS + (ch % ROW_CHUNKS) * VEC) * CSIZE;
      if (s <= s_end) {
        kr[j] = __ldg(reinterpret_cast<const uint4*>(k + off));
        vr[j] = __ldg(reinterpret_cast<const uint4*>(v + off));
      } else {
        kr[j] = make_uint4(0u, 0u, 0u, 0u);
        vr[j] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  float m = kNegInf, l = 0.f, acc = 0.f;
  const int sp = tid >> 1, half = tid & 1;  // the slot this thread scores, and its half

  fetch(s_begin);
  for (int s0 = s_begin; s0 <= s_end; s0 += kTile) {
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int ch = tid + j * kThreads;
      const int ss = ch / ROW_CHUNKS, dd = (ch % ROW_CHUNKS) * VEC;
      if constexpr (MODE == kPlain) {
        *reinterpret_cast<uint4*>(&k_s[ss][dd]) = kr[j];
        *reinterpret_cast<uint4*>(&v_s[ss][dd]) = vr[j];
      } else {
        const uint32_t kw[4] = {kr[j].x, kr[j].y, kr[j].z, kr[j].w};
        const uint32_t vw[4] = {vr[j].x, vr[j].y, vr[j].z, vr[j].w};
        uint32_t ko[8], vo[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          f8x4_to_bf16<MODE>(kw[e], ko[2 * e], ko[2 * e + 1]);
          f8x4_to_bf16<MODE>(vw[e], vo[2 * e], vo[2 * e + 1]);
        }
        uint4* kd = reinterpret_cast<uint4*>(&k_s[ss][dd]);
        uint4* vd = reinterpret_cast<uint4*>(&v_s[ss][dd]);
        kd[0] = make_uint4(ko[0], ko[1], ko[2], ko[3]);
        kd[1] = make_uint4(ko[4], ko[5], ko[6], ko[7]);
        vd[0] = make_uint4(vo[0], vo[1], vo[2], vo[3]);
        vd[1] = make_uint4(vo[4], vo[5], vo[6], vo[7]);
      }
    }
    __syncthreads();
    if (s0 + kTile <= s_end) fetch(s0 + kTile);

    // scores: slot sp, dimensions of the 16-byte pieces 2i + half
    {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < kHS / 16; ++i) {
        const int dd = (2 * i + half) * 8;
        const uint4 raw = *reinterpret_cast<const uint4*>(&k_s[sp][dd]);
        const __nv_bfloat162* kh = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float4 q0 = *reinterpret_cast<const float4*>(&q_s[dd]);
        const float4 q1 = *reinterpret_cast<const float4*>(&q_s[dd + 4]);
        const float2 k0 = __bfloat1622float2(kh[0]), k1 = __bfloat1622float2(kh[1]);
        const float2 k2 = __bfloat1622float2(kh[2]), k3 = __bfloat1622float2(kh[3]);
        d = fmaf(q0.x, k0.x, d);
        d = fmaf(q0.y, k0.y, d);
        d = fmaf(q0.z, k1.x, d);
        d = fmaf(q0.w, k1.y, d);
        d = fmaf(q1.x, k2.x, d);
        d = fmaf(q1.y, k2.y, d);
        d = fmaf(q1.z, k3.x, d);
        d = fmaf(q1.w, k3.y, d);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      if (half == 0) sc_s[sp] = s0 + sp <= s_end ? d * scale : kNegInf;
    }
    __syncthreads();
    float tmax = kNegInf;
#pragma unroll
    for (int i = 0; i < kTile; i += 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(&sc_s[i]);
      tmax = fmaxf(tmax, fmaxf(fmaxf(s4.x, s4.y), fmaxf(s4.z, s4.w)));
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    if (tid < kTile) {
      const float p = s0 + tid <= s_end ? expf(sc_s[tid] - m_new) : 0.f;
      p_s[tid] = p;
      pb_s[tid] = __bfloat162float(__float2bfloat16_rn(p));
    }
    __syncthreads();
    float ps = 0.f, a = 0.f;
#pragma unroll 4
    for (int i = 0; i < kTile; i += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(&p_s[i]);
      const float4 b4 = *reinterpret_cast<const float4*>(&pb_s[i]);
      ps += (p4.x + p4.y) + (p4.z + p4.w);
      a = fmaf(b4.x, __bfloat162float(v_s[i][tid]), a);
      a = fmaf(b4.y, __bfloat162float(v_s[i + 1][tid]), a);
      a = fmaf(b4.z, __bfloat162float(v_s[i + 2][tid]), a);
      a = fmaf(b4.w, __bfloat162float(v_s[i + 3][tid]), a);
    }
    l = l * alpha + ps;
    acc = acc * alpha + a;
    m = m_new;
  }

  const size_t slot = (size_t)row * n_split + c;
  part_acc[slot * kHS + tid] = acc;
  if (tid == 0) {
    part_m[slot] = m;
    part_l[slot] = l;
  }
}

// one block per row: the partials of the splits that hold visible slots
__global__ void __launch_bounds__(kThreads)
f8_flash_merge_kernel(const int* __restrict__ pos, const float* __restrict__ part_m,
                      const float* __restrict__ part_l, const float* __restrict__ part_acc,
                      __nv_bfloat16* __restrict__ out, int kvh, int s_len, int n_split) {
  const int row = blockIdx.x, tid = threadIdx.x;
  const int pr = min(pos[row / kvh], s_len - 1);
  const int used = pr / kSplit + 1;
  const size_t slot0 = (size_t)row * n_split;
  float mx = kNegInf;
  for (int c = 0; c < used; ++c) mx = fmaxf(mx, part_m[slot0 + c]);
  float l = 0.f, a = 0.f;
  for (int c = 0; c < used; ++c) {
    const float w = expf(part_m[slot0 + c] - mx);
    l = fmaf(part_l[slot0 + c], w, l);
    a = fmaf(part_acc[(slot0 + c) * kHS + tid], w, a);
  }
  out[(size_t)row * kHS + tid] = __float2bfloat16_rn(a / l);
}

template <int MODE>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos, float* part_m, float* part_l,
                   float* part_acc, void* out, int rows, int kvh, int s_len, cudaStream_t stream) {
  const int n_split = (s_len + kSplit - 1) / kSplit;
  f8_flash_split_kernel<MODE><<<dim3((unsigned)n_split, (unsigned)rows), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v), pos,
      part_m, part_l, part_acc, kvh, s_len, n_split, 1.f / sqrtf((float)kHS));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  f8_flash_merge_kernel<<<(unsigned)rows, kThreads, 0, stream>>>(pos, part_m, part_l, part_acc,
                                                                  static_cast<__nv_bfloat16*>(out), kvh, s_len,
                                                                  n_split);
  return cudaGetLastError();
}

}  // namespace

// mode 0..3 = plain, astype, bits, bitsflush. q: (rows, 128) bf16; k, v:
// (rows, s_len, 128), bf16 for plain, e4m3 bytes otherwise; pos: (rows /
// kvh,) int32 on the device; part_m, part_l: (rows, n_split) f32 and
// part_acc: (rows, n_split, 128) f32 scratch, n_split = ceil(s_len / 256);
// out: (rows, 128) bf16. Two launches: the split pass and the merge.
// Returns the first failing launch's cudaError_t, else 0.
extern "C" int f8_flash_decode_launch(int mode, const void* q, const void* k, const void* v, const void* pos,
                                      void* part_m, void* part_l, void* part_acc, void* out, int rows, int kvh,
                                      int s_len, void* stream) {
  if (rows < 1 || kvh < 1 || rows % kvh || s_len < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  switch (mode) {
    case kPlain: return (int)launch<kPlain>(q, k, v, p, pm, pl, pa, out, rows, kvh, s_len, s);
    case kAstype: return (int)launch<kAstype>(q, k, v, p, pm, pl, pa, out, rows, kvh, s_len, s);
    case kBits: return (int)launch<kBits>(q, k, v, p, pm, pl, pa, out, rows, kvh, s_len, s);
    case kBitsFlush: return (int)launch<kBitsFlush>(q, k, v, p, pm, pl, pa, out, rows, kvh, s_len, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
