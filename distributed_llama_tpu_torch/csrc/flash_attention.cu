// Causal GQA flash attention of T query tokens against the KV cache, for
// Hopper (sm_90a), decode (T = 1) and prefill chunks alike.
//
// Replaces: distributed_llama_tpu/ops/pallas_attention.py flash_attention
// (the pallas_call at pallas_attention.py:233; flash_decode_attention is its
// T = 1 name).
//
// Semantics: q (B, T, H, hs), cache k/v (B, KVH, S, hs) head-major, pos0 (B,)
// the position of each row's first query token. Query row r of kv head kh is
// token r / G, head kh*G + r % G (G = H / KVH) and sees cache slot s iff
// s <= pos0[b] + r / G. Scale 1/sqrt(hs); softmax state m, l, acc in f32;
// output (B, T, H, hs) in the cache dtype.
//
// What bounds it on the H100: the cache bytes read. A decode step at fill p
// reads 2 * L * p * kv_dim elements, 3.35 TB/s sets the floor; the scores
// and probabilities never touch device memory.
//
// Design:
//  * One block per (tile of query rows, b * KVH + kh): 4 warps, each warp
//    owning RPW query rows (1 for a decode step's G rows, 4 for a prefill
//    chunk). The queries of the tile sit in shared memory, pre-scaled.
//  * The block walks the cache in tiles of 32 positions staged in shared
//    memory as f32 (K rows padded to hs+1 floats so the lanes' column reads
//    hit distinct banks). Tiles move with 16-byte loads, and each thread
//    keeps the next tile's loads in flight in registers while the block
//    computes on the current one. Per tile and row a lane scores one position, the
//    warp takes max and sum with shuffles (online softmax), and each lane
//    accumulates its own hs/32 output dimensions from the V tile.
//  * The walk STOPS at the tile holding the last position any row of the
//    block may see (pos0[b] + last token of the tile): bytes read grow with
//    the fill, not with the preallocated S. This is the Pallas kernel's
//    dead-read fix (pallas_attention.py:27-33), per block here.
// Known slow spot: a decode step at B = 1 gives B * KVH blocks (32 at 7B)
// for 132 SMs; splitting S across blocks with a merge is later work, as are
// tensor cores and TMA. The fp8 cache mode is not ported yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kSB = 32;  // cache positions per tile: one per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
// 16 loaded bytes -> 4 floats or 8 bf16 as floats
template <int N>
__device__ __forceinline__ void unpack16(uint4 raw, float (&out)[N]) {
  if constexpr (N == 4) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = f[e];
  } else {  // 8 bf16
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  }
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int HS, int RPW>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ pos0,
                       T* __restrict__ out, int t, int h, int kvh, int s_len,
                       float scale) {
  constexpr int ROWS = kWarps * RPW;
  constexpr int DPL = (HS + 31) / 32;  // output dims per lane
  __shared__ __align__(16) float q_s[ROWS][HS];
  __shared__ float k_s[kSB][HS + 1];
  __shared__ float v_s[kSB][HS];
  __shared__ float p_s[kWarps][kSB];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = h / kvh;
  const int rows = t * g;
  const int bk = blockIdx.y;
  const int b = bk / kvh, kh = bk % kvh;
  const int row0 = blockIdx.x * ROWS;
  const int p0 = pos0[b];

  for (int i = threadIdx.x; i < ROWS * HS; i += blockDim.x) {
    const int rr = i / HS, dd = i % HS, r = row0 + rr;
    float val = 0.f;
    if (r < rows) {
      const int tok = r / g, head = kh * g + r % g;
      val = to_f(q[(((size_t)b * t + tok) * h + head) * HS + dd]) * scale;
    }
    q_s[rr][dd] = val;
  }

  const int r_last = min(row0 + ROWS, rows) - 1;
  const int s_end = min(p0 + r_last / g, s_len - 1);  // inclusive

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
  }

  const size_t base = ((size_t)b * kvh + kh) * (size_t)s_len * HS;
  // K/V tiles move 16 bytes per load; a thread holds the next tile's loads
  // in registers while the block computes on the current one
  constexpr int VEC = 16 / sizeof(T);
  constexpr int ROW_CHUNKS = HS / VEC;
  constexpr int CHUNKS = kSB * ROW_CHUNKS;
  constexpr int PER_THREAD = (CHUNKS + kWarps * 32 - 1) / (kWarps * 32);
  uint4 kr[PER_THREAD], vr[PER_THREAD];
  auto fetch = [&](int s0) {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int c = threadIdx.x + j * kWarps * 32;
      const int s = s0 + c / ROW_CHUNKS, dd = (c % ROW_CHUNKS) * VEC;
      if (c < CHUNKS && s <= s_end) {
        kr[j] = __ldg(reinterpret_cast<const uint4*>(k + base + (size_t)s * HS + dd));
        vr[j] = __ldg(reinterpret_cast<const uint4*>(v + base + (size_t)s * HS + dd));
      } else {
        kr[j] = make_uint4(0u, 0u, 0u, 0u);
        vr[j] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  fetch(0);
  for (int s0 = 0; s0 <= s_end; s0 += kSB) {
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int c = threadIdx.x + j * kWarps * 32;
      if (c < CHUNKS) {
        const int ss = c / ROW_CHUNKS, dd = (c % ROW_CHUNKS) * VEC;
        float kf[VEC], vf[VEC];
        unpack16(kr[j], kf);
        unpack16(vr[j], vf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          k_s[ss][dd + e] = kf[e];
          v_s[ss][dd + e] = vf[e];
        }
      }
    }
    __syncthreads();
    if (s0 + kSB <= s_end) fetch(s0 + kSB);

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int rr = warp * RPW + i, r = row0 + rr;
      if (r < rows) {  // uniform across the warp
        const int pr = p0 + r / g;
        const int s = s0 + lane;
        const bool seen = s <= pr;
        float sc = kNegInf;
        if (seen) {  // four independent chains over the head dimension
          float d4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int dd = 0; dd < HS; dd += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(&q_s[rr][dd]);
            d4[0] = fmaf(qv.x, k_s[lane][dd], d4[0]);
            d4[1] = fmaf(qv.y, k_s[lane][dd + 1], d4[1]);
            d4[2] = fmaf(qv.z, k_s[lane][dd + 2], d4[2]);
            d4[3] = fmaf(qv.w, k_s[lane][dd + 3], d4[3]);
          }
          sc = (d4[0] + d4[1]) + (d4[2] + d4[3]);
        }
        float mx = sc;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        const float p = seen ? expf(sc - m_new) : 0.f;
        float ps = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
        l[i] = l[i] * alpha + ps;
        m[i] = m_new;
        p_s[warp][lane] = p;
        __syncwarp();
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int dd = lane + 32 * j;
          float a = acc[i][j] * alpha;
          if (dd < HS) {
#pragma unroll 8
            for (int ss = 0; ss < kSB; ++ss) a = fmaf(p_s[warp][ss], v_s[ss][dd], a);
          }
          acc[i][j] = a;
        }
        __syncwarp();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row0 + warp * RPW + i;
    if (r < rows) {
      const int tok = r / g, head = kh * g + r % g;
      T* o = out + (((size_t)b * t + tok) * h + head) * HS;
      const float inv = 1.f / l[i];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int dd = lane + 32 * j;
        if (dd < HS) store(o + dd, acc[i][j] * inv);
      }
    }
  }
}

template <typename T, int HS>
cudaError_t launch_hs(const void* q, const void* k, const void* v, const int* pos0, void* out,
                      int b, int t, int h, int kvh, int s_len, cudaStream_t stream) {
  const int rows = t * (h / kvh);
  const float scale = 1.f / sqrtf((float)HS);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (rows <= kWarps) {
    const dim3 grid(1, (unsigned)(b * kvh));
    flash_attention_kernel<T, HS, 1><<<grid, kWarps * 32, 0, stream>>>(qp, kp, vp, pos0, op, t, h, kvh, s_len, scale);
  } else {
    const dim3 grid((unsigned)((rows + 4 * kWarps - 1) / (4 * kWarps)), (unsigned)(b * kvh));
    flash_attention_kernel<T, HS, 4><<<grid, kWarps * 32, 0, stream>>>(qp, kp, vp, pos0, op, t, h, kvh, s_len, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos0, void* out,
                   int b, int t, int h, int kvh, int s_len, int hs, cudaStream_t stream) {
  switch (hs) {
    case 16: return launch_hs<T, 16>(q, k, v, pos0, out, b, t, h, kvh, s_len, stream);
    case 32: return launch_hs<T, 32>(q, k, v, pos0, out, b, t, h, kvh, s_len, stream);
    case 64: return launch_hs<T, 64>(q, k, v, pos0, out, b, t, h, kvh, s_len, stream);
    case 128: return launch_hs<T, 128>(q, k, v, pos0, out, b, t, h, kvh, s_len, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (b, t, h, hs); k, v: (b, kvh, s_len, hs); out: (b, t, h, hs); all of one
// dtype, f32 (dtype 0) or bf16 (1). pos0: (b,) int32 on the device.
// Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* pos0, void* out, int dtype, int b,
                                      int t, int h, int kvh, int s_len, int hs,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos0);
  if (dtype == 0) return launch<float>(q, k, v, p, out, b, t, h, kvh, s_len, hs, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, p, out, b, t, h, kvh, s_len, hs, s);
  return (int)cudaErrorInvalidValue;
}
