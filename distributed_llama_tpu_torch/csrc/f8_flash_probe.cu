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
// TB/s; e4m3 62.9 MB, 18.8 us. The operations are negligible, but at one
// query row a slot the instructions that score and convert each byte are
// not.
//
// Design. The TPU grid walks S in order on one core; here S is split
// (flash-decoding) and the partials are merged:
//  * The split comes from the shapes alone (f8_flash_plan; the same
//    integer rule as ops/cuda_probes.py f8_split_plan): n_split blocks a
//    row, as many as keep rows x n_split within one wave of blocks_per_sm
//    blocks an SM: 1 for a bf16 cache, 4 (16 warps) for e4m3, whose
//    conversions are instruction-bound and need the warps to hide latency. Each block
//    reads pos on the device and derives its slots: the row's fill = min(pos,
//    S - 1) + 1 visible slots are cut into n_split x kWarps equal ranges, one
//    a warp (f8_split_ranges in Python), so the bytes a warp reads follow
//    the fill, not S, and no host reads pos.
//  * Each warp streams its range through its own ring of cp.async.cg
//    stages in shared memory, 16 slots of raw K and V a stage (4 stages of
//    8 KB for bf16, 2 of 4 KB for e4m3: 4-24 KB in flight a warp, 64-96 KB
//    an SM), no block barrier in the loop. 16-byte pieces are stored with
//    their index XOR'd by the slot's low 3 bits, so the fragment reads
//    below hit distinct banks. The cache is converted to bf16 by the mode's
//    conversion only in registers, once a byte.
//  * QK and P.V run on mma.sync m16n8k16 (bf16, f32 sums) with the one query
//    row padded to 16: the tensor cores take the score and P.V issue off the
//    CUDA cores. Two permutations keep the loads 16 bytes wide and the
//    fragments in place: QK's k index runs over each lane's own 32 dims (q
//    and K in the same order, so the dot is unchanged), and its columns are
//    slots ordered so that lane q's four scores are slots 4q .. 4q + 3, which
//    are exactly P.V's k = 2q, 2q + 1, 2q + 8, 2q + 9. P.V runs transposed,
//    O^T = V^T P^T (the query a column of B, 32 sums a thread instead of
//    64), its m16 tile mt's rows g and g + 8 dims 16g + 2mt and + 1, so
//    lane (g, q) reads V rows 4q .. 4q + 3 at dims 16g .. 16g + 15. Online softmax in f32 per warp; p is rounded to
//    bf16 for P.V and summed unrounded.
//  * The block merges its 4 warps through shared memory in a fixed order;
//    with one split it writes the output, else its partial (m, l, acc), and
//    a second launch merges a row's partials in split order. Empty ranges
//    weigh 0. No atomics: a repeated launch gives the same bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kPlain = 0, kAstype = 1, kBits = 2, kBitsFlush = 3 };

constexpr int kHS = 128;          // head size: the probe's
constexpr int kWarps = 4;         // warps a block, each with its own slot range
constexpr int kThreads = 32 * kWarps;
constexpr int kStg = 16;          // slots a stage
constexpr int kSms = 132;         // H100 SXM
constexpr float kNegInf = -1e30f;
// blocks an SM and bytes of a warp's ring, by cache type: a bf16 cache
// streams best from few long warps, an e4m3 one needs more warps to hide
// its conversions' latency
constexpr int kBpsBf16 = 1, kRingBf16 = 32768;
constexpr int kBpsF8 = 4, kRingF8 = 8192;
__host__ __device__ constexpr int blocks_per_sm(bool f8) { return f8 ? kBpsF8 : kBpsBf16; }
__host__ __device__ constexpr int ring_bytes(bool f8) { return f8 ? kRingF8 : kRingBf16; }
// shared memory a block: the warps' rings, then the merge of the warps
__host__ __device__ constexpr int smem_bytes(bool f8) { return kWarps * ring_bytes(f8) + kWarps * (kHS + 2) * 4; }

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

// the split: blocks a row, from the shapes and the cache type alone
__host__ __device__ inline int f8_plan(int rows, int s_len, bool f8) {
  const int most = (s_len + kWarps * kStg - 1) / (kWarps * kStg);   // at least a stage a warp
  const int n = kSms * blocks_per_sm(f8) / rows;
  return n < 1 ? 1 : n > most ? most : n;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes to shared memory without passing through registers; an invalid
// source fills zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// word e (a constant) of 16 loaded bytes
__device__ __forceinline__ uint32_t word(const uint4& r, int e) { return e == 0 ? r.x : e == 1 ? r.y : e == 2 ? r.z : r.w; }

template <int MODE>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(MODE != kPlain))
f8_flash_split_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k,
                      const uint8_t* __restrict__ v, const int* __restrict__ pos, float* __restrict__ part_m,
                      float* __restrict__ part_l, float* __restrict__ part_acc, __nv_bfloat16* __restrict__ out,
                      int kvh, int s_len, int n_split, float scale) {
  constexpr int CS = MODE == kPlain ? 2 : 1;   // cache bytes a value
  constexpr int RB = kHS * CS;                  // bytes a cache row
  constexpr int CPR = RB / 16;                  // 16-byte pieces a row
  constexpr int SB = 2 * kStg * RB;             // bytes a stage: K then V
  constexpr int RING = ring_bytes(MODE != kPlain);
  constexpr int NS = RING / SB;                 // stages in a warp's ring
  constexpr int WPC = 16 / CS / 2;              // bf16x2 words a 16-byte piece
  extern __shared__ __align__(16) uint8_t smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;
  const int c = blockIdx.x, row = blockIdx.y;
  const int fill = min(pos[row / kvh], s_len - 1) + 1;
  const int units = n_split * kWarps, per = (fill + units - 1) / units;
  const int s0 = min((c * kWarps + warp) * per, fill), count = min(per, fill - s0);
  const int n_stg = (count + kStg - 1) / kStg;

  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem + warp * RING));
  const uint8_t* ring_g = smem + warp * RING;
  const size_t base = ((size_t)row * s_len + s0) * RB;   // bytes to the range's first slot
  auto issue = [&](int st) {
    const uint32_t dst = ring + (st % NS) * SB;
#pragma unroll
    for (int i = 0; i < kStg * CPR / 32; ++i) {
      const int ch = lane + 32 * i, r = ch / CPR, col = ch % CPR;
      const int sl = st * kStg + r;
      const size_t off = base + (size_t)sl * RB + col * 16;
      const bool ok = sl < count;
      const uint32_t at = (r * CPR + (col ^ (r & 7))) * 16;
      cp_async16(dst + at, ok ? k + off : k, ok);
      cp_async16(dst + kStg * RB + at, ok ? v + off : v, ok);
    }
  };

  // q at this lane's dims, as the K fragment words below (lanes of row 0 only)
  uint32_t qw[16];
  {
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(q + (size_t)row * kHS);
#pragma unroll
    for (int w = 0; w < 16; ++w) {
      const int col = qd + 4 * (w / WPC), dim = col * (8 * WPC / 4) + 2 * (w % WPC);
      qw[w] = g == 0 ? __ldg(qr + dim / 2) : 0u;
    }
  }

  float m = kNegInf, l = 0.f;
  float acc[8][4];   // O^T: m16 tile mt holds dims 16g + 2mt (row g) and 16g + 2mt + 1 (row g + 8)
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < n_stg) issue(st);
    cp_async_commit();
  }
  for (int st = 0; st < n_stg; ++st) {
    if (st + NS - 1 < n_stg) issue(st + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncwarp();
    const uint8_t* ks = ring_g + (st % NS) * SB;
    const uint8_t* vs = ks + kStg * RB;

    // scores: columns of n8 tile nt are slots tau(nt, n); lane (g, q) reads
    // slot tau(nt, g) at its own dims (pieces q, q + 4, ...), each raw word
    // converted just before the MMA that takes it (fewer live registers,
    // more warps an SM)
    float sc[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int r = 2 * g + 2 * nt - (g & 1);
      uint4 raw[16 / WPC];
#pragma unroll
      for (int p = 0; p < 16 / WPC; ++p) {
        const int col = qd + 4 * p;
        raw[p] = *reinterpret_cast<const uint4*>(ks + (r * CPR + (col ^ (r & 7))) * 16);
      }
      float cf[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {   // k16 step j: words 2j, 2j + 1 of this lane's dims
        uint32_t b0, b1;
        if constexpr (MODE == kPlain) {
          b0 = word(raw[j / 2], 2 * (j % 2));
          b1 = word(raw[j / 2], 2 * (j % 2) + 1);
        } else {
          f8x4_to_bf16<MODE>(word(raw[j / 4], j % 4), b0, b1);
        }
        mma_bf16(cf, qw[2 * j], 0u, qw[2 * j + 1], 0u, b0, b1);
      }
      sc[2 * nt] = cf[0] * scale;       // slot 4q + 2nt
      sc[2 * nt + 1] = cf[1] * scale;   // slot 4q + 2nt + 1
    }
    const int left = count - st * kStg;   // valid slots in this stage
    float tmax = kNegInf;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * qd + e < left) tmax = fmaxf(tmax, sc[e]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float p[4], ps = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = 4 * qd + e < left ? expf(sc[e] - m_new) : 0.f;
      ps += p[e];
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l = l * alpha + ps;
    m = m_new;
    // P.V as O^T = V^T P^T: A = V^T, m16 tile mt's rows g, g + 8 are dims
    // 16g + 2mt, 16g + 2mt + 1 and its k = 2q, 2q+1, 2q+8, 2q+9 slots 4q ..
    // 4q+3; B = P^T, column 0 the query (lanes g = 0), the rest zero
    const float al = __shfl_sync(0xffffffffu, alpha, 0);
    const uint32_t pb0 = g == 0 ? bf2_bits(__floats2bfloat162_rn(p[0], p[1])) : 0u;
    const uint32_t pb1 = g == 0 ? bf2_bits(__floats2bfloat162_rn(p[2], p[3])) : 0u;
    uint4 vr[4][8 / WPC];   // rows 4q .. 4q+3, dims 16g .. 16g+15, raw
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int r = 4 * qd + rr;
#pragma unroll
      for (int p2 = 0; p2 < 8 / WPC; ++p2) {
        const int col = g * (8 / WPC) + p2;
        vr[rr][p2] = *reinterpret_cast<const uint4*>(vs + (r * CPR + (col ^ (r & 7))) * 16);
      }
    }
    // tile mt takes word mt of each row's dims (slots 4q+rr in its halves)
    auto pv = [&](int mt, const uint32_t (&w)[4]) {
      acc[mt][0] *= al;
      acc[mt][2] *= al;
      mma_bf16(acc[mt], __byte_perm(w[0], w[1], 0x5410u), __byte_perm(w[0], w[1], 0x7632u),
               __byte_perm(w[2], w[3], 0x5410u), __byte_perm(w[2], w[3], 0x7632u), pb0, pb1);
    };
    if constexpr (MODE == kPlain) {
#pragma unroll
      for (int mt = 0; mt < 8; ++mt) {
        const uint32_t w[4] = {word(vr[0][mt / 4], mt % 4), word(vr[1][mt / 4], mt % 4),
                               word(vr[2][mt / 4], mt % 4), word(vr[3][mt / 4], mt % 4)};
        pv(mt, w);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // raw word e of each row: tiles 2e (low pair) and 2e + 1 (high pair)
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) f8x4_to_bf16<MODE>(word(vr[rr][0], e), lo[rr], hi[rr]);
        pv(2 * e, lo);
        pv(2 * e + 1, hi);
      }
    }
    __syncwarp();   // this stage is read: the next issue may refill it
  }
  cp_async_wait<0>();

  // merge the warps: lane (g, 0) holds dims 16g + 2mt and 16g + 2mt + 1
  float* cm = reinterpret_cast<float*>(smem + kWarps * RING);
  float* cl = cm + kWarps;
  float* ca = cl + kWarps;   // [warp][dim]
  if (qd == 0) {
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) {
      ca[warp * kHS + 16 * g + 2 * mt] = acc[mt][0];
      ca[warp * kHS + 16 * g + 2 * mt + 1] = acc[mt][2];
    }
    if (g == 0) {
      cm[warp] = m;
      cl[warp] = l;
    }
  }
  __syncthreads();
  const int dim = threadIdx.x;
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, cm[w]);
  float lt = 0.f, a = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float wt = expf(cm[w] - mx);
    lt = fmaf(cl[w], wt, lt);
    a = fmaf(ca[w * kHS + dim], wt, a);
  }
  if (n_split == 1) {
    out[(size_t)row * kHS + dim] = __float2bfloat16_rn(a / lt);
    return;
  }
  const size_t slot = (size_t)row * n_split + c;
  part_acc[slot * kHS + dim] = a;
  if (dim == 0) {
    part_m[slot] = mx;
    part_l[slot] = lt;
  }
}

// one block per row: its n_split partials, in split order
__global__ void __launch_bounds__(kHS)
f8_flash_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, __nv_bfloat16* __restrict__ out, int n_split) {
  const int row = blockIdx.x, dim = threadIdx.x;
  const size_t slot0 = (size_t)row * n_split;
  float mx = kNegInf;
  for (int c = 0; c < n_split; ++c) mx = fmaxf(mx, part_m[slot0 + c]);
  float l = 0.f, a = 0.f;
  for (int c = 0; c < n_split; ++c) {
    const float w = expf(part_m[slot0 + c] - mx);
    l = fmaf(part_l[slot0 + c], w, l);
    a = fmaf(part_acc[(slot0 + c) * kHS + dim], w, a);
  }
  out[(size_t)row * kHS + dim] = __float2bfloat16_rn(a / l);
}

template <int MODE>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos, float* part_m, float* part_l,
                   float* part_acc, void* out, int rows, int kvh, int s_len, int n_split, cudaStream_t stream) {
  static bool configured = false;   // above 48 KB a kernel must opt in
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(f8_flash_split_kernel<MODE>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(MODE != kPlain));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  f8_flash_split_kernel<MODE><<<dim3((unsigned)n_split, (unsigned)rows), kThreads, smem_bytes(MODE != kPlain), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v), pos,
      part_m, part_l, part_acc, static_cast<__nv_bfloat16*>(out), kvh, s_len, n_split, 1.f / sqrtf((float)kHS));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  f8_flash_merge_kernel<<<(unsigned)rows, kHS, 0, stream>>>(part_m, part_l, part_acc,
                                                            static_cast<__nv_bfloat16*>(out), n_split);
  return cudaGetLastError();
}

const void* split_kernel(int mode) {
  switch (mode) {
    case kPlain: return (const void*)f8_flash_split_kernel<kPlain>;
    case kAstype: return (const void*)f8_flash_split_kernel<kAstype>;
    case kBits: return (const void*)f8_flash_split_kernel<kBits>;
    case kBitsFlush: return (const void*)f8_flash_split_kernel<kBitsFlush>;
    default: return nullptr;
  }
}

}  // namespace

// The split's blocks a row for rows x s_len and the mode's cache type
// (ops/cuda_probes.py f8_split_plan is the same rule).
extern "C" int f8_flash_plan(int rows, int s_len, int mode) {
  return rows < 1 || s_len < 1 ? 0 : f8_plan(rows, s_len, mode != kPlain);
}

// mode 0..3 = plain, astype, bits, bitsflush. q: (rows, 128) bf16; k, v:
// (rows, s_len, 128), bf16 for plain, e4m3 bytes otherwise, 16-byte
// aligned; pos: (rows / kvh,) int32 on the device, each >= 0; n_split:
// blocks a row (0: f8_flash_plan's); part_m, part_l: (rows, n_split) f32
// and part_acc: (rows, n_split, 128) f32 scratch (unread when n_split is
// 1); out: (rows, 128) bf16. One launch for n_split = 1, else two: the
// split pass and the merge. Returns the first failing launch's
// cudaError_t, else 0.
extern "C" int f8_flash_decode_launch(int mode, const void* q, const void* k, const void* v, const void* pos,
                                      void* part_m, void* part_l, void* part_acc, void* out, int rows, int kvh,
                                      int s_len, int n_split, void* stream) {
  if (rows < 1 || kvh < 1 || rows % kvh || s_len < 1 || n_split < 0) return (int)cudaErrorInvalidValue;
  if (n_split == 0) n_split = f8_plan(rows, s_len, mode != kPlain);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  switch (mode) {
    case kPlain: return (int)launch<kPlain>(q, k, v, p, pm, pl, pa, out, rows, kvh, s_len, n_split, s);
    case kAstype: return (int)launch<kAstype>(q, k, v, p, pm, pl, pa, out, rows, kvh, s_len, n_split, s);
    case kBits: return (int)launch<kBits>(q, k, v, p, pm, pl, pa, out, rows, kvh, s_len, n_split, s);
    case kBitsFlush: return (int)launch<kBitsFlush>(q, k, v, p, pm, pl, pa, out, rows, kvh, s_len, n_split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The mode's split kernel as compiled: out[0..4] = registers a thread,
// local (spill) bytes a thread, static shared bytes, the dynamic shared
// bytes a launch asks for, threads a block. Returns a cudaError_t.
extern "C" int f8_flash_decode_attrs(int mode, int* out) {
  const void* kf = split_kernel(mode);
  if (kf == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kf);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = smem_bytes(mode != kPlain);
  out[4] = kThreads;
  return 0;
}
