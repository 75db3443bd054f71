// Causal GQA flash attention of T query tokens against the KV cache, for
// Hopper (sm_90a), decode steps and prefill chunks alike.
//
// Replaces: distributed_llama_tpu/ops/pallas_attention.py flash_attention
// (the pallas_call at pallas_attention.py:233; flash_decode_attention is its
// T = 1 name).
//
// Semantics: q (B, T, H, hs), cache k/v (B, KVH, S, hs) head-major, pos0 (B,)
// the position of each row's first query token. Query row r of kv head kh is
// token r / G, head kh*G + r % G (G = H / KVH) and sees cache slot s iff
// s <= pos0[b] + r / G. Scale 1/sqrt(hs); softmax state m, l, acc in f32;
// output (B, T, H, hs) in q's dtype. q and the cache are both f32 or both
// bf16, or the cache is fp8 e4m3 under f32 or bf16 q.
//
// What bounds it on the H100:
//  * decode (T * G <= 16 rows per kv head): the cache bytes. A step at fill p
//    reads 2 * p * KVH * hs cache values per layer and does ~4 * G * hs
//    operations per slot, far below the ~295 operations per byte at which
//    the tensor cores become the limit. 3.35 TB/s sets the floor, and at
//    batch 1 only B * KVH heads of work exist (8 for Mixtral, 32 for 7B)
//    against 132 SMs.
//  * prefill at depth (a 256-token chunk at pos0 1792, 8.06 GFLOP a layer):
//    operations. The chunk does 256 * G operations per cache byte against
//    the ~295 of the tensor cores' ridge, so 989 TFLOP/s bf16 sets the
//    floor for Mixtral (G = 4); for 7B (G = 1) the cache bytes, 33.5 MB a
//    layer, are just the larger.
//
// Design. Every launch has the grid (row tiles, n_split, B * KVH), fixed by
// the shapes alone (the wrapper's split_plan), and reads pos0 only on the
// device, so the launch can sit in a CUDA graph.
//  * Split S (flash-decoding). Split c of a row takes the slots
//    [c * len, (c + 1) * len), len = ceil(min(pos0 + T, S) / n_split)
//    rounded up to the 64-slot tile (split_len below; the wrapper's
//    split_len is the same rule), so the fill, not S, is spread over the
//    n_split blocks. A block stops at the last slot its rows may see: bytes
//    read grow with the fill (the Pallas kernel's dead-read fix,
//    pallas_attention.py:27-33), and blocks past it return at once. With
//    n_split > 1 each block writes its rows' partial (m, l, acc) to f32
//    scratch and a second launch (flash_merge_kernel) merges the splits a
//    row can see; a split that holds no visible slot of a row is never read
//    (l = 0 would weigh 0 all the same). n_split is the most splits that
//    keep the blocks within one wave of two an SM (2 x 132), at most S / 64:
//    a part-filled second wave costs as much as the first.
//  * bf16 q (a bf16 or e4m3 cache): tensor cores, FA2-style
//    (flash_mma_kernel). 4 warps; S = Q K^T and O += P V by mma.sync
//    m16n8k16 bf16 with f32 accumulation. Each warp keeps its 16 query rows'
//    Q fragments in registers for the whole walk; K fragments come by
//    ldmatrix, V fragments by ldmatrix.trans, from 64-slot tiles padded by
//    16 bytes a row (conflict-free). The online softmax runs on the score
//    fragments: row max and sum by quad shuffles, exp2 with the scale folded
//    into log2 e; p is rounded to bf16 in registers and is the A operand of
//    P V as it stands (the JAX kernel rounds p to the value dtype too,
//    pallas_attention.py:168). The causal mask is applied only on tiles that
//    cross a row's last slot. Tiles move by cp.async through a ring of 3
//    stages, one barrier a tile; slots past the block's last visible slot
//    are zero-filled, never read.
//     - T * G > 16 rows (prefill): 64 query rows a block, 16 a warp; the
//       four warps share each K/V tile.
//     - T * G <= 16 rows (decode: 1 row for 7B, 4 for Mixtral, 6 for Grok-1):
//       one block serves all G rows of a kv head, so each K/V byte is read
//       once for the group; the four warps split each tile's 64 slots, 16
//       each, and merge their states in shared memory at the end.
//     - e4m3 cache: the tile moves as one byte a value by cp.async into a
//       raw ring, off the critical path; each thread converts the pieces it
//       loaded to bf16 (cvt e4m3x2 -> f16x2 -> bf16x2, exact, P2's
//       `astype`, csrc/f8_flash_probe.cu) into the padded tile the warps
//       read. Never to f32. Writes saturate at +-448, so the magnitude code
//       0x7F, which the hardware reads as NaN, never arises.
//  * f32 q (an f32 cache, or f32 q over e4m3): exact f32 on the CUDA cores
//    (flash_f32_kernel), no TF32, so the CLI's f32 tokens equal the CPU's.
//    4 warps, each owning 1 (T * G <= 4) or 4 query rows; 32-slot tiles
//    staged in shared memory as f32, one slot a lane, max and sum by
//    shuffles. It takes the same split-S grid and merge.
// Not yet here: wgmma and TMA (FA3-style), and a merge without a second
// launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;    // slots per tensor-core tile; split lengths are multiples of it
constexpr int kStages = 3;   // tensor-core path: K/V tiles in flight
constexpr int kSB = 32;      // slots per f32 tile: one per lane
constexpr float kNegInf = -1e30f;  // softmax state before any visible slot
constexpr float kLog2e = 1.4426950408889634f;

// slots per split: ceil(fill / n_split) rounded up to the tile, fill =
// min(pos0 + t, s_len) (ops/cuda_attention.py split_len)
__device__ __forceinline__ int split_len(int p0, int t, int s_len, int n_split) {
  const int fill = min(p0 + t, s_len);
  const int per = (fill + n_split - 1) / n_split;
  return (per + kTile - 1) / kTile * kTile;
}

// the last slot query row r may see
__device__ __forceinline__ int row_limit(int p0, int r, int g, int s_len) { return min(p0 + r / g, s_len - 1); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two e4m3 values (the low byte first) -> bf16x2, exactly
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t two) {
  const __half2 h(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)two, __NV_E4M3));
  return pack_bf16(__low2float(h), __high2float(h));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------- bf16 q

template <typename TC, int HS>
struct MmaSmem {
  static constexpr bool F8 = sizeof(TC) == 1;
  static constexpr int LD = HS + 8;                            // bf16 a staged row
  static constexpr int TILE_BYTES = kTile * LD * 2;            // one of K, V as bf16
  static constexpr int RAW_BYTES = kTile * HS;                 // one of K, V as e4m3
  static constexpr int RING = F8 ? kStages * 2 * RAW_BYTES + 2 * TILE_BYTES : kStages * 2 * TILE_BYTES;
  static constexpr int ACC_LD = HS + 4;                        // f32 a row of the epilogue
  static constexpr int EPI = kWarps * 16 * (ACC_LD + 2) * 4;
  static constexpr int BYTES = RING > EPI ? RING : EPI;
};

// TC: the cache, bf16 or uint8 holding e4m3 bits. SW: warps that split a
// tile's slots (4 for decode, 1 for prefill); the other 4 / SW warps split
// the query rows, 16 each.
template <typename TC, int HS, int SW>
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const TC* __restrict__ k, const TC* __restrict__ v,
                 const int* __restrict__ pos0, __nv_bfloat16* __restrict__ out, float* __restrict__ part_ml,
                 float* __restrict__ part_acc, int t, int h, int kvh, int s_len, int n_split, float scale_log2) {
  using Sm = MmaSmem<TC, HS>;
  constexpr bool F8 = Sm::F8;
  constexpr int BR = 16 * (kWarps / SW);  // query rows a block
  constexpr int NS = kTile / SW;          // slots a warp takes of each tile
  constexpr int NJ = NS / 8;              // score fragments a warp (n = 8 slots each)
  constexpr int KD = HS / 16;             // k-steps over the head
  constexpr int ND = HS / 8;              // output fragments over the head
  constexpr int LD = Sm::LD;
  static_assert(NJ % 2 == 0 && ND % 2 == 0, "fragments go in pairs");
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int g = h / kvh, rows = t * g;
  const int bk = blockIdx.z, b = bk / kvh, kh = bk % kvh, c = blockIdx.y;
  const int row0 = blockIdx.x * BR;
  const int p0 = pos0[b];
  const int s_end = row_limit(p0, min(row0 + BR, rows) - 1, g, s_len);  // inclusive
  const int len = split_len(p0, t, s_len, n_split);
  const int s_lo = c * len;
  const int s_hi = min(s_lo + len, s_end + 1);
  if (s_lo >= s_hi) return;  // uniform: no slot of this split is visible to the block
  const int n_tiles = (s_hi - s_lo + kTile - 1) / kTile;

  // this warp's rows and slots of each tile
  const int wr0 = row0 + (SW == 1 ? 16 * warp : 0);
  const int sw0 = SW == 1 ? 0 : NS * warp;
  const bool has_rows = wr0 < rows;
  const int lim_lo = row_limit(p0, wr0, g, s_len);
  const int lim_hi = row_limit(p0, min(wr0 + 16, rows) - 1, g, s_len);
  const int ra = wr0 + gid, rb = ra + 8;  // the two rows of this thread's fragments
  const int lim_a = row_limit(p0, ra, g, s_len), lim_b = row_limit(p0, rb, g, s_len);

  // Q fragments, held for the whole walk (rows past the last are zero)
  uint32_t qa[KD][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? rb : ra;
    const __nv_bfloat16* qr = q + (((size_t)b * t + r / g) * h + kh * g + r % g) * HS + 2 * tig;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qa[kk][i] = r < rows ? *reinterpret_cast<const uint32_t*>(qr + 16 * kk) : 0u;
      qa[kk][i + 2] = r < rows ? *reinterpret_cast<const uint32_t*>(qr + 16 * kk + 8) : 0u;
    }
  }

  const size_t head = ((size_t)b * kvh + kh) * (size_t)s_len * HS;  // elements
  constexpr int VEC = 16 / sizeof(TC);                              // values a 16-byte piece
  constexpr int CH = HS / VEC;                                      // pieces a row
  __nv_bfloat16* const kv_bf = reinterpret_cast<__nv_bfloat16*>(smem + (F8 ? kStages * 2 * Sm::RAW_BYTES : 0));
  auto tile_k = [&](int stage) { return kv_bf + (F8 ? 0 : stage) * 2 * kTile * LD; };
  auto raw = [&](int stage) { return smem + stage * 2 * Sm::RAW_BYTES; };

  constexpr int PER = (kTile * CH + kThreads - 1) / kThreads;       // pieces a thread, of each of K, V
  auto load_tile = [&](int tile) {
    const int s0 = s_lo + tile * kTile, stage = tile % kStages;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * kThreads;
      if (i >= kTile * CH) break;
      const int ss = i / CH, dd = (i % CH) * VEC, s = s0 + ss;
      const bool ok = s < s_hi;
      const size_t off = head + (size_t)(ok ? s : s_lo) * HS + dd;
      if constexpr (F8) {
        unsigned char* rp = raw(stage) + ss * HS + dd;
        cp_async16(rp, k + off, ok);
        cp_async16(rp + Sm::RAW_BYTES, v + off, ok);
      } else {
        __nv_bfloat16* kp = tile_k(stage) + ss * LD + dd;
        cp_async16(kp, k + off, ok);
        cp_async16(kp + kTile * LD, v + off, ok);
      }
    }
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // one barrier a tile: it makes tile it visible to every warp and tells
  // that all of them are done with tile it - 1, whose stage the next load
  // then takes. The e4m3 path converts into one bf16 tile before that
  // barrier, so it needs a second one after the tile's compute.
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's pieces of tile it have landed
    if constexpr (F8) {  // convert the pieces this thread loaded into the bf16 tile
      const unsigned char* rp = raw(it % kStages);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int i = tid + j * kThreads;
        if (i >= kTile * CH) break;
        const int ss = i / CH, dd = (i % CH) * VEC;
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          const uint4 w = *reinterpret_cast<const uint4*>(rp + kv * Sm::RAW_BYTES + ss * HS + dd);
          const uint32_t in[4] = {w.x, w.y, w.z, w.w};
          uint32_t o[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[2 * e] = e4m3x2_to_bf16x2(in[e] & 0xFFFFu);
            o[2 * e + 1] = e4m3x2_to_bf16x2(in[e] >> 16);
          }
          uint4* dst = reinterpret_cast<uint4*>(kv_bf + kv * kTile * LD + ss * LD + dd);
          dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
          dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
        }
      }
    }
    __syncthreads();
    if (it + kStages - 1 < n_tiles) load_tile(it + kStages - 1);  // into the stage of tile it - 1
    cp_async_commit();

    const int s_first = s_lo + it * kTile + sw0;  // this warp's first slot of the tile
    if (has_rows && s_first <= lim_hi) {
      const __nv_bfloat16* ks = tile_k(it % kStages);
      const __nv_bfloat16* vs = ks + kTile * LD;
      float sc[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          uint32_t bf[4];
          ldmatrix_x4(bf, ks + (sw0 + 8 * j + (lane & 7) + ((lane >> 4) << 3)) * LD + 16 * kk +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(sc[j], qa[kk], bf[0], bf[1]);
          mma_bf16(sc[j + 1], qa[kk], bf[2], bf[3]);
        }
      }
      if (s_first + NS - 1 > lim_lo) {  // the tile crosses a row's last slot
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int s = s_first + 8 * j + 2 * tig;
          if (s > lim_a) sc[j][0] = -INFINITY;
          if (s + 1 > lim_a) sc[j][1] = -INFINITY;
          if (s > lim_b) sc[j][2] = -INFINITY;
          if (s + 1 > lim_b) sc[j][3] = -INFINITY;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
      }
      float mc[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        mc[i] = mx[i] * scale_log2;
        // subtract first: m * c - mc fused into one fma leaves the rounding
        // of m * c, ~1e22 while m is still kNegInf, and 2^that is inf
        const float alpha = ex2((m[i] - mx[i]) * scale_log2);
        m[i] = mx[i];
        l[i] *= alpha;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          acc[j][2 * i] *= alpha;
          acc[j][2 * i + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = ex2(fmaf(sc[j][e], scale_log2, -mc[e >> 1]));
        l[0] += sc[j][0] + sc[j][1];
        l[1] += sc[j][2] + sc[j][3];
      }
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
        const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]), pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < ND; j += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, vs + (sw0 + 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + 8 * j +
                                    (lane >> 4) * 8);
          mma_bf16(acc[j], pa, bf[0], bf[1]);
          mma_bf16(acc[j + 1], pa, bf[2], bf[3]);
        }
      }
    }
    if constexpr (F8) __syncthreads();  // the bf16 tile is consumed before the next convert
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the tiles: the epilogue reuses their memory

  // epilogue: each warp's state to shared memory, then merged per row
  // (decode: the four warps' slot ranges), normalized or written as the
  // split's partial
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  float* acc_s = reinterpret_cast<float*>(smem);  // [warp][16][ACC_LD]
  float* ml_s = acc_s + kWarps * 16 * Sm::ACC_LD; // [warp][16][2]
  {
    float* a = acc_s + warp * 16 * Sm::ACC_LD;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<float2*>(a + gid * Sm::ACC_LD + 8 * j + 2 * tig) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(a + (gid + 8) * Sm::ACC_LD + 8 * j + 2 * tig) = make_float2(acc[j][2], acc[j][3]);
    }
    if (tig == 0) {
      float* ml = ml_s + warp * 32;
      ml[2 * gid] = m[0];
      ml[2 * gid + 1] = l[0];
      ml[2 * (gid + 8)] = m[1];
      ml[2 * (gid + 8) + 1] = l[1];
    }
  }
  __syncthreads();
  for (int i = tid; i < BR * HS; i += kThreads) {
    const int rr = i / HS, d = i % HS, r = row0 + rr;
    if (r >= rows) break;
    float mm, ll, aa;
    if constexpr (SW == 1) {
      const int w = rr >> 4, rw = rr & 15;
      mm = ml_s[w * 32 + 2 * rw];
      ll = ml_s[w * 32 + 2 * rw + 1];
      aa = acc_s[(w * 16 + rw) * Sm::ACC_LD + d];
    } else {
      mm = kNegInf;
#pragma unroll
      for (int w = 0; w < SW; ++w) mm = fmaxf(mm, ml_s[w * 32 + 2 * rr]);
      ll = 0.f;
      aa = 0.f;
#pragma unroll
      for (int w = 0; w < SW; ++w) {
        const float e = ex2((ml_s[w * 32 + 2 * rr] - mm) * scale_log2);
        ll = fmaf(ml_s[w * 32 + 2 * rr + 1], e, ll);
        aa = fmaf(acc_s[(w * 16 + rr) * Sm::ACC_LD + d], e, aa);
      }
    }
    if (n_split == 1) {
      out[(((size_t)b * t + r / g) * h + kh * g + r % g) * HS + d] = __float2bfloat16(aa / ll);
    } else {
      const size_t slot = ((size_t)bk * n_split + c) * rows + r;
      part_acc[slot * HS + d] = aa;
      if (d == 0) {
        part_ml[2 * slot] = mm * scale_log2;  // in log2 units, as the merge takes it
        part_ml[2 * slot + 1] = ll;
      }
    }
  }
}

// ---------------------------------------------------------------- f32 q

// 16 loaded bytes -> 4 floats, or 16 e4m3 (uint8 storage) as floats
template <int N>
__device__ __forceinline__ void unpack16(uint4 raw, float (&out)[N]) {
  if constexpr (N == 4) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = f[e];
  } else {  // 16 e4m3: the low byte of each pair is the first value
    const __nv_fp8x2_storage_t* p = reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const __half2 hh(__nv_cvt_fp8x2_to_halfraw2(p[e], __NV_E4M3));
      const float2 f = __half22float2(hh);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  }
}

// TC: the cache (float, or uint8 holding e4m3 bits). RPW: query rows a warp.
template <typename TC, int HS, int RPW>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const TC* __restrict__ k, const TC* __restrict__ v,
                 const int* __restrict__ pos0, float* __restrict__ out, float* __restrict__ part_ml,
                 float* __restrict__ part_acc, int t, int h, int kvh, int s_len, int n_split, float scale) {
  constexpr int ROWS = kWarps * RPW;
  constexpr int DPL = (HS + 31) / 32;  // output dims a lane
  __shared__ __align__(16) float q_s[ROWS][HS];
  __shared__ float k_s[kSB][HS + 1];
  __shared__ float v_s[kSB][HS];
  __shared__ float p_s[kWarps][kSB];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = h / kvh;
  const int rows = t * g;
  const int bk = blockIdx.z, b = bk / kvh, kh = bk % kvh, c = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int p0 = pos0[b];
  const int s_end = row_limit(p0, min(row0 + ROWS, rows) - 1, g, s_len);
  const int len = split_len(p0, t, s_len, n_split);
  const int s_lo = c * len;
  const int s_hi = min(s_lo + len, s_end + 1);
  if (s_lo >= s_hi) return;

  for (int i = threadIdx.x; i < ROWS * HS; i += blockDim.x) {
    const int rr = i / HS, dd = i % HS, r = row0 + rr;
    float val = 0.f;
    if (r < rows) {
      const int tok = r / g, head = kh * g + r % g;
      val = q[(((size_t)b * t + tok) * h + head) * HS + dd] * scale;
    }
    q_s[rr][dd] = val;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
  }

  const size_t base = ((size_t)b * kvh + kh) * (size_t)s_len * HS;
  // K/V tiles move 16 bytes a load; a thread holds the next tile's loads
  // in registers while the block computes on the current one
  constexpr int VEC = 16 / sizeof(TC);
  constexpr int ROW_CHUNKS = HS / VEC;
  constexpr int CHUNKS = kSB * ROW_CHUNKS;
  constexpr int PER_THREAD = (CHUNKS + kThreads - 1) / kThreads;
  uint4 kr[PER_THREAD], vr[PER_THREAD];
  auto fetch = [&](int s0) {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int ch = threadIdx.x + j * kThreads;
      const int s = s0 + ch / ROW_CHUNKS, dd = (ch % ROW_CHUNKS) * VEC;
      if (ch < CHUNKS && s < s_hi) {
        kr[j] = __ldg(reinterpret_cast<const uint4*>(k + base + (size_t)s * HS + dd));
        vr[j] = __ldg(reinterpret_cast<const uint4*>(v + base + (size_t)s * HS + dd));
      } else {
        kr[j] = make_uint4(0u, 0u, 0u, 0u);
        vr[j] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  fetch(s_lo);
  for (int s0 = s_lo; s0 < s_hi; s0 += kSB) {
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int ch = threadIdx.x + j * kThreads;
      if (ch < CHUNKS) {
        const int ss = ch / ROW_CHUNKS, dd = (ch % ROW_CHUNKS) * VEC;
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
    if (s0 + kSB < s_hi) fetch(s0 + kSB);

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int rr = warp * RPW + i, r = row0 + rr;
      if (r < rows) {  // uniform across the warp
        const int pr = row_limit(p0, r, g, s_len);
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
      if (n_split == 1) {
        float* o = out + (((size_t)b * t + r / g) * h + kh * g + r % g) * HS;
        const float inv = 1.f / l[i];
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int dd = lane + 32 * j;
          if (dd < HS) o[dd] = acc[i][j] * inv;
        }
      } else {
        const size_t slot = ((size_t)bk * n_split + c) * rows + r;
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int dd = lane + 32 * j;
          if (dd < HS) part_acc[slot * HS + dd] = acc[i][j];
        }
        if (lane == 0) {
          part_ml[2 * slot] = m[i] * kLog2e;  // the scores were scaled: natural units to log2
          part_ml[2 * slot + 1] = l[i];
        }
      }
    }
  }
}

// ---------------------------------------------------------------- merge

// The partials of the splits row r can see, c <= row_limit / len (each
// holds at least one visible slot), weighed by 2^(m_c - max m); m is in
// log2 units. A block of 128 threads takes 128 / (HS / 4 * sg) rows of one
// kv head; a thread takes four output values of a row and every sg-th of
// its splits, keeping its own running (m, l, acc), and the sg groups of a
// row combine in shared memory. sg (a power of two, at most n_split) keeps
// the serial chain of loads short when a decode step has many splits and
// few rows. Index math stays in 32 bits with HS a constant: 64-bit
// divisions per value cost more than the bytes.
template <typename TQ, int HS>
__global__ void __launch_bounds__(128)
flash_merge_kernel(const int* __restrict__ pos0, const float* __restrict__ part_ml,
                   const float* __restrict__ part_acc, TQ* __restrict__ out, int t, int h, int kvh, int s_len,
                   int n_split, int log2_sg) {
  constexpr int TPR = HS / 4;  // threads a row and split group
  __shared__ float4 acc_s[128];
  __shared__ float2 ml_s[128];
  const int sg = 1 << log2_sg, rpb = 128 / (TPR * sg);
  const int g = h / kvh, rows = t * g;
  const int bk = blockIdx.y, b = bk / kvh, kh = bk % kvh;
  const int tid = threadIdx.x, d = (tid % TPR) * 4, grp = (tid / TPR) & (sg - 1);
  const int r = blockIdx.x * rpb + tid / (TPR * sg);
  float m = kNegInf, l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r < rows) {
    const int p0 = pos0[b];
    const int used = min(row_limit(p0, r, g, s_len) / split_len(p0, t, s_len, n_split) + 1, n_split);
    const size_t slot0 = (size_t)bk * n_split * rows + r;
#pragma unroll 2
    for (int c = grp; c < used; c += sg) {
      const size_t slot = slot0 + (size_t)c * rows;
      const float mc = part_ml[2 * slot], lc = part_ml[2 * slot + 1];
      const float4 v = *reinterpret_cast<const float4*>(part_acc + slot * HS + d);
      const float mn = fmaxf(m, mc), s0 = exp2f(m - mn), s1 = exp2f(mc - mn);
      l = fmaf(l, s0, lc * s1);
      a = make_float4(fmaf(a.x, s0, v.x * s1), fmaf(a.y, s0, v.y * s1), fmaf(a.z, s0, v.z * s1),
                      fmaf(a.w, s0, v.w * s1));
      m = mn;
    }
  }
  acc_s[tid] = a;
  ml_s[tid] = make_float2(m, l);
  __syncthreads();
  if (r >= rows || grp != 0) return;
  float mx = kNegInf;
  for (int j = 0; j < sg; ++j) mx = fmaxf(mx, ml_s[tid + j * TPR].x);
  float ll = 0.f;
  float4 aa = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < sg; ++j) {
    const float w = exp2f(ml_s[tid + j * TPR].x - mx);
    const float4 v = acc_s[tid + j * TPR];
    ll = fmaf(ml_s[tid + j * TPR].y, w, ll);
    aa = make_float4(fmaf(v.x, w, aa.x), fmaf(v.y, w, aa.y), fmaf(v.z, w, aa.z), fmaf(v.w, w, aa.w));
  }
  const float inv = 1.f / ll;
  TQ* o = out + (((size_t)b * t + r / g) * h + kh * g + r % g) * HS + d;
  store(o, aa.x * inv);
  store(o + 1, aa.y * inv);
  store(o + 2, aa.z * inv);
  store(o + 3, aa.w * inv);
}

// ---------------------------------------------------------------- launch

template <typename TQ, int HS>
cudaError_t launch_merge(const int* pos0, const float* part_ml, const float* part_acc, void* out, int b, int t,
                         int h, int kvh, int s_len, int n_split, cudaStream_t stream) {
  constexpr int GROUPS = 128 / (HS / 4);  // rows x split groups a block
  int log2_sg = 0;                         // split groups: up to n_split / 4, within the block
  while ((2 << log2_sg) <= GROUPS && (8 << log2_sg) <= n_split) ++log2_sg;
  const int rpb = GROUPS >> log2_sg;
  const int rows = t * (h / kvh);
  const dim3 grid((unsigned)((rows + rpb - 1) / rpb), (unsigned)(b * kvh));
  flash_merge_kernel<TQ, HS><<<grid, 128, 0, stream>>>(pos0, part_ml, part_acc, static_cast<TQ*>(out), t, h, kvh,
                                                       s_len, n_split, log2_sg);
  return cudaGetLastError();
}

template <typename TC, int HS, int SW>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const int* pos0, void* out, float* part_ml,
                       float* part_acc, int b, int t, int h, int kvh, int s_len, int n_split, cudaStream_t stream) {
  constexpr int BR = 16 * (kWarps / SW);
  constexpr int BYTES = MmaSmem<TC, HS>::BYTES;
  static bool sized = false;  // above 48 KB a block's shared memory must be asked for
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(flash_mma_kernel<TC, HS, SW>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const int rows = t * (h / kvh);
  const dim3 grid((unsigned)((rows + BR - 1) / BR), (unsigned)n_split, (unsigned)(b * kvh));
  flash_mma_kernel<TC, HS, SW><<<grid, kThreads, BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TC*>(k), static_cast<const TC*>(v), pos0,
      static_cast<__nv_bfloat16*>(out), part_ml, part_acc, t, h, kvh, s_len, n_split,
      kLog2e / sqrtf((float)HS));
  return cudaGetLastError();
}

template <typename TC, int HS, int RPW>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const int* pos0, void* out, float* part_ml,
                       float* part_acc, int b, int t, int h, int kvh, int s_len, int n_split, cudaStream_t stream) {
  const int rows = t * (h / kvh);
  const dim3 grid((unsigned)((rows + kWarps * RPW - 1) / (kWarps * RPW)), (unsigned)n_split, (unsigned)(b * kvh));
  flash_f32_kernel<TC, HS, RPW><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const TC*>(k), static_cast<const TC*>(v), pos0, static_cast<float*>(out),
      part_ml, part_acc, t, h, kvh, s_len, n_split, 1.f / sqrtf((float)HS));
  return cudaGetLastError();
}

// the split pass for one head size (block_rows picks the variant), then the
// merge where there are splits to merge
template <typename TQ, typename TC, int HS>
cudaError_t launch_split(const void* q, const void* k, const void* v, const int* pos0, void* out, float* part_ml,
                         float* part_acc, int b, int t, int h, int kvh, int s_len, int block_rows, int n_split,
                         cudaStream_t s) {
  cudaError_t e = cudaErrorInvalidValue;
  if constexpr (sizeof(TQ) == 2) {  // bf16 q: tensor cores
    if (block_rows == 16) e = launch_mma<TC, HS, 4>(q, k, v, pos0, out, part_ml, part_acc, b, t, h, kvh, s_len, n_split, s);
    if (block_rows == 64) e = launch_mma<TC, HS, 1>(q, k, v, pos0, out, part_ml, part_acc, b, t, h, kvh, s_len, n_split, s);
  } else {  // f32 q: CUDA cores
    if (block_rows == kWarps) e = launch_f32<TC, HS, 1>(q, k, v, pos0, out, part_ml, part_acc, b, t, h, kvh, s_len, n_split, s);
    if (block_rows == 4 * kWarps) e = launch_f32<TC, HS, 4>(q, k, v, pos0, out, part_ml, part_acc, b, t, h, kvh, s_len, n_split, s);
  }
  if (e != cudaSuccess || n_split == 1) return e;
  return launch_merge<TQ, HS>(pos0, part_ml, part_acc, out, b, t, h, kvh, s_len, n_split, s);
}

template <typename TQ, typename TC>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos0, void* out, float* part_ml,
                   float* part_acc, int b, int t, int h, int kvh, int s_len, int hs, int block_rows, int n_split,
                   cudaStream_t s) {
  switch (hs) {
    case 16: return launch_split<TQ, TC, 16>(q, k, v, pos0, out, part_ml, part_acc, b, t, h, kvh, s_len, block_rows, n_split, s);
    case 32: return launch_split<TQ, TC, 32>(q, k, v, pos0, out, part_ml, part_acc, b, t, h, kvh, s_len, block_rows, n_split, s);
    case 64: return launch_split<TQ, TC, 64>(q, k, v, pos0, out, part_ml, part_acc, b, t, h, kvh, s_len, block_rows, n_split, s);
    case 128: return launch_split<TQ, TC, 128>(q, k, v, pos0, out, part_ml, part_acc, b, t, h, kvh, s_len, block_rows, n_split, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (b, t, h, hs) and out: (b, t, h, hs) of q_dtype, f32 (0) or bf16 (1);
// k, v: (b, kvh, s_len, hs) of cache_dtype, the same as q_dtype, or e4m3 (2).
// pos0: (b,) int32 on the device. block_rows and n_split: the wrapper's
// split_plan (bf16 q: 16 or 64 rows a block; f32 q: 4 or 16). With n_split
// > 1, part_ml (b * kvh, n_split, t * h / kvh, 2) and part_acc (the same,
// hs) are f32 scratch, and a merge launch follows the split pass. Returns
// the first failing launch's cudaError_t, else 0.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, const void* pos0, void* out,
                                      void* part_ml, void* part_acc, int q_dtype, int cache_dtype, int b, int t,
                                      int h, int kvh, int s_len, int hs, int block_rows, int n_split,
                                      void* stream) {
  if (b < 1 || t < 1 || kvh < 1 || h % kvh || s_len < 1 || n_split < 1 ||
      (n_split > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos0);
  float* pm = static_cast<float*>(part_ml);
  float* pa = static_cast<float*>(part_acc);
  if (q_dtype == 0 && cache_dtype == 0)
    return (int)launch<float, float>(q, k, v, p, out, pm, pa, b, t, h, kvh, s_len, hs, block_rows, n_split, s);
  if (q_dtype == 1 && cache_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, p, out, pm, pa, b, t, h, kvh, s_len, hs, block_rows,
                                                     n_split, s);
  if (q_dtype == 0 && cache_dtype == 2)
    return (int)launch<float, uint8_t>(q, k, v, p, out, pm, pa, b, t, h, kvh, s_len, hs, block_rows, n_split, s);
  if (q_dtype == 1 && cache_dtype == 2)
    return (int)launch<__nv_bfloat16, uint8_t>(q, k, v, p, out, pm, pa, b, t, h, kvh, s_len, hs, block_rows,
                                               n_split, s);
  return (int)cudaErrorInvalidValue;
}
