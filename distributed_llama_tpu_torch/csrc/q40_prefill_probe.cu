// Q40 prefill-chunk matmul with the dequantize and the tensor-core product
// on separate warps, for Hopper (sm_90a): the unpack/MMA overlap probe.
//
// Replaces: tools/exp_unpack_overlap.py matmul_sub (the pallas_call at
// exp_unpack_overlap.py:86), the probe behind the JAX package's sub-tiled
// prefill path (ops/pallas_q40.py _n_sub). Its question on this card:
// does dequantizing one piece of the weight while the tensor cores consume
// the previous piece pay, against dequantize-then-multiply. K1's tensor-core
// path (csrc/q40_matmul.cu) answers it one way, the same warps dequantizing
// into wgmma's A registers and issuing the MMAs; this kernel tests the
// other: warps that only dequantize into shared memory, and warps that only
// issue wgmma from it.
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
// Design. A CTA owns td weight rows (64 or 128) x 256 tokens (all of a
// 256-token chunk: each weight is dequantized once) and walks N. Warp-
// specialised: td / 64 MMA warpgroups and one dequantize warpgroup:
//  * the producer, thread 0 of MMA warpgroup 0, keeps a ring of TMA stages
//    full (5 at td 128, 6 at td 64: what fits beside the A ring),
//    refilling a slot once its own warpgroup has released it and the
//    slot's empty barrier completes. A stage is 64 values of N: x, 256
//    tokens x 128 bytes with the 128-byte swizzle (wgmma's B operand), and
//    the packed weight tile, td rows x 32 bytes. Tokens past t arrive as zeros (TMA's out-of-bounds fill). The
//    f16 scales are not in the stage: a TMA box needs 16 bytes a row and a
//    stage's two blocks hold 4; the dequantize warps read 8 blocks (16
//    bytes) a row straight from device memory, one 256-value group ahead.
//  * the dequantize warpgroup issues no MMA (a thread a row; at td 64 its
//    last two warps only keep the barriers). It turns the packed bytes into
//    bf16(nib * s), rounded once, into a second ring: one 128-value chunk
//    of the weight in wgmma's K-major 128-byte-swizzled A layout, cut along
//    N into n_sub sub-tiles of 128 / n_sub values, each with its own full
//    and empty mbarriers. A nibble becomes nib * s in f32 without a convert
//    (PRMT into 0x4B000000, one exact FMA) and one cvt.rn packs two. A
//    thread loads its row's blocks of a stage into registers as soon as the
//    stage lands and frees it at once.
//  * the MMA warpgroups (td / 64 of them: wgmma's M is 64) issue
//    wgmma.mma_async m64n256k16 with A and B both from shared memory (the
//    SS form) into 128 f32 sums a thread. A sub-tile's buffer and an x
//    stage are released once wgmma.wait_group says the wgmmas that read
//    them are done. No setmaxnreg: ptxas allocates every path of a kernel
//    within the launch's cap (65536 / threads), so the MMA warps' 128 sums
//    and a wgmma's operands (154 registers) need at most 384 threads (168
//    a thread); a fourth warpgroup (cap 128) does not compile. So the
//    producer shares a warp with other work. A producer warp beside 3
//    dequantize warps (two rows a thread on one of them) left the
//    dequantize the bottleneck (0.0806 ms at td 128 n_sub 4, against 0.0522
//    with no dequantize at all); a producer in a dequantize warp tied the
//    loads to the A ring's hand-offs (0.1112), and one in an MMA warp that
//    polls the empty barriers instead of blocking on them slowed its
//    warpgroup more (0.0912; H100 at 700 W). Multicasting x to pairs of
//    row tiles (2-CTA clusters) timed the same as loading it per CTA
//    (0.0714 against 0.0713 at td 128 n_sub 2) and was dropped: the L2
//    reads of x do not bound it.
// n_sub keeps the probe's question:
//  * n_sub = 1, the control: the A ring is one buffer, the whole chunk;
//    the MMA warps wait for the chunk's wgmmas to retire before they
//    release it, so the dequantize of chunk c + 1 never overlaps the MMAs
//    of chunk c.
//  * n_sub = 2, 4, 8: sub-tiles of 64, 32, 16 values; the dequantize warps
//    write sub-tile i + 1 (up to n_sub - 1 ahead) while the wgmmas of
//    sub-tile i are in flight; the MMA warps keep one commit group in
//    flight while they wait for the one before. n_sub = 8 is 16 values, one
//    k16 step, half of each Q40 block (its low or its high nibbles).
// The -8 correction is exact in its terms: -8 s is exact in tf32 (an f16
// scale has 11 significant bits) and xsum is rounded to tf32 (cvt.rna,
// 2^-11 relative) by the first, small launch of the call that sums x's
// blocks. After the main loop the rings are reused: TMA brings xsum, 256
// tokens x 32 blocks a piece (128-byte swizzle), the dequantize warps
// write -8 s in the same layout, and the MMA warps add wgmma tf32
// m64n256k8 products into the same sums. The epilogue transposes the sums
// through shared memory into (t, d) rows. No atomics: a repeated launch
// gives the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int kBN = 256;          // tokens a CTA: wgmma's widest N
constexpr int kXK = 64;           // N values a TMA stage: one 128-byte swizzle row of bf16
constexpr int kChunk = 128;       // N values a chunk of the A ring (cut into n_sub sub-tiles)
constexpr int kXBytes = kBN * kXK * 2;
constexpr int kPiece = 32;        // Q40 blocks a piece of the -8 correction (128 bytes of f32)
constexpr int kPieces = 4;        // pieces a round of the correction

constexpr int kSmemMax = 227 * 1024;  // dynamic shared memory a block can have
constexpr int kDeqWarps = 4;          // the dequantize warpgroup

template <int TD>
struct Cfg {
  static constexpr int NWG = TD / 64;                 // MMA warpgroups
  static constexpr int DEQ = NWG;                     // the dequantize warpgroup's index
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int WBYTES = TD * kXK / 2;         // packed tile of a stage
  static constexpr int ABYTES = TD * kChunk * 2;      // the A ring: one chunk
  static constexpr int STAGE = kXBytes + WBYTES;
  // as many TMA stages (at most 6) as fit beside the A ring
  static constexpr int FIT = (kSmemMax - ABYTES - 2048) / STAGE;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int X0 = 0, W0 = STAGES * kXBytes, A0 = W0 + STAGES * WBYTES;
  static constexpr int MAIN = A0 + ABYTES;
  // the correction: xsum pieces over the x ring, -8 s pieces after them
  static constexpr int CS0 = kPieces * kXBytes;
  static constexpr int CORR = CS0 + kPieces * TD * 128;
  static constexpr int BAR = MAIN > CORR ? MAIN : CORR;
  static constexpr int SMEM = BAR + 256 + 1024;       // + barriers, + alignment slack
  static_assert(STAGES >= 4, "two chunks of TMA stages in flight");
  static_assert(2 * kBN * 72 * 2 <= BAR, "the epilogue's transpose fits");
  static_assert(SMEM <= kSmemMax, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
// a wait that has not completed after ~2 s traps (a launch error the
// wrapper reports) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 == 0) t0 = now;
    else if (now - t0 > 4000000000LL) __trap();
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
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
// generic-proxy writes to shared memory made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// descriptor of a K-major tile with the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart; the start may step by 32 bytes
// (one k16 bf16 or k8 tf32 step) inside a 1024-aligned atom
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d[64 x 256] += A[64 x 16] * B[16 x 256], bf16, both from shared memory
__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 256] += A[64 x 8] * B[8 x 256], tf32, both from shared memory
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1;\n}\n"
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
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(f));
  return r;
}

// xsum[t, b] = the sum of x[t, 32b .. 32b + 31] in f32, rounded to tf32,
// one thread each
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
  xsum[i] = __uint_as_float(to_tf32(s));
}

// the f16 scale of block b (0..7) of a 16-byte group of 8
// (selects, not an indexed load: a runtime index would put sc in local memory)
__device__ __forceinline__ float scale_of(const uint4& sc, int b) {
  const uint32_t w = b < 2 ? sc.x : b < 4 ? sc.y : b < 6 ? sc.z : sc.w;
  return __half2float(__ushort_as_half((unsigned short)(w >> (16 * (b & 1)))));
}

// 8 nibbles (the low or high ones of 8 bytes, in byte order) -> 8 bf16
// bf16(nib * s) as 4 words: PRMT puts a nibble into 0x4B00000n (2^23 +
// nib), one FMA with s and -2^23 s gives nib * s exactly, cvt.rn rounds
__device__ __forceinline__ uint4 dq8(uint32_t w0, uint32_t w1, bool hi, float s, float c) {
  const uint32_t m0 = (hi ? w0 >> 4 : w0) & 0x0F0F0F0Fu, m1 = (hi ? w1 >> 4 : w1) & 0x0F0F0F0Fu;
  uint32_t o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t m = e < 2 ? m0 : m1;
    const int b = (e & 1) * 2;
    const float f0 = __fmaf_rn(__uint_as_float(__byte_perm(m, 0x4B000000u, 0x7440u | b)), s, c);
    const float f1 = __fmaf_rn(__uint_as_float(__byte_perm(m, 0x4B000000u, 0x7440u | (b + 1))), s, c);
    const __nv_bfloat162 v = __floats2bfloat162_rn(f0, f1);
    o[e] = *reinterpret_cast<const uint32_t*>(&v);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// One thread's share of a sub-tile: row `row`, values [K0, K0 + VPT) of a
// chunk, from the row's 4 packed blocks of the chunk in q4 and their
// scales s4 (with cs4 = -2^23 s), into the A ring at a0.
template <int TD, int K0, int VPT>
__device__ __forceinline__ void dequant_share(const uint4 (&q4)[4], const float (&s4)[4], const float (&cs4)[4],
                                              uint8_t* a0, int row) {
  static_assert(K0 % 16 == 0 && VPT % 16 == 0, "whole halves of Q40 blocks");
#pragma unroll
  for (int kk = K0; kk < K0 + VPT; kk += 8) {   // 8 values: bytes kk % 16 .. + 7, low or high nibbles
    const uint4& q = q4[kk / 32];
    const bool second = (kk % 16) == 8;
    const uint4 v = dq8(second ? q.z : q.x, second ? q.w : q.y, (kk % 32) >= 16, s4[kk / 32], cs4[kk / 32]);
    const int atom = kk / 64, c8 = (kk % 64) / 8;
    *reinterpret_cast<uint4*>(a0 + atom * (TD * 128) + row * 128 + ((c8 ^ (row & 7)) * 16)) = v;
  }
}

// f(std::integral_constant<int, 0>{}), ..., f(<N - 1>): a loop whose index
// is a constant expression
template <typename F, int... Is>
__device__ __forceinline__ void static_for_impl(F&& f, std::integer_sequence<int, Is...>) {
  (f(std::integral_constant<int, Is>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

// does [lo, lo + len) hold value v
__host__ __device__ constexpr bool holds(int lo, int len, int v) { return v >= lo && v < lo + len; }

template <int TD, int NSUB>
__global__ void __launch_bounds__(Cfg<TD>::THREADS, 1)
q40_sub_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
               const __grid_constant__ CUtensorMap s_map, const __half* __restrict__ scales,
               __nv_bfloat16* __restrict__ out, int t, int n, int d) {
  using C = Cfg<TD>;
  constexpr int KS = kChunk / NSUB;   // values a sub-tile
  constexpr int kStages = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment for the 128-byte swizzle's pattern
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sb = smem_u32(smem);
  const uint32_t bar = sb + C::BAR;
  auto x_full = [&](int s) { return bar + 8 * s; };
  auto x_empty = [&](int s) { return bar + 8 * (kStages + s); };
  auto a_full = [&](int i) { return bar + 8 * (2 * kStages + i); };
  auto a_empty = [&](int i) { return bar + 8 * (2 * kStages + NSUB + i); };
  const uint32_t corr_full = bar + 8 * (2 * kStages + 2 * NSUB);

  const int tok0 = blockIdx.x * kBN, row0 = blockIdx.y * TD;
  const int n_chunks = n / kChunk, nb = n / 32;
  const int n_pieces = (nb + kPiece - 1) / kPiece, rounds = (n_pieces + kPieces - 1) / kPieces;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(x_full(s), 1);
      mbar_init(x_empty(s), kDeqWarps + 4 * C::NWG);   // a warp each: dequantize, MMA
    }
    for (int i = 0; i < NSUB; ++i) {
      mbar_init(a_full(i), kDeqWarps);
      mbar_init(a_empty(i), 4 * C::NWG);
    }
    mbar_init(corr_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Each role runs to the end on its own path; the phases of the -8
  // correction meet at named barrier 1 (all threads), twice a round: once
  // the rings are free, and once -8 s is written.
  if (wg == C::DEQ) {
    // ---- dequantize: thread tid owns row tid (td 64: warps 2-3 keep only the barriers) ----
    const int row = min(tid, TD - 1);
    const bool mine = tid < TD;
    const __half* srow = scales + (size_t)(row0 + row) * nb;
    uint4 sc = make_uint4(0u, 0u, 0u, 0u), sc_next = __ldg(reinterpret_cast<const uint4*>(srow));
    for (int c = 0; c < n_chunks; ++c) {
      if ((c & 1) == 0) {   // a new 256-value group: its scales, and the next group's in flight
        sc = sc_next;
        if (2 * (c / 2 + 1) < n_chunks) sc_next = __ldg(reinterpret_cast<const uint4*>(srow + 8 * (c / 2 + 1)));
      }
      const int j0 = 2 * c;   // the chunk's x stages: j0, j0 + 1
      // the row's 4 blocks of the chunk and their scales, into registers:
      // each stage's two blocks once the stage has landed (at the first
      // sub-tile that needs it), the stage freed right after the loads
      uint4 q4[4];
      float s4[4], cs4[4];
      const uint32_t sw[2] = {(c & 1) ? sc.z : sc.x, (c & 1) ? sc.w : sc.y};
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s4[b] = __half2float(__ushort_as_half((unsigned short)(sw[b / 2] >> (16 * (b & 1)))));
        cs4[b] = s4[b] * -8388608.f;
      }
      auto load_stage = [&](int m) {
        mbar_wait(x_full((j0 + m) % kStages), ((j0 + m) / kStages) & 1);
#pragma unroll
        for (int b = 2 * m; b < 2 * m + 2; ++b)
          q4[b] = *reinterpret_cast<const uint4*>(smem + C::W0 + ((j0 + m) % kStages) * C::WBYTES +
                                                  row * (kXK / 2) + (b & 1) * 16);
        __syncwarp();
        if (lane == 0) mbar_arrive(x_empty((j0 + m) % kStages));
      };
      static_for<NSUB>([&](auto I) {
        constexpr int i = decltype(I)::value;
#pragma unroll
        for (int m = 0; m < 2; ++m)   // the stages whose first value is in this sub-tile
          if (holds(i * KS, KS, kXK * m)) load_stage(m);
        mbar_wait(a_empty(i), (c & 1) ^ 1);
        if (mine) dequant_share<TD, i * KS, KS>(q4, s4, cs4, smem + C::A0, row);
        fence_async_smem();
        __syncwarp();
        if (lane == 0) mbar_arrive(a_full(i));
      });
    }
    for (int r = 0; r < rounds; ++r) {   // -8 s: 4 blocks (16 bytes) a store
      const int p0 = r * kPieces, np = min(kPieces, n_pieces - p0);
      named_sync(1, C::THREADS);
      for (int p = 0; p < np && mine; ++p) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {   // 8 blocks: one 16-byte scale load
          const int b0 = (p0 + p) * kPiece + 8 * q;
          const uint4 s8 = b0 < nb ? __ldg(reinterpret_cast<const uint4*>(srow + b0)) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = __float_as_uint(-8.f * scale_of(s8, 4 * h + e));
            const int c16 = 2 * q + h;   // 16-byte chunk of the 128-byte row
            *reinterpret_cast<uint4*>(smem + C::CS0 + p * (TD * 128) + row * 128 + ((c16 ^ (row & 7)) * 16)) =
                make_uint4(v[0], v[1], v[2], v[3]);
          }
        }
      }
      fence_async_smem();
      named_sync(1, C::THREADS);
    }
    return;
  }

  // ---- MMA: warpgroup wg owns rows row0 + 64 wg .. + 63 ----
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  const uint32_t a_wg = sb + C::A0 + wg * 64 * 128;
  // the producer: thread 0 of warpgroup 0 issues stage j's TMA loads; a
  // slot is refilled once its own warpgroup has released it and its empty
  // barrier completes
  const bool producer = wg == 0 && tid == 0;
  const int n_xst = n / kXK;
  auto issue = [&](int j) {
    const int s = j % kStages;
    mbar_expect_tx(x_full(s), kXBytes + C::WBYTES);
    tma_load_2d(sb + C::X0 + s * kXBytes, &x_map, x_full(s), j * kXK, tok0);
    tma_load_2d(sb + C::W0 + s * C::WBYTES, &w_map, x_full(s), j * (kXK / 2), row0);
  };
  int next = min(kStages, n_xst);   // the next stage to issue
  if (producer)
    for (int j = 0; j < next; ++j) issue(j);
  // release sub-tile i of chunk c: its A buffer, and the x stages whose
  // last value it holds (a warp each); then the refills
  auto release = [&](int c, int i) {
    if (lane != 0) return;
    mbar_arrive(a_empty(i));
    int done = -1;
#pragma unroll
    for (int m = 0; m < 2; ++m)
      if (holds(i * KS, KS, kXK * m + kXK - 1)) {
        mbar_arrive(x_empty((2 * c + m) % kStages));
        done = 2 * c + m;
      }
    if (producer)
      for (; next < n_xst && next - kStages <= done; ++next) {
        mbar_wait(x_empty(next % kStages), ((next / kStages) & 1) ^ 1);
        issue(next);
      }
  };
  for (int c = 0; c < n_chunks; ++c) {
    static_for<NSUB>([&](auto I) {
      constexpr int i = decltype(I)::value;
      mbar_wait(a_full(i), c & 1);
#pragma unroll
      for (int m = 0; m < 2; ++m)
        if (holds(i * KS, KS, kXK * m)) mbar_wait(x_full((2 * c + m) % kStages), ((2 * c + m) / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int k = i * KS; k < (i + 1) * KS; k += 16) {
        const int s = (2 * c + k / kXK) % kStages;
        wgmma_ss_bf16(acc, desc128(a_wg + (k / kXK) * (TD * 128) + (k % kXK) * 2),
                      desc128(sb + C::X0 + s * kXBytes + (k % kXK) * 2));
      }
      wgmma_commit();
      if constexpr (NSUB == 1) {   // the control: the chunk's wgmmas retire before its buffer is freed
        wgmma_wait<0>();
        release(c, i);
      } else {   // one group in flight: free the one before
        wgmma_wait<1>();
        if (i > 0) release(c, i - 1);
        else if (c > 0) release(c - 1, NSUB - 1);
      }
    });
  }
  wgmma_wait<0>();

  // ---- the -8 correction: acc += (-8 s) . xsum in tf32, rounds of up to
  // kPieces pieces of 32 blocks in the freed rings ----
  for (int r = 0; r < rounds; ++r) {
    const int p0 = r * kPieces, np = min(kPieces, n_pieces - p0);
    named_sync(1, C::THREADS);   // the rings are free
    if (producer) {   // xsum: 256 tokens x 32 blocks a piece
      mbar_expect_tx(corr_full, np * kXBytes);
      for (int p = 0; p < np; ++p)
        tma_load_2d(sb + C::X0 + p * kXBytes, &s_map, corr_full, (p0 + p) * kPiece, tok0);
    }
    named_sync(1, C::THREADS);   // -8 s is written
    mbar_wait(corr_full, r & 1);
    wgmma_fence();
    for (int p = 0; p < np; ++p) {
#pragma unroll
      for (int k = 0; k < kPiece; k += 8) {
        if ((p0 + p) * kPiece + k < nb)
          wgmma_ss_tf32(acc, desc128(sb + C::CS0 + p * (TD * 128) + wg * 64 * 128 + k * 4),
                        desc128(sb + C::X0 + p * kXBytes + k * 4));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
  }
  named_sync(2, 128 * C::NWG);   // every MMA warpgroup is done with xsum

  // ---- epilogue: this warpgroup's 64 rows x 256 tokens, transposed through
  // shared memory to [token][64 rows] (72-element rows: no bank conflicts) ----
  constexpr int LD = 72;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(smem) + wg * kBN * LD;
  const int g = lane / 4, q = lane % 4, r0 = 16 * warp + g;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int tk = 8 * j + 2 * q;
    o[tk * LD + r0] = __float2bfloat16_rn(acc[4 * j + 0]);
    o[(tk + 1) * LD + r0] = __float2bfloat16_rn(acc[4 * j + 1]);
    o[tk * LD + r0 + 8] = __float2bfloat16_rn(acc[4 * j + 2]);
    o[(tk + 1) * LD + r0 + 8] = __float2bfloat16_rn(acc[4 * j + 3]);
  }
  named_sync(3 + wg, 128);
  const int piece = tid % 8, rbase = row0 + 64 * wg + piece * 8;
  for (int tk = tid / 8; tk < kBN; tk += 16) {
    const int tok = tok0 + tk;
    if (tok >= t) break;
    *reinterpret_cast<uint4*>(out + (size_t)tok * d + rbase) = *reinterpret_cast<const uint4*>(o + tk * LD + piece * 8);
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

// a 2-D map over a row-major (rows, cols) tensor, box (box_rows, box_cols);
// elements outside the tensor arrive as zeros
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

template <int TD, int NSUB>
cudaError_t launch_sub(const void* x, const void* packed, const void* scales, const float* xsum, void* out, int t,
                       int n, int d, cudaStream_t stream) {
  using C = Cfg<TD>;
  static bool configured = false;  // above 48 KB a kernel must opt in
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(q40_sub_kernel<TD, NSUB>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap xm, wm, sm;
  if (!make_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, t, n, kBN, kXK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, packed, d, n / 2, TD, kXK / 2,
                CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, xsum, t, n / 32, kBN, kPiece,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((t + kBN - 1) / kBN), (unsigned)(d / TD));
  q40_sub_kernel<TD, NSUB><<<grid, C::THREADS, C::SMEM, stream>>>(
      xm, wm, sm, static_cast<const __half*>(scales), static_cast<__nv_bfloat16*>(out), t, n, d);
  return cudaGetLastError();
}

template <int TD>
cudaError_t launch_td(int n_sub, const void* x, const void* packed, const void* scales, const float* xsum, void* out,
                      int t, int n, int d, cudaStream_t stream) {
  switch (n_sub) {
    case 1: return launch_sub<TD, 1>(x, packed, scales, xsum, out, t, n, d, stream);
    case 2: return launch_sub<TD, 2>(x, packed, scales, xsum, out, t, n, d, stream);
    case 4: return launch_sub<TD, 4>(x, packed, scales, xsum, out, t, n, d, stream);
    case 8: return launch_sub<TD, 8>(x, packed, scales, xsum, out, t, n, d, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int TD>
const void* kernel_td(int n_sub) {
  switch (n_sub) {
    case 1: return (const void*)q40_sub_kernel<TD, 1>;
    case 2: return (const void*)q40_sub_kernel<TD, 2>;
    case 4: return (const void*)q40_sub_kernel<TD, 4>;
    case 8: return (const void*)q40_sub_kernel<TD, 8>;
    default: return nullptr;
  }
}

}  // namespace

// P6. x: (t, n) bf16; packed: (d, n/2) u8 block-major; scales: (d, n/32)
// f16; xsum: (t, n/32) f32 scratch; out: (t, d) bf16. td in {64, 128} with
// d % td == 0, n_sub in {1, 2, 4, 8}, n % 256 == 0; x, packed, scales and
// xsum 16-byte aligned. Two launches: the block sums of x, then the
// product. Returns the first failing launch's cudaError_t, else 0.
extern "C" int q40_matmul_sub_launch(const void* x, const void* packed, const void* scales, void* xsum, void* out,
                                     int t, int n, int d, int n_sub, int td, void* stream) {
  if (t < 1 || n < 256 || n % 256 || (td != 64 && td != 128) || d < td || d % td) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xs = static_cast<float*>(xsum);
  const int pieces = t * (n / 32);
  xsum_kernel<<<(unsigned)((pieces + 255) / 256), 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x), xs, t, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = td == 64 ? launch_td<64>(n_sub, x, packed, scales, xs, out, t, n, d, s)
                 : launch_td<128>(n_sub, x, packed, scales, xs, out, t, n, d, s);
  return (int)err;
}

// The (td, n_sub) variant's product kernel as compiled: out[0..4] =
// registers a thread, local (spill) bytes a thread, static shared bytes,
// the dynamic shared bytes a launch asks for, threads a CTA. Returns a
// cudaError_t.
extern "C" int q40_matmul_sub_attrs(int td, int n_sub, int* out) {
  const void* k = td == 64 ? kernel_td<64>(n_sub) : td == 128 ? kernel_td<128>(n_sub) : nullptr;
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, k);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = td == 64 ? Cfg<64>::SMEM : Cfg<128>::SMEM;
  out[4] = td == 64 ? Cfg<64>::THREADS : Cfg<128>::THREADS;
  return 0;
}
