// Q80 activation round trip for Hopper (sm_90a): out = dequantize_q80(
// quantize_q80(x)) in one launch, the input of every matmul of a Q40 model
// run with the reference's Q80 activation buffers (--buffer-float-type q80).
//
// Replaces: the Q80 round trip that distributed_llama_tpu/ops/matmul.py
// applies before every matmul (:93-95) and fused_expert_matmul (:165-167)
// with quants/jax_codec.py quantize_q80_jax / dequantize_q80_jax; there XLA
// fuses it into the matmul's operand read. Not a pallas_call: a kernel here
// because the eager torch ops would be about a dozen launches per input on
// a decode step that is already bound by the host's launches.
//
// Per 32-value block, bit for bit the plain version
// (quants/torch_codec.py quantize_q80_torch, dequantize_q80_torch):
//   scale = absmax * f32(1/127)          (XLA's form of absmax / 127)
//                                        (absmax is NaN if the block holds
//                                        a NaN, as the codec's amax is)
//   inv   = scale > 0 ? 1 / scale : 0     (IEEE reciprocal, round to nearest)
//   q     = round_half_even(g * inv)      (int, |q| <= 127)
//   s16   = f16(scale)                    (the stored scale)
//   out   = f32: q * f32(s16);  bf16: bf16(q * f32(bf16(s16)))
// Every product is an explicit __fmul_rn, so nothing contracts into an FMA.
// A block holding a NaN gets a NaN scale and dequantizes to 32 NaNs, as the
// codec's does; fmaxf would drop the NaN and give a finite block with a 0
// in its place, so the absmax is taken with max.NaN (sm_80 and later). A
// block holding +-inf gets an inf scale, inv = 0, and 0 * inf = NaN at
// every position, as in the codec.
//
// Layout: one thread per 4 consecutive values, 8 threads per block, so a
// warp covers 4 blocks with one 16-byte (f32) or 8-byte (bf16) load a
// thread; the absmax is a 3-step shuffle within each group of 8.
//
// What bounds it on the H100: bytes, x read once and out written once
// (a 7B decode input is 8-22 KB, so a launch is ~2-3 us of ramp; a
// 256-token chunk's w13 input 2 MB, ~1.3 us at 3.35 TB/s).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// max that returns NaN if either operand is NaN (fmaxf returns the other)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// q * s16 in the output type, rounded once
__device__ __forceinline__ void store4(float* p, const int* q, __half s16) {
  const float s = __half2float(s16);
  *reinterpret_cast<float4*>(p) = make_float4(__fmul_rn((float)q[0], s), __fmul_rn((float)q[1], s),
                                              __fmul_rn((float)q[2], s), __fmul_rn((float)q[3], s));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const int* q, __half s16) {
  const float s = __bfloat162float(__float2bfloat16_rn(__half2float(s16)));
  __nv_bfloat162 h[2];
  h[0] = __halves2bfloat162(__float2bfloat16_rn(__fmul_rn((float)q[0], s)),
                            __float2bfloat16_rn(__fmul_rn((float)q[1], s)));
  h[1] = __halves2bfloat162(__float2bfloat16_rn(__fmul_rn((float)q[2], s)),
                            __float2bfloat16_rn(__fmul_rn((float)q[3], s)));
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
q80_roundtrip_kernel(const TI* __restrict__ x, TO* __restrict__ out, long long n4) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;  // 4-value chunk
  const bool live = i < n4;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) load4(x + 4 * i, v);
  float am = max_nan(max_nan(fabsf(v[0]), fabsf(v[1])), max_nan(fabsf(v[2]), fabsf(v[3])));
  // n4 is a multiple of 8, so a group of 8 lanes is all live or all dead
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) am = max_nan(am, __shfl_xor_sync(0xffffffffu, am, off));
  if (!live) return;
  const float scale = __fmul_rn(am, 1.0f / 127.0f);
  const float inv = scale > 0.f ? __frcp_rn(scale) : 0.f;
  int q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) q[j] = __float2int_rn(__fmul_rn(v[j], inv));
  store4(out + 4 * i, q, __float2half_rn(scale));
}

template <typename TI, typename TO>
cudaError_t launch(const void* x, void* out, long long n, cudaStream_t stream) {
  const long long n4 = n / 4;
  const unsigned grid = (unsigned)((n4 + kThreads - 1) / kThreads);
  q80_roundtrip_kernel<TI, TO><<<grid, kThreads, 0, stream>>>(
      static_cast<const TI*>(x), static_cast<TO*>(out), n4);
  return cudaGetLastError();
}

}  // namespace

// x: n values, f32 (x_dtype 0) or bf16 (1), n a multiple of 32, 16-byte
// aligned; out: n values, f32 (out_dtype 0) or bf16 (1). Returns the
// launch's cudaError_t.
extern "C" int q80_roundtrip_launch(const void* x, int x_dtype, void* out, int out_dtype,
                                    long long n, void* stream) {
  if (n <= 0 || n % 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && out_dtype == 0) return launch<float, float>(x, out, n, s);
  if (x_dtype == 0 && out_dtype == 1) return launch<float, __nv_bfloat16>(x, out, n, s);
  if (x_dtype == 1 && out_dtype == 0) return launch<__nv_bfloat16, float>(x, out, n, s);
  if (x_dtype == 1 && out_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(x, out, n, s);
  return (int)cudaErrorInvalidValue;
}
