// Per-row int8 quantization of activations (the A side of W8A8).
//
// Replaces no TPU kernel: llmd_tpu/ops/quant.py:quantize_activations is
// left to XLA, which fuses it into the product that follows. In PyTorch the
// same chain (abs, amax, clamp, divide, divide, round, clamp, cast) is about
// six launches a product input, several hundred a graphed decode step; this
// is one. Each row of x [M, K] (bf16, f16 or f32) gives
//
//   amax    = max |x|                                  (f32)
//   scale   = max(amax, 1e-30) / 127                   (IEEE f32 divide)
//   xq[k]   = clamp(rint(x[k] / scale), -127, 127)     (IEEE f32 divide,
//                                                       round half to even)
//
// with xq int8 [M, K] and a_scale f32 [M], bit-equal to the plain version
// (built without fast-math, so '/' is correctly rounded).
//
// Bound: bytes, M K (2 + 1) + 4 M for bf16 input. Design: one block of 256
// threads a row, 16-byte loads; the row is read twice (the amax, then the
// quantized values), the second time from L1/L2.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) quantize_rows_kernel(
    int8_t* __restrict__ xq, float* __restrict__ a_scale, const T* __restrict__ x, int K) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte load
  struct alignas(16) Vec {
    T v[V];
  };
  struct alignas(V) Out {
    int8_t q[V];
  };
  __shared__ float warp_max[kThreads / 32];
  const int64_t row = blockIdx.x;
  const Vec* xr = reinterpret_cast<const Vec*>(x + row * K);
  Out* qr = reinterpret_cast<Out*>(xq + row * K);
  const int nv = K / V;

  float amax = 0.f;
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const Vec a = xr[i];
#pragma unroll
    for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(convert::to_f(a.v[e])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-30f), 127.0f);
  if (threadIdx.x == 0) a_scale[row] = scale;

  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const Vec a = xr[i];
    Out o;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float q = rintf(__fdiv_rn(convert::to_f(a.v[e]), scale));
      o.q[e] = (int8_t)__float2int_rn(fminf(fmaxf(q, -127.f), 127.f));
    }
    qr[i] = o;
  }
}

}  // namespace

// xq int8 [M, K] and a_scale f32 [M] from x [M, K]. dtype: 0 = float32,
// 1 = bfloat16, 2 = float16. K must be a multiple of 16 and x 16-byte
// aligned (the wrapper checks it).
extern "C" int quantize_rows(void* xq, void* a_scale, const void* x, int M, int K, int dtype,
                             void* stream) {
  if (M == 0) return (int)cudaGetLastError();
  if (K <= 0 || K % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      quantize_rows_kernel<float><<<M, kThreads, 0, s>>>((int8_t*)xq, (float*)a_scale, (const float*)x, K);
      break;
    case 1:
      quantize_rows_kernel<__nv_bfloat16><<<M, kThreads, 0, s>>>((int8_t*)xq, (float*)a_scale,
                                                                 (const __nv_bfloat16*)x, K);
      break;
    case 2:
      quantize_rows_kernel<__half><<<M, kThreads, 0, s>>>((int8_t*)xq, (float*)a_scale, (const __half*)x, K);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
