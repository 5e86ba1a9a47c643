// Device code shared by the two KV-write kernels' int8 paths
// (flat_kv_write.cu, decode_kv_write.cu, and their fused forms in
// rope_kv_write.cuh): one warp quantizes one (token, head) row's K or V
// half and stores it into the int8 pool, bit for bit as
// llmd_tpu/ops/quant_kv.py:quantize_kv_rows does on the CPU:
//
//   amax  = max |x|                                    (f32)
//   scale = max(amax, 1e-30) / 127                     (IEEE f32 divide)
//   scale = f16 round-to-nearest-even, back to f32
//   r     = 1 / scale                                  (IEEE f32 divide)
//   q     = rint(x * r) (round half to even), NaN -> 0, clamped to +-127
//
// The kernels are built without fast-math, so '/' is correctly rounded and
// __fmul_rn keeps the product from fusing. The two edge rows come out as in
// the reference: an all-zero row gets scale 0 and data 0 (0 * 1/0 is NaN,
// which XLA converts to 0), a row whose amax / 127 overflows f16 gets scale
// inf and data 0 (x * 1/inf).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "convert.cuh"

namespace kv_quant {

// Quantize the warp's row from registers: each lane holds DPL consecutive
// elements of the row (in f32, already rounded to the row's dtype); stores
// the lane's DPL int8 values at dst + lane * DPL (aligned to DPL bytes) and
// returns the row's scale (the same in every lane). Every lane of the warp
// must call it.
template <int DPL>
__device__ __forceinline__ float quantize_vals(const float (&v)[DPL],
                                               int8_t* __restrict__ dst) {
  const int lane = threadIdx.x % 32;
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  const float scale = __half2float(__float2half_rn(fmaxf(amax, 1e-30f) / 127.0f));
  const float r = 1.0f / scale;
  union {
    int8_t b[DPL];
    typename std::conditional<DPL == 8, uint2,
        typename std::conditional<DPL == 4, uint32_t, uint16_t>::type>::type w;
  } out;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const float q = rintf(__fmul_rn(v[i], r));
    out.b[i] = (int8_t)(isnan(q) ? 0.f : fminf(fmaxf(q, -127.f), 127.f));
  }
  *reinterpret_cast<decltype(out.w)*>(dst + lane * DPL) = out.w;
  return scale;
}

// Quantize the warp's row read from x: lane l takes elements
// [l * DPL, (l + 1) * DPL).
template <typename T, int DPL>
__device__ __forceinline__ float quantize_row(const T* __restrict__ x,
                                              int8_t* __restrict__ dst) {
  const int lane = threadIdx.x % 32;
  float v[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) v[i] = convert::to_f(x[lane * DPL + i]);
  return quantize_vals<DPL>(v, dst);
}

}  // namespace kv_quant
