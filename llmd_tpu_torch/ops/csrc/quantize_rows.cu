// Per-row int8 quantization of activations (the A side of W8A8), alone and
// fused with what produces its input.
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
//
// The fused forms. A lone quantize_rows is one launch of about 3 us at a
// decode step whose bytes take 0.1 us: what it saves is bounded by the
// launches before it, the plain PyTorch chain that makes its input. So two
// kernels take that chain in:
//
//   add_rms_norm_quant_kernel   the residual add (x + (delta + bias)), the
//       RMSNorm of models/common.py:rms_norm and the quantization of its
//       output: about ten launches (the add, the bias, float, square, mean,
//       + eps, rsqrt, multiply, cast, * weight, quantize) become one;
//   glu_quant_kernel            the gated unit (silu(gate) * up, or
//       gpt-oss's clamped SwiGLU after the experts' biases picked by each
//       row's expert id) and the quantization of its output.
//
// Each rounds to the element type where PyTorch's eager ops round (the
// add and the bias; the norm's cast and its weight product; each op of
// the gated unit), with the same f32 functions (rsqrtf, expf, IEEE
// divides, no contraction into FMAs), so that the residual is bit-equal to
// the plain chain's, the normed or gated row within one ulp of it (the sum
// of squares runs in another order than torch.mean's), and (xq, a_scale)
// bit-equal to quantize_rows of the kernel's own row. Design: a group of
// threads a row (a multiple of 32, more threads for longer rows), one row
// a block at decode and a few a block once there are several blocks an SM;
// the row is read from HBM once with 16-byte loads and staged in shared
// memory (dynamic, K elements a row: above 48 KB, the qwen3-32b and
// deepseek-r1 intermediate rows, the attribute is set on every launch) as
// the type-rounded normed or gated values, from which the amax and the
// quantized store run. Bound: bytes, each input read once and each output
// written once. At a decode step (32 rows) latency, not the bytes, sets
// the time (about 4 us a norm, 4-13 a gated unit on an H100), so a decode
// row takes one 16-byte vector a thread where 512 threads suffice and the
// norm's weight is loaded with the residual; two other designs timed no
// faster there and slower at prefill: a row cut over a cluster of up to 8
// blocks with its loads unrolled four deep, and the row brought into
// shared memory by TMA bulk copies.

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

// ---------------------------------------------------------------------------
// The fused forms.

constexpr int kMaxBlock = 512;

// One element rounded to T, as a PyTorch op writing a T tensor rounds it.
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return convert::to_f(convert::from_f<T>(v));
}

// The row group's sum (or max) of v: a group is `tpr` threads (whole warps)
// of the block, `red` one slot a warp. Every thread of the block calls it.
template <bool kMax>
__device__ __forceinline__ float group_reduce(float v, float* red, int tpr) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : __fadd_rn(v, o);
  }
  __syncthreads();  // red's slots are free again
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  const int first = threadIdx.x / tpr * (tpr / 32);
  float r = red[first];
  for (int w = 1; w < tpr / 32; ++w) r = kMax ? fmaxf(r, red[first + w]) : __fadd_rn(r, red[first + w]);
  return r;
}

// The quantized store of a staged row (its amax already reduced).
template <typename Vec, typename Out, int V>
__device__ __forceinline__ void store_quantized(Out* qr, const Vec* stage, int t, int tpr, int nv,
                                                float scale) {
  for (int i = t; i < nv; i += tpr) {
    const Vec a = stage[i];
    Out o;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float q = rintf(__fdiv_rn(convert::to_f(a.v[e]), scale));
      o.q[e] = (int8_t)__float2int_rn(fminf(fmaxf(q, -127.f), 127.f));
    }
    qr[i] = o;
  }
}

// x_out = x + (delta + bias) (when delta is given), h = RMSNorm(x_out) *
// weight, then h's row quantized. Rows blockDim.x / tpr a block.
template <typename T>
__global__ void __launch_bounds__(kMaxBlock) add_rms_norm_quant_kernel(
    T* __restrict__ x_out, T* __restrict__ h_out, int8_t* __restrict__ xq, float* __restrict__ a_scale,
    float* __restrict__ rstd, const T* __restrict__ x, const T* __restrict__ delta,
    const T* __restrict__ bias, const T* __restrict__ weight, float eps, float inv_k, int M, int K,
    int tpr) {
  constexpr int V = 16 / sizeof(T);
  struct alignas(16) Vec {
    T v[V];
  };
  struct alignas(V) Out {
    int8_t q[V];
  };
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kMaxBlock / 32];
  const int t = threadIdx.x % tpr;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < M;
  const int nv = K / V;
  Vec* stage = reinterpret_cast<Vec*>(smem) + (int64_t)(threadIdx.x / tpr) * nv;
  const int64_t off = live ? row * K : 0;
  const Vec* xr = reinterpret_cast<const Vec*>(x + off);
  const Vec* dr = reinterpret_cast<const Vec*>(delta + (delta ? off : 0));
  const Vec* br = reinterpret_cast<const Vec*>(bias);
  const Vec* wr = reinterpret_cast<const Vec*>(weight);

  // The residual, written back, staged; the f32 sum of its squares. The
  // weight's first vector is loaded beside it: at a decode step it is a
  // thread's only one, so the norm's second pass waits on no load.
  float ss = 0.f;
  Vec w0;
  if (live && t < nv) w0 = wr[t];
  if (live) {
    for (int i = t; i < nv; i += tpr) {
      Vec a = xr[i];
      if (delta != nullptr) {
        Vec d = dr[i];
        if (bias != nullptr) {
          const Vec b = br[i];
#pragma unroll
          for (int e = 0; e < V; ++e)
            d.v[e] = convert::from_f<T>(__fadd_rn(convert::to_f(d.v[e]), convert::to_f(b.v[e])));
        }
#pragma unroll
        for (int e = 0; e < V; ++e)
          a.v[e] = convert::from_f<T>(__fadd_rn(convert::to_f(a.v[e]), convert::to_f(d.v[e])));
        reinterpret_cast<Vec*>(x_out + off)[i] = a;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = convert::to_f(a.v[e]);
        ss = __fadd_rn(ss, __fmul_rn(f, f));
      }
      stage[i] = a;
    }
  }
  const float var = __fmul_rn(group_reduce<false>(ss, red, tpr), inv_k);
  const float r = rsqrtf(__fadd_rn(var, eps));
  if (rstd != nullptr && live && t == 0) rstd[row] = r;

  // h = ((x * r) -> T) * weight -> T, staged over the residual; its amax.
  float amax = 0.f;
  if (live) {
    for (int i = t; i < nv; i += tpr) {
      Vec a = stage[i];
      const Vec w = i == t ? w0 : wr[i];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float n = rnd<T>(__fmul_rn(convert::to_f(a.v[e]), r));
        a.v[e] = convert::from_f<T>(__fmul_rn(n, convert::to_f(w.v[e])));
        amax = fmaxf(amax, fabsf(convert::to_f(a.v[e])));
      }
      stage[i] = a;
      if (h_out != nullptr) reinterpret_cast<Vec*>(h_out + off)[i] = a;
    }
  }
  amax = group_reduce<true>(amax, red, tpr);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-30f), 127.0f);
  if (live) {
    if (t == 0) a_scale[row] = scale;
    store_quantized<Vec, Out, V>(reinterpret_cast<Out*>(xq + off), stage, t, tpr, nv, scale);
  }
}

// act = the gated unit of (gate, up) [M, F] (row strides gate_ld, up_ld),
// after the experts' biases b_gate/b_up [E, F] picked by expert_ids [M]
// where given; then act's row quantized. kind 0: silu(gate) * up; kind 1:
// gpt-oss's clamped SwiGLU, (clamp(up, -limit, limit) + 1) * (g *
// sigmoid(1.702 g)) with g = min(gate, limit), each step rounded to T as
// JAX rounds it (1.702 itself, and the sigmoid's exp and sum). Rows
// blockDim.x / tpr a
// block.
template <typename T>
__global__ void __launch_bounds__(kMaxBlock) glu_quant_kernel(
    int8_t* __restrict__ xq, float* __restrict__ a_scale, T* __restrict__ act_out,
    const T* __restrict__ gate, const T* __restrict__ up, int64_t gate_ld, int64_t up_ld,
    const T* __restrict__ b_gate, const T* __restrict__ b_up, const int64_t* __restrict__ expert_ids,
    int kind, float limit, int M, int F, int tpr) {
  constexpr int V = 16 / sizeof(T);
  struct alignas(16) Vec {
    T v[V];
  };
  struct alignas(V) Out {
    int8_t q[V];
  };
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kMaxBlock / 32];
  const int t = threadIdx.x % tpr;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < M;
  const int nv = F / V;
  Vec* stage = reinterpret_cast<Vec*>(smem) + (int64_t)(threadIdx.x / tpr) * nv;
  const int64_t r = live ? row : 0;
  const Vec* gr = reinterpret_cast<const Vec*>(gate + r * gate_ld);
  const Vec* ur = reinterpret_cast<const Vec*>(up + r * up_ld);
  const bool biased = b_gate != nullptr;
  const int64_t eo = (biased && live) ? expert_ids[r] * F : 0;
  const Vec* bgr = reinterpret_cast<const Vec*>(b_gate + eo);
  const Vec* bur = reinterpret_cast<const Vec*>(b_up + eo);
  const float lim = rnd<T>(limit);

  float amax = 0.f;
  if (live) {
    for (int i = t; i < nv; i += tpr) {
      Vec g = gr[i];
      const Vec u = ur[i];
      Vec bg, bu;
      if (biased) {
        bg = bgr[i];
        bu = bur[i];
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float gv = convert::to_f(g.v[e]), uv = convert::to_f(u.v[e]);
        if (biased) {
          gv = rnd<T>(__fadd_rn(gv, convert::to_f(bg.v[e])));
          uv = rnd<T>(__fadd_rn(uv, convert::to_f(bu.v[e])));
        }
        float a;
        if (kind == 0) {
          const float sl = rnd<T>(__fdiv_rn(gv, __fadd_rn(1.0f, expf(-gv))));
          a = __fmul_rn(sl, uv);
        } else {
          gv = gv > lim ? lim : gv;  // NaN passes, as clamp keeps it
          uv = uv > lim ? lim : uv < -lim ? -lim : uv;
          // JAX's arithmetic: 1.702 in T, and the sigmoid's exp and sum
          // rounded to T as XLA's 1 / (1 + exp(-z)) rounds them.
          const float z = rnd<T>(__fmul_rn(gv, rnd<T>(1.702f)));
          const float sg = rnd<T>(__fdiv_rn(1.0f, rnd<T>(__fadd_rn(1.0f, rnd<T>(expf(-z))))));
          const float glu = rnd<T>(__fmul_rn(gv, sg));
          a = __fmul_rn(rnd<T>(__fadd_rn(uv, 1.0f)), glu);
        }
        g.v[e] = convert::from_f<T>(a);
        amax = fmaxf(amax, fabsf(convert::to_f(g.v[e])));
      }
      stage[i] = g;
      if (act_out != nullptr) reinterpret_cast<Vec*>(act_out + r * F)[i] = g;
    }
  }
  amax = group_reduce<true>(amax, red, tpr);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-30f), 127.0f);
  if (live) {
    if (t == 0) a_scale[row] = scale;
    store_quantized<Vec, Out, V>(reinterpret_cast<Out*>(xq + r * F), stage, t, tpr, nv, scale);
  }
}

// Rows a block: one while the rows fill fewer than two blocks an SM (a
// decode step), else enough rows for 256 threads whose staging fits 96 KB
// (two blocks an SM). Threads a row, whole warps, at most kMaxBlock: at a
// decode step one 16-byte vector a thread where they suffice (the time is
// latency, so the fewest rounds of loads), else about four.
struct RowPlan {
  int tpr, rows;
  size_t smem;
};

inline RowPlan row_plan(int M, int K, int elt) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const int nv = K * elt / 16;
  const bool decode = M <= 2 * sms;
  int tpr = 32;
  while (tpr < kMaxBlock && tpr * (decode ? 1 : 4) < nv) tpr *= 2;
  const size_t row_bytes = (size_t)K * elt;
  int rows = 1;
  if (!decode)
    while (rows * tpr < 256 && 2 * rows * row_bytes <= 96 * 1024) rows *= 2;
  return {tpr, rows, rows * row_bytes};
}

// Shared memory a block may take (H100: 227 KB).
constexpr size_t kMaxSmem = 232448;

template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

template <typename T>
int launch_add_rms_norm_quant(void* x_out, void* h_out, void* xq, void* a_scale, void* rstd,
                              const void* x, const void* delta, const void* bias, const void* weight,
                              float eps, int M, int K, cudaStream_t s) {
  const RowPlan p = row_plan(M, K, sizeof(T));
  auto kernel = add_rms_norm_quant_kernel<T>;
  cudaError_t e = prepare(kernel, p.smem);
  if (e != cudaSuccess) return (int)e;
  // torch.mean's factor: the output count over the element count, in f32.
  const float inv_k = (float)M / (float)((int64_t)M * K);
  kernel<<<(M + p.rows - 1) / p.rows, p.tpr * p.rows, p.smem, s>>>(
      (T*)x_out, (T*)h_out, (int8_t*)xq, (float*)a_scale, (float*)rstd, (const T*)x, (const T*)delta,
      (const T*)bias, (const T*)weight, eps, inv_k, M, K, p.tpr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_glu_quant(void* xq, void* a_scale, void* act_out, const void* gate, const void* up,
                     int64_t gate_ld, int64_t up_ld, const void* b_gate, const void* b_up,
                     const void* expert_ids, int kind, float limit, int M, int F, cudaStream_t s) {
  const RowPlan p = row_plan(M, F, sizeof(T));
  auto kernel = glu_quant_kernel<T>;
  cudaError_t e = prepare(kernel, p.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(M + p.rows - 1) / p.rows, p.tpr * p.rows, p.smem, s>>>(
      (int8_t*)xq, (float*)a_scale, (T*)act_out, (const T*)gate, (const T*)up, gate_ld, up_ld,
      (const T*)b_gate, (const T*)b_up, (const int64_t*)expert_ids, kind, limit, M, F, p.tpr);
  return (int)cudaGetLastError();
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

// The residual x_out = x + (delta + bias) (delta and bias may be null: no
// add, no bias; x_out is written only with delta), h = RMSNorm(x_out) *
// weight (h_out may be null), xq int8 [M, K] and a_scale f32 [M] from h;
// rstd f32 [M] (may be null) gets each row's rsqrt(mean(x_out^2) + eps).
// All [M, K] but the weight and bias [K]. K a multiple of 16, every pointer
// 16-byte aligned (the wrapper checks it). dtype as above.
extern "C" int add_rms_norm_quant(void* x_out, void* h_out, void* xq, void* a_scale, void* rstd,
                                  const void* x, const void* delta, const void* bias, const void* weight,
                                  float eps, int M, int K, int dtype, void* stream) {
  if (M == 0) return (int)cudaGetLastError();
  if (K <= 0 || K % 16 || (bias != nullptr && delta == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_add_rms_norm_quant<float>(x_out, h_out, xq, a_scale, rstd, x, delta, bias, weight, eps, M, K, s);
    case 1:
      return launch_add_rms_norm_quant<__nv_bfloat16>(x_out, h_out, xq, a_scale, rstd, x, delta, bias, weight,
                                                      eps, M, K, s);
    case 2:
      return launch_add_rms_norm_quant<__half>(x_out, h_out, xq, a_scale, rstd, x, delta, bias, weight, eps, M,
                                               K, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// xq int8 [M, F], a_scale f32 [M] (and act [M, F] where act_out is not
// null) from the gated unit of gate and up [M, F], rows gate_ld and up_ld
// elements apart; b_gate, b_up [E, F] and expert_ids int64 [M] all given or
// all null. kind 0 = silu, 1 = gpt-oss's clamped SwiGLU at `limit`. F a
// multiple of 16, pointers and row strides 16-byte aligned (the wrapper
// checks it).
extern "C" int glu_quant(void* xq, void* a_scale, void* act_out, const void* gate, const void* up,
                         long long gate_ld, long long up_ld, const void* b_gate, const void* b_up,
                         const void* expert_ids, int kind, float limit, int M, int F, int dtype,
                         void* stream) {
  if (M == 0) return (int)cudaGetLastError();
  if (F <= 0 || F % 16 || (kind != 0 && kind != 1) ||
      (b_gate == nullptr) != (expert_ids == nullptr) || (b_gate == nullptr) != (b_up == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_glu_quant<float>(xq, a_scale, act_out, gate, up, gate_ld, up_ld, b_gate, b_up,
                                     expert_ids, kind, limit, M, F, s);
    case 1:
      return launch_glu_quant<__nv_bfloat16>(xq, a_scale, act_out, gate, up, gate_ld, up_ld, b_gate, b_up,
                                             expert_ids, kind, limit, M, F, s);
    case 2:
      return launch_glu_quant<__half>(xq, a_scale, act_out, gate, up, gate_ld, up_ld, b_gate, b_up,
                                      expert_ids, kind, limit, M, F, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
