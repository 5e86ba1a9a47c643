// The fused form of the two KV-write kernels (K2' flat_kv_write.cu, K4'
// decode_kv_write.cu): the q|k|v bias, the rotary embedding of q and k and
// the K|V store in one launch a layer.
//
// What it replaces. Between the q|k|v projection and the store the model
// ran, in plain PyTorch, the three bias adds, apply_rope on q and on k (ten
// elementwise kernels each: two widenings, four products, a difference, a
// sum, a concatenation and a narrowing) and a copy of k|v into one slab:
// about 22 kernels a layer, each a launch and a round trip through device
// memory, where the JAX package's XLA fuses the same chain
// (llmd_tpu/models/llama.py:378-379) into its neighbours. This kernel is
// that chain and the store: one block per token (K2') or decode row (K4')
// reads the row's q, k and v once, straight from the projection's output
// (each a view with its own row stride and a contiguous [heads, D] tail),
// adds the biases, rotates q and k in f32 with the row's cos/sin (loaded
// once into shared memory and reused by every head), writes the rotated q
// to a contiguous [N, Nq, D] output for the attention kernels (every row,
// pads too, as the plain version does) and stores rotated k | v at the
// row's (page, slot). A pad (a flat token at or past the device-side live
// count, a decode row with valid == 0) stores nothing.
//
// Bit for bit the plain version's arithmetic, which rounds every step apart:
//   biased = dtype(x + b)                       (f32 sum, rounded to the dtype)
//   out1   = dtype(x1 c - x2 s), out2 = dtype(x2 c + x1 s)
// with each product, the difference and the sum rounded in f32
// (__fmul_rn, __fsub_rn, __fadd_rn keep them from contracting into FMAs,
// which PyTorch's separate elementwise kernels never form) and the result
// rounded to the dtype to nearest even.
//
// Float pool: every (head, 16-byte vector of a half head) is an item; a
// thread takes its items four at a time, loads first, so that a block has
// its loads in flight together. Int8 pool: the q heads are items as
// above; each K|V head is one warp, lane l holding elements [l DPL, (l + 1)
// DPL) of the row and the DPL elements half a head away that rotate with
// them, so the rotated, dtype-rounded row is quantized from registers
// (kv_quant.cuh) into exactly the plain path's bytes and scale pair.
//
// Bound: bytes. q, k and v in once, q out once, k|v out once in the pool's
// type (int8: half, plus 8 bytes of scales a head), the biases and the
// cos/sin row. At a decode batch that is a fraction of a microsecond and
// the kernel's time is its launch and a few dependent round trips; what it
// saves there is the other ~21 launches a layer.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "convert.cuh"
#include "kv_quant.cuh"

namespace rope_kv {

// f32 -> T, round to nearest even, as PyTorch's casts round.
template <typename T> __device__ __forceinline__ T round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half round_to<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and widened back: the value a tensor of dtype T holds.
template <typename T>
__device__ __forceinline__ float in_dtype(float x) {
  return convert::to_f(round_to<T>(x));
}

// M consecutive elements of T (aligned to their size, or to 16 bytes),
// moved with the widest vector accesses that fit.
template <typename T, int M>
struct Vec {
  static constexpr int kBytes = M * (int)sizeof(T);
  using W = typename std::conditional<kBytes % 16 == 0, uint4,
      typename std::conditional<kBytes % 8 == 0, uint2,
          typename std::conditional<kBytes % 4 == 0, uint32_t, uint16_t>::type>::type>::type;
  static constexpr int kWords = kBytes / (int)sizeof(W);
  W w[kWords];

  __device__ __forceinline__ void load(const T* __restrict__ p) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = reinterpret_cast<const W*>(p)[i];
  }
  // Element i widened to f32.
  __device__ __forceinline__ float operator[](int i) const {
    return convert::to_f(reinterpret_cast<const T*>(w)[i]);
  }
};

// x rounded to T, stored at p as M consecutive elements.
template <typename T, int M>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&x)[M]) {
  Vec<T, M> v;
#pragma unroll
  for (int i = 0; i < M; ++i) reinterpret_cast<T*>(v.w)[i] = round_to<T>(x[i]);
#pragma unroll
  for (int i = 0; i < Vec<T, M>::kWords; ++i) {
    reinterpret_cast<typename Vec<T, M>::W*>(p)[i] = v.w[i];
  }
}

// The pointers and sizes of one launch (both kernels).
template <typename T>
struct Params {
  void* cache;             // [L, P, K, page, 2D] of T, or int8 with scales
  float* scales;           // [L, P, K, page, 2] f32, or nullptr (float pool)
  T* q_out;                // [N, Nq, D], contiguous
  const T* q;              // row r at q + r * q_stride: [Nq, D]
  const T* k;              // [K, D] rows at k_stride
  const T* v;              // [K, D] rows at v_stride
  int64_t q_stride, k_stride, v_stride;  // elements between rows
  const T* bq;             // [Nq D], or nullptr (no bias)
  const T* bk;             // [K D]
  const T* bv;             // [K D]
  const float* cos;        // [N, D / 2]
  const float* sin;        // [N, D / 2]
  int layer, num_pages, num_q_heads, num_kv_heads, page;
};

// One row's rotation of its own element x against its partner y, half a
// head away: the first half takes x c - y s, the second x c + y s.
__device__ __forceinline__ float rotate(float x, float y, float c, float s, bool first) {
  return first ? __fsub_rn(__fmul_rn(x, c), __fmul_rn(y, s))
               : __fadd_rn(__fmul_rn(x, c), __fmul_rn(y, s));
}

// Grid: one block per row (token or decode row) r; 128 threads. Target
// maps r to its (phys page, slot), or says it is a pad (stores nothing).
template <typename T, int D, bool kInt8, class Target>
__global__ void __launch_bounds__(128) rope_kv_write_kernel(Params<T> p, Target target) {
  constexpr int HALF = D / 2;
  constexpr int N = 16 / (int)sizeof(T);  // elements a 16-byte vector
  constexpr int CH = HALF / N;             // vectors a half head
  constexpr int U = 4;                     // items a thread has in flight
  __shared__ float cs[D];                  // this row's cos | sin
  const int r = blockIdx.x;
  for (int i = threadIdx.x; i < HALF; i += blockDim.x) {
    cs[i] = p.cos[(int64_t)r * HALF + i];
    cs[HALF + i] = p.sin[(int64_t)r * HALF + i];
  }
  int phys = 0, slot = 0;
  const bool live = target(r, &phys, &slot);
  __syncthreads();
  const int K = p.num_kv_heads;
  // Pool row of KV head 0 at (layer, phys, :, slot); head h is h * page on.
  const int64_t base = ((int64_t)p.layer * p.num_pages + phys) * K * p.page + slot;
  const int nq = p.num_q_heads * CH;
  const int n = nq + (live && !kInt8 ? 2 * K * CH : 0);

  for (int i0 = threadIdx.x; i0 < n; i0 += U * blockDim.x) {
    Vec<T, N> x1[U], x2[U], b1[U], b2[U];
    T* dst[U];
    int j[U];
    bool rot[U], bias[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i >= n) break;
      const T* src;
      const T* b;
      int h;
      if (i < nq) {
        h = i / CH;
        j[u] = i - h * CH;
        src = p.q + r * p.q_stride + h * D;
        b = p.bq;
        dst[u] = p.q_out + ((int64_t)r * p.num_q_heads + h) * D;
        rot[u] = true;
      } else {
        const int kv = (i - nq) / (K * CH);  // 0: k, 1: v
        const int rest = i - nq - kv * K * CH;
        h = rest / CH;
        j[u] = rest - h * CH;
        src = (kv ? p.v + r * p.v_stride : p.k + r * p.k_stride) + h * D;
        b = kv ? p.bv : p.bk;
        dst[u] = reinterpret_cast<T*>(p.cache) + (base + (int64_t)h * p.page) * 2 * D + kv * D;
        rot[u] = kv == 0;
      }
      x1[u].load(src + j[u] * N);
      x2[u].load(src + HALF + j[u] * N);
      bias[u] = b != nullptr;
      if (bias[u]) {
        b1[u].load(b + h * D + j[u] * N);
        b2[u].load(b + h * D + HALF + j[u] * N);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u * blockDim.x >= n) break;
      float y1[N], y2[N];
#pragma unroll
      for (int e = 0; e < N; ++e) {
        float lo = x1[u][e], hi = x2[u][e];  // element e of each half
        if (bias[u]) {
          lo = in_dtype<T>(__fadd_rn(lo, b1[u][e]));
          hi = in_dtype<T>(__fadd_rn(hi, b2[u][e]));
        }
        if (rot[u]) {
          const float c = cs[j[u] * N + e], sn = cs[HALF + j[u] * N + e];
          y1[e] = rotate(lo, hi, c, sn, true);
          y2[e] = rotate(hi, lo, c, sn, false);
        } else {
          y1[e] = lo;
          y2[e] = hi;
        }
      }
      store<T, N>(dst[u] + j[u] * N, y1);
      store<T, N>(dst[u] + HALF + j[u] * N, y2);
    }
  }

  if constexpr (kInt8) {
    if (!live) return;  // block-uniform
    constexpr int DPL = D / 32;
    const int lane = threadIdx.x % 32;
    const int own = lane * DPL;
    const bool first = own < HALF;
    const int other = first ? own + HALF : own - HALF;
    const int c0 = first ? own : other;  // index into the cos/sin row
    int8_t* cache8 = reinterpret_cast<int8_t*>(p.cache);
    for (int h = threadIdx.x / 32; h < K; h += blockDim.x / 32) {  // warp-uniform
      const int64_t row = base + (int64_t)h * p.page;
      const T* kr = p.k + r * p.k_stride + h * D;
      const T* vr = p.v + r * p.v_stride + h * D;
      Vec<T, DPL> kx, ky, vx;
      kx.load(kr + own);
      ky.load(kr + other);
      vx.load(vr + own);
      float x[DPL], y[DPL], w[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        x[e] = kx[e];
        y[e] = ky[e];
        w[e] = vx[e];
      }
      if (p.bk != nullptr) {
        Vec<T, DPL> bx, by, bv;
        bx.load(p.bk + h * D + own);
        by.load(p.bk + h * D + other);
        bv.load(p.bv + h * D + own);
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          x[e] = in_dtype<T>(__fadd_rn(x[e], bx[e]));
          y[e] = in_dtype<T>(__fadd_rn(y[e], by[e]));
          w[e] = in_dtype<T>(__fadd_rn(w[e], bv[e]));
        }
      }
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        x[e] = in_dtype<T>(rotate(x[e], y[e], cs[c0 + e], cs[HALF + c0 + e], first));
      }
      const float ks = kv_quant::quantize_vals<DPL>(x, cache8 + row * 2 * D);
      const float vs = kv_quant::quantize_vals<DPL>(w, cache8 + row * 2 * D + D);
      if (lane == 0) reinterpret_cast<float2*>(p.scales)[row] = make_float2(ks, vs);
    }
  }
}

// The launch's arguments as the C entries receive them (dtype erased).
struct RawParams {
  void* cache;
  void* scales;
  void* q_out;
  const void* q;
  const void* k;
  const void* v;
  long long q_stride, k_stride, v_stride;
  const void* bq;
  const void* bk;
  const void* bv;
  const void* cos;
  const void* sin;
  int layer, num_pages, num_q_heads, num_kv_heads, page;
};

template <typename T, int D, class Target>
cudaError_t launch_d(const RawParams& a, const Target& target, int rows, cudaStream_t s) {
  const Params<T> p{a.cache, (float*)a.scales, (T*)a.q_out, (const T*)a.q, (const T*)a.k,
                    (const T*)a.v, a.q_stride, a.k_stride, a.v_stride, (const T*)a.bq,
                    (const T*)a.bk, (const T*)a.bv, (const float*)a.cos, (const float*)a.sin,
                    a.layer, a.num_pages, a.num_q_heads, a.num_kv_heads, a.page};
  if (a.scales != nullptr) {
    rope_kv_write_kernel<T, D, true, Target><<<rows, 128, 0, s>>>(p, target);
  } else {
    rope_kv_write_kernel<T, D, false, Target><<<rows, 128, 0, s>>>(p, target);
  }
  return cudaGetLastError();
}

template <typename T, class Target>
cudaError_t launch_t(const RawParams& a, const Target& target, int rows, int head_dim,
                     cudaStream_t s) {
  switch (head_dim) {
    case 64:
      return launch_d<T, 64>(a, target, rows, s);
    case 128:
      return launch_d<T, 128>(a, target, rows, s);
    case 256:
      return launch_d<T, 256>(a, target, rows, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// dtype 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, the biases, the
// float pool and q_out); head_dim 64, 128 or 256.
template <class Target>
int launch(const RawParams& a, const Target& target, int rows, int head_dim, int dtype,
           void* stream) {
  if (rows == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return (int)launch_t<float>(a, target, rows, head_dim, s);
    case 1:
      return (int)launch_t<__nv_bfloat16>(a, target, rows, head_dim, s);
    case 2:
      return (int)launch_t<__half>(a, target, rows, head_dim, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rope_kv
