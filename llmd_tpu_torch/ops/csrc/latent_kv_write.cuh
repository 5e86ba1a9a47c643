// The latent form of the decode KV write (K4' decode_kv_write.cu, entry
// decode_kv_write_latent): MLA's kv_norm, the rotary embedding of k_pe and
// of the query's rope heads, the latent row's padding and its store, with
// the absorbed query's assembly, in one launch a layer at any Q.
//
// What it replaces. Between the projections and the attention an MLA layer
// ran, in plain PyTorch (models/mla.py:mla_write before this form), about
// 34 small kernels at Q == 1: apply_rope of q_pe and of k_pe (ten each:
// two widenings, four products, a difference, a sum, a concatenation, a
// narrowing), rms_norm of c_kv (eight), the concatenation and pad of the
// latent row and of q_eff, and the store-only K4' (with the copy that
// joins the halves posing as K and V); the JAX package's XLA fuses that
// chain (llmd_tpu/models/mla.py:65-88) into its neighbours. At Q > 1 the
// same chain ran over every token, and the store was the plain scatter.
//
// Per row r of the step's N = B Q rows (one block of 256 threads):
//   pool row  [w * T(c_kv * r), rope(k_pe), 0 ...]   at (page, slot)
//   q_eff[r]  [q_eff_nope[h], rope(q_pe[h]), 0 ...]  for each head h
// with r = rsqrt(sum(c_kv^2) / rank + eps) in f32. A pad row (valid == 0,
// or a target outside the pool or the page table) stores nothing; its
// q_eff is written all the same, as the plain version's is.
//
// Bit for bit the plain version's arithmetic given the norm's factor: the
// norm rounds x r to the row's type T and then multiplies by the weight
// with T's rounding (models/common.py:rms_norm); the rope computes
// x1 c - x2 s and x2 c + x1 s in f32 with each product, the difference and
// the sum rounded apart (rope_kv_write.cuh's rotate, no FMA contraction),
// then rounds to T. The sum of squares runs in another order than
// torch.mean's, so r may differ from the plain chain's by an f32 ulp, and
// the stored c_kv by an ulp or two of T; rstd (when given) receives r.
//
// Design. Bound: bytes (kv_a, q_pe and q_eff_nope in once; the pool row
// and q_eff out once; the cos/sin row). At a decode step (64 rows) that is
// a fraction of a microsecond and the time is the launch and two dependent
// round trips; at a 1,024-token prefill chunk of deepseek-v2-lite it is
// 41 MB, mostly q_eff_nope in and q_eff out (16 and 20 KB a row). So every
// access is a 16-byte vector where the widths allow (the rope halves and
// pads in vectors of M = 8 elements, or 4 where 8 does not divide them:
// tiny-mla's widths, and f32), a thread issues the loads of all its copy items before it stores
// any, the c_kv vector it normalises is loaded first and kept in registers
// across the block's sum, and the cos/sin row is read straight from global
// memory (no shared-memory staging, so no barrier before the q_eff work).
// The one block-wide reduction (warp shuffles, then one slot a warp) sits
// after the q_eff work, so the norm's loads have landed by then.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"
#include "rope_kv_write.cuh"

namespace latent_kv {

constexpr int kThreads = 256;
constexpr int kCopyInFlight = 4;  // q_eff_nope vectors a thread has in flight

template <typename T>
struct Params {
  T* cache;            // [L, P, 1, page, Dl]
  T* q_eff;            // [N, heads, Dl], contiguous
  float* rstd;         // [N], or nullptr
  const T* kv_a;       // row r at kv_a + r * kv_stride: [rank + rope]
  const T* weight;     // [rank], kv_norm's
  const float* cos;    // [N, rope / 2]
  const float* sin;    // [N, rope / 2]
  const T* q_pe;       // row r, head h at q_pe + r * qp_row + h * qp_head: [rope]
  const T* q_nope;     // row r, head h at q_nope + r * qn_row + h * qn_head: [rank]
  int64_t kv_stride, qp_row, qp_head, qn_row, qn_head;  // elements
  float eps, inv_rank;
  int layer, num_pages, page, heads, rank, rope, dl;
};

// The step's addressing (any Q; q = 1 at decode): row r is token r % q of
// batch row r / q; it is live when valid[r] and its page index lies in the
// table and its physical page in the pool.
struct bucket_rows {
  const int32_t* page_table;  // [B, max_pages]
  const int32_t* positions;   // [B, q]
  const uint8_t* valid;       // [B, q] (torch.bool)
  int q, max_pages, num_pages, page;

  __device__ __forceinline__ bool operator()(int r, int* p, int* slot) const {
    if (valid[r] == 0) return false;
    const int pos = positions[r];
    if (pos < 0) return false;
    const int pi = pos / page;
    if (pi >= max_pages) return false;
    *p = page_table[(int64_t)(r / q) * max_pages + pi];
    *slot = pos - pi * page;
    return *p >= 0 && *p < num_pages;
  }
};

// Rotates the M-element vectors at j of both halves of src (a rope head)
// by the row's cos/sin and stores them at dst's.
template <typename T, int M>
__device__ __forceinline__ void rope_pair(T* __restrict__ dst, const T* __restrict__ src,
                                          const float* __restrict__ cs,
                                          const float* __restrict__ sn, int half, int j) {
  rope_kv::Vec<T, M> x1, x2;
  rope_kv::Vec<float, M> c, s;
  x1.load(src + j * M);
  x2.load(src + half + j * M);
  c.load(cs + j * M);
  s.load(sn + j * M);
  float y1[M], y2[M];
#pragma unroll
  for (int e = 0; e < M; ++e) {
    y1[e] = rope_kv::rotate(x1[e], x2[e], c[e], s[e], true);
    y2[e] = rope_kv::rotate(x2[e], x1[e], c[e], s[e], false);
  }
  rope_kv::store<T, M>(dst + j * M, y1);
  rope_kv::store<T, M>(dst + half + j * M, y2);
}

template <typename T, int M>
__device__ __forceinline__ void zeros(T* __restrict__ dst) {
  float z[M];
#pragma unroll
  for (int e = 0; e < M; ++e) z[e] = 0.f;
  rope_kv::store<T, M>(dst, z);
}

// Grid: one block per row r; kThreads threads. M: elements a rope / pad
// vector. target maps r to its (phys page, slot), or says it is a pad.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads) latent_kv_write_kernel(Params<T> p,
                                                                  bucket_rows target) {
  constexpr int V = 16 / (int)sizeof(T);  // elements a 16-byte vector
  using Vec = rope_kv::Vec<T, V>;
  __shared__ float red[kThreads / 32];
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const int half = p.rope / 2;
  const int nvc = p.rank / V;                        // 16-byte vectors of a rank row
  const int nrp = half / M;                          // M-vectors of a rope half
  const int npad = (p.dl - p.rank - p.rope) / M;     // M-vectors of the pad
  int phys = 0, slot = 0;
  const bool live = target(r, &phys, &slot);
  T* row = p.cache + (((int64_t)p.layer * p.num_pages + phys) * p.page + slot) * p.dl;
  T* qo = p.q_eff + (int64_t)r * p.heads * p.dl;
  const T* kv = p.kv_a + r * p.kv_stride;
  const float* cs = p.cos + (int64_t)r * half;
  const float* sn = p.sin + (int64_t)r * half;

  // c_kv: the first vector this thread normalises, loaded first and kept;
  // the f32 sum of squares of all its vectors.
  Vec c0;
  float ss = 0.f;
  for (int i = t; i < nvc; i += kThreads) {
    Vec c;
    c.load(kv + i * V);
    if (i == t) c0 = c;
#pragma unroll
    for (int e = 0; e < V; ++e) ss = __fadd_rn(ss, __fmul_rn(c[e], c[e]));
  }

  // q_eff's nope part: q_eff_nope copied, kCopyInFlight loads in flight.
  const int ncopy = p.heads * nvc;
  for (int i0 = t; i0 < ncopy; i0 += kCopyInFlight * kThreads) {
    uint4 w[kCopyInFlight];
    int h[kCopyInFlight], j[kCopyInFlight];
#pragma unroll
    for (int u = 0; u < kCopyInFlight; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= ncopy) break;
      h[u] = i / nvc;
      j[u] = i - h[u] * nvc;
      w[u] = reinterpret_cast<const uint4*>(p.q_nope + r * p.qn_row + h[u] * p.qn_head)[j[u]];
    }
#pragma unroll
    for (int u = 0; u < kCopyInFlight; ++u) {
      if (i0 + u * kThreads >= ncopy) break;
      reinterpret_cast<uint4*>(qo + (int64_t)h[u] * p.dl)[j[u]] = w[u];
    }
  }

  // The rope pairs of every q head and, for a live row, of k_pe; then the
  // pads of q_eff and of the pool row.
  const int nq = p.heads * nrp;
  const int nrot = nq + (live ? nrp : 0);
  for (int i = t; i < nrot; i += kThreads) {
    if (i < nq) {
      const int h = i / nrp;
      rope_pair<T, M>(qo + (int64_t)h * p.dl + p.rank, p.q_pe + r * p.qp_row + h * p.qp_head,
                      cs, sn, half, i - h * nrp);
    } else {
      rope_pair<T, M>(row + p.rank, kv + p.rank, cs, sn, half, i - nq);
    }
  }
  const int nzq = p.heads * npad;
  const int nz = nzq + (live ? npad : 0);
  for (int i = t; i < nz; i += kThreads) {
    if (i < nzq) {
      const int h = i / npad;
      zeros<T, M>(qo + (int64_t)h * p.dl + p.rank + p.rope + (i - h * npad) * M);
    } else {
      zeros<T, M>(row + p.rank + p.rope + (i - nzq) * M);
    }
  }

  // The norm: the block's sum of squares, its factor, the normed c_kv.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  if (t % 32 == 0) red[t / 32] = ss;
  __syncthreads();
  float sum = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) sum = __fadd_rn(sum, red[w]);
  const float rs = rsqrtf(__fadd_rn(__fmul_rn(sum, p.inv_rank), p.eps));
  if (p.rstd != nullptr && t == 0) p.rstd[r] = rs;
  if (!live) return;
  for (int i = t; i < nvc; i += kThreads) {
    Vec c = c0;
    if (i != t) c.load(kv + i * V);
    Vec w;
    w.load(p.weight + i * V);
    float y[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      y[e] = __fmul_rn(rope_kv::in_dtype<T>(__fmul_rn(c[e], rs)), w[e]);
    }
    rope_kv::store<T, V>(row + i * V, y);
  }
}

// The launch's arguments as the C entry receives them (dtype erased).
struct RawParams {
  void* cache;
  void* q_eff;
  void* rstd;
  const void* kv_a;
  const void* weight;
  const void* cos;
  const void* sin;
  const void* q_pe;
  const void* q_nope;
  long long kv_stride, qp_row, qp_head, qn_row, qn_head;
  float eps;
  int layer, num_pages, page, heads, rank, rope, dl;
};

template <typename T, int M>
cudaError_t launch_m(const RawParams& a, const bucket_rows& target, int rows, cudaStream_t s) {
  const Params<T> p{(T*)a.cache, (T*)a.q_eff, (float*)a.rstd, (const T*)a.kv_a,
                    (const T*)a.weight, (const float*)a.cos, (const float*)a.sin,
                    (const T*)a.q_pe, (const T*)a.q_nope, a.kv_stride, a.qp_row, a.qp_head,
                    a.qn_row, a.qn_head, a.eps, 1.0f / (float)a.rank, a.layer, a.num_pages,
                    a.page, a.heads, a.rank, a.rope, a.dl};
  latent_kv_write_kernel<T, M><<<rows, kThreads, 0, s>>>(p, target);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const RawParams& a, const bucket_rows& target, int rows, int m,
                     cudaStream_t s) {
  switch (m) {
    case 4:
      return launch_m<T, 4>(a, target, rows, s);
    case 8:
      if constexpr (sizeof(T) <= 2) return launch_m<T, 8>(a, target, rows, s);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

// dtype 0 = float32, 1 = bfloat16, 2 = float16 (kv_a, the weight, q_pe,
// q_nope, the pool and q_eff); m: elements a rope / pad vector, 4 or 8 (at
// most 16 bytes), dividing rope / 2 and dl - rank - rope.
inline int launch(const RawParams& a, const bucket_rows& target, int rows, int m, int dtype,
                  void* stream) {
  if (rows == 0) return (int)cudaGetLastError();
  if (a.rank % (16 / (dtype == 0 ? 4 : 2)) || a.rope % (2 * m) ||
      (a.dl - a.rank - a.rope) % m || a.dl < a.rank + a.rope) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return (int)launch_t<float>(a, target, rows, m, s);
    case 1:
      return (int)launch_t<__nv_bfloat16>(a, target, rows, m, s);
    case 2:
      return (int)launch_t<__half>(a, target, rows, m, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace latent_kv
