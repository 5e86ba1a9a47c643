// Device code shared by the two paged-attention kernels
// (flat_paged_attention.cu, decode_paged_attention.cu), as the TPU package
// shares llmd_tpu/ops/ragged_paged_attention.py:_decode_kernel between its
// row-lookup (flat) and batch-grid (decode) entries.
//
// attend_row: the G = H / K query heads of one KV head of one query token
// attend over positions [win_start, kv_len) of one page-table row. One
// block with G warps, one warp per query head; each lane holds D / 32
// elements of q and of the accumulator. The block walks the live pages,
// staging each page's [page, 2D] K|V tile of its KV head in shared memory
// once for all G warps. A warp scores the tile's live positions with
// shuffle reductions and folds them into an f32 online softmax (m, l, acc),
// one rescale per page. Only live positions are read, so uninitialised pool
// memory never enters a sum. sm_scale folds into q; l == 0 (kv_len 0, a
// pad) divides by 1 and writes zeros, as the TPU kernel does. Pool offsets
// are 64-bit: a 32-layer pool of 8,192 pages exceeds 2^31 elements.
//
// The TPU kernel's three further branches, each as it computes them:
// - Sliding window (window > 0): win_start = max(kv_len - window, 0). The
//   walk starts at page win_start / page, so the pages before the window
//   are never read, and the first page's positions below win_start are
//   skipped.
// - Attention sinks (sinks != nullptr, [H] f32): after the walk, one key
//   without a value joins the softmax: m2 = max(m, sink),
//   l = l * exp(m - m2) + exp(sink - m2), acc *= exp(m - m2). m starts at
//   -inf here (the TPU kernel starts at -2^30), so exp(m - m2) is taken
//   only for a finite m: a pad row with a sink gets l = 1, acc = 0 and
//   writes exact zeros, and nothing computes -inf - -inf.
// - int8 pool (C = int8_t, scales [L, P, K, page, 2] f32 on the f16 grid):
//   the tile holds int8 (half the bytes of bf16), widened to f32 in
//   registers; each live position's (ks, vs) pair is staged beside it. The
//   scales fold as on the TPU: the score is (q . k_i8) * ks, the value
//   weight (p * vs) and l sums p. Dead slots' scales are never read (they
//   may be an f16-overflow inf).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "convert.cuh"

namespace paged_attention {

constexpr int kMaxPage = 32;

using convert::from_f;
using convert::to_f;

// N consecutive elements at p (aligned to their total size) as floats,
// read with the widest vector load that size allows.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* __restrict__ p, float (&out)[N]) {
  constexpr int kBytes = N * sizeof(T);
  static_assert(kBytes % 2 == 0, "lane slice must be a multiple of 2 bytes");
  using V = typename std::conditional<
      kBytes % 16 == 0, uint4,
      typename std::conditional<
          kBytes % 8 == 0, uint2,
          typename std::conditional<kBytes % 4 == 0, uint32_t,
                                    uint16_t>::type>::type>::type;
  constexpr int kVecs = kBytes / sizeof(V);
  constexpr int kPer = sizeof(V) / sizeof(T);
#pragma unroll
  for (int a = 0; a < kVecs; ++a) {
    V raw = reinterpret_cast<const V*>(p)[a];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int b = 0; b < kPer; ++b) out[a * kPer + b] = to_f(e[b]);
  }
}

// blockDim.x = group * 32. q_tok and out_tok point at the token's [H, D]
// slab, table_row at its row of the page table, tile at page * 2D
// elements of C in shared memory, sc at 2 * page floats of shared memory.
// T is q's and the output's type, C the pool's (T, or int8_t with scales).
template <typename T, typename C, int DPL>  // DPL = head_dim / 32 per lane
__device__ __forceinline__ void attend_row(
    T* __restrict__ out_tok, const T* __restrict__ q_tok,
    const C* __restrict__ cache,            // [L, P, K, page, 2D]
    const float* __restrict__ scales,       // [L, P, K, page, 2] or null
    const float* __restrict__ sinks,        // [H] or null
    const int32_t* __restrict__ table_row, int kv_len, int kh, int layer,
    int num_pages, int num_kv_heads, int page, int group, int window,
    float sm_scale, C* __restrict__ tile, float* __restrict__ sc) {
  constexpr int D = DPL * 32;
  constexpr bool kQuant = std::is_same<C, int8_t>::value;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = kh * group + warp;

  float qf[DPL], acc[DPL];
  load_f<T, DPL>(q_tok + (int64_t)h * D + lane * DPL, qf);
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    qf[i] *= sm_scale;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  const int win_start = window > 0 ? max(kv_len - window, 0) : 0;
  const int64_t slab = (int64_t)page * 2 * D;  // elements of one (page, head)
  const int nvec = (int)(slab * sizeof(C) / 16);
  const int n_pages = (kv_len + page - 1) / page;
  for (int p = win_start / page; p < n_pages; ++p) {
    const int phys = table_row[p];
    const int64_t head_page = ((int64_t)layer * num_pages + phys) * num_kv_heads + kh;
    const uint4* src = reinterpret_cast<const uint4*>(cache + head_page * slab);
    const int lo = max(win_start - p * page, 0);   // first live position
    const int n = min(page, kv_len - p * page);    // live positions end, > lo
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      reinterpret_cast<uint4*>(tile)[i] = src[i];
    }
    if constexpr (kQuant) {
      const float* s_src = scales + head_page * page * 2;
      for (int i = lo * 2 + threadIdx.x; i < n * 2; i += blockDim.x) sc[i] = s_src[i];
    }
    __syncthreads();

    float s[kMaxPage];
    float m_page = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxPage; ++j) {
      if (j >= lo && j < n) {  // warp-uniform
        float kf[DPL];
        load_f<C, DPL>(tile + j * 2 * D + lane * DPL, kf);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) dot += qf[i] * kf[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        }
        if constexpr (kQuant) dot *= sc[2 * j];
        s[j] = dot;
        m_page = fmaxf(m_page, dot);
      }
    }
    const float m_new = fmaxf(m, m_page);
    const float alpha = expf(m - m_new);  // 0 on the first page (m = -inf)
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kMaxPage; ++j) {
      if (j >= lo && j < n) {
        const float pj = expf(s[j] - m_new);
        l += pj;
        float wj = pj;
        if constexpr (kQuant) wj *= sc[2 * j + 1];
        float vf[DPL];
        load_f<C, DPL>(tile + j * 2 * D + D + lane * DPL, vf);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] += wj * vf[i];
      }
    }
    m = m_new;
  }

  if (sinks != nullptr) {
    const float sk = sinks[h];
    const float m2 = fmaxf(m, sk);
    const float alpha = (m == -INFINITY) ? 0.f : expf(m - m2);
    l = l * alpha + ((sk == -INFINITY) ? 0.f : expf(sk - m2));
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
  }

  const float denom = (l == 0.f) ? 1.f : l;
  T* op = out_tok + (int64_t)h * D + lane * DPL;
#pragma unroll
  for (int i = 0; i < DPL; ++i) op[i] = from_f<T>(acc[i] / denom);
}

}  // namespace paged_attention
