// Device code shared by the two paged-attention kernels
// (flat_paged_attention.cu, decode_paged_attention.cu), as the TPU package
// shares llmd_tpu/ops/ragged_paged_attention.py:_decode_kernel between its
// row-lookup (flat) and batch-grid (decode) entries.
//
// attend_row: the G = H / K query heads of one KV head of one query token
// attend over positions [0, kv_len) of one page-table row. One block with
// G warps, one warp per query head; each lane holds D / 32 elements of q
// and of the accumulator. The block walks the live pages, staging each
// page's [page, 2D] K|V tile of its KV head in shared memory once for all
// G warps. A warp scores the tile's live positions with shuffle reductions
// and folds them into an f32 online softmax (m, l, acc), one rescale per
// page. Only live positions are read, so uninitialised pool memory never
// enters a sum. sm_scale folds into q; l == 0 (kv_len 0, a pad) divides by
// 1 and writes zeros, as the TPU kernel does. Pool offsets are 64-bit: a
// 32-layer pool of 8,192 pages exceeds 2^31 elements.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace paged_attention {

constexpr int kMaxPage = 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// N consecutive elements at p (aligned to their total size) as floats,
// read with the widest vector load that size allows.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* __restrict__ p, float (&out)[N]) {
  constexpr int kBytes = N * sizeof(T);
  static_assert(kBytes % 4 == 0, "lane slice must be a multiple of 4 bytes");
  using V = typename std::conditional<
      kBytes % 16 == 0, uint4,
      typename std::conditional<kBytes % 8 == 0, uint2, uint32_t>::type>::type;
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
// elements of shared memory.
template <typename T, int DPL>  // DPL = head_dim / 32 elements per lane
__device__ __forceinline__ void attend_row(
    T* __restrict__ out_tok, const T* __restrict__ q_tok,
    const T* __restrict__ cache,  // [L, P, K, page, 2D]
    const int32_t* __restrict__ table_row, int kv_len, int kh, int layer,
    int num_pages, int num_kv_heads, int page, int group, float sm_scale,
    T* __restrict__ tile) {
  constexpr int D = DPL * 32;
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

  const int64_t slab = (int64_t)page * 2 * D;  // elements of one (page, head)
  const int nvec = (int)(slab * sizeof(T) / 16);
  const int n_pages = (kv_len + page - 1) / page;
  for (int p = 0; p < n_pages; ++p) {
    const int phys = table_row[p];
    const uint4* src = reinterpret_cast<const uint4*>(
        cache + (((int64_t)layer * num_pages + phys) * num_kv_heads + kh) * slab);
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      reinterpret_cast<uint4*>(tile)[i] = src[i];
    }
    __syncthreads();

    const int n = min(page, kv_len - p * page);  // live positions, >= 1
    float s[kMaxPage];
    float m_page = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxPage; ++j) {
      if (j < n) {  // warp-uniform
        float kf[DPL];
        load_f<T, DPL>(tile + j * 2 * D + lane * DPL, kf);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) dot += qf[i] * kf[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        }
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
      if (j < n) {
        const float pj = expf(s[j] - m_new);
        l += pj;
        float vf[DPL];
        load_f<T, DPL>(tile + j * 2 * D + D + lane * DPL, vf);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] += pj * vf[i];
      }
    }
    m = m_new;
  }

  const float denom = (l == 0.f) ? 1.f : l;
  T* op = out_tok + (int64_t)h * D + lane * DPL;
#pragma unroll
  for (int i = 0; i < DPL; ++i) op[i] = from_f<T>(acc[i] / denom);
}

}  // namespace paged_attention
