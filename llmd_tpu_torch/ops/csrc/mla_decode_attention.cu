// Latent (MLA) decode attention over the paged latent pool.
//
// Replaces the TPU kernel llmd_tpu/ops/mla_decode.py:_mla_decode_kernel
// (entry mla_decode_paged_attention_full). Row b of the decode batch
// attends with its H absorbed query heads q_eff[b, 0, h, :Dl] over the
// cached latent rows at positions [0, kv_lens[b]) of its page-table row:
// scores q_eff[h] . latent[pos] * sm_scale over the whole latent row,
// softmax in f32, values latent[pos, :rank]. Out is [B, 1, H, rank]. A pad
// row (kv_len 0) reads nothing and writes zeros.
//
// Bound: bytes, each row's live latent rows read once (Dl values per
// position, for all H heads: MLA is MQA with a wide head). The TPU kernel's
// point is that one latent tile serves every query head; so is this one's.
//
// Design. Grid (B, S): row b's live pages are cut into S contiguous
// spans, one block each, so that a batch of a few dozen rows still fills
// the card's 132 SMs with several blocks apiece (the wrapper picks S from
// the batch and the SM count; the host never learns the rows' lengths). A
// block of eight warps walks its span, staging each [page, Dl] tile in
// shared memory with cp.async, the next page's copy in flight while the
// current one is scored (two buffers). Warp w owns heads w, w + 8, ...; a
// lane holds elements lane + 32 i of q (pre-scaled by sm_scale) and of the
// f32 accumulator [rank] of each of its heads. Per page a warp scores the
// live positions (lane j keeps position j's score after a shuffle
// reduction), folds them into an online softmax (m, l, acc) with one
// rescale per page, and accumulates p_j * latent[j, :rank]. Positions past
// kv_len are copied with their page but never read into a sum. With S = 1
// the block writes the normalised output; otherwise it writes its (m, l,
// acc) and a second kernel merges a row's spans (flash-decoding). Pool
// offsets are 64-bit.
//
// What is left for the redesign: the scores and values run on the CUDA
// cores, one shuffle reduction per (position, head). The [H, Dl] x
// [Dl, page] and [H, page] x [page, rank] products fit the tensor cores
// (mma/wgmma) for 16-head models (ROADMAP queue 2).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxPage = 32;
constexpr int kMaxD = 20;   // Dl <= 640
constexpr int kMaxR = 16;   // rank <= 512
constexpr int kMaxSpans = 32;  // spans a row is cut into (one merge warp)
constexpr unsigned kAll = 0xffffffffu;

using convert::from_f;
using convert::to_f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, off));
  return v;
}

template <typename T, int HPW>  // HPW: heads per warp
__global__ void __launch_bounds__(kWarps * 32, HPW <= 2 ? 2 : 1) mla_decode_attention_kernel(
    T* __restrict__ out,                     // [B, H, rank] (one span a row)
    float* __restrict__ part_acc,            // [B, S, H, rank] (several spans)
    float* __restrict__ part_ml,             // [B, S, H, 2]: (m, l) per head
    const T* __restrict__ q,                 // [B, H, Dl]
    const T* __restrict__ cache,             // [L, P, 1, page, Dl]
    const int32_t* __restrict__ page_table,  // [B, max_pages]
    const int32_t* __restrict__ kv_lens,     // [B]
    int layer, int num_pages, int page, int max_pages, int H, int Dl, int rank,
    float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);  // [2][page * Dl]
  const int b = blockIdx.x, span = blockIdx.y, spans = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dpl = Dl / 32, rpl = rank / 32;
  const int kv_len = kv_lens[b];

  float qf[HPW][kMaxD], acc[HPW][kMaxR], m[HPW], l[HPW];
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    const int h = warp + kWarps * hh;
    const T* qh = q + ((int64_t)b * H + min(h, H - 1)) * Dl;
#pragma unroll
    for (int i = 0; i < kMaxD; ++i) {
      qf[hh][i] = (i < dpl && h < H) ? to_f(qh[lane + 32 * i]) * sm_scale : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kMaxR; ++i) acc[hh][i] = 0.f;
    m[hh] = -INFINITY;
    l[hh] = 0.f;
  }

  const int64_t tile_elems = (int64_t)page * Dl;
  const int nvec = (int)(tile_elems * sizeof(T) / 16);
  const int n_pages = (kv_len + page - 1) / page;
  const int per_span = (n_pages + spans - 1) / spans;
  const int p_begin = span * per_span;
  const int p_end = min(n_pages, p_begin + per_span);
  const int32_t* row_pages = page_table + (int64_t)b * max_pages;
  auto fetch = [&](int p) {
    const uint4* src = reinterpret_cast<const uint4*>(
        cache + ((int64_t)layer * num_pages + row_pages[p]) * tile_elems);
    uint4* dst = reinterpret_cast<uint4*>(tiles + (p & 1) * tile_elems);
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) cp_async16(dst + i, src + i);
  };
  if (p_begin < p_end) fetch(p_begin);
  cp_async_commit();

  for (int p = p_begin; p < p_end; ++p) {
    if (p + 1 < p_end) fetch(p + 1);
    cp_async_commit();
    cp_async_wait1();  // page p has landed (page p + 1 may still be in flight)
    __syncthreads();
    const T* tile = tiles + (p & 1) * tile_elems;
    const int n = min(page, kv_len - p * page);  // live positions, >= 1

    // Scores: lane j keeps position j's score for each of its heads.
    float s[HPW];
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) s[hh] = -INFINITY;
    for (int j = 0; j < n; ++j) {
      const T* row = tile + (int64_t)j * Dl + lane;
      float dot[HPW];
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh) dot[hh] = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxD; ++i) {
        if (i < dpl) {
          const float v = to_f(row[32 * i]);
#pragma unroll
          for (int hh = 0; hh < HPW; ++hh) dot[hh] = fmaf(qf[hh][i], v, dot[hh]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh) {
        const float d = warp_sum(dot[hh]);
        if (lane == j) s[hh] = d;
      }
    }

    // Online softmax, one rescale per page.
    float pj[HPW];
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const float m_new = fmaxf(m[hh], warp_max(s[hh]));
      const float alpha = expf(m[hh] - m_new);  // 0 on the first page
      pj[hh] = lane < n ? expf(s[hh] - m_new) : 0.f;
      l[hh] = l[hh] * alpha + warp_sum(pj[hh]);
      m[hh] = m_new;
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) acc[hh][i] *= alpha;
    }

    // Values: acc[h] += p_j * latent[j, :rank].
    for (int j = 0; j < n; ++j) {
      const T* row = tile + (int64_t)j * Dl + lane;
      float pw[HPW];
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh) pw[hh] = __shfl_sync(kAll, pj[hh], j);
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) {
        if (i < rpl) {
          const float v = to_f(row[32 * i]);
#pragma unroll
          for (int hh = 0; hh < HPW; ++hh) acc[hh][i] = fmaf(pw[hh], v, acc[hh][i]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    const int h = warp + kWarps * hh;
    if (h >= H) continue;
    if (spans == 1) {
      const float inv = 1.f / (l[hh] == 0.f ? 1.f : l[hh]);
      T* oh = out + ((int64_t)b * H + h) * rank;
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) {
        if (i < rpl) oh[lane + 32 * i] = from_f<T>(acc[hh][i] * inv);
      }
    } else {
      const int64_t bsh = ((int64_t)b * spans + span) * H + h;
      if (lane == 0) {
        part_ml[2 * bsh] = m[hh];
        part_ml[2 * bsh + 1] = l[hh];
      }
      float* ah = part_acc + bsh * rank;
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) {
        if (i < rpl) ah[lane + 32 * i] = acc[hh][i];  // zeros for an empty span
      }
    }
  }
}

// Merge the S spans of row b, head h (block (b, h)): out = sum_s acc_s
// e^(m_s - m) / sum_s l_s e^(m_s - m), m the largest m_s of the non-empty
// spans. Warp 0 turns the spans' (m, l) into weights; the block's threads
// then combine the rank columns. A row whose spans are all empty (a pad
// row) gets zeros.
template <typename T>
__global__ void __launch_bounds__(128) mla_merge_spans_kernel(
    T* __restrict__ out, const float* __restrict__ part_acc,
    const float* __restrict__ part_ml, int spans, int H, int rank) {
  __shared__ float weight[kMaxSpans];
  __shared__ float inv_den;
  const int b = blockIdx.x, h = blockIdx.y;
  if (threadIdx.x < 32) {
    const int s = threadIdx.x;
    const int64_t bsh = ((int64_t)b * spans + s) * H + h;
    const float ms = s < spans ? part_ml[2 * bsh] : -INFINITY;
    const float ls = s < spans ? part_ml[2 * bsh + 1] : 0.f;
    const bool live = ls > 0.f;
    const float m = warp_max(live ? ms : -INFINITY);
    const float w = live ? expf(ms - m) : 0.f;
    const float den = warp_sum(w * ls);
    if (s < spans) weight[s] = w;
    if (s == 0) inv_den = 1.f / (den == 0.f ? 1.f : den);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rank; r += blockDim.x) {
    float num = 0.f;
    for (int s = 0; s < spans; ++s) {
      const float w = weight[s];
      if (w != 0.f) num += w * part_acc[(((int64_t)b * spans + s) * H + h) * rank + r];
    }
    out[((int64_t)b * H + h) * rank + r] = from_f<T>(num * inv_den);
  }
}

struct Args {
  void* out;
  float* part_acc;
  float* part_ml;
  const void* q;
  const void* cache;
  const int32_t* page_table;
  const int32_t* kv_lens;
  int batch, spans, layer, num_pages, page, max_pages, H, Dl, rank;
  float sm_scale;
};

template <typename T, int HPW>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)a.page * a.Dl * sizeof(T);
  auto kernel = mla_decode_attention_kernel<T, HPW>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(a.batch, a.spans), kWarps * 32, smem, stream>>>(
      (T*)a.out, a.part_acc, a.part_ml, (const T*)a.q, (const T*)a.cache, a.page_table,
      a.kv_lens, a.layer, a.num_pages, a.page, a.max_pages, a.H, a.Dl, a.rank, a.sm_scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.spans == 1) return e;
  mla_merge_spans_kernel<T><<<dim3(a.batch, a.H), 128, 0, stream>>>(
      (T*)a.out, a.part_acc, a.part_ml, a.spans, a.H, a.rank);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_h(const Args& a, cudaStream_t stream) {
  if (a.H <= kWarps) return launch<T, 1>(a, stream);
  if (a.H <= 2 * kWarps) return launch<T, 2>(a, stream);
  return launch<T, 4>(a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. The wrapper checks the
// geometry (Dl and rank multiples of 32, rank <= Dl <= 640, rank <= 512,
// page <= 32, H <= 32) and, for spans > 1, passes f32 scratch of
// [B, spans, H, rank] (part_acc) and [B, spans, H, 2] (part_ml).
extern "C" int mla_decode_attention(void* out, void* part_acc, void* part_ml, const void* q,
                                    const void* cache, const void* page_table,
                                    const void* kv_lens, int batch, int spans, int layer,
                                    int num_pages, int page, int max_pages, int H, int Dl,
                                    int rank, int dtype, float sm_scale, void* stream) {
  if (batch == 0) return (int)cudaGetLastError();
  if (Dl % 32 || rank % 32 || rank > Dl || Dl > 32 * kMaxD || rank > 32 * kMaxR ||
      page < 1 || page > kMaxPage || H < 1 || H > 4 * kWarps || spans < 1 || spans > kMaxSpans ||
      (spans > 1 && (part_acc == nullptr || part_ml == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{out, (float*)part_acc, (float*)part_ml, q, cache,
               (const int32_t*)page_table, (const int32_t*)kv_lens, batch, spans, layer,
               num_pages, page, max_pages, H, Dl, rank, sm_scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return (int)launch_h<float>(a, s);
    case 1:
      return (int)launch_h<__nv_bfloat16>(a, s);
    case 2:
      return (int)launch_h<__half>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
