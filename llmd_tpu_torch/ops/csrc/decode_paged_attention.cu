// Batch-grid decode paged attention over the KV pool.
//
// Replaces the TPU kernel llmd_tpu/ops/ragged_paged_attention.py:
// _decode_kernel without row lookup (_decode_call; entries
// decode_paged_attention and decode_paged_attention_full), plain form: no
// sliding window, no sinks, no int8 pool.
//
// Row b of the decode batch attends with the H heads of its one query
// token over positions [0, kv_lens[b]) of its own page-table row, G = H / K
// query heads per KV head, scores and softmax in f32. A pad row
// (kv_len 0) reads nothing and writes zeros. Grid (B, K): one block per
// (row, KV head) with G warps; the block's work is
// paged_attention.cuh:attend_row, shared with the flat kernel, as the TPU
// package shares _decode_kernel between the two entries.
//
// Bound: bytes, the live K|V of every row read once (4 * G flops per
// element). The grid is the decode batch's own: B is 8-64 rows of long
// context, so (B, K) offers as few as 64 blocks to 132 SMs, and each block
// walks its row's pages in series (up to max_model_len / page of them),
// one page load at a time. That is accepted for the first port. The
// redesign splits each row's context across several blocks, each keeping
// its own (m, l, acc), with a second pass that merges the partial
// softmaxes, and keeps several page loads in flight (cp.async or TMA into
// a ring of tiles) so that the loads overlap the scoring.

#include "paged_attention.cuh"

namespace {

using paged_attention::attend_row;
using paged_attention::kMaxPage;

template <typename T, int DPL>  // DPL = head_dim / 32 elements per lane
__global__ void decode_paged_attention_kernel(
    T* __restrict__ out,                   // [B, H, D]
    const T* __restrict__ q,               // [B, H, D]
    const T* __restrict__ cache,           // [L, P, K, page, 2D]
    const int32_t* __restrict__ page_table,  // [B, max_pages]
    const int32_t* __restrict__ kv_lens,   // [B]
    int layer, int num_pages, int num_kv_heads, int page, int max_pages,
    int group, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int64_t tok = (int64_t)b * num_kv_heads * group * DPL * 32;
  attend_row<T, DPL>(
      out + tok, q + tok, cache, page_table + (int64_t)b * max_pages,
      kv_lens[b], blockIdx.y, layer, num_pages, num_kv_heads, page, group,
      sm_scale, reinterpret_cast<T*>(smem_raw));
}

template <typename T, int DPL>
cudaError_t launch(void* out, const void* q, const void* cache,
                   const void* page_table, const void* kv_lens, int batch,
                   int layer, int num_pages, int num_kv_heads, int page,
                   int max_pages, int group, float sm_scale,
                   cudaStream_t stream) {
  const dim3 grid(batch, num_kv_heads);
  const size_t smem = (size_t)page * 2 * DPL * 32 * sizeof(T);
  decode_paged_attention_kernel<T, DPL><<<grid, group * 32, smem, stream>>>(
      (T*)out, (const T*)q, (const T*)cache, (const int32_t*)page_table,
      (const int32_t*)kv_lens, layer, num_pages, num_kv_heads, page,
      max_pages, group, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int head_dim, void* out, const void* q,
                     const void* cache, const void* page_table,
                     const void* kv_lens, int batch, int layer, int num_pages,
                     int num_kv_heads, int page, int max_pages, int group,
                     float sm_scale, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 2>(out, q, cache, page_table, kv_lens, batch, layer,
                          num_pages, num_kv_heads, page, max_pages, group,
                          sm_scale, stream);
    case 128:
      return launch<T, 4>(out, q, cache, page_table, kv_lens, batch, layer,
                          num_pages, num_kv_heads, page, max_pages, group,
                          sm_scale, stream);
    case 256:
      return launch<T, 8>(out, q, cache, page_table, kv_lens, batch, layer,
                          num_pages, num_kv_heads, page, max_pages, group,
                          sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.
extern "C" int decode_paged_attention(
    void* out, const void* q, const void* cache, const void* page_table,
    const void* kv_lens, int batch, int layer, int num_pages,
    int num_kv_heads, int page, int max_pages, int group, int head_dim,
    int dtype, float sm_scale, void* stream) {
  if (batch == 0) return (int)cudaGetLastError();
  if (page > kMaxPage || group < 1 || group > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return (int)launch_d<float>(head_dim, out, q, cache, page_table, kv_lens,
                                  batch, layer, num_pages, num_kv_heads, page,
                                  max_pages, group, sm_scale, s);
    case 1:
      return (int)launch_d<__nv_bfloat16>(head_dim, out, q, cache, page_table,
                                          kv_lens, batch, layer, num_pages,
                                          num_kv_heads, page, max_pages, group,
                                          sm_scale, s);
    case 2:
      return (int)launch_d<__half>(head_dim, out, q, cache, page_table, kv_lens,
                                   batch, layer, num_pages, num_kv_heads, page,
                                   max_pages, group, sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
