// Flattened-token paged attention over the KV pool.
//
// Replaces the TPU kernel llmd_tpu/ops/ragged_paged_attention.py:
// _decode_kernel in its row-lookup form (entry flat_paged_attention_full),
// plain form: no sliding window, no sinks, no int8 pool.
//
// For each packed token t, its H query heads attend over positions
// [0, kv_lens[t]) of the pages of row rows[t] (kv_len = position + 1 is
// the causal mask inside a row), with G = H / K query heads per KV head.
// Grid (T, K): one block per (token, KV head) with G warps; the block's
// work is paged_attention.cuh:attend_row, shared with the decode kernel.
//
// Bound: bytes. Decode rows read K|V once per (token, KV head) and do
// about 4 * G flops per element read. The design reads each page once per
// block for all G query heads; what it does not do yet is share pages
// between the tokens of one prefill chunk (each re-reads its prefix, as
// the TPU kernel does) or split long rows across blocks.

#include "paged_attention.cuh"

namespace {

using paged_attention::attend_row;
using paged_attention::kMaxPage;

template <typename T, int DPL>  // DPL = head_dim / 32 elements per lane
__global__ void flat_paged_attention_kernel(
    T* __restrict__ out,                   // [T, H, D]
    const T* __restrict__ q,               // [T, H, D]
    const T* __restrict__ cache,           // [L, P, K, page, 2D]
    const int32_t* __restrict__ rows,      // [T]
    const int32_t* __restrict__ page_table,  // [R, max_pages]
    const int32_t* __restrict__ kv_lens,   // [T]
    int layer, int num_pages, int num_kv_heads, int page, int max_pages,
    int group, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = blockIdx.x;
  const int64_t tok = (int64_t)t * num_kv_heads * group * DPL * 32;
  attend_row<T, DPL>(
      out + tok, q + tok, cache, page_table + (int64_t)rows[t] * max_pages,
      kv_lens[t], blockIdx.y, layer, num_pages, num_kv_heads, page, group,
      sm_scale, reinterpret_cast<T*>(smem_raw));
}

template <typename T, int DPL>
cudaError_t launch(void* out, const void* q, const void* cache,
                   const void* rows, const void* page_table,
                   const void* kv_lens, int num_tokens, int layer,
                   int num_pages, int num_kv_heads, int page, int max_pages,
                   int group, float sm_scale, cudaStream_t stream) {
  const dim3 grid(num_tokens, num_kv_heads);
  const size_t smem = (size_t)page * 2 * DPL * 32 * sizeof(T);
  flat_paged_attention_kernel<T, DPL><<<grid, group * 32, smem, stream>>>(
      (T*)out, (const T*)q, (const T*)cache, (const int32_t*)rows,
      (const int32_t*)page_table, (const int32_t*)kv_lens, layer, num_pages,
      num_kv_heads, page, max_pages, group, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int head_dim, void* out, const void* q,
                     const void* cache, const void* rows,
                     const void* page_table, const void* kv_lens,
                     int num_tokens, int layer, int num_pages,
                     int num_kv_heads, int page, int max_pages, int group,
                     float sm_scale, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 2>(out, q, cache, rows, page_table, kv_lens,
                          num_tokens, layer, num_pages, num_kv_heads, page,
                          max_pages, group, sm_scale, stream);
    case 128:
      return launch<T, 4>(out, q, cache, rows, page_table, kv_lens,
                          num_tokens, layer, num_pages, num_kv_heads, page,
                          max_pages, group, sm_scale, stream);
    case 256:
      return launch<T, 8>(out, q, cache, rows, page_table, kv_lens,
                          num_tokens, layer, num_pages, num_kv_heads, page,
                          max_pages, group, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.
extern "C" int flat_paged_attention(
    void* out, const void* q, const void* cache, const void* rows,
    const void* page_table, const void* kv_lens, int num_tokens, int layer,
    int num_pages, int num_kv_heads, int page, int max_pages, int group,
    int head_dim, int dtype, float sm_scale, void* stream) {
  if (num_tokens == 0) return (int)cudaGetLastError();
  if (page > kMaxPage || group < 1 || group > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_d<float>(head_dim, out, q, cache, rows, page_table,
                            kv_lens, num_tokens, layer, num_pages,
                            num_kv_heads, page, max_pages, group, sm_scale, s);
      break;
    case 1:
      err = launch_d<__nv_bfloat16>(head_dim, out, q, cache, rows, page_table,
                                    kv_lens, num_tokens, layer, num_pages,
                                    num_kv_heads, page, max_pages, group,
                                    sm_scale, s);
      break;
    case 2:
      err = launch_d<__half>(head_dim, out, q, cache, rows, page_table,
                             kv_lens, num_tokens, layer, num_pages,
                             num_kv_heads, page, max_pages, group, sm_scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}
