// Batch-grid decode paged attention over the KV pool.
//
// Replaces the TPU kernel llmd_tpu/ops/ragged_paged_attention.py:
// _decode_kernel without row lookup (_decode_call; entries
// decode_paged_attention and decode_paged_attention_full), with all of its
// branches: the sliding window, attention sinks and the int8 pool
// (paged_attention.cuh says how each is computed).
//
// Row b of the decode batch attends with the H heads of its one query
// token over positions [win_start, kv_lens[b]) of its own page-table row
// (win_start = max(kv_len - window, 0) on a sliding layer, else 0), G = H / K
// query heads per KV head, scores and softmax in f32. A pad row (kv_len 0)
// reads nothing and writes zeros, with or without sinks. Grid (B, K): one
// block per (row, KV head) with G warps; the block's work is
// paged_attention.cuh:attend_row, shared with the flat kernel, as the TPU
// package shares _decode_kernel between the two entries.
//
// Bound: bytes, the live (in-window) K|V of every row read once (4 * G
// flops per element); an int8 pool reads half the bytes of bf16 plus 8
// bytes of scales a position. The grid is the decode batch's own: B is
// 8-64 rows of long context, so (B, K) offers as few as 64 blocks to 132
// SMs, and each block walks its row's pages in series (up to
// max_model_len / page of them, or window / page + 1 on a sliding layer),
// one page load at a time. That is accepted for the first port. The
// redesign splits each row's context across several blocks, each keeping
// its own (m, l, acc), with a second pass that merges the partial
// softmaxes, and keeps several page loads in flight (cp.async or TMA into
// a ring of tiles) so that the loads overlap the scoring.

#include "paged_attention.cuh"

namespace {

using paged_attention::attend_row;
using paged_attention::kMaxPage;

struct Args {
  void* out;
  const void* q;
  const void* cache;
  const float* scales;
  const float* sinks;
  const int32_t* page_table;
  const int32_t* kv_lens;
  int batch, layer, num_pages, num_kv_heads, page, max_pages, group, window;
  float sm_scale;
};

template <typename T, typename C, int DPL>  // DPL = head_dim / 32 per lane
__global__ void decode_paged_attention_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int64_t tok = (int64_t)b * a.num_kv_heads * a.group * DPL * 32;
  C* tile = reinterpret_cast<C*>(smem_raw);
  float* sc = reinterpret_cast<float*>(smem_raw + (size_t)a.page * 2 * DPL * 32 * sizeof(C));
  attend_row<T, C, DPL>(
      static_cast<T*>(a.out) + tok, static_cast<const T*>(a.q) + tok,
      static_cast<const C*>(a.cache), a.scales, a.sinks,
      a.page_table + (int64_t)b * a.max_pages, a.kv_lens[b], blockIdx.y,
      a.layer, a.num_pages, a.num_kv_heads, a.page, a.group, a.window,
      a.sm_scale, tile, sc);
}

template <typename T, typename C, int DPL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.batch, a.num_kv_heads);
  const size_t smem = (size_t)a.page * 2 * DPL * 32 * sizeof(C)
                      + (std::is_same<C, int8_t>::value ? (size_t)a.page * 2 * sizeof(float) : 0);
  decode_paged_attention_kernel<T, C, DPL><<<grid, a.group * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t launch_d(int head_dim, const Args& a, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch<T, C, 2>(a, stream);
    case 128: return launch<T, C, 4>(a, stream);
    case 256: return launch<T, C, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_c(int cache_int8, int head_dim, const Args& a, cudaStream_t stream) {
  return cache_int8 ? launch_d<T, int8_t>(head_dim, a, stream)
                    : launch_d<T, T>(head_dim, a, stream);
}

}  // namespace

// dtype (q, out and a float pool): 0 = float32, 1 = bfloat16, 2 = float16.
// cache_int8: the pool is int8 and scales ([L, P, K, page, 2] f32) is set.
// sinks ([H] f32) may be null; window 0 is full attention.
extern "C" int decode_paged_attention(
    void* out, const void* q, const void* cache, const void* scales,
    const void* sinks, const void* page_table, const void* kv_lens, int batch,
    int layer, int num_pages, int num_kv_heads, int page, int max_pages,
    int group, int head_dim, int dtype, int cache_int8, int window,
    float sm_scale, void* stream) {
  if (batch == 0) return (int)cudaGetLastError();
  if (page > kMaxPage || group < 1 || group > 32) return (int)cudaErrorInvalidValue;
  if (cache_int8 && scales == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{out, q, cache, (const float*)scales, (const float*)sinks,
               (const int32_t*)page_table, (const int32_t*)kv_lens, batch,
               layer, num_pages, num_kv_heads, page, max_pages, group, window,
               sm_scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch_c<float>(cache_int8, head_dim, a, s);
    case 1: return (int)launch_c<__nv_bfloat16>(cache_int8, head_dim, a, s);
    case 2: return (int)launch_c<__half>(cache_int8, head_dim, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
