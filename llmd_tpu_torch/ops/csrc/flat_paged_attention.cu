// Flattened-token paged attention over the KV pool.
//
// Replaces the TPU kernel llmd_tpu/ops/ragged_paged_attention.py:
// _decode_kernel in its row-lookup form (entry flat_paged_attention_full),
// with all of its branches: the sliding window, attention sinks and the
// int8 pool (paged_attention.cuh says how each is computed).
//
// For each packed token t, its H query heads attend over positions
// [win_start, kv_lens[t]) of the pages of row rows[t] (kv_len = position + 1
// is the causal mask inside a row; win_start = max(kv_len - window, 0) on a
// sliding layer, else 0), with G = H / K query heads per KV head. Grid
// (T, K): one block per (token, KV head) with G warps; the block's work is
// paged_attention.cuh:attend_row, shared with the decode kernel.
//
// Bound: bytes. Decode rows read K|V once per (token, KV head) and do
// about 4 * G flops per element read. The design reads each page once per
// block for all G query heads and never fetches a page before the window;
// an int8 pool moves half the bytes of bf16 plus 8 bytes of scales a
// position. What it does not do yet is share pages between the tokens of
// one prefill chunk (each re-reads its prefix, as the TPU kernel does) or
// split long rows across blocks.

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
  const int32_t* rows;
  const int32_t* page_table;
  const int32_t* kv_lens;
  int num_tokens, layer, num_pages, num_kv_heads, page, max_pages, group,
      window;
  float sm_scale;
};

template <typename T, typename C, int DPL>  // DPL = head_dim / 32 per lane
__global__ void flat_paged_attention_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = blockIdx.x;
  const int64_t tok = (int64_t)t * a.num_kv_heads * a.group * DPL * 32;
  C* tile = reinterpret_cast<C*>(smem_raw);
  float* sc = reinterpret_cast<float*>(smem_raw + (size_t)a.page * 2 * DPL * 32 * sizeof(C));
  attend_row<T, C, DPL>(
      static_cast<T*>(a.out) + tok, static_cast<const T*>(a.q) + tok,
      static_cast<const C*>(a.cache), a.scales, a.sinks,
      a.page_table + (int64_t)a.rows[t] * a.max_pages, a.kv_lens[t],
      blockIdx.y, a.layer, a.num_pages, a.num_kv_heads, a.page, a.group,
      a.window, a.sm_scale, tile, sc);
}

template <typename T, typename C, int DPL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.num_tokens, a.num_kv_heads);
  const size_t smem = (size_t)a.page * 2 * DPL * 32 * sizeof(C)
                      + (std::is_same<C, int8_t>::value ? (size_t)a.page * 2 * sizeof(float) : 0);
  flat_paged_attention_kernel<T, C, DPL><<<grid, a.group * 32, smem, stream>>>(a);
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
extern "C" int flat_paged_attention(
    void* out, const void* q, const void* cache, const void* scales,
    const void* sinks, const void* rows, const void* page_table,
    const void* kv_lens, int num_tokens, int layer, int num_pages,
    int num_kv_heads, int page, int max_pages, int group, int head_dim,
    int dtype, int cache_int8, int window, float sm_scale, void* stream) {
  if (num_tokens == 0) return (int)cudaGetLastError();
  if (page > kMaxPage || group < 1 || group > 32) return (int)cudaErrorInvalidValue;
  if (cache_int8 && scales == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{out, q, cache, (const float*)scales, (const float*)sinks,
               (const int32_t*)rows, (const int32_t*)page_table,
               (const int32_t*)kv_lens, num_tokens, layer, num_pages,
               num_kv_heads, page, max_pages, group, window, sm_scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch_c<float>(cache_int8, head_dim, a, s);
    case 1: return (int)launch_c<__nv_bfloat16>(cache_int8, head_dim, a, s);
    case 2: return (int)launch_c<__half>(cache_int8, head_dim, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
