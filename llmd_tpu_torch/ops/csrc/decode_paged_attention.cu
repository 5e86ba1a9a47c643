// Batch-grid decode paged attention over the KV pool.
//
// Replaces the TPU kernel llmd_tpu/ops/ragged_paged_attention.py:
// _decode_kernel without row lookup (_decode_call; entries
// decode_paged_attention and decode_paged_attention_full), with all of its
// branches: the sliding window, attention sinks and the int8 pool
// (paged_attention.cuh says how each is computed).
//
// Row b of the decode batch attends with the H heads of its one query
// token over positions [win_start, kv_lens[b]) of its own page-table row,
// G = H / K query heads per KV head, scores and softmax in f32. A pad row
// (kv_len 0) reads nothing and writes zeros, with or without sinks.
//
// Bound: bytes, the live (in-window) K|V of every row read once (4 * G
// flops per element); an int8 pool reads half the bytes of bf16 plus 8
// bytes of scales a position.
//
// Design (bf16 / f16). Grid (B, K, spans): each row's live pages are cut
// into `spans` contiguous spans (the wrapper picks the count from B, K and
// the SM count, about four blocks per SM, so that rows of 1k and of 4k
// context no longer finish far apart and a batch of 8 rows still fills the
// card); one block per (row, KV head, span) runs
// paged_attention.cuh:attend_tile on a tile of one token (G rows of the
// mma), keeping the next two stages of page loads in flight while it
// scores one;
// a second kernel, launched here, merges the spans and adds the sinks.
// Launch shapes depend only on B, K and the table's width, so a decode
// window can be captured in a CUDA graph.
//
// f32 keeps the per-warp CUDA-core path (attend_row), grid (B, K).

#include "paged_attention.cuh"

namespace {

using paged_attention::attend_row;
using paged_attention::kMaxPage;
using paged_attention::TileArgs;

// Names the tensor-core kernels of this library in traces.
struct decode_paged_attention_kernel {};

template <typename C, int DPL>  // DPL = head_dim / 32 per lane
__global__ void decode_paged_attention_f32_kernel(TileArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int64_t tok = (int64_t)b * a.num_kv_heads * a.group * DPL * 32;
  C* tile = reinterpret_cast<C*>(smem_raw);
  float* sc = reinterpret_cast<float*>(smem_raw + (size_t)a.page * 2 * DPL * 32 * sizeof(C));
  attend_row<float, C, DPL>(
      static_cast<float*>(a.out) + tok, static_cast<const float*>(a.q) + tok,
      static_cast<const C*>(a.cache), a.scales, a.sinks,
      a.page_table + (int64_t)b * a.max_pages, a.kv_lens[b], blockIdx.y,
      a.layer, a.num_pages, a.num_kv_heads, a.page, a.group, a.window,
      a.sm_scale, tile, sc);
}

template <typename C, int DPL>
cudaError_t launch_f32(const TileArgs& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.page * 2 * DPL * 32 * sizeof(C)
                      + (std::is_same<C, int8_t>::value ? (size_t)a.page * 2 * sizeof(float) : 0);
  auto kernel = decode_paged_attention_f32_kernel<C, DPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(a.num_tokens, a.num_kv_heads), a.group * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename C>
cudaError_t launch_f32_d(int head_dim, const TileArgs& a, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch_f32<C, 2>(a, stream);
    case 128: return launch_f32<C, 4>(a, stream);
    case 256: return launch_f32<C, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (q, out and a float pool): 0 = float32, 1 = bfloat16, 2 = float16.
// cache_int8: the pool is int8 and scales ([L, P, K, page, 2] f32) is set.
// sinks ([H] f32) may be null; window 0 is full attention. bf16/f16 with
// spans > 1: part_acc ([spans, B, H, D] f32) and part_ml ([spans, B, H, 2]
// f32) are the merge's scratch. f32 takes no spans.
extern "C" int decode_paged_attention(
    void* out, void* part_acc, void* part_ml, const void* q, const void* cache,
    const void* scales, const void* sinks, const void* page_table,
    const void* kv_lens, int batch, int spans, int layer, int num_pages,
    int num_kv_heads, int page, int max_pages, int group, int head_dim,
    int dtype, int cache_int8, int window, float sm_scale, void* stream) {
  if (batch == 0) return (int)cudaGetLastError();
  if (page < 1 || page > kMaxPage || group < 1 || group > 32) return (int)cudaErrorInvalidValue;
  if (cache_int8 && scales == nullptr) return (int)cudaErrorInvalidValue;
  const TileArgs a{out, (float*)part_acc, (float*)part_ml, q, cache, (const float*)scales,
                   (const float*)sinks, nullptr, nullptr, (const int32_t*)page_table,
                   (const int32_t*)kv_lens, batch, batch, layer, num_pages, num_kv_heads,
                   page, max_pages, group, window, dtype == 0 ? 1 : spans, sm_scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return (int)(cache_int8 ? launch_f32_d<int8_t>(head_dim, a, s)
                            : launch_f32_d<float>(head_dim, a, s));
  }
  return (int)paged_attention::launch_tiles_dtype<decode_paged_attention_kernel>(
      dtype, cache_int8, head_dim, a, batch, s);
}
