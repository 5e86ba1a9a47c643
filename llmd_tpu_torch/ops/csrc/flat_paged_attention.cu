// Flattened-token paged attention over the KV pool.
//
// Replaces the TPU kernel llmd_tpu/ops/ragged_paged_attention.py:
// _decode_kernel in its row-lookup form (entry flat_paged_attention_full),
// with all of its branches: the sliding window, attention sinks and the
// int8 pool (paged_attention.cuh says how each is computed).
//
// For each packed token t, its H query heads attend over positions
// [win_start, kv_lens[t]) of the pages of row rows[t], G = H / K query
// heads per KV head; a pad token (kv_len 0) gets zeros.
//
// Bound. A mixed step (prefill chunks and decode rows) is bound by bytes:
// its decode rows read their whole context for one token each. A prefill
// chunk over a long prefix is bound by operations: each of its tokens
// attends the whole prefix, about 4 * H * D flops a (token, position).
//
// Design (bf16 / f16). The step's query tiles (`items`: up to Tq = 64 / G
// consecutive tokens of one row, built once per step on the device by
// ops/ragged_paged_attention.py:flat_work_items) are the grid, with the KV
// heads and the spans: grid (tiles, K, spans), one block per (tile, KV
// head, span) running paged_attention.cuh:attend_tile. A prefill chunk's
// tokens share each staged K|V page Tq ways and its Q K^T and P V run on
// the tensor cores; a decode token is a tile of one, its context cut
// into spans merged by a second kernel. The grid's size comes from sizes
// the host knows (T, the rows, the SM count): nothing is read back. Pad
// tokens have no tile; the blocks zero their outputs.
//
// f32 keeps the per-warp CUDA-core path (attend_row), grid (T, K).

#include "paged_attention.cuh"

namespace {

using paged_attention::attend_row;
using paged_attention::kMaxPage;
using paged_attention::TileArgs;

// Names the tensor-core kernels of this library in traces.
struct flat_paged_attention_kernel {};

template <typename C, int DPL>  // DPL = head_dim / 32 per lane
__global__ void flat_paged_attention_f32_kernel(TileArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = blockIdx.x;
  const int64_t tok = (int64_t)t * a.num_kv_heads * a.group * DPL * 32;
  C* tile = reinterpret_cast<C*>(smem_raw);
  float* sc = reinterpret_cast<float*>(smem_raw + (size_t)a.page * 2 * DPL * 32 * sizeof(C));
  attend_row<float, C, DPL>(
      static_cast<float*>(a.out) + tok, static_cast<const float*>(a.q) + tok,
      static_cast<const C*>(a.cache), a.scales, a.sinks,
      a.page_table + (int64_t)a.rows[t] * a.max_pages, a.kv_lens[t],
      blockIdx.y, a.layer, a.num_pages, a.num_kv_heads, a.page, a.group,
      a.window, a.sm_scale, tile, sc);
}

template <typename C, int DPL>
cudaError_t launch_f32(const TileArgs& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.page * 2 * DPL * 32 * sizeof(C)
                      + (std::is_same<C, int8_t>::value ? (size_t)a.page * 2 * sizeof(float) : 0);
  auto kernel = flat_paged_attention_f32_kernel<C, DPL>;
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
// sinks ([H] f32) may be null; window 0 is full attention. bf16/f16:
// items ([num_tokens, 2] int32, flat_work_items) lists the query tiles and
// grid_x blocks walk them; for spans > 1 part_acc ([spans, T, H, D] f32)
// and part_ml ([spans, T, H, 2] f32) are the merge's scratch. f32 takes
// neither items nor spans.
extern "C" int flat_paged_attention(
    void* out, void* part_acc, void* part_ml, const void* q, const void* cache,
    const void* scales, const void* sinks, const void* items, const void* rows,
    const void* page_table, const void* kv_lens, int num_tokens, int grid_x,
    int spans, int layer, int num_pages, int num_kv_heads, int page,
    int max_pages, int group, int head_dim, int dtype, int cache_int8,
    int window, float sm_scale, void* stream) {
  if (num_tokens == 0) return (int)cudaGetLastError();
  if (page < 1 || page > kMaxPage || group < 1 || group > 32) return (int)cudaErrorInvalidValue;
  if (cache_int8 && scales == nullptr) return (int)cudaErrorInvalidValue;
  const TileArgs a{out, (float*)part_acc, (float*)part_ml, q, cache, (const float*)scales,
                   (const float*)sinks, (const int32_t*)items, (const int32_t*)rows,
                   (const int32_t*)page_table, (const int32_t*)kv_lens, num_tokens,
                   num_tokens, layer, num_pages, num_kv_heads, page, max_pages, group,
                   window, dtype == 0 ? 1 : spans, sm_scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return (int)(cache_int8 ? launch_f32_d<int8_t>(head_dim, a, s)
                            : launch_f32_d<float>(head_dim, a, s));
  }
  if (items == nullptr || grid_x < 1) return (int)cudaErrorInvalidValue;
  return (int)paged_attention::launch_tiles_dtype<flat_paged_attention_kernel>(
      dtype, cache_int8, head_dim, a, grid_x, s);
}
