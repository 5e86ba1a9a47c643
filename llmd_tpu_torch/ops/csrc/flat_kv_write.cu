// Flattened-token KV write into the paged pool, in place.
//
// Replaces the TPU kernel llmd_tpu/ops/kv_write.py:_flat_write_kernel
// (entry write_kv_pages_flat_full). That kernel moves whole pages through
// VMEM along a host-built run plan because Mosaic cannot DMA a single
// (page, slot) row; on Hopper a per-token store is legal, so this kernel
// addresses each token directly and needs no run plan.
//
// Grid: one block per packed token t of the step's T. The live count
// (num_live, one int32 on the device) is read by every block, so a step
// captured in a CUDA graph at one T replays with any count of live tokens;
// tokens t >= num_live are pads and do nothing. For a live token,
// phys = page_table[rows[t], pos_t / page], slot = pos_t % page; the block
// copies k_t and v_t ([K, D] each, read straight from the
// step's k/v tensors, no concatenated slab) into the K and V halves of
// cache[layer, phys, :, slot, :] with 16-byte vector stores. Live
// (page, slot) targets are distinct, so blocks never race.
//
// Bound: bytes. It moves 2 * num_live * K * D elements in and out once;
// there is no arithmetic. The design keeps it a single pass with full 16-byte
// accesses and no pool-sized copy.
//
// The int8 pool (scales given) fuses what the JAX package runs
// as three XLA steps around the TPU kernel (llmd_tpu/ops/__init__.py:
// write_kv_pages_full_flat: quantize_kv_rows, the data write and
// scatter_kv_scales_flat) into one launch. One warp per (live token, KV
// head) reads the float K and V rows, quantizes each half against its own
// f16-grid scale (kv_quant.cuh, bit for bit the reference's bytes), stores
// the int8 row at (phys, slot) and lane 0 stores the (ks, vs) pair into the
// f32 scale pool. Bound: bytes, 2D float elements in, 2D bytes and 8 bytes
// of scales out per (token, head).

#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_quant.cuh"

namespace {

__global__ void flat_kv_write_kernel(
    char* __restrict__ cache,            // [L, P, K, page, 2D] bytes
    const char* __restrict__ k,          // [T, K, D] bytes
    const char* __restrict__ v,          // [T, K, D] bytes
    const int32_t* __restrict__ page_table,  // [R, max_pages]
    const int32_t* __restrict__ rows,    // [T]
    const int32_t* __restrict__ positions,   // [T]
    const int32_t* __restrict__ num_live,    // [1]
    int layer, int num_pages, int num_kv_heads, int page,
    int max_pages, int row_bytes) {
  const int t = blockIdx.x;
  if (t >= *num_live) return;
  const int row = rows[t];
  const int pos = positions[t];
  const int phys = page_table[(int64_t)row * max_pages + pos / page];
  const int slot = pos % page;
  const int vec_per_half = row_bytes / 16;
  const int n = num_kv_heads * 2 * vec_per_half;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int h = i / (2 * vec_per_half);
    const int rem = i - h * 2 * vec_per_half;
    const int half = rem / vec_per_half;
    const int j = rem - half * vec_per_half;
    const char* src = (half ? v : k) + ((int64_t)t * num_kv_heads + h) * row_bytes;
    const int64_t dst =
        ((((int64_t)layer * num_pages + phys) * num_kv_heads + h) * page + slot)
            * 2 * (int64_t)row_bytes
        + (int64_t)half * row_bytes;
    reinterpret_cast<uint4*>(cache + dst)[j] =
        reinterpret_cast<const uint4*>(src)[j];
  }
}

template <typename T, int DPL>  // DPL = head_dim / 32 per lane
__global__ void flat_kv_write_int8_kernel(
    int8_t* __restrict__ cache,          // [L, P, K, page, 2D]
    float* __restrict__ scales,          // [L, P, K, page, 2]
    const T* __restrict__ k,             // [T, K, D]
    const T* __restrict__ v,             // [T, K, D]
    const int32_t* __restrict__ page_table,  // [R, max_pages]
    const int32_t* __restrict__ rows,    // [T]
    const int32_t* __restrict__ positions,   // [T]
    const int32_t* __restrict__ num_live,    // [1]
    int layer, int num_pages, int num_kv_heads, int page,
    int max_pages) {
  constexpr int D = DPL * 32;
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) / 32;  // (token, head)
  if (w >= *num_live * num_kv_heads) return;  // warp-uniform
  const int t = w / num_kv_heads;
  const int h = w - t * num_kv_heads;
  const int pos = positions[t];
  const int phys = page_table[(int64_t)rows[t] * max_pages + pos / page];
  const int64_t row =
      (((int64_t)layer * num_pages + phys) * num_kv_heads + h) * page + pos % page;
  const int64_t src = ((int64_t)t * num_kv_heads + h) * D;
  const float ks = kv_quant::quantize_row<T, DPL>(k + src, cache + row * 2 * D);
  const float vs = kv_quant::quantize_row<T, DPL>(v + src, cache + row * 2 * D + D);
  if (threadIdx.x % 32 == 0) reinterpret_cast<float2*>(scales)[row] = make_float2(ks, vs);
}

template <typename T, int DPL>
cudaError_t launch_int8(void* cache, void* scales, const void* k, const void* v,
                        const void* page_table, const void* rows,
                        const void* positions, const void* num_live,
                        int tokens, int layer, int num_pages, int num_kv_heads,
                        int page, int max_pages, cudaStream_t stream) {
  const int warps = tokens * num_kv_heads;
  flat_kv_write_int8_kernel<T, DPL><<<(warps + 3) / 4, 128, 0, stream>>>(
      (int8_t*)cache, (float*)scales, (const T*)k, (const T*)v,
      (const int32_t*)page_table, (const int32_t*)rows,
      (const int32_t*)positions, (const int32_t*)num_live, layer, num_pages,
      num_kv_heads, page, max_pages);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_int8_d(int head_dim, void* cache, void* scales,
                          const void* k, const void* v, const void* page_table,
                          const void* rows, const void* positions,
                          const void* num_live, int tokens, int layer,
                          int num_pages, int num_kv_heads, int page,
                          int max_pages, cudaStream_t s) {
  switch (head_dim) {
    case 64:
      return launch_int8<T, 2>(cache, scales, k, v, page_table, rows, positions,
                               num_live, tokens, layer, num_pages, num_kv_heads, page,
                               max_pages, s);
    case 128:
      return launch_int8<T, 4>(cache, scales, k, v, page_table, rows, positions,
                               num_live, tokens, layer, num_pages, num_kv_heads, page,
                               max_pages, s);
    case 256:
      return launch_int8<T, 8>(cache, scales, k, v, page_table, rows, positions,
                               num_live, tokens, layer, num_pages, num_kv_heads, page,
                               max_pages, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One entry for both pools. k/v are [T, K, D] of dtype 0 = float32,
// 1 = bfloat16, 2 = float16; tokens = T. num_live points at one int32 on
// the device: the live tokens [0, num_live), the rest of the stream pads.
// scales == nullptr: a float pool of k's dtype, copied. Otherwise an int8
// pool: k/v are quantized into cache (int8) and scales (f32, [L, P, K,
// page, 2]).
extern "C" int flat_kv_write(
    void* cache, void* scales, const void* k, const void* v,
    const void* page_table, const void* rows, const void* positions,
    const void* num_live, int tokens, int layer, int num_pages,
    int num_kv_heads, int page, int max_pages, int head_dim, int dtype,
    void* stream) {
  if (dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  if (tokens == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (scales == nullptr) {
    const int row_bytes = head_dim * (dtype == 0 ? 4 : 2);
    flat_kv_write_kernel<<<tokens, 128, 0, s>>>(
        (char*)cache, (const char*)k, (const char*)v,
        (const int32_t*)page_table, (const int32_t*)rows,
        (const int32_t*)positions, (const int32_t*)num_live, layer, num_pages,
        num_kv_heads, page, max_pages, row_bytes);
    return (int)cudaGetLastError();
  }
  switch (dtype) {
    case 0:
      return (int)launch_int8_d<float>(head_dim, cache, scales, k, v, page_table, rows,
                                       positions, num_live, tokens, layer, num_pages,
                                       num_kv_heads, page, max_pages, s);
    case 1:
      return (int)launch_int8_d<__nv_bfloat16>(head_dim, cache, scales, k, v, page_table,
                                               rows, positions, num_live, tokens, layer,
                                               num_pages, num_kv_heads, page, max_pages, s);
    default:
      return (int)launch_int8_d<__half>(head_dim, cache, scales, k, v, page_table, rows,
                                        positions, num_live, tokens, layer, num_pages,
                                        num_kv_heads, page, max_pages, s);
  }
}
