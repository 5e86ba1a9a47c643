// Flattened-token KV write into the paged pool, in place.
//
// Replaces the TPU kernel llmd_tpu/ops/kv_write.py:_flat_write_kernel
// (entry write_kv_pages_flat_full). That kernel moves whole pages through
// VMEM along a host-built run plan because Mosaic cannot DMA a single
// (page, slot) row; on Hopper a per-token store is legal, so this kernel
// addresses each token directly and needs no run plan.
//
// Grid: one block per packed token t. Tokens t >= total are pads and do
// nothing. phys = page_table[rows[t], pos_t / page], slot = pos_t % page;
// the block copies k_t and v_t ([K, D] each, read straight from the
// step's k/v tensors, no concatenated slab) into the K and V halves of
// cache[layer, phys, :, slot, :] with 16-byte vector stores. Live
// (page, slot) targets are distinct, so blocks never race.
//
// Bound: bytes. It moves 2 * T * K * D elements in and out once; there is
// no arithmetic. The design keeps it a single pass with full 16-byte
// accesses and no pool-sized copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void flat_kv_write_kernel(
    char* __restrict__ cache,            // [L, P, K, page, 2D] bytes
    const char* __restrict__ k,          // [T, K, D] bytes
    const char* __restrict__ v,          // [T, K, D] bytes
    const int32_t* __restrict__ page_table,  // [R, max_pages]
    const int32_t* __restrict__ rows,    // [T]
    const int32_t* __restrict__ positions,   // [T]
    int total, int layer, int num_pages, int num_kv_heads, int page,
    int max_pages, int row_bytes) {
  const int t = blockIdx.x;
  if (t >= total) return;
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

}  // namespace

extern "C" int flat_kv_write(
    void* cache, const void* k, const void* v, const void* page_table,
    const void* rows, const void* positions, int total, int layer,
    int num_pages, int num_kv_heads, int page, int max_pages, int row_bytes,
    void* stream) {
  flat_kv_write_kernel<<<total, 128, 0, (cudaStream_t)stream>>>(
      (char*)cache, (const char*)k, (const char*)v,
      (const int32_t*)page_table, (const int32_t*)rows,
      (const int32_t*)positions, total, layer, num_pages, num_kv_heads,
      page, max_pages, row_bytes);
  return (int)cudaGetLastError();
}
