// Decode KV write into the paged pool, in place: one token per row.
//
// Replaces the TPU kernel llmd_tpu/ops/kv_write.py:_write_kernel
// (_write_call; entries write_kv_pages_decode and
// write_kv_pages_decode_full). That kernel reads, patches and rewrites a
// whole page through VMEM because Mosaic cannot DMA a single (page, slot)
// row; on Hopper a per-row store is legal, so this kernel stores each
// row's K x 2D values where they belong and touches nothing else.
//
// Grid: one block per row b of the decode batch. A row with valid[b] == 0
// (a pad row) returns before it reads phys[b], which may hold any value.
// A live row copies kv_new[b] ([K, 2D], K then V halves) into
// cache[layer, phys[b], :, offset[b], :] with 16-byte vector stores. Live
// (page, slot) targets are distinct, so blocks never race. A target
// outside the pool is dropped, as the scatter it replaces drops it.
//
// Bound: bytes, B * K * 2D elements in and out once, no arithmetic. At a
// decode batch (tens of rows, 4 KB each) that is a fraction of a
// microsecond, so the kernel's time is its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void decode_kv_write_kernel(
    char* __restrict__ cache,           // [L, P, K, page, 2D] bytes
    const char* __restrict__ kv_new,    // [B, K, 2D] bytes
    const int32_t* __restrict__ phys,   // [B]
    const int32_t* __restrict__ offset, // [B]
    const int32_t* __restrict__ valid,  // [B]
    int layer, int num_pages, int num_kv_heads, int page, int row_bytes) {
  const int b = blockIdx.x;
  if (valid[b] == 0) return;
  const int p = phys[b];
  const int slot = offset[b];
  if (p < 0 || p >= num_pages || slot < 0 || slot >= page) return;
  const int vec_per_row = row_bytes / 16;
  const int n = num_kv_heads * vec_per_row;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int h = i / vec_per_row;
    const int j = i - h * vec_per_row;
    const char* src = kv_new + ((int64_t)b * num_kv_heads + h) * row_bytes;
    const int64_t dst =
        ((((int64_t)layer * num_pages + p) * num_kv_heads + h) * page + slot)
        * (int64_t)row_bytes;
    reinterpret_cast<uint4*>(cache + dst)[j] =
        reinterpret_cast<const uint4*>(src)[j];
  }
}

}  // namespace

// row_bytes: bytes of one (row, head) K|V slab, 2D * itemsize, a multiple
// of 16.
extern "C" int decode_kv_write(
    void* cache, const void* kv_new, const void* phys, const void* offset,
    const void* valid, int batch, int layer, int num_pages, int num_kv_heads,
    int page, int row_bytes, void* stream) {
  if (batch == 0) return (int)cudaGetLastError();
  decode_kv_write_kernel<<<batch, 128, 0, (cudaStream_t)stream>>>(
      (char*)cache, (const char*)kv_new, (const int32_t*)phys,
      (const int32_t*)offset, (const int32_t*)valid, layer, num_pages,
      num_kv_heads, page, row_bytes);
  return (int)cudaGetLastError();
}
