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
//
// The int8 pool (scales given) fuses what the JAX package
// runs as three XLA steps around the TPU kernel (llmd_tpu/ops/__init__.py:
// write_kv_pages_full: quantize_kv_rows, the data write and
// scatter_kv_scales) into one launch: one warp per (row, KV head) quantizes
// the K and V halves of kv_new[b] (kv_quant.cuh, bit for bit the
// reference's bytes), stores the int8 row and lane 0 the (ks, vs) pair. A
// row with valid[b] == 0 returns before it reads phys[b] and writes neither
// data nor scales.
//
// The fused form (decode_kv_write_rope, rope_kv_write.cuh) takes each row's
// q, k and v straight from the q|k|v projection, adds the biases, applies
// the rotary embedding to q and k, writes the rotated q for the attention
// kernel and stores k|v (int8: quantized) in the same launch: every Q = 1
// decode forward of a GQA model runs it, one launch a layer where the
// unfused chain ran about 22. A pad row's q is rotated all the same; it
// stores nothing.
//
// The latent form (decode_kv_write_latent, latent_kv_write.cuh) is MLA's:
// each row's kv_norm, the rotary embedding of k_pe and of the query's rope
// heads, the latent row's padding and its store, and the absorbed query
// q_eff assembled from the einsum's output, in one launch a layer at any
// Q (decode rows and the bucketed prefill chunks alike: it computes each
// token's page and slot from the page table and positions), where the
// unfused chain ran about 34 kernels a layer. The store-only entry above is the TPU kernel's own
// function: it stays, on no model's path since.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_quant.cuh"
#include "latent_kv_write.cuh"
#include "rope_kv_write.cuh"

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

template <typename T, int DPL>  // DPL = head_dim / 32 per lane
__global__ void decode_kv_write_int8_kernel(
    int8_t* __restrict__ cache,         // [L, P, K, page, 2D]
    float* __restrict__ scales,         // [L, P, K, page, 2]
    const T* __restrict__ kv_new,       // [B, K, 2D]
    const int32_t* __restrict__ phys,   // [B]
    const int32_t* __restrict__ offset, // [B]
    const int32_t* __restrict__ valid,  // [B]
    int batch, int layer, int num_pages, int num_kv_heads, int page) {
  constexpr int D = DPL * 32;
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) / 32;  // (row, head)
  if (w >= batch * num_kv_heads) return;  // warp-uniform
  const int b = w / num_kv_heads;
  const int h = w - b * num_kv_heads;
  if (valid[b] == 0) return;
  const int p = phys[b];
  const int slot = offset[b];
  if (p < 0 || p >= num_pages || slot < 0 || slot >= page) return;
  const int64_t row = (((int64_t)layer * num_pages + p) * num_kv_heads + h) * page + slot;
  const T* src = kv_new + ((int64_t)b * num_kv_heads + h) * 2 * D;
  const float ks = kv_quant::quantize_row<T, DPL>(src, cache + row * 2 * D);
  const float vs = kv_quant::quantize_row<T, DPL>(src + D, cache + row * 2 * D + D);
  if (threadIdx.x % 32 == 0) reinterpret_cast<float2*>(scales)[row] = make_float2(ks, vs);
}

template <typename T, int DPL>
cudaError_t launch_int8(void* cache, void* scales, const void* kv_new,
                        const void* phys, const void* offset, const void* valid,
                        int batch, int layer, int num_pages, int num_kv_heads,
                        int page, cudaStream_t stream) {
  const int warps = batch * num_kv_heads;
  decode_kv_write_int8_kernel<T, DPL><<<(warps + 3) / 4, 128, 0, stream>>>(
      (int8_t*)cache, (float*)scales, (const T*)kv_new, (const int32_t*)phys,
      (const int32_t*)offset, (const int32_t*)valid, batch, layer, num_pages,
      num_kv_heads, page);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_int8_d(int head_dim, void* cache, void* scales,
                          const void* kv_new, const void* phys,
                          const void* offset, const void* valid, int batch,
                          int layer, int num_pages, int num_kv_heads, int page,
                          cudaStream_t s) {
  switch (head_dim) {
    case 64:
      return launch_int8<T, 2>(cache, scales, kv_new, phys, offset, valid, batch,
                               layer, num_pages, num_kv_heads, page, s);
    case 128:
      return launch_int8<T, 4>(cache, scales, kv_new, phys, offset, valid, batch,
                               layer, num_pages, num_kv_heads, page, s);
    case 256:
      return launch_int8<T, 8>(cache, scales, kv_new, phys, offset, valid, batch,
                               layer, num_pages, num_kv_heads, page, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The fused form's addressing: row b is live when valid[b] != 0 and its
// target (phys[b], offset[b]) lies in the pool (pad rows' phys may hold any
// value and is not read). (The name tags the kernel's profiler name as K4'.)
struct decode_kv_write_rows {
  const int32_t* phys;
  const int32_t* offset;
  const int32_t* valid;
  int num_pages, page;

  __device__ __forceinline__ bool operator()(int b, int* p, int* slot) const {
    if (valid[b] == 0) return false;
    *p = phys[b];
    *slot = offset[b];
    return *p >= 0 && *p < num_pages && *slot >= 0 && *slot < page;
  }
};

}  // namespace

// One entry for both pools. kv_new is [B, K, 2D] of dtype 0 = float32,
// 1 = bfloat16, 2 = float16. scales == nullptr: a float pool of kv_new's
// dtype, copied. Otherwise an int8 pool: kv_new is quantized into cache
// (int8) and scales (f32, [L, P, K, page, 2]).
extern "C" int decode_kv_write(
    void* cache, void* scales, const void* kv_new, const void* phys,
    const void* offset, const void* valid, int batch, int layer,
    int num_pages, int num_kv_heads, int page, int head_dim, int dtype,
    void* stream) {
  if (dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (scales == nullptr) {
    const int row_bytes = 2 * head_dim * (dtype == 0 ? 4 : 2);
    decode_kv_write_kernel<<<batch, 128, 0, s>>>(
        (char*)cache, (const char*)kv_new, (const int32_t*)phys,
        (const int32_t*)offset, (const int32_t*)valid, layer, num_pages,
        num_kv_heads, page, row_bytes);
    return (int)cudaGetLastError();
  }
  switch (dtype) {
    case 0:
      return (int)launch_int8_d<float>(head_dim, cache, scales, kv_new, phys, offset,
                                       valid, batch, layer, num_pages, num_kv_heads, page, s);
    case 1:
      return (int)launch_int8_d<__nv_bfloat16>(head_dim, cache, scales, kv_new, phys,
                                               offset, valid, batch, layer, num_pages,
                                               num_kv_heads, page, s);
    default:
      return (int)launch_int8_d<__half>(head_dim, cache, scales, kv_new, phys, offset,
                                        valid, batch, layer, num_pages, num_kv_heads, page, s);
  }
}

// The fused form: q [B, Nq, D], k and v [B, K, D], each row at its own
// stride (elements) with a contiguous [heads, D] tail, of dtype 0 = float32,
// 1 = bfloat16, 2 = float16; bq/bk/bv ([Nq D], [K D], [K D], the same
// dtype) all given or all nullptr; cos/sin [B, D / 2] f32. Writes the
// rotated q of every row into q_out ([B, Nq, D], contiguous) and stores the
// live rows' rotated k | v as decode_kv_write does (scales == nullptr: a
// float pool of q's dtype; otherwise int8 with its scales).
extern "C" int decode_kv_write_rope(
    void* cache, void* scales, void* q_out, const void* q, const void* k, const void* v,
    long long q_stride, long long k_stride, long long v_stride, const void* bq,
    const void* bk, const void* bv, const void* cos, const void* sin, const void* phys,
    const void* offset, const void* valid, int batch, int layer, int num_pages,
    int num_q_heads, int num_kv_heads, int page, int head_dim, int dtype, void* stream) {
  const rope_kv::RawParams a{cache, scales, q_out, q, k, v, q_stride, k_stride, v_stride,
                             bq, bk, bv, cos, sin, layer, num_pages, num_q_heads,
                             num_kv_heads, page};
  const decode_kv_write_rows target{(const int32_t*)phys, (const int32_t*)offset,
                                    (const int32_t*)valid, num_pages, page};
  return rope_kv::launch(a, target, batch, head_dim, dtype, stream);
}

// The latent form: for each of the step's rows r (N = rows = B q_len),
// kv_a row r ([rank + rope] at kv_stride), kv_norm's weight [rank],
// cos/sin [N, rope / 2] f32, q_pe (row r, head h at qp_row / qp_head) and
// q_nope, the absorbed q_nope (qn_row / qn_head), of dtype 0 = float32,
// 1 = bfloat16, 2 = float16. Writes q_eff [N, heads, dl] (contiguous) for
// every row and stores the live rows' latent rows into cache [L, P, 1,
// page, dl] at the (page, slot) it computes from page_table [B, max_pages]
// int32, positions [N] int32 and valid [N] bool; rstd (f32 [N], or
// nullptr) gets each row's norm factor. m: elements a rope / pad vector.
extern "C" int decode_kv_write_latent(
    void* cache, void* q_eff, void* rstd, const void* kv_a, const void* weight,
    const void* cos, const void* sin, const void* q_pe, const void* q_nope,
    long long kv_stride, long long qp_row, long long qp_head, long long qn_row,
    long long qn_head, float eps, const void* page_table, const void* positions,
    const void* valid, int rows, int q_len, int max_pages, int layer, int num_pages, int page,
    int heads, int rank, int rope, int dl, int m, int dtype, void* stream) {
  const latent_kv::RawParams a{cache, q_eff, rstd, kv_a, weight, cos, sin, q_pe, q_nope,
                               kv_stride, qp_row, qp_head, qn_row, qn_head, eps, layer,
                               num_pages, page, heads, rank, rope, dl};
  const latent_kv::bucket_rows target{(const int32_t*)page_table, (const int32_t*)positions,
                                      (const uint8_t*)valid, q_len, max_pages, num_pages, page};
  return latent_kv::launch(a, target, rows, m, dtype, stream);
}
