// Flattened-token paged attention over the KV pool.
//
// Replaces the TPU kernel llmd_tpu/ops/ragged_paged_attention.py:
// _decode_kernel in its row-lookup form (entry flat_paged_attention_full),
// plain form: no sliding window, no sinks, no int8 pool.
//
// For each packed token t, its H query heads attend over positions
// [0, kv_lens[t]) of the pages of row rows[t] (kv_len = position + 1 is
// the causal mask inside a row), with G = H / K query heads per KV head.
// Grid (T, K): one block per (token, KV head) with G warps, one warp per
// query head of the group; each lane holds D / 32 elements of q and of
// the accumulator. The block walks the token's live pages, staging each
// page's [page, 2D] K|V tile of its KV head in shared memory once for all
// G warps. A warp scores the tile's live positions with shuffle
// reductions and folds them into an f32 online softmax (m, l, acc), one
// rescale per page. Only live positions are read, so uninitialised pool
// memory never enters a sum. sm_scale folds into q; l == 0 (a pad token,
// kv_len 0) divides by 1 and writes zeros, as the TPU kernel does.
//
// Bound: bytes. Decode rows read K|V once per (token, KV head) and do
// about 4 * G flops per element read. The design reads each page once per
// block for all G query heads; what it does not do yet is share pages
// between the tokens of one prefill chunk (each re-reads its prefix, as
// the TPU kernel does) or split long rows across blocks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxPage = 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// N consecutive elements at p (aligned to their total size) as floats,
// read with the widest vector load that size allows.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* __restrict__ p, float (&out)[N]) {
  constexpr int kBytes = N * sizeof(T);
  static_assert(kBytes % 4 == 0, "lane slice must be a multiple of 4 bytes");
  using V = typename std::conditional<
      kBytes % 16 == 0, uint4,
      typename std::conditional<kBytes % 8 == 0, uint2, uint32_t>::type>::type;
  constexpr int kVecs = kBytes / sizeof(V);
  constexpr int kPer = sizeof(V) / sizeof(T);
#pragma unroll
  for (int a = 0; a < kVecs; ++a) {
    V raw = reinterpret_cast<const V*>(p)[a];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int b = 0; b < kPer; ++b) out[a * kPer + b] = to_f(e[b]);
  }
}

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
  constexpr int D = DPL * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // [page, 2D]

  const int t = blockIdx.x;
  const int kh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int H = num_kv_heads * group;
  const int h = kh * group + warp;
  const int kv_len = kv_lens[t];
  const int row = rows[t];

  float qf[DPL], acc[DPL];
  load_f<T, DPL>(q + ((int64_t)t * H + h) * D + lane * DPL, qf);
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    qf[i] *= sm_scale;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  const int64_t slab = (int64_t)page * 2 * D;  // elements of one (page, head)
  const int nvec = (int)(slab * sizeof(T) / 16);
  const int n_pages = (kv_len + page - 1) / page;
  for (int p = 0; p < n_pages; ++p) {
    const int phys = page_table[(int64_t)row * max_pages + p];
    const uint4* src = reinterpret_cast<const uint4*>(
        cache + (((int64_t)layer * num_pages + phys) * num_kv_heads + kh) * slab);
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      reinterpret_cast<uint4*>(tile)[i] = src[i];
    }
    __syncthreads();

    const int n = min(page, kv_len - p * page);  // live positions, >= 1
    float s[kMaxPage];
    float m_page = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxPage; ++j) {
      if (j < n) {  // warp-uniform
        float kf[DPL];
        load_f<T, DPL>(tile + j * 2 * D + lane * DPL, kf);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) dot += qf[i] * kf[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        }
        s[j] = dot;
        m_page = fmaxf(m_page, dot);
      }
    }
    const float m_new = fmaxf(m, m_page);
    const float alpha = expf(m - m_new);  // 0 on the first page (m = -inf)
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kMaxPage; ++j) {
      if (j < n) {
        const float pj = expf(s[j] - m_new);
        l += pj;
        float vf[DPL];
        load_f<T, DPL>(tile + j * 2 * D + D + lane * DPL, vf);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] += pj * vf[i];
      }
    }
    m = m_new;
  }

  const float denom = (l == 0.f) ? 1.f : l;
  T* op = out + ((int64_t)t * H + h) * D + lane * DPL;
#pragma unroll
  for (int i = 0; i < DPL; ++i) op[i] = from_f<T>(acc[i] / denom);
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
