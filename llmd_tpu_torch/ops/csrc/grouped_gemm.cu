// Grouped GEMM over rows sorted by group (the MoE expert matmul).
//
// Replaces the TPU kernel llmd_tpu/ops/grouped_gemm.py:grouped_matmul
// (megablox.gmm, a library Pallas kernel): out[r, :] = x[r, :] @ w[g(r)],
// where x [M, K] holds the rows of group 0, then group 1, ... (group g has
// group_sizes[g] rows, the sizes sum to M), w is [G, K, N] and out [M, N].
// Products accumulate in f32; the output is x's dtype.
//
// Bound: at a decode step (M = 288 rows over 64 experts) every expert's
// weights are read once for a few rows each, so bytes bound it (369 MB a
// call at deepseek-v2-lite, 0.11 ms); at a 1024-token prefill step the
// weights are still read once and the 35 GFLOP take 0.036 ms of tensor-core
// time, so it stays byte-bound.
//
// Design. Output tiles of BM x BN = 64 x 64 never straddle two groups. The
// host knows M and G but not the sizes (reading them back would stall the
// window loop), so the grid is sized for the worst case, ceil(M / BM) + G
// row tiles (each group adds at most one partial tile) by ceil(N / BN)
// column tiles. Warp 0 of each block scans group_sizes (a shuffle scan, 32
// groups at a time) to find its (group, row tile); a block with none
// returns. The K loop stages 64-byte K slices of the x and w tiles in
// shared memory with cp.async, three stages deep, zero-filling rows past
// the group's end and columns past K or N. bf16/f16 multiply on the tensor
// cores (mma.sync m16n8k16, fragments by ldmatrix; four warps of 32 x 32);
// f32 multiplies on the CUDA cores in full f32 (no TF32), 4 x 8 outputs a
// thread, so that it matches the f32 plain version.
//
// What is left for the redesign: wgmma with TMA-fed 128-row tiles, a
// persistent grid, and gate|up fused into one call (ROADMAP queue 2).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kThreads = 128;
constexpr int kStages = 3;
constexpr int kSliceBytes = 64;  // bytes of K per stage

template <typename T>
struct Tile {
  static constexpr int kBK = kSliceBytes / sizeof(T);   // K elements per stage
  static constexpr int kVec = 16 / sizeof(T);           // elements per 16-byte copy
  static constexpr int kAStride = kBK + kVec;           // padded row, elements
  static constexpr int kBStride = kBN + kVec;
  static constexpr int kAElems = kBM * kAStride;
  static constexpr int kBElems = kBK * kBStride;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage K slice kt of the block's x rows and w columns into one stage.
template <typename T>
__device__ __forceinline__ void load_stage(
    T* __restrict__ As, T* __restrict__ Bs, const T* __restrict__ x,
    const T* __restrict__ wg, int row0, int rows, int n0, int kt, int K, int N) {
  using C = Tile<T>;
  const int k0 = kt * C::kBK;
  constexpr int kAChunks = kBM * (C::kBK / C::kVec);  // 256
  constexpr int kAPerRow = C::kBK / C::kVec;
  for (int c = threadIdx.x; c < kAChunks; c += kThreads) {
    const int r = c / kAPerRow, kc = (c % kAPerRow) * C::kVec;
    const bool ok = r < rows && k0 + kc < K;
    const T* src = ok ? x + (int64_t)(row0 + r) * K + k0 + kc : x;
    cp_async16(As + r * C::kAStride + kc, src, ok);
  }
  constexpr int kBPerRow = kBN / C::kVec;
  constexpr int kBChunks = C::kBK * kBPerRow;  // 256
  for (int c = threadIdx.x; c < kBChunks; c += kThreads) {
    const int kr = c / kBPerRow, nc = (c % kBPerRow) * C::kVec;
    const bool ok = k0 + kr < K && n0 + nc < N;
    const T* src = ok ? wg + (int64_t)(k0 + kr) * N + n0 + nc : wg;
    cp_async16(Bs + kr * C::kBStride + nc, src, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// Which (group, row tile) block `tile` computes: group, first row, rows.
// Warp 0 scans the group sizes; returns false if the block has no tile.
__device__ __forceinline__ bool find_tile(const int32_t* __restrict__ group_sizes,
                                          int G, int M, int tile, int* info) {
  if (threadIdx.x < 32) {
    const unsigned kAll = 0xffffffffu;
    const int lane = threadIdx.x;
    int tiles_before = 0, rows_before = 0;
    bool found = false;
    for (int base = 0; base < G && !found; base += 32) {
      const int g = base + lane;
      const int size = g < G ? max(group_sizes[g], 0) : 0;
      const int nt = (size + kBM - 1) / kBM;
      int t_incl = nt, r_incl = size;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kAll, t_incl, off);
        const int r = __shfl_up_sync(kAll, r_incl, off);
        if (lane >= off) {
          t_incl += t;
          r_incl += r;
        }
      }
      const int t_lo = tiles_before + t_incl - nt;
      const bool mine = g < G && tile >= t_lo && tile < t_lo + nt;
      const unsigned who = __ballot_sync(kAll, mine);
      if (who) {
        if (lane == __ffs(who) - 1) {
          const int first = rows_before + r_incl - size + (tile - t_lo) * kBM;
          info[0] = g;
          info[1] = first;
          info[2] = min(min(kBM, size - (tile - t_lo) * kBM), M - first);
        }
        found = true;
      }
      tiles_before += __shfl_sync(kAll, t_incl, 31);
      rows_before += __shfl_sync(kAll, r_incl, 31);
    }
    if (!found && lane == 0) info[0] = -1;
  }
  __syncthreads();
  return info[0] >= 0 && info[2] > 0;
}

// bf16 / f16: tensor cores. Four warps in a 2 x 2 grid, each 32 x 32 of
// the tile: 2 m16 fragments x 4 n8 fragments.
template <typename T>
__global__ void __launch_bounds__(kThreads) grouped_gemm_mma_kernel(
    T* __restrict__ out, const T* __restrict__ x, const T* __restrict__ w,
    const int32_t* __restrict__ group_sizes, int M, int K, int N, int G) {
  using C = Tile<T>;
  __shared__ __align__(128) T As[kStages][C::kAElems];
  __shared__ __align__(128) T Bs[kStages][C::kBElems];
  __shared__ int info[3];
  if (!find_tile(group_sizes, G, M, blockIdx.x, info)) return;
  const int g = info[0], row0 = info[1], rows = info[2];
  const int n0 = blockIdx.y * kBN;
  const T* wg = w + (int64_t)g * K * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ktiles = (K + C::kBK - 1) / C::kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage<T>(As[s], Bs[s], x, wg, row0, rows, n0, s, K, N);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; every warp is done with kt - 1
    const int nk = kt + kStages - 1;
    if (nk < ktiles) {
      load_stage<T>(As[nk % kStages], Bs[nk % kStages], x, wg, row0, rows, n0, nk, K, N);
    }
    cp_async_commit();
    const T* a_s = As[kt % kStages];
    const T* b_s = Bs[kt % kStages];
#pragma unroll
    for (int k16 = 0; k16 < C::kBK; k16 += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ldmatrix_x4(a[i], a_s + (wm + i * 16 + lane % 16) * C::kAStride + k16 + (lane / 16) * 8);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {  // two n8 fragments per ldmatrix
        unsigned b[4];
        ldmatrix_x4_trans(b, b_s + (k16 + lane % 16) * C::kBStride + wn + jj * 16 + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma16816<T>(acc[i][2 * jj], a[i], b[0], b[1]);
          mma16816<T>(acc[i][2 * jj + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + wn + j * 8 + 2 * (lane % 4);
      if (c >= N) continue;  // N is a multiple of 8, so c + 1 < N as well
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + i * 16 + lane / 4 + h * 8;
        if (r < rows) {
          store2(out + (int64_t)(row0 + r) * N + c, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    }
  }
}

// f32: CUDA cores in full f32. Thread (ty, tx) of a 16 x 8 grid owns rows
// ty * 4 + [0, 4) and columns tx * 8 + [0, 8) of the tile.
__global__ void __launch_bounds__(kThreads) grouped_gemm_f32_kernel(
    float* __restrict__ out, const float* __restrict__ x, const float* __restrict__ w,
    const int32_t* __restrict__ group_sizes, int M, int K, int N, int G) {
  using C = Tile<float>;
  __shared__ __align__(128) float As[kStages][C::kAElems];
  __shared__ __align__(128) float Bs[kStages][C::kBElems];
  __shared__ int info[3];
  if (!find_tile(group_sizes, G, M, blockIdx.x, info)) return;
  const int g = info[0], row0 = info[1], rows = info[2];
  const int n0 = blockIdx.y * kBN;
  const float* wg = w + (int64_t)g * K * N;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int ktiles = (K + C::kBK - 1) / C::kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage<float>(As[s], Bs[s], x, wg, row0, rows, n0, s, K, N);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < ktiles) {
      load_stage<float>(As[nk % kStages], Bs[nk % kStages], x, wg, row0, rows, n0, nk, K, N);
    }
    cp_async_commit();
    const float* a_s = As[kt % kStages];
    const float* b_s = Bs[kt % kStages];
#pragma unroll
    for (int k = 0; k < C::kBK; ++k) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[(ty * 4 + i) * C::kAStride + k];
      const float4* bp = reinterpret_cast<const float4*>(b_s + k * C::kBStride + tx * 8);
      const float4 b0 = bp[0], b1 = bp[1];
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; j += 4) {
      const int c = n0 + tx * 8 + j;
      if (c < N) {  // N is a multiple of 4 for f32 rows of 16-byte copies
        *reinterpret_cast<float4*>(out + (int64_t)(row0 + r) * N + c) =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
      }
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. K and N must be multiples
// of 8 and the pointers 16-byte aligned (the wrapper checks both).
extern "C" int grouped_gemm(void* out, const void* x, const void* w,
                            const void* group_sizes, int M, int K, int N, int G,
                            int dtype, void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  if (K % 8 || N % 8 || G < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kBM - 1) / kBM + G, (N + kBN - 1) / kBN);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* gs = (const int32_t*)group_sizes;
  switch (dtype) {
    case 0:
      grouped_gemm_f32_kernel<<<grid, kThreads, 0, s>>>(
          (float*)out, (const float*)x, (const float*)w, gs, M, K, N, G);
      break;
    case 1:
      grouped_gemm_mma_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          (__nv_bfloat16*)out, (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, gs,
          M, K, N, G);
      break;
    case 2:
      grouped_gemm_mma_kernel<__half><<<grid, kThreads, 0, s>>>(
          (__half*)out, (const __half*)x, (const __half*)w, gs, M, K, N, G);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
