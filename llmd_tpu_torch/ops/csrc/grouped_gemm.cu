// Grouped GEMM over rows sorted by group (the MoE expert matmul).
//
// Replaces the TPU kernel llmd_tpu/ops/grouped_gemm.py:grouped_matmul
// (megablox.gmm, a library Pallas kernel): out[r, :] = x[r, :] @ w[g(r)],
// where x [M, K] holds the rows of group 0, then group 1, ... (group g has
// group_sizes[g] rows, the sizes sum to M), w is [G, K, N] and out [M, N].
// Products accumulate in f32; the output is x's dtype. The pair form takes
// two weight tensors of one shape (an MoE layer's gate and up) and writes
// two outputs from one launch, each rounded once from f32 as two calls
// would.
//
// Bound: bytes. At a decode step (288 rows over 64 experts at
// deepseek-v2-lite) every expert's weights are read once for a few rows
// each (369 MB a product, 0.11 ms); at a 1,024-token prefill step the
// weights are still read once and the 35 GFLOP take 0.036 ms of tensor-core
// time. What must not happen is a weight tile streamed twice, or x re-read
// from device memory per column tile.
//
// bf16 / f16 design (sm_90a):
// - Work items (group, row tile, column tile): row tiles of BM rows never
//   straddle two groups (group g has ceil(size_g / BM) of them), column
//   tiles are 128 wide; the pair's column space spans both weight tensors
//   (tile c < n_tiles is w_a's, the rest w_b's). Items are numbered row
//   tile major, so neighbouring blocks take the column tiles of one row
//   tile at the same time and x's tile is served from L2; a group of up to
//   BM rows streams its weights once.
// - Persistent grid: one block an SM (the host sizes it from M, G and N
//   alone: at most ceil(M / BM) + min(G, M) row tiles). Each block scans
//   group_sizes on the device once into shared memory (row tiles and rows
//   before each group) and walks items blockIdx.x, + gridDim.x, ...; it
//   finds an item's group by binary search. Nothing is read back.
// - Warp specialisation: warpgroup 0 produces, BM / 64 consumer
//   warpgroups each own 64 rows of the tile. One producer thread keeps a
//   ring of stages full with TMA: a stage is K slice of 64 elements (128
//   bytes) of x's tile ([BM, 64], K-major) and w's tile ([64, 128] as two
//   boxes of [64 K, 64 N], N contiguous: MN-major for wgmma's B), both
//   with the 128-byte swizzle, completion on an mbarrier per stage
//   (expect_tx); the consumers free a stage through a second mbarrier.
//   TMA zero-fills columns past N (2,880 at gpt-oss is not a multiple of
//   128), K past K and rows past M; rows of a tile past its group's end
//   are computed but never stored.
// - Consumers: wgmma.mma_async m64n128k16 (bf16/f16 in, f32 accumulate;
//   B through the transpose bit), four k16 steps a stage, one wgmma group
//   kept in flight while the previous stage is released. The epilogue
//   stores the f32 accumulators rounded to x's type, masked by row and
//   column, while the producer already loads the next item's stages.
// - Tiles: BM = 64 rows (one consumer warpgroup) at a decode step, where
//   groups hold a few rows each, or 128 (two) at prefill; the wrapper picks
//   from M and G alone. (128 x 256 tiles measured no faster on the card.)
// - Tensor maps: w's are encoded once per (pointer, shape, dtype) and
//   cached; x's per call. cuTensorMapEncodeTiled is reached through
//   cudaGetDriverEntryPoint, so nothing links libcuda by hand.
//
// f32 keeps the CUDA-core kernel (full f32, no TF32, so that it matches the
// f32 plain version): 64 x 64 tiles, a grid sized for the worst case,
// ceil(M / 64) + G row tiles, warp 0 of each block scanning the sizes for
// its tile, a three-stage cp.async ring; the pair is two launches of it.
//
// The int8 branch (W8A8) is its own source, grouped_gemm_s8.cu.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------- //
// f32: the CUDA-core path.

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


// ---------------------------------------------------------------------- //
// bf16 / f16: wgmma fed by TMA.

constexpr int kMaxGroups = 1024;  // group prefix sums kept in shared memory
constexpr int kSliceK = 64;       // K elements a stage: 128 bytes of bf16/f16
constexpr int kBox = 64;          // rows or columns of one TMA box
constexpr int kSmemBudget = 200 * 1024;

using tma::smem_u32;

using hopper::smem_desc;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

// Keeps the compiler from moving accumulator registers across an async
// wgmma (they are read and written by the tensor cores until it retires).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define LLMD_D8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64x128] += A[64x16] (K-major, descriptor a) * B[16x128] (MN-major,
// descriptor b), f32 accumulate.
template <typename T>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
        : LLMD_D8(0), LLMD_D8(8), LLMD_D8(16), LLMD_D8(24), LLMD_D8(32), LLMD_D8(40),
          LLMD_D8(48), LLMD_D8(56)
        : "l"(a), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
        : LLMD_D8(0), LLMD_D8(8), LLMD_D8(16), LLMD_D8(24), LLMD_D8(32), LLMD_D8(40),
          LLMD_D8(48), LLMD_D8(56)
        : "l"(a), "l"(b), "r"(1));
  }
}
#undef LLMD_D8

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

constexpr int kTileN = 128;  // output columns a work item (one n128 wgmma a k16 step)

template <int BM>
struct Wg {
  static constexpr int kConsumers = BM / 64;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kABytes = BM * kSliceK * 2;
  static constexpr int kBBytes = kTileN * kSliceK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = kSmemBudget / kStageBytes < 8 ? kSmemBudget / kStageBytes : 8;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment slack
};

// One work item: group, first row, rows, column tile; rows <= 0 = none.
struct Item {
  int g, row0, rows, ct;
};

// Item i of the walk (row tile i / ncols, column tile i % ncols), from the
// block's prefix sums: tstart[g] row tiles and rstart[g] rows before group
// g (tstart[G] = all row tiles). Mirrors ops/grouped_gemm.py:grouped_tiles.
template <int BM>
__device__ __forceinline__ Item item_at(int i, int ncols, const int* tstart, const int* rstart,
                                        int G, int M) {
  const int rt = i / ncols;
  int lo = 0, hi = G - 1;  // the last g with tstart[g] <= rt
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tstart[mid] <= rt) lo = mid; else hi = mid - 1;
  }
  const int local = rt - tstart[lo];
  const int size = rstart[lo + 1] - rstart[lo];
  const int row0 = rstart[lo] + local * BM;
  return Item{lo, row0, min(min(BM, size - local * BM), M - row0), i % ncols};
}

template <typename T, int BM>
__global__ void __launch_bounds__(Wg<BM>::kThreads, 1) grouped_gemm_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_wa,
    const __grid_constant__ CUtensorMap map_wb, T* __restrict__ out_a, T* __restrict__ out_b,
    const int32_t* __restrict__ group_sizes, int M, int K, int N, int G, int pair) {
  using W = Wg<BM>;
  constexpr int S = W::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  __shared__ int tstart[kMaxGroups + 1], rstart[kMaxGroups + 1];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      tma::mbar_init(&full[s], 1);
      tma::mbar_init(&empty[s], 4 * W::kConsumers);  // lane 0 of every consumer warp
    }
    tma::mbar_init_fence();
  }
  if (warp == 0) {  // prefix sums of row tiles and rows over the groups
    const unsigned kAll = 0xffffffffu;
    int tiles = 0, rows = 0;
    for (int base = 0; base < G; base += 32) {
      const int g = base + lane;
      const int size = g < G ? max(group_sizes[g], 0) : 0;
      const int nt = (size + BM - 1) / BM;
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
      if (g < G) {
        tstart[g] = tiles + t_incl - nt;
        rstart[g] = rows + r_incl - size;
      }
      tiles += __shfl_sync(kAll, t_incl, 31);
      rows += __shfl_sync(kAll, r_incl, 31);
    }
    if (lane == 0) {
      tstart[G] = tiles;
      rstart[G] = rows;
    }
  }
  __syncthreads();

  const int n_tiles = (N + kTileN - 1) / kTileN;
  const int ncols = n_tiles * (pair ? 2 : 1);
  const int items = tstart[G] * ncols;
  const int ksteps = (K + kSliceK - 1) / kSliceK;

  if (warp < 4) {  // producer warpgroup: one thread issues every load
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const Item t = item_at<BM>(i, ncols, tstart, rstart, G, M);
      if (t.rows <= 0) continue;
      const bool second = t.ct >= n_tiles;
      const CUtensorMap* mw = second ? &map_wb : &map_wa;
      const int n0 = (second ? t.ct - n_tiles : t.ct) * kTileN;
      for (int ks = 0; ks < ksteps; ++ks, ++it) {
        const int s = it % S;
        tma::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        unsigned char* a = smem + s * W::kStageBytes;
        unsigned char* b = a + W::kABytes;
        tma::mbar_expect_tx(&full[s], W::kStageBytes);
        tma::load_2d(a, &map_x, &full[s], ks * kSliceK, t.row0);
#pragma unroll
        for (int j = 0; j < kTileN / kBox; ++j) {
          tma::load_3d(b + j * kBox * kSliceK * 2, mw, &full[s], n0 + j * kBox, ks * kSliceK, t.g);
        }
      }
    }
    return;
  }

  // Consumer warpgroup c: rows 64 c .. 64 c + 63 of the tile.
  const int c = warp / 4 - 1, tid = threadIdx.x % 128;
  const int wr = (tid / 32) * 16 + lane / 4;  // this thread's first row in the warpgroup's 64
  float acc[64];
  int it = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const Item t = item_at<BM>(i, ncols, tstart, rstart, G, M);
    if (t.rows <= 0) continue;
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    int prev = -1;
    for (int ks = 0; ks < ksteps; ++ks, ++it) {
      const int s = it % S;
      tma::mbar_wait(&full[s], (it / S) & 1);
      const uint32_t a = smem_u32(smem + s * W::kStageBytes) + c * 64 * 128;
      const uint32_t b = smem_u32(smem + s * W::kStageBytes + W::kABytes);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSliceK / 16; ++kk) {
        // A: 16 K columns 32 bytes on in each 128-byte row; B: 16 K rows on,
        // its two [64 K, 64 N] boxes LBO apart.
        wgmma_m64n128k16<T>(acc, smem_desc(a + kk * 32, 16, 1024),
                            smem_desc(b + kk * 16 * 128, kBox * kSliceK * 2, 1024));
      }
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();  // the previous stage's products have retired
      if (prev >= 0 && lane == 0) tma::mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) tma::mbar_arrive(&empty[prev]);

    const bool second = t.ct >= n_tiles;
    T* out = second ? out_b : out_a;
    const int n0 = (second ? t.ct - n_tiles : t.ct) * kTileN;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + j * 8 + 2 * (lane % 4);
      if (col >= N) continue;  // N is a multiple of 8, so col + 1 < N as well
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = c * 64 + wr + hr * 8;
        if (r < t.rows) {
          store2(out + (int64_t)(t.row0 + r) * N + col, acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
        }
      }
    }
  }
}


// ---------------------------------------------------------------------- //
// Host side.

using hopper::encode;
using hopper::sm_count;

// w [G, K, N] as boxes of [64 K, 64 N]; cached by (pointer, shape, type).
bool weight_map(CUtensorMap* map, CUtensorMapDataType type, const void* w, int G, int K, int N) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int, int>, CUtensorMap> cache;
  const auto key = std::make_tuple(w, G, K, N, (int)type);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return true;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)G};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t box[3] = {kBox, kSliceK, 1};
  if (!encode(map, type, 3, w, dims, strides, box)) return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}

template <typename T, int BM>
cudaError_t launch_wgmma(void* out_a, void* out_b, const void* x, const void* w_a,
                         const void* w_b, const int32_t* gs, int M, int K, int N, int G,
                         cudaStream_t stream) {
  using W = Wg<BM>;
  const CUtensorMapDataType type = std::is_same<T, __nv_bfloat16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap mx, ma, mb;
  const cuuint64_t xdims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t xstrides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xbox[2] = {kSliceK, BM};
  if (!encode(&mx, type, 2, x, xdims, xstrides, xbox) ||
      !weight_map(&ma, type, w_a, G, K, N) ||
      !weight_map(&mb, type, w_b != nullptr ? w_b : w_a, G, K, N)) {
    return cudaErrorInvalidValue;
  }
  const int pair = w_b != nullptr ? 1 : 0;
  const long long cols = (long long)((N + kTileN - 1) / kTileN) * (1 + pair);
  const long long row_tiles = (M + BM - 1) / BM + (G < M ? G : M);
  const long long items = row_tiles * cols;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = (int)(items < sms ? items : sms);
  auto kernel = grouped_gemm_wgmma_kernel<T, BM>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::kSmem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, W::kThreads, W::kSmem, stream>>>(mx, ma, mb, (T*)out_a, (T*)out_b, gs, M, K, N,
                                                  G, pair);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tiles(int tiles, void* out_a, void* out_b, const void* x, const void* w_a,
                         const void* w_b, const int32_t* gs, int M, int K, int N, int G,
                         cudaStream_t s) {
  switch (tiles) {
    case 0:
      return launch_wgmma<T, 64>(out_a, out_b, x, w_a, w_b, gs, M, K, N, G, s);
    case 1:
      return launch_wgmma<T, 128>(out_a, out_b, x, w_a, w_b, gs, M, K, N, G, s);
    default:
      return cudaErrorInvalidValue;
  }
}


}  // namespace

// out_a = x @ w_a[g(r)] and, when w_b is not null, out_b = x @ w_b[g(r)]
// (w_a and w_b of one shape [G, K, N]). dtype: 0 = float32, 1 = bfloat16,
// 2 = float16. tiles (bf16/f16): 0 = 64 x 128, 1 = 128 x 128 (BM x BN).
// K and N must be multiples of 8, G <= 1024, the pointers 16-byte aligned
// (the wrapper checks all of it).
extern "C" int grouped_gemm(void* out_a, void* out_b, const void* x, const void* w_a,
                            const void* w_b, const void* group_sizes, int M, int K, int N, int G,
                            int dtype, int tiles, void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  if (K % 8 || N % 8 || G < 1 || G > kMaxGroups || (w_b != nullptr && out_b == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* gs = (const int32_t*)group_sizes;
  switch (dtype) {
    case 0: {
      const dim3 grid((M + kBM - 1) / kBM + G, (N + kBN - 1) / kBN);
      for (int p = 0; p < (w_b != nullptr ? 2 : 1); ++p) {
        grouped_gemm_f32_kernel<<<grid, kThreads, 0, s>>>(
            (float*)(p ? out_b : out_a), (const float*)x, (const float*)(p ? w_b : w_a), gs, M,
            K, N, G);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
      }
      return 0;
    }
    case 1:
      return (int)launch_tiles<__nv_bfloat16>(tiles, out_a, out_b, x, w_a, w_b, gs, M, K, N, G, s);
    case 2:
      return (int)launch_tiles<__half>(tiles, out_a, out_b, x, w_a, w_b, gs, M, K, N, G, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
