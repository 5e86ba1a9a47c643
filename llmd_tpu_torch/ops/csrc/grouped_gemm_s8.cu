// K6''s int8 branch (W8A8): grouped and dense int8 products on Hopper.
//
// Replaces, with grouped_gemm.cu, the TPU kernel
// llmd_tpu/ops/grouped_gemm.py:grouped_matmul (megablox.gmm) for int8
// weights; the products themselves are llmd_tpu/ops/quant.py:qdot and
// grouped_matmul_q, which JAX leaves to XLA's dot_general and ragged_dot.
// out[r, c] = rescale(xq[r, :] . wq[g(r)][c, :]) with xq int8 [M, K] (one
// f32 scale a row, rows sorted by group, group g has group_sizes[g] rows),
// wq int8 [G, N, K] (K-major: the HF [out, in] layout; one f32 scale a
// group and column), s32 sums (exact in any order: K * 127^2 < 2^31) and
// the epilogue (float(acc) * a_scale[r]) * w_scale[g][c], rounded once to
// the output's type (f32, bf16 or f16): bit-equal to the plain version.
// A dense product is the one-group form (no group sizes: one group of M
// rows); the pair form multiplies one xq by two weight tensors of one
// shape (an MoE layer's gate and up) in one launch.
//
// Bound: bytes at a decode step (the weights read once:
// llama-3-8b's wo at 32 rows: 16.8 MB, 5.0 us at 3.35 TB/s), int8 operations at a
// prefill step (240 GOP for its gate|up at 1,024 tokens, 0.12 ms at 1,979
// TOP/s). The design:
// - Both operands K-major in shared memory, so s8 wgmma (which has no
//   transpose for 8-bit types) reads them straight from 128-byte swizzled
//   TMA boxes: a stage is a 128-byte K slice of the item's rows and of its
//   weight columns.
// - Warp specialisation: one producer warp keeps a ring of stages full
//   with TMA (completion on a `full` mbarrier a stage, expect_tx); one or
//   two consumer warpgroups run wgmma.mma_async ... .s32.s8.s8, four k32
//   steps a stage, and free a stage through an `empty` mbarrier once its
//   products retire. No block-wide sync in the K loop. With two consumer
//   warpgroups the producer's warpgroup gives registers up (setmaxnreg)
//   and the consumers take them.
// - Two forms, chosen on the host (ops/grouped_gemm.py:q8_plan):
//   * swap-AB (decode: a few rows an item). The weight tile is wgmma's
//     64-row A side, 64 output columns a consumer warpgroup; the item's
//     rows are its N side, rounded up to an N that s8 wgmma takes (8, 16,
//     24, 32, 48 or 64), so 32 decode rows cost 32 columns of work, not a
//     64-row tile. Accumulator element (m, n) is out[row0 + n, col0 + m].
//   * prefill: x is A (128-row tiles, 64 rows a consumer warpgroup), the
//     weight B (128 or 256 columns), m64n128k32 or m64n256k32.
// - Work items (group, row tile, column tile): row tiles never straddle a
//   group; the pair's column space spans both weight tensors. Items are
//   numbered group-major, then column tile, then the group's row tiles:
//   the row tiles that read one weight tile run side by side and the
//   tile is served from L2 after the first (llama-3-8b's gate|up, 117 MB
//   of int8, is larger than the 50 MB L2, so a row-tile-major walk would
//   stream it once a row tile); a group's rows stay in L2 throughout.
// - No split K: a sweep of 1 to 8 splits at the models' decode and
//   prefill shapes found a split 3-8 us dearer at decode and 2.0-3.8x
//   slower at prefill (PERF.md), so an item sums all of its K.
// - Persistent grid: one block an SM walks items blockIdx.x, + gridDim.x,
//   ...; it scans group_sizes on the device once into shared memory (row
//   tiles and rows before each group) and finds an item's group by binary
//   search, so nothing is read back and a CUDA graph replays with any
//   sizes. The producer runs ahead into the next item's stages while the
//   consumers store the last one's outputs.
// - TMA zero-fills rows past M, columns past N and K past K (2,880 at
//   gpt-oss is not a multiple of 128); rows of a tile past its group's end
//   are computed but never stored.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using hopper::smem_desc;
using tma::smem_u32;

constexpr int kMaxGroups = 1024;      // group prefix sums kept in shared memory
constexpr int kSlice = 128;           // K bytes a stage
constexpr int kRingBytes = 192 * 1024;
constexpr int kProducerRegs = 40;     // setmaxnreg with two consumer warpgroups:
constexpr int kConsumerRegs = 232;    // 128 x (168 - 40) = 256 x (232 - 168)
constexpr int kEntryRegs = 168;       // 65,536 / 384 threads, as ptxas assigns them

// s32 accumulators: d[64 x N] += A[64 x 32] . B[N x 32]^T, A and B K-major
// int8 in shared memory (descriptors a, b); N / 2 registers a thread.
#define LLMD_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
__device__ __forceinline__ void wgmma_s8(int (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : LLMD_R4(0)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : LLMD_R4(0), LLMD_R4(4)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[12], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11"
      "}, %12, %13, p;\n}\n"
      : LLMD_R4(0), LLMD_R4(4), LLMD_R4(8)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : LLMD_R4(0), LLMD_R4(4), LLMD_R4(8), LLMD_R4(12)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[24], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p;\n}\n"
      : LLMD_R4(0), LLMD_R4(4), LLMD_R4(8), LLMD_R4(12), LLMD_R4(16), LLMD_R4(20)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : LLMD_R4(0), LLMD_R4(4), LLMD_R4(8), LLMD_R4(12), LLMD_R4(16), LLMD_R4(20), LLMD_R4(24), LLMD_R4(28)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : LLMD_R4(0), LLMD_R4(4), LLMD_R4(8), LLMD_R4(12), LLMD_R4(16), LLMD_R4(20), LLMD_R4(24), LLMD_R4(28),
          LLMD_R4(32), LLMD_R4(36), LLMD_R4(40), LLMD_R4(44), LLMD_R4(48), LLMD_R4(52), LLMD_R4(56), LLMD_R4(60)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : LLMD_R4(0), LLMD_R4(4), LLMD_R4(8), LLMD_R4(12), LLMD_R4(16), LLMD_R4(20), LLMD_R4(24), LLMD_R4(28),
          LLMD_R4(32), LLMD_R4(36), LLMD_R4(40), LLMD_R4(44), LLMD_R4(48), LLMD_R4(52), LLMD_R4(56), LLMD_R4(60),
          LLMD_R4(64), LLMD_R4(68), LLMD_R4(72), LLMD_R4(76), LLMD_R4(80), LLMD_R4(84), LLMD_R4(88), LLMD_R4(92),
          LLMD_R4(96), LLMD_R4(100), LLMD_R4(104), LLMD_R4(108), LLMD_R4(112), LLMD_R4(116), LLMD_R4(120), LLMD_R4(124)
      : "l"(a), "l"(b), "r"(1));
}

#undef LLMD_R4

template <int A>
__device__ __forceinline__ void fence_acc(int (&d)[A]) {
#pragma unroll
  for (int i = 0; i < A; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// One kernel form. SWAP: R rows an item (wgmma's N) and C = 64 x (consumer
// warpgroups) columns; prefill: R = 128 rows (64 a consumer warpgroup) and
// C columns (wgmma's N).
template <bool SWAP, int R, int C>
struct Form {
  static constexpr int kConsumers = SWAP ? C / 64 : R / 64;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kN = SWAP ? R : C;
  static constexpr int kAcc = kN / 2;
  static constexpr int kXBytes = R * kSlice;
  static constexpr int kStageBytes = (R + C) * kSlice;
  static constexpr int kStages = kRingBytes / kStageBytes < 8 ? kRingBytes / kStageBytes : 8;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment slack
  static constexpr bool kRebalance = kConsumers == 2;
  static_assert(R % 8 == 0 && C % 64 == 0 && (SWAP || R == 128), "tile");
};

// One work item: group, first row, rows, column tile.
struct Item {
  int g, row0, rows, ct;
};

// Item i: group-major, then column tile, then the group's row tiles of R
// rows (tstart[g] row tiles and rstart[g] rows before group g).
template <int R>
__device__ __forceinline__ Item item_at(int i, int ncols, const int* tstart, const int* rstart,
                                        int G, int M) {
  int lo = 0, hi = G - 1;  // the last g with tstart[g] * ncols <= i
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tstart[mid] * ncols <= i) lo = mid; else hi = mid - 1;
  }
  const int nt = tstart[lo + 1] - tstart[lo];
  const int local = i - tstart[lo] * ncols;
  const int rt = local % nt;
  const int size = rstart[lo + 1] - rstart[lo];
  const int row0 = rstart[lo] + rt * R;
  return Item{lo, row0, min(min(R, size - rt * R), M - row0), local / nt};
}

__device__ __forceinline__ void store1(void* out, int64_t i, float v, int dt) {
  if (dt == 0) {
    static_cast<float*>(out)[i] = v;
  } else if (dt == 1) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<__half*>(out)[i] = __float2half_rn(v);
  }
}
// Two neighbouring columns (i even).
__device__ __forceinline__ void store2(void* out, int64_t i, float a, float b, int dt) {
  if (dt == 0) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + i) = make_float2(a, b);
  } else if (dt == 1) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + i) = __floats2bfloat162_rn(a, b);
  } else {
    *reinterpret_cast<__half2*>(static_cast<__half*>(out) + i) = __floats2half2_rn(a, b);
  }
}

__device__ __forceinline__ float rescale(int acc, float sa, float sw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sa), sw);
}

template <bool SWAP, int R, int C>
__global__ void __launch_bounds__(Form<SWAP, R, C>::kThreads, 1) grouped_gemm_s8_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_wa,
    const __grid_constant__ CUtensorMap map_wb, void* __restrict__ out_a, void* __restrict__ out_b,
    const float* __restrict__ a_scale, const float* __restrict__ s_a, const float* __restrict__ s_b,
    const int32_t* __restrict__ group_sizes, int M, int K, int N, int G, int pair, int out_dtype) {
  using F = Form<SWAP, R, C>;
  constexpr int S = F::kStages;
  extern __shared__ unsigned char s8_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  __shared__ int tstart[kMaxGroups + 1], rstart[kMaxGroups + 1];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(s8_raw) + 1023) & ~(uintptr_t)1023);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      tma::mbar_init(&full[s], 1);
      tma::mbar_init(&empty[s], 4 * F::kConsumers);  // lane 0 of every consumer warp
    }
    tma::mbar_init_fence();
  }
  if (warp == 0) {  // prefix sums of row tiles and rows over the groups
    const unsigned kAll = 0xffffffffu;
    int tiles = 0, rows = 0;
    for (int base = 0; base < G; base += 32) {
      const int g = base + lane;
      const int size = g >= G ? 0 : group_sizes == nullptr ? M : max(group_sizes[g], 0);
      const int nt = (size + R - 1) / R;
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

  const int n_tiles = (N + C - 1) / C;
  const int ncols = n_tiles * (pair ? 2 : 1);
  const int items = tstart[G] * ncols;
  const int kall = (K + kSlice - 1) / kSlice;

  if (warp < 4) {  // producer warpgroup: one thread issues every load
    if constexpr (F::kRebalance) hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const Item t = item_at<R>(i, ncols, tstart, rstart, G, M);
      if (t.rows <= 0) continue;
      const bool second = t.ct >= n_tiles;
      const CUtensorMap* mw = second ? &map_wb : &map_wa;
      const int n0 = (second ? t.ct - n_tiles : t.ct) * C;
      for (int ks = 0; ks < kall; ++ks, ++it) {
        const int s = it % S;
        tma::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        unsigned char* x = smem + s * F::kStageBytes;
        tma::mbar_expect_tx(&full[s], F::kStageBytes);
        tma::load_2d(x, &map_x, &full[s], ks * kSlice, t.row0);
        tma::load_3d(x + F::kXBytes, mw, &full[s], ks * kSlice, n0, t.g);
      }
    }
    return;
  }

  // Consumer warpgroup c: weight rows (SWAP) or x rows (prefill) 64 c ..
  // 64 c + 63 of the stage's box.
  if constexpr (F::kRebalance) hopper::regs_inc<kConsumerRegs>();
  const int c = warp / 4 - 1, w4 = warp % 4;
  int acc[F::kAcc];
  int it = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const Item t = item_at<R>(i, ncols, tstart, rstart, G, M);
    if (t.rows <= 0) continue;
#pragma unroll
    for (int e = 0; e < F::kAcc; ++e) acc[e] = 0;
    int prev = -1;
    for (int ks = 0; ks < kall; ++ks, ++it) {
      const int s = it % S;
      tma::mbar_wait(&full[s], (it / S) & 1);
      const uint32_t x = smem_u32(smem + s * F::kStageBytes);
      const uint32_t a = SWAP ? x + F::kXBytes + c * 64 * kSlice : x + c * 64 * kSlice;
      const uint32_t b = SWAP ? x : x + F::kXBytes;
      fence_acc(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlice / 32; ++kk) {
        // k32 steps 32 bytes on in each 128-byte row of both boxes.
        wgmma_s8(acc, smem_desc(a + kk * 32, 16, 1024), smem_desc(b + kk * 32, 16, 1024));
      }
      hopper::wgmma_commit();
      fence_acc(acc);
      hopper::wgmma_wait<1>();  // the previous stage's products have retired
      if (prev >= 0 && lane == 0) tma::mbar_arrive(&empty[prev]);
      prev = s;
    }
    hopper::wgmma_wait<0>();
    fence_acc(acc);
    if (prev >= 0 && lane == 0) tma::mbar_arrive(&empty[prev]);

    // Accumulator e = 4 j + 2 h + v is element (m, n) = (16 w4 + lane / 4 +
    // 8 h, 8 j + 2 (lane % 4) + v) of the warpgroup's 64 x kN; its tile
    // row and column:
    const bool second = t.ct >= n_tiles;
    const int n0 = (second ? t.ct - n_tiles : t.ct) * C;
    auto row_of = [&](int e) {
      const int m = 16 * w4 + lane / 4 + 8 * ((e >> 1) & 1), n = 8 * (e >> 2) + 2 * (lane % 4) + (e & 1);
      return SWAP ? n : c * 64 + m;
    };
    auto col_of = [&](int e) {
      const int m = 16 * w4 + lane / 4 + 8 * ((e >> 1) & 1), n = 8 * (e >> 2) + 2 * (lane % 4) + (e & 1);
      return n0 + (SWAP ? c * 64 + m : n);
    };

    void* out = second ? out_b : out_a;
    const float* ws = (second ? s_b : s_a) + (int64_t)t.g * N;
    if constexpr (SWAP) {
#pragma unroll
      for (int e = 0; e < F::kAcc; ++e) {
        const int r = row_of(e), col = col_of(e);
        if (r < t.rows && col < N) {
          const int64_t row = t.row0 + r;
          store1(out, row * N + col, rescale(acc[e], a_scale[row], ws[col]), out_dtype);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < F::kAcc; e += 2) {  // v = 0, 1: two neighbouring columns
        const int r = row_of(e), col = col_of(e);
        if (r < t.rows && col < N) {  // N is even, so col + 1 < N as well
          const int64_t row = t.row0 + r;
          const float sa = a_scale[row];
          store2(out, row * N + col, rescale(acc[e], sa, ws[col]), rescale(acc[e + 1], sa, ws[col + 1]),
                 out_dtype);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------- //
// Host side.

// w int8 [G, N, K] (K-major) as boxes of [C rows, 128 K bytes]; cached by
// (pointer, shape, box).
bool weight_map(CUtensorMap* map, const void* w, int G, int N, int K, int C) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int, int>, CUtensorMap> cache;
  const auto key = std::make_tuple(w, G, N, K, C);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return true;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, (cuuint64_t)G};
  const cuuint64_t strides[2] = {(cuuint64_t)K, (cuuint64_t)K * N};
  const cuuint32_t box[3] = {kSlice, (cuuint32_t)C, 1};
  if (!hopper::encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, w, dims, strides, box)) return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}

struct Args {
  void *out_a, *out_b;
  const void *xq, *a_scale, *w_a, *s_a, *w_b, *s_b;
  const int32_t* gs;
  int M, K, N, G, out_dtype;
  cudaStream_t stream;
};

template <bool SWAP, int R, int C>
cudaError_t launch(const Args& p) {
  using F = Form<SWAP, R, C>;
  auto kernel = grouped_gemm_s8_kernel<SWAP, R, C>;
  static int regs = -1;  // the kernel's registers at entry, read once
  if (regs < 0) {
    cudaFuncAttributes fa;
    const cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return e;
    regs = fa.numRegs;
  }
  // setmaxnreg moves registers only between warpgroups of one block: the
  // producer's 128 x (168 - 40) must meet the consumers' 256 x (232 - 168).
  if (F::kRebalance && regs != kEntryRegs) return cudaErrorInvalidDeviceFunction;
  const int pair = p.w_b != nullptr ? 1 : 0;
  CUtensorMap mx, ma, mb;
  const cuuint64_t xdims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.M};
  const cuuint64_t xstrides[1] = {(cuuint64_t)p.K};
  const cuuint32_t xbox[2] = {kSlice, R};
  if (!hopper::encode(&mx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, p.xq, xdims, xstrides, xbox) ||
      !weight_map(&ma, p.w_a, p.G, p.N, p.K, C) ||
      !weight_map(&mb, pair ? p.w_b : p.w_a, p.G, p.N, p.K, C)) {
    return cudaErrorInvalidValue;
  }
  const long long ncols = (long long)((p.N + C - 1) / C) * (1 + pair);
  const long long items = ((p.M + R - 1) / R + (p.G < p.M ? p.G : p.M)) * ncols;  // the most
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int sms = hopper::sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = (int)(items < sms ? items : sms);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, F::kThreads, F::kSmem, p.stream>>>(
      mx, ma, mb, p.out_a, p.out_b, (const float*)p.a_scale, (const float*)p.s_a,
      (const float*)p.s_b, p.gs, p.M, p.K, p.N, p.G, pair, p.out_dtype);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_swap(const Args& p, int cols) {
  switch (cols) {
    case 64:
      return launch<true, R, 64>(p);
    case 128:
      return launch<true, R, 128>(p);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// out_a = rescale(xq @ w_a[g(r)]^T) and, when w_b is not null, out_b =
// rescale(xq @ w_b[g(r)]^T): w_a and w_b int8 [G, N, K] (K-major), their
// scales f32 [G, N]; xq int8 [M, K], a_scale f32 [M]. group_sizes null:
// one group of M rows (G must be 1), a dense product. out_dtype: 0 =
// float32, 1 = bfloat16, 2 = float16. The form (ops/grouped_gemm.py:
// q8_plan): swap = 1 with rows in {8, 16, 24, 32, 48, 64} and cols in {64,
// 128}, or swap = 0 with rows 128 and cols in {128, 256}. K and N must be
// multiples of 16, K * 127^2 < 2^31, G <= 1024, xq and the weights 16-byte
// aligned (the wrapper checks all of it).
extern "C" int grouped_gemm_s8(void* out_a, void* out_b, const void* xq, const void* a_scale,
                               const void* w_a, const void* s_a, const void* w_b,
                               const void* s_b, const void* group_sizes, int M, int K, int N,
                               int G, int out_dtype, int swap, int rows, int cols, void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  if (K % 16 || N % 16 || K < 16 || (long long)K * 127 * 127 >= (1LL << 31) || G < 1 ||
      G > kMaxGroups || (group_sizes == nullptr && G != 1) || out_dtype < 0 || out_dtype > 2 ||
      (w_b != nullptr && (out_b == nullptr || s_b == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args p{out_a, out_b, xq, a_scale, w_a, s_a, w_b, s_b, (const int32_t*)group_sizes,
               M, K, N, G, out_dtype, (cudaStream_t)stream};
  if (!swap) {
    if (rows != 128) return (int)cudaErrorInvalidValue;
    switch (cols) {
      case 128:
        return (int)launch<false, 128, 128>(p);
      case 256:
        return (int)launch<false, 128, 256>(p);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (rows) {
    case 8:
      return (int)launch_swap<8>(p, cols);
    case 16:
      return (int)launch_swap<16>(p, cols);
    case 24:
      return (int)launch_swap<24>(p, cols);
    case 32:
      return (int)launch_swap<32>(p, cols);
    case 48:
      return (int)launch_swap<48>(p, cols);
    case 64:
      return (int)launch_swap<64>(p, cols);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
