// Latent (MLA) decode attention over the paged latent pool.
//
// Replaces the TPU kernel llmd_tpu/ops/mla_decode.py:_mla_decode_kernel
// (entry mla_decode_paged_attention_full). Row b of the decode batch
// attends with its H absorbed query heads q_eff[b, 0, h, :Dl] over the
// cached latent rows at positions [0, kv_lens[b]) of its page-table row:
// scores q_eff[h] . latent[pos] * sm_scale over the whole latent row (pad
// columns included, as JAX contracts them), softmax in f32, values
// latent[pos, :rank]. Out is [B, 1, H, rank]. A pad row (kv_len 0) reads
// nothing and writes zeros.
//
// Bound: bytes, each row's live latent rows read once (Dl values per
// position for all H heads: MLA is MQA with a wide head). The TPU kernel's
// point is that one latent tile serves every query head; so is this one's.
//
// bf16 / f16 design: heads are the rows of the tensor-core products.
// - Work items: every row's live pages are cut into chunks of one size
//   for the whole batch, the smallest whose count fits one wave of blocks
//   (schedule: one block an SM a head group), so a 4k-token row gets about
//   four times the chunks of a 1k-token one and every block about the same
//   work. Block (head group, j) takes item j, found on the device from
//   kv_lens; nothing is read back.
// - Head groups of HG = 16 or 32 heads (16 MF; H up to 16 takes 16, more
//   take 32 each, the last group padded and masked on store). The head
//   groups of one item are neighbouring blocks, so the pages they all read
//   come from L2 after the first (at 128 heads, four groups of 32 measured
//   faster than two of 64).
// - Warp specialisation: one producer warp moves the query tile [HG, Dl]
//   and then the chunk's keys, 32 latent rows a stage, into a ring of 4
//   stages (what 227 KB leave at Dl 640) with TMA bulk copies, one
//   latent row each, completing on a full barrier per stage; eight consumer
//   warps compute and free a stage through an empty barrier. Lane j of the
//   producer moves row j of every stage and loads its page-table entry a
//   stage ahead. Rows it does not load (positions past kv_len or the
//   chunk, heads past H) are zeroed by plain stores, never read from the
//   pool, so NaN in dead pool slots never reaches an operand. Rows of Q and
//   the ring are padded by 16 bytes, so ldmatrix has no bank conflicts.
// - Scores S[HG, keys] = Q Lᵀ on mma.sync m16n8k16 (f32 accumulate) over
//   the whole Dl: warp w takes m16 head fragment w % MF against the stage's
//   keys over part w / MF of Dl (Q and the keys are read from shared memory
//   once a stage; 16 heads keep their query fragments in registers); the
//   parts meet in shared memory in f32.
// - Softmax: in f32, log2 units, one rescale a stage; scores outside the
//   row's live keys are set to -inf before the max. P is written to shared
//   memory as hi + lo terms in the working type (as paged_attention.cuh
//   does: about 16 bits of P instead of 8, which keeps outputs near zero
//   within one bf16 ulp), with each row's rescale factor.
// - P·V: [HG, keys] x L[keys, :rank] on mma.sync: warp w owns rank columns
//   16 w, 16 (w + 8), ... (64 of rank 512) for every head of the group,
//   its f32 accumulators in registers; each V fragment is read once for all
//   head fragments, and hi and lo each go through the mma.
// - End of an item: a row of one chunk is normalised and written by its
//   block; otherwise the block writes (m, l, acc) to f32 scratch indexed by
//   item, and mla_decode_attention_merge_kernel folds the row's chunks
//   (flash-decoding) and writes pad rows' zeros. Pool offsets are 64-bit.
//
// f32: the CUDA-core path (the card's f32 engine tests need full f32), on
// the same items: grid (items, 1, head groups of 32); eight warps, warp w
// owning heads w, w + 8, ...; a lane holds q and the f32 accumulator in
// lane-strided slices; per page (two cp.async buffers), scores by shuffle
// reduction and an online softmax.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "convert.cuh"
#include "paged_attention.cuh"
#include "tma.cuh"

namespace {

namespace pa = paged_attention;

constexpr int kWarps = 8;
constexpr int kMaxPage = 32;
constexpr int kMaxD = 20;   // Dl <= 640
constexpr int kMaxR = 16;   // rank <= 512
constexpr int kMaxSpans = 32;  // spans a row is cut into (one merge warp)
constexpr unsigned kAll = 0xffffffffu;

using convert::from_f;
using convert::to_f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, off));
  return v;
}

// A block's work item: chunk k of row b's live pages. Every row's live
// pages are cut into chunks of one size for the whole batch, the smallest
// for which all rows' chunks number at most `target` (one wave of blocks a
// head group), so that long and short rows give blocks of about equal
// work, and no fewer than the longest row's pages / spans (a row has at
// most `spans` chunks). The items are numbered row by row; block j takes
// item j (none past the last). Found by warp 0: the chunk by bisection,
// the row by a scan of the rows' chunk counts, which one block also writes
// to row_items ([B + 1]: each row's first item, then the count) for the
// merge. Mirrored by ops/mla_decode.py:span_chunk. Every thread of the
// block calls it (it synchronises).
struct Item {
  int chunk, b, k, count;  // b < 0: no item; count: the row's chunks
};

__device__ __forceinline__ Item schedule(const int32_t* __restrict__ kv_lens, int batch, int page,
                                         int spans, int target, int j,
                                         int32_t* __restrict__ row_items, int* shared) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int total = 0, longest = 0;
    for (int b = lane; b < batch; b += 32) {
      const int n = (max(kv_lens[b], 0) + page - 1) / page;
      total += n;
      longest = max(longest, n);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      total += __shfl_xor_sync(kAll, total, off);
      longest = max(longest, __shfl_xor_sync(kAll, longest, off));
    }
    int lo = max(1, max((total + target - 1) / target, (longest + spans - 1) / spans));
    int hi = max(lo, longest);
    while (lo < hi) {  // the smallest chunk whose count fits the target
      const int mid = (lo + hi) / 2;
      int count = 0;
      for (int b = lane; b < batch; b += 32) {
        count += ((max(kv_lens[b], 0) + page - 1) / page + mid - 1) / mid;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(kAll, count, off);
      if (count <= target) hi = mid; else lo = mid + 1;
    }
    if (lane == 0) {
      shared[0] = lo;
      shared[1] = -1;
    }
    __syncwarp();
    int before = 0;
    for (int base = 0; base < batch; base += 32) {
      const int b = base + lane;
      const int c = b < batch ? ((max(kv_lens[b], 0) + page - 1) / page + lo - 1) / lo : 0;
      int incl = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kAll, incl, off);
        if (lane >= off) incl += v;
      }
      const int first = before + incl - c;
      if (row_items != nullptr && b < batch) row_items[b] = first;
      if (b < batch && j >= first && j < first + c) {  // one lane of one round
        shared[1] = b;
        shared[2] = j - first;
        shared[3] = c;
      }
      before += __shfl_sync(kAll, incl, 31);
    }
    if (row_items != nullptr && lane == 0) row_items[batch] = before;
  }
  __syncthreads();
  return Item{shared[0], shared[1], shared[2], shared[3]};
}

// ---------------------------------------------------------------------- //
// f32: the CUDA-core path.

template <typename T, int HPW>  // HPW: heads per warp
__global__ void __launch_bounds__(kWarps * 32, HPW <= 2 ? 2 : 1) mla_decode_attention_kernel(
    T* __restrict__ out,                     // [B, H, rank] (rows of one chunk)
    float* __restrict__ part_acc,            // [items, H, rank] (rows of several)
    float* __restrict__ part_ml,             // [items, H, 2]: (m, l) per head
    int32_t* __restrict__ row_items,         // [B + 1] for the merge
    const T* __restrict__ q,                 // [B, H, Dl]
    const T* __restrict__ cache,             // [L, P, 1, page, Dl]
    const int32_t* __restrict__ page_table,  // [B, max_pages]
    const int32_t* __restrict__ kv_lens,     // [B]
    int layer, int num_pages, int page, int max_pages, int H, int Dl, int rank,
    float sm_scale, int batch, int spans, int target) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int sched_s[4];
  T* tiles = reinterpret_cast<T*>(smem_raw);  // [2][page * Dl]
  const int j = blockIdx.x;
  const Item it = schedule(kv_lens, batch, page, spans, target, j,
                           j == 0 && blockIdx.z == 0 ? row_items : nullptr, sched_s);
  if (it.b < 0) return;
  const int b = it.b;
  const int h0 = blockIdx.z * HPW * kWarps;  // the block's head group
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dpl = Dl / 32, rpl = rank / 32;
  const int kv_len = kv_lens[b];
  float qf[HPW][kMaxD], acc[HPW][kMaxR], m[HPW], l[HPW];
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    const int h = h0 + warp + kWarps * hh;
    const T* qh = q + ((int64_t)b * H + min(h, H - 1)) * Dl;
#pragma unroll
    for (int i = 0; i < kMaxD; ++i) {
      qf[hh][i] = (i < dpl && h < H) ? to_f(qh[lane + 32 * i]) * sm_scale : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kMaxR; ++i) acc[hh][i] = 0.f;
    m[hh] = -INFINITY;
    l[hh] = 0.f;
  }

  const int64_t tile_elems = (int64_t)page * Dl;
  const int nvec = (int)(tile_elems * sizeof(T) / 16);
  const int n_pages = (kv_len + page - 1) / page;
  const int p_begin = it.k * it.chunk;
  const int p_end = min(n_pages, p_begin + it.chunk);
  const int32_t* row_pages = page_table + (int64_t)b * max_pages;
  auto fetch = [&](int p) {
    const uint4* src = reinterpret_cast<const uint4*>(
        cache + ((int64_t)layer * num_pages + row_pages[p]) * tile_elems);
    uint4* dst = reinterpret_cast<uint4*>(tiles + (p & 1) * tile_elems);
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) cp_async16(dst + i, src + i);
  };
  if (p_begin < p_end) fetch(p_begin);
  cp_async_commit();

  for (int p = p_begin; p < p_end; ++p) {
    if (p + 1 < p_end) fetch(p + 1);
    cp_async_commit();
    cp_async_wait1();  // page p has landed (page p + 1 may still be in flight)
    __syncthreads();
    const T* tile = tiles + (p & 1) * tile_elems;
    const int n = min(page, kv_len - p * page);  // live positions, >= 1

    // Scores: lane j keeps position j's score for each of its heads.
    float s[HPW];
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) s[hh] = -INFINITY;
    for (int j = 0; j < n; ++j) {
      const T* row = tile + (int64_t)j * Dl + lane;
      float dot[HPW];
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh) dot[hh] = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxD; ++i) {
        if (i < dpl) {
          const float v = to_f(row[32 * i]);
#pragma unroll
          for (int hh = 0; hh < HPW; ++hh) dot[hh] = fmaf(qf[hh][i], v, dot[hh]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh) {
        const float d = warp_sum(dot[hh]);
        if (lane == j) s[hh] = d;
      }
    }

    // Online softmax, one rescale per page.
    float pj[HPW];
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const float m_new = fmaxf(m[hh], warp_max(s[hh]));
      const float alpha = expf(m[hh] - m_new);  // 0 on the first page
      pj[hh] = lane < n ? expf(s[hh] - m_new) : 0.f;
      l[hh] = l[hh] * alpha + warp_sum(pj[hh]);
      m[hh] = m_new;
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) acc[hh][i] *= alpha;
    }

    // Values: acc[h] += p_j * latent[j, :rank].
    for (int j = 0; j < n; ++j) {
      const T* row = tile + (int64_t)j * Dl + lane;
      float pw[HPW];
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh) pw[hh] = __shfl_sync(kAll, pj[hh], j);
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) {
        if (i < rpl) {
          const float v = to_f(row[32 * i]);
#pragma unroll
          for (int hh = 0; hh < HPW; ++hh) acc[hh][i] = fmaf(pw[hh], v, acc[hh][i]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    const int h = h0 + warp + kWarps * hh;
    if (h >= H) continue;
    if (it.count == 1) {
      const float inv = 1.f / (l[hh] == 0.f ? 1.f : l[hh]);
      T* oh = out + ((int64_t)b * H + h) * rank;
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) {
        if (i < rpl) oh[lane + 32 * i] = from_f<T>(acc[hh][i] * inv);
      }
    } else {
      const int64_t jh = (int64_t)j * H + h;
      if (lane == 0) {
        part_ml[2 * jh] = m[hh];
        part_ml[2 * jh + 1] = l[hh];
      }
      float* ah = part_acc + jh * rank;
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) {
        if (i < rpl) ah[lane + 32 * i] = acc[hh][i];
      }
    }
  }
}

// Merge the chunks of row b, head h (block (b, h)): out = sum_s acc_s
// e^(m_s - m) / sum_s l_s e^(m_s - m), m the largest m_s of the chunks
// (items row_items[b] ..). Warp 0 turns the chunks' (m, l) into weights;
// the block's threads then combine the rank columns. A row of one chunk
// was written by its block; a row of none (a pad row) gets zeros.
template <typename T>
__global__ void __launch_bounds__(128) mla_decode_attention_merge_kernel(
    T* __restrict__ out, const float* __restrict__ part_acc,
    const float* __restrict__ part_ml, const int32_t* __restrict__ row_items, int H, int rank) {
  __shared__ float weight[kMaxSpans];
  __shared__ float inv_den;
  const int b = blockIdx.x, h = blockIdx.y;
  const int first = row_items[b], spans = row_items[b + 1] - first;
  if (spans == 1) return;
  if (threadIdx.x < 32) {
    const int s = threadIdx.x;
    const int64_t jh = (int64_t)(first + s) * H + h;
    const float ms = s < spans ? part_ml[2 * jh] : -INFINITY;
    const float ls = s < spans ? part_ml[2 * jh + 1] : 0.f;
    const bool live = ls > 0.f;
    const float m = warp_max(live ? ms : -INFINITY);
    const float w = live ? expf(ms - m) : 0.f;
    const float den = warp_sum(w * ls);
    if (s < spans) weight[s] = w;
    if (s == 0) inv_den = 1.f / (den == 0.f ? 1.f : den);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rank; r += blockDim.x) {
    float num = 0.f;
    for (int s = 0; s < spans; ++s) {
      const float w = weight[s];
      if (w != 0.f) num += w * part_acc[((int64_t)(first + s) * H + h) * rank + r];
    }
    out[((int64_t)b * H + h) * rank + r] = from_f<T>(num * inv_den);
  }
}

// ---------------------------------------------------------------------- //
// bf16 / f16: the tensor-core path.

constexpr int kColBlocks = kMaxR * 32 / 16 / kWarps;  // 16-column blocks of rank a warp owns, at most
constexpr int kConsumerThreads = kWarps * 32;

// The consumer warps' own barrier (the producer warp never joins it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

// Shared memory of a block of MF m16 head fragments (HG = 16 MF heads), in
// bytes for a latent width Dl: the query tile, the ring, the score parts
// (f32), P's hi and lo terms, and per row the rescale factor and final
// (m, l). Rows of Q and the ring are padded by 16 bytes, so ldmatrix has
// no bank conflicts. At Dl 640 the ring takes what 227 KB leave: 4 stages
// of 32 latent rows.
template <int MF>
struct TcSmem {
  static constexpr int kKeys = 32;  // latent rows a stage: one a producer lane
  static constexpr int kStages = 4;
  static constexpr int kRows = 16 * MF;
  static constexpr int kParts = kWarps / MF;  // Dl is cut in this many parts a head fragment
  // 16 heads keep the warp's query fragments in registers (Dl <= 640: at
  // most 5 k16 steps a part); more heads read them from the staged tile.
  static constexpr int kQRegSteps = MF == 1 ? 5 : 1;
  static constexpr int kPasses = kRows / kWarps;  // softmax rows a warp
  static constexpr int kSRow = kKeys + 1;  // f32 score row
  static constexpr int kPRow = kKeys + 8;  // P row, elements
  static constexpr int kS = kParts * kRows * kSRow * 4;
  static constexpr int kP = 2 * kRows * kPRow * 2;
  static constexpr int kMisc = 3 * kRows * 4;
  __host__ __device__ static int row(int Dl) { return Dl + 8; }
  __host__ __device__ static int q_bytes(int Dl) { return kRows * row(Dl) * 2; }
  __host__ __device__ static int ring_bytes(int Dl) { return kStages * kKeys * row(Dl) * 2; }
  __host__ __device__ static int bytes(int Dl) {
    return q_bytes(Dl) + ring_bytes(Dl) + kS + kP + kMisc;
  }
};

template <typename T, int MF>
__global__ void __launch_bounds__(kConsumerThreads + 32, 1) mla_decode_attention_tc_kernel(
    T* __restrict__ out, float* __restrict__ part_acc, float* __restrict__ part_ml,
    int32_t* __restrict__ row_items, const T* __restrict__ q, const T* __restrict__ cache,
    const int32_t* __restrict__ page_table, const int32_t* __restrict__ kv_lens, int layer,
    int num_pages, int page, int max_pages, int H, int Dl, int rank, float sm_scale, int batch,
    int spans, int target) {
  using S = TcSmem<MF>;
  constexpr int R = S::kRows;
  constexpr int NS = S::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[NS], empty[NS], q_full;
  __shared__ int sched_s[4];
  const int rowE = S::row(Dl);
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ring = reinterpret_cast<T*>(smem_raw + S::q_bytes(Dl));
  float* sp = reinterpret_cast<float*>(smem_raw + S::q_bytes(Dl) + S::ring_bytes(Dl));
  T* p_hi = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(sp) + S::kS);
  T* p_lo = p_hi + R * S::kPRow;
  float* alpha_s = reinterpret_cast<float*>(p_lo + R * S::kPRow);
  float* m_fin = alpha_s + R;
  float* l_fin = m_fin + R;

  const int h0 = blockIdx.x * R, j = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      tma::mbar_init(&full[s], 1);
      tma::mbar_init(&empty[s], kWarps);  // lane 0 of every consumer warp
    }
    tma::mbar_init(&q_full, 1);
    tma::mbar_init_fence();
  }
  const Item it = schedule(kv_lens, batch, page, spans, target, j,
                           j == 0 && blockIdx.x == 0 ? row_items : nullptr, sched_s);
  if (it.b < 0) return;
  const int b = it.b, kv_len = kv_lens[b];
  const int n_pages = (kv_len + page - 1) / page;
  const int p_begin = it.k * it.chunk;
  const int p_end = min(n_pages, p_begin + it.chunk);
  const int key0 = p_begin * page;                // the chunk's first position
  const int key_end = min(p_end * page, kv_len);  // one past its last live one
  const int n_stages = (key_end - key0 + S::kKeys - 1) / S::kKeys;  // >= 1

  if (warp == kWarps) {
    // Producer warp. Rows it does not load (heads past H, positions past
    // the span) are zeroed by plain stores before the stage's barrier
    // arrive: an unloaded row would otherwise hold stale or uninitialised
    // bytes, and 0 * NaN poisons a product.
    const int row_bytes = Dl * 2;
    auto zero_row = [&](T* dst) {
      for (int c = 0; c < Dl / 8; ++c) reinterpret_cast<uint4*>(dst)[c] = make_uint4(0, 0, 0, 0);
    };
    const T* qb = q + (int64_t)b * H * Dl;
    const int nq = min(R, H - h0);
    for (int r = lane; r < R; r += 32) {
      if (r >= nq) zero_row(qs + r * rowE);
    }
    __syncwarp();
    if (lane == 0) tma::mbar_expect_tx(&q_full, nq * row_bytes);
    __syncwarp();
    for (int r = lane; r < nq; r += 32) {
      tma::bulk_copy(qs + r * rowE, qb + (int64_t)(h0 + r) * Dl, row_bytes, &q_full);
    }
    // Lane j < kKeys moves latent row j of every stage; its page-table
    // entry is loaded one stage ahead, so no copy waits on a table load.
    const int32_t* row_pages = page_table + (int64_t)b * max_pages;
    auto table_entry = [&](int st) {
      const int pos = key0 + st * S::kKeys + lane;
      return (lane < S::kKeys && pos < key_end) ? row_pages[pos / page] : 0;
    };
    int phys = table_entry(0);
    for (int st = 0; st < n_stages; ++st) {
      const int s = st % NS;
      tma::mbar_wait(&empty[s], ((st / NS) & 1) ^ 1);
      const int pos = key0 + st * S::kKeys + lane;
      const bool live = lane < S::kKeys && pos < key_end;
      T* dst = ring + (s * S::kKeys + lane) * rowE;
      if (lane < S::kKeys && !live) zero_row(dst);
      __syncwarp();
      if (lane == 0) {
        tma::mbar_expect_tx(&full[s], min(S::kKeys, key_end - (key0 + st * S::kKeys)) * row_bytes);
      }
      __syncwarp();
      if (live) {
        tma::bulk_copy(dst, cache + (((int64_t)layer * num_pages + phys) * page + pos % page) * Dl,
                  row_bytes, &full[s]);
      }
      phys = table_entry(st + 1);
    }
    return;
  }

  // Consumer warps. Scores: warp w takes head fragment mf = w % MF against
  // the stage's keys over part w / MF of Dl, so Q and the keys are read
  // from shared memory once a stage (Q not at all with 16 heads).
  constexpr int KEYS = S::kKeys, NF = KEYS / 8, KS16 = KEYS / 16;
  const int mf = warp % MF, part = warp / MF;
  const int nk16 = Dl / 16;
  const int k_lo = part * nk16 / S::kParts, k_hi = (part + 1) * nk16 / S::kParts;
  const T* q_frag = qs + (mf * 16 + lane % 16) * rowE + (lane / 16) * 8;
  const int nb = rank / 16;
  const float scale = sm_scale * pa::kLog2e;  // scores in log2 units
  // Softmax: a warp a row (lane = key), row f * kWarps + warp in pass f.
  auto soft_row = [&](int f) { return f * kWarps + warp; };

  float m_run[S::kPasses], l_run[S::kPasses];
#pragma unroll
  for (int f = 0; f < S::kPasses; ++f) {
    m_run[f] = -INFINITY;
    l_run[f] = 0.f;
  }
  float acc[MF][kColBlocks][2][4];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int i = 0; i < kColBlocks; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][i][n][e] = 0.f;
  unsigned qreg[S::kQRegSteps][4];
  tma::mbar_wait(&q_full, 0);
  if constexpr (MF == 1) {
#pragma unroll
    for (int i = 0; i < S::kQRegSteps; ++i) {
      if (k_lo + i < k_hi) pa::ldmatrix_x4(qreg[i], q_frag + (k_lo + i) * 16);
    }
  }

  for (int st = 0; st < n_stages; ++st) {
    const int s = st % NS;
    tma::mbar_wait(&full[s], (st / NS) & 1);
    const T* tile = ring + s * KEYS * rowE;

    {  // S[16 mf .., KEYS keys] over k16 steps [k_lo, k_hi): NF n8 chains
      float c[NF][4];
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
      const T* k_frag = tile + (lane % 8 + (lane / 16) * 8) * rowE + ((lane / 8) % 2) * 8;
      auto step = [&](const unsigned (&qa)[4], int kk) {
#pragma unroll
        for (int kb = 0; kb < KS16; ++kb) {
          unsigned kf[4];
          pa::ldmatrix_x4(kf, k_frag + kb * 16 * rowE + kk * 16);
          pa::mma16816<T>(c[2 * kb], qa, kf[0], kf[1]);
          pa::mma16816<T>(c[2 * kb + 1], qa, kf[2], kf[3]);
        }
      };
      if constexpr (MF == 1) {
#pragma unroll
        for (int i = 0; i < S::kQRegSteps; ++i) {
          if (k_lo + i < k_hi) step(qreg[i], k_lo + i);
        }
      } else {
        for (int kk = k_lo; kk < k_hi; ++kk) {
          unsigned qa[4];
          pa::ldmatrix_x4(qa, q_frag + kk * 16);
          step(qa, kk);
        }
      }
      float* sr = sp + (part * R + mf * 16 + g) * S::kSRow + 2 * t4;
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        sr[8 * n] = c[n][0];
        sr[8 * n + 1] = c[n][1];
        sr[8 * S::kSRow + 8 * n] = c[n][2];
        sr[8 * S::kSRow + 8 * n + 1] = c[n][3];
      }
    }
    consumer_sync();

    // Online softmax, kPasses rows a warp.
#pragma unroll
    for (int f = 0; f < S::kPasses; ++f) {
      const int r = soft_row(f), j = lane;
      float sc = 0.f;
#pragma unroll
      for (int p = 0; p < S::kParts; ++p) sc += sp[(p * R + r) * S::kSRow + j];
      sc = key0 + st * KEYS + j < key_end ? sc * scale : -INFINITY;
      float mx = sc;
#pragma unroll
      for (int off = KEYS / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, off));
      const float m_new = fmaxf(m_run[f], mx);
      const float alpha = (m_run[f] == -INFINITY) ? 0.f : pa::ex2(m_run[f] - m_new);
      const float pe = pa::ex2(sc - (m_new == -INFINITY ? 0.f : m_new));  // 0 where masked
      float sum = pe;
#pragma unroll
      for (int off = KEYS / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(kAll, sum, off);
      l_run[f] = l_run[f] * alpha + sum;
      m_run[f] = m_new;
      const T hi = from_f<T>(pe);
      p_hi[r * S::kPRow + j] = hi;
      p_lo[r * S::kPRow + j] = from_f<T>(pe - to_f(hi));
      if (j == 0) alpha_s[r] = alpha;
    }
    consumer_sync();

    // acc = acc * alpha + P V over this warp's rank columns, P as hi + lo;
    // each V fragment is read once for every head fragment.
    unsigned ph[MF][KS16][4], pl[MF][KS16][4];
#pragma unroll
    for (int f = 0; f < MF; ++f) {
#pragma unroll
      for (int kb = 0; kb < KS16; ++kb) {
        const int off = (f * 16 + lane % 16) * S::kPRow + kb * 16 + (lane / 16) * 8;
        pa::ldmatrix_x4(ph[f][kb], p_hi + off);
        pa::ldmatrix_x4(pl[f][kb], p_lo + off);
      }
      const float a0 = alpha_s[f * 16 + g], a1 = alpha_s[f * 16 + g + 8];
#pragma unroll
      for (int i = 0; i < kColBlocks; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          acc[f][i][n][0] *= a0;
          acc[f][i][n][1] *= a0;
          acc[f][i][n][2] *= a1;
          acc[f][i][n][3] *= a1;
        }
    }
#pragma unroll
    for (int i = 0; i < kColBlocks; ++i) {
      const int cb = warp + kWarps * i;
      if (cb < nb) {
#pragma unroll
        for (int kb = 0; kb < KS16; ++kb) {
          unsigned vb[4];
          pa::ldmatrix_x4_trans(vb, tile + (kb * 16 + lane % 16) * rowE + cb * 16 + (lane / 16) * 8);
#pragma unroll
          for (int f = 0; f < MF; ++f) {
            pa::mma16816<T>(acc[f][i][0], ph[f][kb], vb[0], vb[1]);
            pa::mma16816<T>(acc[f][i][1], ph[f][kb], vb[2], vb[3]);
            pa::mma16816<T>(acc[f][i][0], pl[f][kb], vb[0], vb[1]);
            pa::mma16816<T>(acc[f][i][1], pl[f][kb], vb[2], vb[3]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) tma::mbar_arrive(&empty[s]);  // this warp is done with the stage
  }

#pragma unroll
  for (int f = 0; f < S::kPasses; ++f) {
    if (lane == 0) {
      m_fin[soft_row(f)] = m_run[f];
      l_fin[soft_row(f)] = l_run[f];
    }
  }
  consumer_sync();
  if (it.count > 1) {  // (m, l) in natural units for the merge
    for (int r = threadIdx.x; r < R; r += kConsumerThreads) {
      if (h0 + r < H) {
        const int64_t jh = (int64_t)j * H + h0 + r;
        part_ml[2 * jh] = m_fin[r] * 0.6931471805599453f;
        part_ml[2 * jh + 1] = l_fin[r];
      }
    }
  }
#pragma unroll
  for (int f = 0; f < MF; ++f) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = f * 16 + g + 8 * hr, h = h0 + r;
      if (h >= H) continue;
      const float inv = 1.f / (l_fin[r] == 0.f ? 1.f : l_fin[r]);
#pragma unroll
      for (int i = 0; i < kColBlocks; ++i) {
        const int cb = warp + kWarps * i;
        if (cb >= nb) continue;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = cb * 16 + n * 8 + 2 * t4;
          const float v0 = acc[f][i][n][2 * hr], v1 = acc[f][i][n][2 * hr + 1];
          if (it.count == 1) {
            *reinterpret_cast<unsigned*>(out + ((int64_t)b * H + h) * rank + col) =
                pa::pack2(T(), v0 * inv, v1 * inv);
          } else {
            *reinterpret_cast<float2*>(part_acc + ((int64_t)j * H + h) * rank + col) =
                make_float2(v0, v1);
          }
        }
      }
    }
  }
}

struct Args {
  void* out;
  float* part_acc;
  float* part_ml;
  int32_t* row_items;
  const void* q;
  const void* cache;
  const int32_t* page_table;
  const int32_t* kv_lens;
  int batch, spans, layer, num_pages, page, max_pages, H, Dl, rank;
  float sm_scale;
  int target;
  // Blocks a head group: one an item, and there are at most `target`
  // items, or one a live row where rows outnumber it.
  int items() const { return target > batch ? target : batch; }
};

template <typename T>
cudaError_t merge(const Args& a, cudaStream_t stream) {
  mla_decode_attention_merge_kernel<T><<<dim3(a.batch, a.H), 128, 0, stream>>>(
      (T*)a.out, a.part_acc, a.part_ml, a.row_items, a.H, a.rank);
  return cudaGetLastError();
}

template <typename T, int HPW>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)a.page * a.Dl * sizeof(T);
  auto kernel = mla_decode_attention_kernel<T, HPW>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int groups = (a.H + HPW * kWarps - 1) / (HPW * kWarps);
  kernel<<<dim3(a.items(), 1, groups), kWarps * 32, smem, stream>>>(
      (T*)a.out, a.part_acc, a.part_ml, a.row_items, (const T*)a.q, (const T*)a.cache,
      a.page_table, a.kv_lens, a.layer, a.num_pages, a.page, a.max_pages, a.H, a.Dl, a.rank,
      a.sm_scale, a.batch, a.spans, a.target);
  const cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? e : merge<T>(a, stream);
}

template <typename T, int MF>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  const int smem = TcSmem<MF>::bytes(a.Dl);
  auto kernel = mla_decode_attention_tc_kernel<T, MF>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int groups = (a.H + 16 * MF - 1) / (16 * MF);
  kernel<<<dim3(groups, a.items()), kConsumerThreads + 32, smem, stream>>>(
      (T*)a.out, a.part_acc, a.part_ml, a.row_items, (const T*)a.q, (const T*)a.cache,
      a.page_table, a.kv_lens, a.layer, a.num_pages, a.page, a.max_pages, a.H, a.Dl, a.rank,
      a.sm_scale, a.batch, a.spans, a.target);
  e = cudaGetLastError();
  return e != cudaSuccess ? e : merge<T>(a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. The wrapper checks the
// geometry (Dl and rank multiples of 32, rank <= Dl <= 640, rank <= 512,
// page <= 32; any H) and passes scratch: part_acc f32 [max(target, B), H,
// rank], part_ml f32 [max(target, B), H, 2], row_items int32 [B + 1].
// spans is the most chunks a row is cut into, target the blocks wanted per
// head group (schedule); bf16/f16 take head groups of 16 (H <= 16), 32 (H
// or more), f32 of 32. The merge kernel runs on every call (it writes pad
// rows' zeros).
extern "C" int mla_decode_attention(void* out, void* part_acc, void* part_ml, void* row_items,
                                    const void* q, const void* cache, const void* page_table,
                                    const void* kv_lens, int batch, int spans, int layer,
                                    int num_pages, int page, int max_pages, int H, int Dl,
                                    int rank, int dtype, float sm_scale, int target,
                                    void* stream) {
  if (batch == 0) return (int)cudaGetLastError();
  if (Dl % 32 || rank % 32 || rank > Dl || Dl > 32 * kMaxD || rank > 32 * kMaxR ||
      page < 1 || page > kMaxPage || H < 1 || spans < 1 || spans > kMaxSpans || target < 1 ||
      part_acc == nullptr || part_ml == nullptr || row_items == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{out, (float*)part_acc, (float*)part_ml, (int32_t*)row_items, q, cache,
               (const int32_t*)page_table, (const int32_t*)kv_lens, batch, spans, layer,
               num_pages, page, max_pages, H, Dl, rank, sm_scale, target};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      if (H <= kWarps) return (int)launch<float, 1>(a, s);
      if (H <= 2 * kWarps) return (int)launch<float, 2>(a, s);
      return (int)launch<float, 4>(a, s);
    case 1:
      return (int)(H <= 16 ? launch_tc<__nv_bfloat16, 1>(a, s) : launch_tc<__nv_bfloat16, 2>(a, s));
    case 2:
      return (int)(H <= 16 ? launch_tc<__half, 1>(a, s) : launch_tc<__half, 2>(a, s));
    default:
      return (int)cudaErrorInvalidValue;
  }
}
