// Device code shared by the two paged-attention kernels
// (flat_paged_attention.cu, decode_paged_attention.cu), as the TPU package
// shares llmd_tpu/ops/ragged_paged_attention.py:_decode_kernel between its
// row-lookup (flat) and batch-grid (decode) entries.
//
// What both compute. Each query token t attends with its G = H / K query
// heads per KV head over positions [win_start(t), kv_len(t)) of its row of
// the page table (kv_len = position + 1 is the causal mask within a row;
// win_start = max(kv_len - window, 0) on a sliding layer, else 0), softmax
// in f32. With sinks ([H] f32) one key without a value joins each head's
// softmax. With an int8 pool (scales [L, P, K, page, 2] f32) the score is
// (q . k_i8) * sm_scale * ks and the value weight p * vs, l summing p. A
// token with kv_len 0 (a pad) writes exact zeros, with or without sinks.
// Pool offsets are 64-bit: a 32-layer pool of 8,192 pages exceeds 2^31
// elements.
//
// bf16 / f16: tile_attention_kernel, on the tensor cores. One block of
// four warps attends a query tile over a span of one row's live pages for
// one KV head:
// - The query tile is n <= Tq consecutive tokens of one row times the G
//   heads of the KV head, M = n * G <= 64 rows of the product (Tq = 64 / G:
//   16 tokens for G = 4, 8 for G = 8; a decode token is a tile of its own).
//   The tokens share every staged K|V page, so a prefill chunk reads its
//   prefix once per tile instead of once per token.
// - K|V staging: the tile's live range is the union of its tokens' ranges;
//   its pages are cut into `spans` contiguous spans (blockIdx.z). A span is
//   walked in stages of 32 keys (whole pages: 2 of 16, 4 of 8), each stage a
//   [32, 2D] tile in shared memory (rows padded by 16 bytes, so ldmatrix
//   has no bank conflicts), in a ring of 3 stages filled by cp.async with
//   commit/wait groups: the next two stages are in flight while one is
//   scored. Three blocks share an SM (D <= 128).
//   Positions outside the union are zero-filled, never loaded, so NaN or
//   inf in dead pool slots or their scales never reaches an operand.
// - Products: S = Q K^T and O += P V on mma.sync m16n8k16 (bf16/f16 in,
//   f32 accumulate), fragments by ldmatrix. Warp w takes the m16 row
//   fragment w % nm (nm = ceil(M / 16), 3 counted as 4) and the 16-key
//   chunks w / nm, w / nm + nk, ... of each stage (nk = 4 / nm, at most
//   2): a decode tile (one fragment) splits its keys over two warps, a
//   full tile gives each warp 16 rows.
// - Masking and softmax: each score is scaled in f32 (sm_scale, then ks),
//   and set to -inf outside its row's [win_start, kv_len) before any sum;
//   the online softmax (m, l) per row is kept in f32 registers, one rescale
//   per stage.
// - P in two terms: p (times vs for int8) is split in the working type as
//   hi = round(p), lo = round(p - hi), and both go through the P V mma, so
//   P keeps about 16 bits where one bf16 rounding keeps 8; that holds the
//   result within one bf16 ulp of the f32 plain version at outputs near 0.
// - int8: the landed int8 stage is widened to bf16/f16 (exact) in a
//   separate shared tile before the mma; the (ks, vs) pairs of the stage
//   are staged beside it by cp.async.
// - End of span: the warps' (m, l, acc) are combined in shared memory. With
//   one span the block adds the sinks, normalises and writes the output;
//   with several it writes the f32 partial (m, l, acc) to scratch and
//   merge_spans_kernel (launched by the same C function) folds the spans,
//   adds the sinks and normalises.
//
// f32: attend_row, on the CUDA cores in full f32 (mma has no f32 input that
// keeps f32 precision), grid (token, KV head): one warp per query head,
// each lane holding D / 32 elements, the page staged once for the G warps,
// shuffle reductions and an online softmax per page.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "convert.cuh"

namespace paged_attention {

constexpr int kMaxPage = 32;
constexpr int kMaxSpans = 16;

using convert::from_f;
using convert::to_f;

// ---------------------------------------------------------------------- //
// f32: the per-warp path.

// N consecutive elements at p (aligned to their total size) as floats,
// read with the widest vector load that size allows.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* __restrict__ p, float (&out)[N]) {
  constexpr int kBytes = N * sizeof(T);
  static_assert(kBytes % 2 == 0, "lane slice must be a multiple of 2 bytes");
  using V = typename std::conditional<
      kBytes % 16 == 0, uint4,
      typename std::conditional<
          kBytes % 8 == 0, uint2,
          typename std::conditional<kBytes % 4 == 0, uint32_t,
                                    uint16_t>::type>::type>::type;
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

// blockDim.x = group * 32. q_tok and out_tok point at the token's [H, D]
// slab, table_row at its row of the page table, tile at page * 2D
// elements of C in shared memory, sc at 2 * page floats of shared memory.
// T is q's and the output's type, C the pool's (T, or int8_t with scales).
// Only live positions are read; the window's first page starts the walk;
// sm_scale folds into q.
template <typename T, typename C, int DPL>  // DPL = head_dim / 32 per lane
__device__ __forceinline__ void attend_row(
    T* __restrict__ out_tok, const T* __restrict__ q_tok,
    const C* __restrict__ cache,            // [L, P, K, page, 2D]
    const float* __restrict__ scales,       // [L, P, K, page, 2] or null
    const float* __restrict__ sinks,        // [H] or null
    const int32_t* __restrict__ table_row, int kv_len, int kh, int layer,
    int num_pages, int num_kv_heads, int page, int group, int window,
    float sm_scale, C* __restrict__ tile, float* __restrict__ sc) {
  constexpr int D = DPL * 32;
  constexpr bool kQuant = std::is_same<C, int8_t>::value;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = kh * group + warp;

  float qf[DPL], acc[DPL];
  load_f<T, DPL>(q_tok + (int64_t)h * D + lane * DPL, qf);
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    qf[i] *= sm_scale;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  const int win_start = window > 0 ? max(kv_len - window, 0) : 0;
  const int64_t slab = (int64_t)page * 2 * D;  // elements of one (page, head)
  const int nvec = (int)(slab * sizeof(C) / 16);
  const int n_pages = (kv_len + page - 1) / page;
  for (int p = win_start / page; p < n_pages; ++p) {
    const int phys = table_row[p];
    const int64_t head_page = ((int64_t)layer * num_pages + phys) * num_kv_heads + kh;
    const uint4* src = reinterpret_cast<const uint4*>(cache + head_page * slab);
    const int lo = max(win_start - p * page, 0);   // first live position
    const int n = min(page, kv_len - p * page);    // live positions end, > lo
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      reinterpret_cast<uint4*>(tile)[i] = src[i];
    }
    if constexpr (kQuant) {
      const float* s_src = scales + head_page * page * 2;
      for (int i = lo * 2 + threadIdx.x; i < n * 2; i += blockDim.x) sc[i] = s_src[i];
    }
    __syncthreads();

    float s[kMaxPage];
    float m_page = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxPage; ++j) {
      if (j >= lo && j < n) {  // warp-uniform
        float kf[DPL];
        load_f<C, DPL>(tile + j * 2 * D + lane * DPL, kf);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) dot += qf[i] * kf[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        }
        if constexpr (kQuant) dot *= sc[2 * j];
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
      if (j >= lo && j < n) {
        const float pj = expf(s[j] - m_new);
        l += pj;
        float wj = pj;
        if constexpr (kQuant) wj *= sc[2 * j + 1];
        float vf[DPL];
        load_f<C, DPL>(tile + j * 2 * D + D + lane * DPL, vf);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] += wj * vf[i];
      }
    }
    m = m_new;
  }

  if (sinks != nullptr) {
    const float sk = sinks[h];
    const float m2 = fmaxf(m, sk);
    const float alpha = (m == -INFINITY) ? 0.f : expf(m - m2);
    l = l * alpha + ((sk == -INFINITY) ? 0.f : expf(sk - m2));
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
  }

  const float denom = (l == 0.f) ? 1.f : l;
  T* op = out_tok + (int64_t)h * D + lane * DPL;
#pragma unroll
  for (int i = 0; i < DPL; ++i) op[i] = from_f<T>(acc[i] / denom);
}

// ---------------------------------------------------------------------- //
// bf16 / f16: the tensor-core path.

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStageKeys = 32;  // keys a stage holds (whole pages)
constexpr int kStages = 3;      // ring depth: kStages - 1 stages in flight
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTileRows = 64;   // M = tokens * G of a query tile, at most

// What a launch needs. `items` ([grid x, 2]: first token, tokens) lists
// the flat step's query tiles, compacted (unused entries have 0 tokens);
// with items null, item i is token i alone over table row i (decode).
struct TileArgs {
  void* out;               // [T, H, D]
  float* part_acc;         // [spans, T, H, D] f32 (spans > 1)
  float* part_ml;          // [spans, T, H, 2] f32 (spans > 1)
  const void* q;           // [T, H, D]
  const void* cache;       // [L, P, K, page, 2D]
  const float* scales;     // [L, P, K, page, 2] or null
  const float* sinks;      // [H] or null
  const int32_t* items;    // [num_items, 2] or null
  const int32_t* rows;     // [T] token -> table row, or null (decode)
  const int32_t* page_table;
  const int32_t* kv_lens;  // [T]
  int num_tokens, num_items, layer, num_pages, num_kv_heads, page, max_pages,
      group, window, spans;
  float sm_scale;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes from gmem, or 16 zero bytes when !valid (nothing is read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
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

// 2^x on the MUFU unit (relative error about 2^-22; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to the working type, packed low element first.
__device__ __forceinline__ unsigned pack2(__nv_bfloat16, float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&v);
}
__device__ __forceinline__ unsigned pack2(__half, float a, float b) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<unsigned*>(&v);
}
// hi = round(x), lo = round(x - hi): x to about twice the type's bits.
template <typename T>
__device__ __forceinline__ void split2(float a, float b, unsigned& hi, unsigned& lo) {
  const T ha = from_f<T>(a), hb = from_f<T>(b);
  hi = pack2(T(), to_f(ha), to_f(hb));
  lo = pack2(T(), a - to_f(ha), b - to_f(hb));
}

// The sinks' key and the normalisation, as one factor on acc: with m the
// row's running max and l its sum, returns alpha / denom (0 if m = -inf).
__device__ __forceinline__ float finish_factor(float m, float l, const float* sinks, int h) {
  float alpha = 1.f;
  if (sinks != nullptr) {
    const float sk = sinks[h] * kLog2e;  // m and l are in log2 units
    const float m2 = fmaxf(m, sk);
    alpha = (m == -INFINITY) ? 0.f : exp2f(m - m2);
    l = l * alpha + ((sk == -INFINITY) ? 0.f : exp2f(sk - m2));
  }
  return alpha / ((l == 0.f) ? 1.f : l);
}

// Shared-memory geometry of one instantiation, in bytes.
template <typename T, typename C, int D>
struct Smem {
  static constexpr bool kQuant = std::is_same<C, int8_t>::value;
  static constexpr int kRowT = 2 * D + 8;                     // T elements a staged key row
  static constexpr int kRowC = 2 * D + 16 / (int)sizeof(C);  // C elements a ring key row
  static constexpr int kRowQ = D + 8;
  static constexpr int kRowP = D + 8;                         // f32 partial row
  static constexpr int kRing = kStages * kStageKeys * kRowC * (int)sizeof(C);
  static constexpr int kConv = kQuant ? kStageKeys * kRowT * (int)sizeof(T) : 0;
  static constexpr int kScales = kQuant ? kStages * kStageKeys * 2 * 4 : 0;
  static constexpr int kPart = kWarps * 16 * kRowP * 4 + kWarps * 16 * 2 * 4;
  static constexpr int kMain = (kRing + kConv > kPart) ? kRing + kConv : kPart;
  // D <= 128 keeps the query fragments in registers, loaded from global
  // memory; D = 256 stages the query tile here.
  static constexpr int kQ = D <= 128 ? 0 : kTileRows * kRowQ * (int)sizeof(T);
  static constexpr int kMisc = kTileRows * 2 * 4    // per token: live range
                               + kTileRows * 4 * 4  // per row: the warps' factors
                               + kTileRows * 4;     // per row: m of the tile
  static constexpr int kBytes = kMain + kScales + kQ + kMisc;
};

// One stage of one warp: the scores of its NCH 16-key chunks (chunk
// kp + i * nk, keys [16 chunk, 16 chunk + 16) of the staged tile), the
// online-softmax update of its two rows (one rescale a stage) and P V
// with P split in hi and lo terms. Scores are in log2 units (scale =
// sm_scale * log2 e), so exp2 is the exponential. With one chunk the
// Q K^T sum runs in two chains (even and odd k16 steps) to hide the mma
// latency; with two chunks their four n8 tiles are the chains. kFull: every
// key of the stage is live for every row of the warp, so nothing is masked.
template <typename T, bool kQuant, int D, int NCH, bool kFull, int QR>
__device__ __forceinline__ void attend_stage(
    const T* __restrict__ tile, int row_stride, const float* __restrict__ sc,
    const unsigned (&qreg)[QR][4], const T* q_rows, int kp, int nk, int keys, int pos0,
    const int (&r_lo)[2], const int (&r_hi)[2], float scale, float (&m_run)[2],
    float (&l_run)[2], float (&acc)[D / 8][4]) {
  constexpr int kPar = NCH == 1 ? 2 : 1;
  const int lane = threadIdx.x % 32, t4 = lane % 4;
  float s[NCH][2][kPar][4];
#pragma unroll
  for (int i = 0; i < NCH; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int p = 0; p < kPar; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j][p][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned qa[4];
    if constexpr (D <= 128) {
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[e] = qreg[kk][e];
    } else {
      ldmatrix_x4(qa, q_rows + kk * 16);
    }
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int kb = (kp + i * nk) * 16;
      unsigned kf[4];
      ldmatrix_x4(kf, tile + (kb + lane % 8 + (lane / 16) * 8) * row_stride + kk * 16 +
                          ((lane / 8) % 2) * 8);
      mma16816<T>(s[i][0][kk % kPar], qa, kf[0], kf[1]);
      mma16816<T>(s[i][1][kk % kPar], qa, kf[2], kf[3]);
    }
  }
  float x[NCH][2][4];
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int kb = (kp + i * nk) * 16;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + 8 * j + 2 * t4 + (e & 1);
        const int pos = pos0 + key, h = e >> 1;
        float v = s[i][j][0][e];
        if constexpr (kPar == 2) v += s[i][j][1][e];
        v *= scale;
        if constexpr (kQuant) v *= sc[2 * key];
        if constexpr (!kFull) {
          const bool live = key < keys && pos >= r_lo[h] && pos < r_hi[h];
          v = live ? v : -INFINITY;
        }
        x[i][j][e] = v;
        mx[h] = fmaxf(mx[h], v);
      }
    }
  }
  float alpha[2], m_use[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m_run[h], mx[h]);
    alpha[h] = (m_run[h] == -INFINITY) ? 0.f : ex2(m_run[h] - m_new);
    m_use[h] = (m_new == -INFINITY) ? 0.f : m_new;
    m_run[h] = m_new;
    l_run[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc[i][0] *= alpha[0];
    acc[i][1] *= alpha[0];
    acc[i][2] *= alpha[1];
    acc[i][3] *= alpha[1];
  }
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int kb = (kp + i * nk) * 16;
    float p[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(x[i][j][e] - m_use[e >> 1]);  // 0 where masked
        l_run[e >> 1] += pe;
        float w = pe;
        if constexpr (kQuant) {
          w = (pe == 0.f) ? 0.f : pe * sc[2 * (kb + 8 * j + 2 * t4 + (e & 1)) + 1];
        }
        p[j][e] = w;
      }
    }
    unsigned ph[4], pl[4];
    split2<T>(p[0][0], p[0][1], ph[0], pl[0]);
    split2<T>(p[0][2], p[0][3], ph[1], pl[1]);
    split2<T>(p[1][0], p[1][1], ph[2], pl[2]);
    split2<T>(p[1][2], p[1][3], ph[3], pl[3]);
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
      unsigned vb[4];
      ldmatrix_x4_trans(vb, tile + (kb + lane % 16) * row_stride + D + jj * 16 + (lane / 16) * 8);
      mma16816<T>(acc[2 * jj], ph, vb[0], vb[1]);
      mma16816<T>(acc[2 * jj + 1], ph, vb[2], vb[3]);
      mma16816<T>(acc[2 * jj], pl, vb[0], vb[1]);
      mma16816<T>(acc[2 * jj + 1], pl, vb[2], vb[3]);
    }
  }
}

// One query tile (tokens t0 .. t0 + n - 1 of table row `row`) over span
// blockIdx.z of its live pages, KV head kh. Every thread of the block
// calls it (it synchronises).
template <typename T, typename C, int D>
__device__ __forceinline__ void attend_tile(const TileArgs& a, unsigned char* smem, int t0,
                                            int n, int row, int kh) {
  using S = Smem<T, C, D>;
  constexpr bool kQuant = S::kQuant;
  constexpr int kChunksC = 2 * D * (int)sizeof(C) / 16;  // 16-byte chunks a key row
  static_assert(kStageKeys == 32 && kStageKeys * 4 == kThreads && kChunksC % 4 == 0,
                "a stage's scales are one key a lane, its rows four threads a key");
  const int G = a.group, H = a.num_kv_heads * G, page = a.page;
  const int M = n * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  C* ring = reinterpret_cast<C*>(smem);
  T* conv = reinterpret_cast<T*>(smem + S::kRing);
  float* part = reinterpret_cast<float*>(smem);  // after the walk, aliases the ring
  float* warp_ml = part + kWarps * 16 * S::kRowP;  // [warp][16 rows]: (m, l)
  float* sc_ring = reinterpret_cast<float*>(smem + S::kMain);
  T* qs = reinterpret_cast<T*>(smem + S::kMain + S::kScales);
  int* tok_lo = reinterpret_cast<int*>(smem + S::kMain + S::kScales + S::kQ);
  int* tok_hi = tok_lo + kTileRows;
  float* fac = reinterpret_cast<float*>(tok_hi + kTileRows);  // [kTileRows][4]
  float* row_m = fac + kTileRows * 4;
  __shared__ int span_info[4];  // union lo, union hi, first page, last page (excl.)

  // Each token's live range and the tile's union.
  if (threadIdx.x < n) {
    const int kvl = a.kv_lens[t0 + threadIdx.x];
    tok_lo[threadIdx.x] = a.window > 0 ? max(kvl - a.window, 0) : 0;
    tok_hi[threadIdx.x] = max(kvl, 0);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    int lo = INT_MAX, hi = 0;
    for (int i = lane; i < n; i += 32) {
      if (tok_hi[i] > tok_lo[i]) {
        lo = min(lo, tok_lo[i]);
        hi = max(hi, tok_hi[i]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {
      if (hi == 0) lo = 0;
      const int pb = lo / page, pe = (hi + page - 1) / page;
      const int per = (pe - pb + a.spans - 1) / a.spans;
      const int sb = min(pe, pb + (int)blockIdx.z * per);
      span_info[0] = lo;
      span_info[1] = hi;
      span_info[2] = sb;
      span_info[3] = min(pe, sb + per);
    }
  }
  __syncthreads();
  const int u_lo = span_info[0], u_hi = span_info[1];
  const int sp_begin = span_info[2], sp_end = span_info[3];
  const int pages_per_stage = kStageKeys / page;
  const int stage_keys = pages_per_stage * page;
  const int n_stages = (sp_end - sp_begin + pages_per_stage - 1) / pages_per_stage;
  const int32_t* table_row = a.page_table + (int64_t)row * a.max_pages;
  const C* cache = static_cast<const C*>(a.cache);

  // The query tile: row r is token t0 + r / G, head kh * G + r % G; rows
  // past M are zero.
  const T* q = static_cast<const T*>(a.q);
  if constexpr (D > 128) {
    constexpr int kChunksQ = D * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < kTileRows * kChunksQ; i += kThreads) {
      const int r = i / kChunksQ, c = i % kChunksQ;
      const bool ok = r < M;
      const T* src =
          ok ? q + ((int64_t)(t0 + r / G) * H + kh * G + r % G) * D + c * (16 / sizeof(T)) : q;
      cp_async16(qs + r * S::kRowQ + c * (16 / sizeof(T)), src, ok);
    }
  }
  // Copies: thread i stages key row lj = i / 4 of every stage, its 16-byte
  // chunks lq, lq + 4, ...; the row's page and offset in a stage are fixed,
  // so a stage costs a thread one address and kChunksC / 4 copies. The
  // stage's table entries: lane i of every warp holds page p0 + i's, loaded
  // one stage ahead (one coalesced load a warp and stage, off the copies'
  // path) and handed to the copying lanes by shuffle.
  const int lj = threadIdx.x / 4, lq = threadIdx.x % 4;
  const int lj_page = lj / page, lj_off = lj % page;
  const int64_t layer_base = (int64_t)a.layer * a.num_pages;
  auto table_entry = [&](int p) {
    return (lane < pages_per_stage && p < sp_end) ? table_row[p] : 0;
  };
  int phys_next = table_entry(sp_begin + lane);
  auto load_stage = [&](int st) {
    constexpr int kVec = 16 / (int)sizeof(C);
    const int slot = st % kStages;
    const int p0 = sp_begin + st * pages_per_stage;
    const int phys_cur = phys_next;
    phys_next = table_entry(p0 + pages_per_stage + lane);
    const int pg = p0 + lj_page, pos = pg * page + lj_off;
    const bool ok = lj < stage_keys && pg < sp_end && pos >= u_lo && pos < u_hi;
    const int phys = __shfl_sync(0xffffffffu, phys_cur, min(lj_page, 31));
    const C* src = cache;
    if (ok) src += (((layer_base + phys) * a.num_kv_heads + kh) * page + lj_off) * 2 * D;
    C* dst = ring + (slot * kStageKeys + lj) * S::kRowC;
#pragma unroll
    for (int c = 0; c < kChunksC / 4; ++c) {
      cp_async16(dst + (lq + 4 * c) * kVec, src + (ok ? (lq + 4 * c) * kVec : 0), ok);
    }
    if constexpr (kQuant) {
      if (warp == 0) {  // one key a lane
        const int j = lane;
        const int spg = p0 + j / page, spos = spg * page + j % page;
        const bool sok = j < stage_keys && spg < sp_end && spos >= u_lo && spos < u_hi;
        const int sphys = __shfl_sync(0xffffffffu, phys_cur, min(j / page, 31));
        const float* ssrc = a.scales;
        if (sok) ssrc += (((layer_base + sphys) * a.num_kv_heads + kh) * page + j % page) * 2;
        cp_async8(sc_ring + (slot * kStageKeys + j) * 2, ssrc, sok);
      }
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_stages) load_stage(st);
    cp_async_commit();  // the query tile rides in the first group
  }

  // This warp's share: m16 fragment mf, key chunks kp, kp + nk, ...
  int nm = (M + 15) / 16;
  if (nm == 3) nm = 4;
  const int nk = min(kWarps / nm, kStageKeys / 16);
  const int mf = warp % nm, kp = warp / nm;
  const bool active = kp < nk && mf * 16 < M;
  const int g = lane / 4, t4 = lane % 4;
  int r_lo[2], r_hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = mf * 16 + g + 8 * h;
    r_lo[h] = r < M ? tok_lo[r / G] : 0;
    r_hi[h] = r < M ? tok_hi[r / G] : 0;
  }
  // The warp's live rows' common range: a stage inside it needs no mask
  // (rows past M are never written, so they do not count).
  int w_lo = INT_MIN, w_hi = INT_MAX;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (mf * 16 + g + 8 * h < M) {
      w_lo = max(w_lo, r_lo[h]);
      w_hi = min(w_hi, r_hi[h]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    w_lo = max(w_lo, __shfl_xor_sync(0xffffffffu, w_lo, off));
    w_hi = min(w_hi, __shfl_xor_sync(0xffffffffu, w_hi, off));
  }
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // The warp's query fragments: in registers for D <= 128 (the mma's A
  // layout: rows g and g + 8, columns 2 t4 and 2 t4 + 8 of each k16 step),
  // else read from the staged tile at each step.
  const T* q_rows = qs + (mf * 16 + lane % 16) * S::kRowQ + (lane / 16) * 8;
  unsigned qreg[D <= 128 ? D / 16 : 1][4];
  if constexpr (D <= 128) {
    if (active) {
      const T* qr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mf * 16 + g + 8 * h;
        qr[h] = r < M ? q + ((int64_t)(t0 + r / G) * H + kh * G + r % G) * D + 2 * t4 : nullptr;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const T* p = qr[e % 2];
          qreg[kk][e] = p ? *reinterpret_cast<const unsigned*>(p + kk * 16 + (e / 2) * 8) : 0u;
        }
      }
    }
  }
  const float score_scale = a.sm_scale * kLog2e;

  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage st landed; every warp is done with st - 1
    if (st + kStages - 1 < n_stages) load_stage(st + kStages - 1);
    cp_async_commit();
    const int slot = st % kStages;
    const T* tile;
    const float* sc = sc_ring + slot * kStageKeys * 2;
    if constexpr (kQuant) {
      // Widen the int8 stage to the working type (exact), 16 values a step.
      const int8_t* src = ring + slot * kStageKeys * S::kRowC;
      for (int i = threadIdx.x; i < kStageKeys * (2 * D / 16); i += kThreads) {
        const int j = i / (2 * D / 16), c = (i % (2 * D / 16)) * 16;
        const int4 raw = *reinterpret_cast<const int4*>(src + j * S::kRowC + c);
        const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
        unsigned w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) w[e] = pack2(T(), (float)v[2 * e], (float)v[2 * e + 1]);
        uint4* d = reinterpret_cast<uint4*>(conv + j * S::kRowT + c);
        d[0] = make_uint4(w[0], w[1], w[2], w[3]);
        d[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
      tile = conv;
    } else {
      tile = ring + slot * kStageKeys * S::kRowC;
    }
    if (!active) continue;
    const int pos0 = (sp_begin + st * pages_per_stage) * page;
    // Keys of this stage that hold the span's positions (the last stage
    // may reach past the span, into the next span's pages).
    const int keys = min(stage_keys, sp_end * page - pos0);
    constexpr int kRowT = kQuant ? S::kRowT : S::kRowC;  // staged row, T elements
    const bool full = keys == kStageKeys && pos0 >= w_lo && pos0 + kStageKeys <= w_hi;
#define PA_STAGE(NCH, FULL)                                                                 \
  attend_stage<T, kQuant, D, NCH, FULL>(tile, kRowT, sc, qreg, q_rows, kp, nk, keys, pos0, \
                                        r_lo, r_hi, score_scale, m_run, l_run, acc)
    if (nk == 1) {
      if (full) PA_STAGE(2, true); else PA_STAGE(2, false);
    } else {
      if (full) PA_STAGE(1, true); else PA_STAGE(1, false);
    }
#undef PA_STAGE
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' partials now

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
  if (active) {
    float* pw = part + warp * 16 * S::kRowP;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<float2*>(pw + g * S::kRowP + i * 8 + 2 * t4) =
          make_float2(acc[i][0], acc[i][1]);
      *reinterpret_cast<float2*>(pw + (g + 8) * S::kRowP + i * 8 + 2 * t4) =
          make_float2(acc[i][2], acc[i][3]);
    }
    if (t4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        warp_ml[(warp * 16 + g + 8 * h) * 2] = m_run[h];
        warp_ml[(warp * 16 + g + 8 * h) * 2 + 1] = l_run[h];
      }
    }
  }
  __syncthreads();

  // Per row: fold the warps that shared its keys, then the sinks and the
  // normalisation (one span) or the span's (m, l) to scratch.
  const int64_t T_ = a.num_tokens;
  if (threadIdx.x < M) {
    const int r = threadIdx.x, f = r / 16;
    float m = -INFINITY;
    for (int k = 0; k < nk; ++k) m = fmaxf(m, warp_ml[((f + k * nm) * 16 + r % 16) * 2]);
    float l = 0.f, w[kWarps];
    for (int k = 0; k < nk; ++k) {
      const float mk = warp_ml[((f + k * nm) * 16 + r % 16) * 2];
      w[k] = (mk == -INFINITY) ? 0.f : exp2f(mk - m);
      l += w[k] * warp_ml[((f + k * nm) * 16 + r % 16) * 2 + 1];
    }
    const int t = t0 + r / G, hd = kh * G + r % G;
    float scale = 1.f;
    if (a.spans == 1) {
      scale = finish_factor(m, l, a.sinks, hd);
    } else {
      float* ml = a.part_ml + (((int64_t)blockIdx.z * T_ + t) * H + hd) * 2;
      ml[0] = m;
      ml[1] = l;
    }
    for (int k = 0; k < kWarps; ++k) fac[r * 4 + k] = k < nk ? w[k] * scale : 0.f;
    row_m[r] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * (D / 2); i += kThreads) {
    const int r = i / (D / 2), d = 2 * (i % (D / 2)), f = r / 16;
    float v0 = 0.f, v1 = 0.f;
    for (int k = 0; k < nk; ++k) {
      const float fk = fac[r * 4 + k];
      if (fk != 0.f) {
        const float2 x = *reinterpret_cast<const float2*>(
            part + ((f + k * nm) * 16 + r % 16) * S::kRowP + d);
        v0 += fk * x.x;
        v1 += fk * x.y;
      }
    }
    const int64_t th = (int64_t)(t0 + r / G) * H + kh * G + r % G;
    if (a.spans == 1) {
      *reinterpret_cast<unsigned*>(static_cast<T*>(a.out) + th * D + d) = pack2(T(), v0, v1);
    } else if (row_m[r] != -INFINITY) {  // an empty span's acc is never read
      *reinterpret_cast<float2*>(a.part_acc + ((int64_t)blockIdx.z * T_ * H + th) * D + d) =
          make_float2(v0, v1);
    }
  }
  __syncthreads();  // shared memory is reused by the block's next tile
}

// Grid (grid x, K, spans), kThreads threads. Item blockIdx.x, then every
// gridDim.x-th item after it while items remain (a caller whose rows are
// not contiguous in the stream may have more items than the grid). Entry
// is a tag type of the calling kernel, so that a trace names the kernel
// (flat or decode) and each library keeps its own instantiations.
// Three blocks an SM for D <= 128 (registers capped at 170 a thread).
template <typename Entry, typename T, typename C, int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 3 : 1) tile_attention_kernel(TileArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kh = blockIdx.y;
  const int G = a.group, H = a.num_kv_heads * G;
  if (a.items != nullptr && a.spans == 1 && blockIdx.z == 0) {
    // Pad tokens (kv_len 0) have no item: their outputs are zeroed here.
    for (int t = blockIdx.x; t < a.num_tokens; t += gridDim.x) {
      if (a.kv_lens[t] > 0) continue;
      T* o = static_cast<T*>(a.out) + ((int64_t)t * H + kh * G) * D;
      for (int i = threadIdx.x; i < G * D; i += kThreads) o[i] = from_f<T>(0.f);
    }
  }
  for (int it = blockIdx.x; it < a.num_items; it += gridDim.x) {
    int t0 = it, n = 1, row = it;
    if (a.items != nullptr) {
      t0 = a.items[2 * it];
      n = a.items[2 * it + 1];
      if (n <= 0) break;  // the list is compacted: no item follows
      row = a.rows[t0];
    }
    attend_tile<T, C, D>(a, smem, t0, n, row, kh);
  }
}

// Fold the spans of token t, KV head kh (block (t, kh)): out = sum_s acc_s
// e^(m_s - m) / (sum_s l_s e^(m_s - m) + the sink's e^(sink - m)), m the
// largest m_s (and sink). A pad token (kv_len 0) gets zeros.
template <typename Entry, typename T, int D>
__global__ void __launch_bounds__(128) merge_spans_kernel(TileArgs a) {
  __shared__ float f[32][kMaxSpans];
  const int t = blockIdx.x, kh = blockIdx.y, G = a.group, H = a.num_kv_heads * G;
  const int S = a.spans;
  const int64_t T_ = a.num_tokens;
  T* o = static_cast<T*>(a.out) + ((int64_t)t * H + kh * G) * D;
  if (a.kv_lens[t] <= 0) {
    for (int i = threadIdx.x; i < G * D; i += blockDim.x) o[i] = from_f<T>(0.f);
    return;
  }
  if (threadIdx.x < G) {
    const int h = kh * G + threadIdx.x;
    float m = -INFINITY;
    for (int s = 0; s < S; ++s) m = fmaxf(m, a.part_ml[((s * T_ + t) * H + h) * 2]);
    float l = 0.f;
    for (int s = 0; s < S; ++s) {
      const float ms = a.part_ml[((s * T_ + t) * H + h) * 2];
      const float w = (ms == -INFINITY) ? 0.f : exp2f(ms - m);
      f[threadIdx.x][s] = w;
      l += w * a.part_ml[((s * T_ + t) * H + h) * 2 + 1];
    }
    const float scale = finish_factor(m, l, a.sinks, h);
    for (int s = 0; s < S; ++s) f[threadIdx.x][s] *= scale;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int gi = i / D, d = i % D;
    float v = 0.f;
    for (int s = 0; s < S; ++s) {
      const float w = f[gi][s];
      if (w != 0.f) v += w * a.part_acc[((s * T_ + t) * H + kh * G + gi) * D + d];
    }
    o[i] = from_f<T>(v);
  }
}

template <typename Entry, typename T, typename C, int D>
cudaError_t launch_tiles(const TileArgs& a, int grid_x, cudaStream_t stream) {
  constexpr int kBytes = Smem<T, C, D>::kBytes;
  auto kernel = tile_attention_kernel<Entry, T, C, D>;
  // Set on every launch (a host call of a microsecond).
  const cudaError_t e0 =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (e0 != cudaSuccess) return e0;
  kernel<<<dim3(grid_x, a.num_kv_heads, a.spans), kThreads, kBytes, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.spans == 1) return e;
  merge_spans_kernel<Entry, T, D><<<dim3(a.num_tokens, a.num_kv_heads), 128, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename Entry, typename T, typename C>
cudaError_t launch_tiles_d(int head_dim, const TileArgs& a, int grid_x, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch_tiles<Entry, T, C, 64>(a, grid_x, stream);
    case 128: return launch_tiles<Entry, T, C, 128>(a, grid_x, stream);
    case 256: return launch_tiles<Entry, T, C, 256>(a, grid_x, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The tensor-core path for a bf16 (dtype 1) or f16 (dtype 2) launch.
template <typename Entry>
cudaError_t launch_tiles_dtype(int dtype, int cache_int8, int head_dim,
                                      const TileArgs& a, int grid_x, cudaStream_t stream) {
  if (a.spans < 1 || a.spans > kMaxSpans || a.group < 1 || a.group > 32 ||
      (a.spans > 1 && (a.part_acc == nullptr || a.part_ml == nullptr))) {
    return cudaErrorInvalidValue;
  }
  if (dtype == 1) {
    return cache_int8 ? launch_tiles_d<Entry, __nv_bfloat16, int8_t>(head_dim, a, grid_x, stream)
                      : launch_tiles_d<Entry, __nv_bfloat16, __nv_bfloat16>(head_dim, a, grid_x,
                                                                            stream);
  }
  if (dtype == 2) {
    return cache_int8 ? launch_tiles_d<Entry, __half, int8_t>(head_dim, a, grid_x, stream)
                      : launch_tiles_d<Entry, __half, __half>(head_dim, a, grid_x, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace paged_attention
