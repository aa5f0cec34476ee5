// The Hopper vocab head shared by head_sweep.cu, head_topk.cu, head_int8.cu
// and (its fp32 head) wholestep.cu: logits = h @ W + b (bf16 or fp32), or
// the dequantized int8 logits, then per row the top-k logits (descending,
// equal values lowest id first), their vocab ids and the log-sum-exp, in
// one launch with no partial results in device memory.
//
// One kernel template, head_kernel<Ops, Epi, STREAM>:
// - Ops, the operands: Bf16 (h [N, H] and W [H, V] bf16, W read MN-major),
//   S8 (int8 rows quantized in the kernel, and w_qt [Vp, Hp], the K-major
//   copy of quantize_head's w_q: 8-bit wgmma has no transpose) or F32 (h
//   and W fp32, compute_dtype="float32": fp32 FMA on the CUDA cores, not
//   TF32).
// - Epi, the epilogue over a tile's logits in registers: Sweep (the
//   single sweep's bar-checked inserts) or Extract<EXTRACT> (the tiled
//   heads' per-tile extraction, extract="mask" or "thresh").
// - STREAM: the A operand (h, or the quantized rows) streams with every W
//   stage instead of staying resident, above HMAX = 1024; always for F32
//   (64 fp32 rows of H = 1024 are 256 KB).
//
// What bounds it on the H100. At the paper shape (N = 2560 = 512 images x 5
// beams, H = 1024, V = 9490) the products are 2 N H V = 49.8 G operations:
// 50 us at 989 TFLOP/s dense bf16, 25 us at 1,979 TOP/s int8, 0.74 ms at
// the 67 TFLOP/s of fp32 outside the tensor cores, against 6-7 us for the
// bf16 bytes read once (13 us in fp32). Every CTA that owns a block of rows
// sees all of W, so W's reads from L2 grow with the number of row blocks.
//
// Design (sm_90a, one launch, a thread-block cluster per 64 rows; 384
// threads a CTA, one CTA an SM):
// - The cluster's CTAs split the vocab: CTA rank c sweeps tiles [c P,
//   (c + 1) P) of 128 columns (P = ceil(tiles / shares)). The host
//   (kernels/head.py::sweep_plan) takes the shares, at most 4, that need
//   the fewest waves x tiles per share, from the number of clusters of
//   each size the card holds (each source's *_max_clusters). Each row
//   block starts its share at another tile (rotated by the row block), so
//   the clusters spread their reads over W; a tile of lower ids may come
//   after one of higher ids.
// - A resident: the CTA's 64 rows are loaded once by TMA (128-byte
//   swizzle, K-major) before the sweep. STREAM: each W stage also brings
//   the two 64-row boxes of A for its K range.
// - One producer thread keeps a 3-stage ring of W full (32 KB a stage,
//   128-byte swizzle), completing on mbarriers; a tile's last stage also
//   brings the tile's bias (and, int8, the column scales) by a bulk copy.
// - Bf16, S8: two consumer warpgroups take the tiles in turns (a
//   ping-pong): each runs a tile's wgmma chain (m64n128k16 bf16,
//   m64n128k32 s8 with int32 sums) and then its epilogue, which overlaps
//   the other warpgroup's products. An mbarrier pair orders their main
//   loops, so the ring is consumed in the order it is filled.
// - F32 (f32_tiles): SIMT products are some 30 times a tile's epilogue, so
//   every consumer warp multiplies every tile: warpgroup wg the tile's rows
//   [32 wg, 32 wg + 32), a thread 4 rows x 8 columns (12 16-byte shared
//   loads per 128 FMAs, each warp load conflict-free under the swizzle),
//   every K in order. The warpgroup's logits go through shared memory to
//   the bf16 epilogues' layout, a row a thread (their OWN form: a row's
//   state is one warpgroup's, so a cluster may hold up to 8 shares).
// - The epilogue stays in registers: in wgmma's accumulator layout a
//   thread holds two rows and 32 of the tile's columns (a row's four
//   threads, a quad, hold its 128). Each warpgroup carries, for each row,
//   an online (m, s) and a running top-k over the tiles it has taken.
// - The merge is on chip: each CTA writes its partial states to its own
//   shared memory (over A and the ring, no longer needed); after a cluster
//   barrier one warp a row reads every CTA's partial states through
//   distributed shared memory: lse = M + log sum_j s_j exp(m_j - M), and
//   the top-k by k rounds of a warp arg-max (head_common.cuh's
//   warp_pop_topk), so ties resolve by vocab id whatever share held them.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "head_common.cuh"
#include "sm90_common.cuh"

namespace {
namespace hsm {

using namespace sm90;

constexpr int BM = 64;              // rows per CTA
constexpr int TN = BN;              // vocab columns per tile (128)
constexpr int STAGES = 3;
constexpr int A_BOX = BM * 128;     // one A box: 64 rows x 128 bytes of K
constexpr int W_STAGE = 32768;      // W bytes a stage
constexpr int HMAX = 1024;          // A resident up to this K; streamed above
constexpr int MAX_SHARES = 8;       // and shares x Epi::SLOTS <= 32 lanes
constexpr int NTHREADS = 384;       // warpgroups 0, 1 consume; 2 produces
constexpr float kLog2e = 1.4426950408889634f;

// What a launch needs besides the two tensor maps. S8 also reads h (fp32
// [N, H]) and writes its quantized rows to qh ([shares * Np, Hp] int8,
// the CTA of share c and row block y at rows c Np + 64 y); Bf16 leaves
// those null. fault = 1 plants the fault of skipping a tile whose max
// equals the row's running k-th value (Extract only; tests).
struct Args {
  const float* bias;   // [V]
  const float* scale;  // [V] (S8: w_scale)
  const float* h;      // S8: fp32 [N, H]
  int8_t* qh;          // S8: scratch
  float* vals;         // [N, k]
  int* idx;            // [N, k]
  float* lse;          // [N]
  int N, H, Hp, Np, V, k, fault;
};

// ---------------------------------------------------------------------------
// Operands
// ---------------------------------------------------------------------------

// bf16 h [N, H] (A boxes 64 rows x 64 K) and W [H, V] row-major, read
// MN-major: a stage is 128 K x 128 columns, four 64 x 64 boxes.
struct Bf16 {
  using Acc = float;
  static constexpr bool QUANT = false;
  static constexpr bool SIMT = false;
  static constexpr int BOXK = 64;     // K elements of an A box
  static constexpr int KS = 2 * BOXK;  // K elements a stage
  static constexpr int SIDE_ARRAYS = 1;  // a tile's bias
  static constexpr int SIDE = TN * 4 * SIDE_ARRAYS;
  static constexpr int W_BOX = 64 * 64 * 2;

  __device__ __forceinline__ static void load_w(unsigned char* st,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int col,
                                                int kb) {
#pragma unroll
    for (int r = 0; r < 2; ++r)  // K halves x column halves
#pragma unroll
      for (int c = 0; c < 2; ++c)
        tma_load_2d(st + (2 * r + c) * W_BOX, map, bar, col + 64 * c,
                    kb * KS + r * BOXK);
  }

  __device__ __forceinline__ static void load_side(unsigned char* side,
                                                   const Args& a, int col,
                                                   uint32_t bytes,
                                                   uint64_t* bar) {
    bulk_load(side, a.bias + col, bytes, bar);
  }

  // One stage's products: a0, a1 the A boxes of its two K halves.
  __device__ __forceinline__ static void mma(float (&acc)[64],
                                             const unsigned char* a0,
                                             const unsigned char* a1,
                                             const unsigned char* st) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // k16 steps: 32 bytes of h, 16 W rows
      const int r = j / 4;
      wgmma_m64n128k16_ss(
          acc, smem_desc((r ? a1 : a0) + 32 * (j % 4), 16, 1024,
                         kSwizzle128B),
          smem_desc(st + 2 * r * W_BOX + 2048 * (j % 4), W_BOX, 1024,
                    kSwizzle128B));
    }
  }

  // The tile's logits: the bias added (column col0 + 8 j + 2 q + e is
  // acc[4 j + 2 h + e] of rows h = 0, 1), columns past V at -inf.
  __device__ __forceinline__ static void logits(const float (&acc)[64],
                                                float (&x)[64],
                                                const unsigned char* side,
                                                int col0, int V, int q,
                                                const float (&)[2]) {
    const float* bias_s = reinterpret_cast<const float*>(side);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * q;  // V % 8 == 0: c, c + 1 alike
      const bool in = col0 + c < V;
      const float2 b =
          in ? *reinterpret_cast<const float2*>(bias_s + c) : float2{};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        x[4 * j + 2 * h] = in ? acc[4 * j + 2 * h] + b.x : -INFINITY;
        x[4 * j + 2 * h + 1] = in ? acc[4 * j + 2 * h + 1] + b.y : -INFINITY;
      }
    }
  }
};

// int8: the rows quantized by the CTA (A boxes 64 rows x 128 K bytes) and
// w_qt [Vp, Hp] int8, K-major: a stage is 256 K x 128 columns, two boxes of
// 128 vocab rows x 128 K bytes.
struct S8 {
  using Acc = int;
  static constexpr bool QUANT = true;
  static constexpr bool SIMT = false;
  static constexpr int BOXK = 128;
  static constexpr int KS = 2 * BOXK;
  static constexpr int SIDE_ARRAYS = 2;  // a tile's bias, then its scales
  static constexpr int SIDE = TN * 4 * SIDE_ARRAYS;
  static constexpr int W_BOX = 128 * 128;

  __device__ __forceinline__ static void load_w(unsigned char* st,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int col,
                                                int kb) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      tma_load_2d(st + r * W_BOX, map, bar, kb * KS + r * BOXK, col);
  }

  __device__ __forceinline__ static void load_side(unsigned char* side,
                                                   const Args& a, int col,
                                                   uint32_t bytes,
                                                   uint64_t* bar) {
    bulk_load(side, a.bias + col, bytes, bar);
    bulk_load(side + TN * 4, a.scale + col, bytes, bar);
  }

  __device__ __forceinline__ static void mma(int (&acc)[64],
                                             const unsigned char* a0,
                                             const unsigned char* a1,
                                             const unsigned char* st) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // k32 steps: 32 bytes of each operand
      const int r = j / 4;
      wgmma_m64n128k32_s8_ss(
          acc, smem_desc((r ? a1 : a0) + 32 * (j % 4), 16, 1024,
                         kSwizzle128B),
          smem_desc(st + r * W_BOX + 32 * (j % 4), 16, 1024,
                    kSwizzle128B));
    }
  }

  // Dequantized: acc * (s_h * s_w) + b, each operation rounded on its own
  // (no contraction into an FMA), the plain version's arithmetic, so the
  // logits are bit-identical to it. sh: the thread's two rows' s_h.
  __device__ __forceinline__ static void logits(const int (&acc)[64],
                                                float (&x)[64],
                                                const unsigned char* side,
                                                int col0, int V, int q,
                                                const float (&sh)[2]) {
    const float* bias_s = reinterpret_cast<const float*>(side);
    const float* scale_s = bias_s + TN;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * q;
      const bool in = col0 + c < V;
      const float2 b =
          in ? *reinterpret_cast<const float2*>(bias_s + c) : float2{};
      const float2 sw =
          in ? *reinterpret_cast<const float2*>(scale_s + c) : float2{};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float s0 = __fmul_rn(sh[h], sw.x);
        const float s1 = __fmul_rn(sh[h], sw.y);
        x[4 * j + 2 * h] =
            in ? __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), s0),
                           b.x)
               : -INFINITY;
        x[4 * j + 2 * h + 1] =
            in ? __fadd_rn(
                     __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), s1),
                     b.y)
               : -INFINITY;
      }
    }
  }

  // The CTA's 64 rows quantized into qh, one warp a row (warps 0-7 of the
  // consumers, 8 rows each), per row symmetric: s_h = max(max|h|, 1e-8) /
  // 127, q = rint(h / s_h) (IEEE division, half to even, no clip: the
  // reference's _quantize_rows). Columns past H and rows past N are zeros.
  // A quantized block is written to device memory and read back by TMA, so
  // resident and streamed rows take one path; a CTA writes its own copy
  // (rows share * Np + ...), so no CTA reads another's writes.
  __device__ __forceinline__ static void quantize(const Args& a, int share,
                                                  int row0, int warp, int lane,
                                                  float* s_rows) {
#pragma unroll 1
    for (int rr = 0; rr < 8; ++rr) {
      const int r = warp * 8 + rr;
      const int gr = row0 + r;
      const bool live = gr < a.N;
      const float* hrow = a.h + static_cast<size_t>(live ? gr : 0) * a.H;
      float amax = 0.0f;
      if (live)
        for (int c = lane * 4; c < a.H; c += 128) {
          const float4 x = *reinterpret_cast<const float4*>(hrow + c);
          amax = fmaxf(amax, fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)),
                                   fmaxf(fabsf(x.z), fabsf(x.w))));
        }
      amax = warp_max(amax);
      const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
      if (lane == 0) s_rows[r] = s;
      int8_t* qrow =
          a.qh + (static_cast<size_t>(share) * a.Np + gr) * a.Hp;
      for (int c = lane * 4; c < a.Hp; c += 128) {
        uint32_t packed = 0u;
        if (live && c < a.H) {  // H % 4 == 0: c..c+3 alike
          const float4 x = *reinterpret_cast<const float4*>(hrow + c);
          const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qv = __float2int_rn(__fdiv_rn(xs[e], s));
            packed |= static_cast<uint32_t>(qv & 0xff) << (8 * e);
          }
        }
        *reinterpret_cast<uint32_t*>(qrow + c) = packed;
      }
    }
  }
};

// fp32 h [N, H] (A boxes 64 rows x 32 K) and W [H, V] row-major: a stage is
// 64 K x 128 columns, four boxes of 64 K x 32 columns; every box 128-byte
// swizzled (16-byte chunk c of a 128-byte row r lands at chunk c ^ (r % 8)),
// which keeps the SIMT loads of f32_stage free of bank conflicts (a TMA box
// cannot be padded). Always streamed with W.
struct F32 {
  using Acc = float;
  static constexpr bool QUANT = false;
  static constexpr bool SIMT = true;
  static constexpr int BOXK = 32;      // K elements of an A box (128 bytes)
  static constexpr int KS = 2 * BOXK;  // K elements a stage
  static constexpr int SIDE_ARRAYS = 1;  // a tile's bias
  static constexpr int SIDE = TN * 4 * SIDE_ARRAYS;
  static constexpr int W_BOX = KS * 32 * 4;  // 64 K x 32 columns
  static constexpr int LDC = TN + 8;  // the shared logits tile's row stride
  static_assert(4 * W_BOX == W_STAGE && BOXK * 4 * BM == A_BOX,
                "an fp32 stage is the bf16 streamed stage's size");

  __device__ __forceinline__ static void load_w(unsigned char* st,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int col,
                                                int kb) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      tma_load_2d(st + c * W_BOX, map, bar, col + 32 * c, kb * KS);
  }

  __device__ __forceinline__ static void load_side(unsigned char* side,
                                                   const Args& a, int col,
                                                   uint32_t bytes,
                                                   uint64_t* bar) {
    bulk_load(side, a.bias + col, bytes, bar);
  }
};

// ---------------------------------------------------------------------------
// Epilogues
// ---------------------------------------------------------------------------

// The quad's (a row's four threads') best of (v, i) by better().
__device__ __forceinline__ void quad_best(float& v, int& i) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int quad_min(int v) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Folds a thread's row h of a tile into its online (m, s): exp(x - m) as
// 2^(x log2 e - m log2 e), one FMA and one ex2 each.
__device__ __forceinline__ void fold_lse(const float (&x)[64], int h,
                                         float tm, float& m, float& s) {
  const float m_new = fmaxf(m, tm);
  if (m_new == -INFINITY) return;
  const float mb = m_new * kLog2e;
  float acc = s * exp2f(m * kLog2e - mb);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    acc += exp2f(fmaf(x[4 * j + 2 * h], kLog2e, -mb)) +
           exp2f(fmaf(x[4 * j + 2 * h + 1], kLog2e, -mb));
  s = acc;
  m = m_new;
}

// The single sweep's epilogue. A thread carries, for each of its rows, an
// online (m, s) and a top-KMAX list of the columns it has held, and the bar
// a column must beat to matter: the best of the quad's last list entries.
// The row's top-KMAX all beat that bar (the quad thread that holds it has
// KMAX entries at least as good), so a column that does not is left out,
// and the check rarely passes after the first tiles. (KMAX above 8: the
// lists outgrow the registers and the compiler keeps them in local
// memory.) Partial states a row per CTA: 8 (one per thread of the row's
// quads) at KMAX = 8, else 2 (one per warpgroup, the quad merged first).
// OWN (the F32 consumers): a thread folds one row, its first (x[4 j + e]),
// and a row's state is the one warpgroup's that owns the row: 4 or 1
// partial states a row.
template <int KMAX, bool OWN>
struct SweepEpi {
  static constexpr int ROWS = OWN ? 1 : 2;  // rows a thread folds
  static constexpr int SLOTS = (KMAX == 8 ? 4 : 1) * (OWN ? 1 : 2);
  static constexpr int PART = 2 + 2 * KMAX;  // m, s, KMAX values, ids

  struct State {
    float m[ROWS];
    float s[ROWS];
    float lv[ROWS][KMAX];
    int li[ROWS][KMAX];
    float bar_v[ROWS];
    int bar_i[ROWS];
  };

  __device__ __forceinline__ static void init(State& st, int) {
#pragma unroll
    for (int h = 0; h < ROWS; ++h) {
      st.m[h] = -INFINITY;
      st.s[h] = 0.0f;
      clear(st.lv[h], st.li[h]);
      st.bar_v[h] = -INFINITY;
      st.bar_i[h] = INT_MAX;
    }
  }

  __device__ __forceinline__ static void fold(const float (&x)[64], int col0,
                                              int V, int q, const Args&,
                                              State& st) {
#pragma unroll
    for (int h = 0; h < ROWS; ++h) {
      float tm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        tm = fmaxf(tm, fmaxf(x[4 * j + 2 * h], x[4 * j + 2 * h + 1]));
      fold_lse(x, h, tm, st.m[h], st.s[h]);
      if (!(tm < st.bar_v[h])) {
        // The columns that reach the bar, as a mask (a superset of those
        // that beat it: insert() orders equal values by id), then one
        // insert loop over them (one copy of the insert code, not 32).
        uint32_t cand = 0;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (x[4 * j + 2 * h + e] >= st.bar_v[h] &&
                col0 + 8 * j + 2 * q + e < V)
              cand |= 1u << (2 * j + e);
        if (cand) {
          float v[32];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            v[2 * j] = x[4 * j + 2 * h];
            v[2 * j + 1] = x[4 * j + 2 * h + 1];
          }
          do {
            const int c = __ffs(cand) - 1;
            cand &= cand - 1;
            insert(st.lv[h], st.li[h], v[c],
                   col0 + 8 * (c >> 1) + 2 * q + (c & 1));
          } while (cand);
        }
      }
      // The new bar: the best of the quad's last entries.
      float bv = st.lv[h][KMAX - 1];
      int bi = st.li[h][KMAX - 1];
      quad_best(bv, bi);
      st.bar_v[h] = bv;
      st.bar_i[h] = bi;
    }
  }

  // The partial state of row h: at KMAX = 8 each thread's own; above,
  // the quad's merged state, written by quad thread 0 (k rounds of a quad
  // arg-max over the lists' heads, the winner's owner popping it).
  template <int h>
  __device__ __forceinline__ static void write(State& st, int k, int q,
                                               int wg, float* row_part) {
    if constexpr (KMAX == 8) {
      float* p = row_part + ((OWN ? 0 : wg * 4) + q) * PART;
      p[0] = st.m[h];
      p[1] = st.s[h];
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        p[2 + i] = st.lv[h][i];
        reinterpret_cast<int*>(p)[2 + KMAX + i] = st.li[h][i];
      }
    } else {
      float* p = row_part + (OWN ? 0 : wg) * PART;
      const float m = st.m[h];
      const float M = quad_max(m);
      float S = M == -INFINITY ? 0.0f : st.s[h] * expf(m - M);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        S += __shfl_xor_sync(0xffffffffu, S, off);
      for (int r = 0; r < k; ++r) {
        float v = st.lv[h][0];
        int i = st.li[h][0];
        quad_best(v, i);
        if (st.lv[h][0] == v && st.li[h][0] == i) {
#pragma unroll
          for (int x = 0; x < KMAX - 1; ++x) {
            st.lv[h][x] = st.lv[h][x + 1];
            st.li[h][x] = st.li[h][x + 1];
          }
          st.lv[h][KMAX - 1] = -INFINITY;
          st.li[h][KMAX - 1] = INT_MAX;
        }
        if (q == 0) {
          p[2 + r] = v;
          reinterpret_cast<int*>(p)[2 + KMAX + r] = i;
        }
      }
      if (q == 0) {
        p[0] = M;
        p[1] = S;
        for (int r = k; r < KMAX; ++r) {
          p[2 + r] = -INFINITY;
          reinterpret_cast<int*>(p)[2 + KMAX + r] = INT_MAX;
        }
      }
    }
  }
};

// The tiled heads' epilogue: per tile and row, the extraction that EXTRACT
// names (the reference's _lse_topk_update), folded into a running top-k.
// - kMask: round r takes the best (value, id) after the last one taken, a
//   quad arg-max over the thread's 32 columns (the whole-step kernel's
//   epi_head).
// - kThresh: the reference's read-only threshold walk: round 1's value is
//   the tile max, each later round a thresholded max, then the lowest
//   eligible id; over the same registers, so the two give the same entries
//   in the same order, bit for bit.
// The running list is the row's top-k so far (kept alike by the row's
// four threads) and its k-th entry is the bar. A tile whose max is
// strictly below the bar adds nothing to the list and skips the rounds;
// it still adds to (m, s). An equal max goes through
// the rounds: the tiles of a share start at a rotated tile, so a later
// tile may hold an equal value with a lower id. The rounds stop at the
// first entry that does not beat the bar: the entries come in order, so no
// later one would; and they scan only the columns that reach the bar at
// the tile's start, which give the same entries (fold_row). Partial
// states: 2 a row per CTA (one per warpgroup); OWN (the F32 consumers, as
// Sweep's): a thread folds one row, 1 partial state a row.
template <int EXTRACT, int KMAX, bool OWN = false>
struct Extract {
  static constexpr int ROWS = OWN ? 1 : 2;
  static constexpr int SLOTS = OWN ? 1 : 2;
  static constexpr int PART = 2 + 2 * KMAX;

  // lv, li: the first KMAX - k entries are sentinels (+inf) that nothing
  // displaces, the row's running top-k follows, so its k-th entry, the
  // bar, is always the last: a static index (a select of entry k - 1
  // became a dynamically indexed load, which moved the lists to local
  // memory).
  struct State {
    float m[ROWS];
    float s[ROWS];
    float lv[ROWS][KMAX];
    int li[ROWS][KMAX];
  };

  __device__ __forceinline__ static void init(State& st, int k) {
#pragma unroll
    for (int h = 0; h < ROWS; ++h) {
      st.m[h] = -INFINITY;
      st.s[h] = 0.0f;
#pragma unroll
      for (int e = 0; e < KMAX; ++e) {
        st.lv[h][e] = e < KMAX - k ? INFINITY : -INFINITY;
        st.li[h][e] = e < KMAX - k ? -1 : INT_MAX;
      }
    }
  }

  __device__ __forceinline__ static void fold(const float (&x)[64], int col0,
                                              int V, int q, const Args& a,
                                              State& st) {
    fold_row<0>(x, col0, V, q, a, st);
    if constexpr (!OWN) fold_row<1>(x, col0, V, q, a, st);
  }

  // Row H (0 or 1) of the thread's two. The rounds look only at the
  // columns that reach the bar when the tile starts: a round's entry
  // enters the list only if it beats the bar, which only rises, so while
  // the rounds go on their entries are among those columns, and the
  // first entry that does not beat the bar is no better among them.
  template <int H>
  __device__ __forceinline__ static void fold_row(const float (&x)[64],
                                                  int col0, int V, int q,
                                                  const Args& a, State& st) {
    float tm = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      tm = fmaxf(tm, fmaxf(x[4 * j + 2 * H], x[4 * j + 2 * H + 1]));
    tm = quad_max(tm);  // the row's tile max, alike in the quad
    fold_lse(x, H, tm, st.m[H], st.s[H]);
    const float bar0 = st.lv[H][KMAX - 1];
    bool live = a.fault == 1 ? tm > bar0 : !(tm < bar0);
    if (!__any_sync(0xffffffffu, live)) return;
    uint32_t cand = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (live && x[4 * j + 2 * H + e] >= bar0 &&
            col0 + 8 * j + 2 * q + e < V)
          cand |= 1u << (2 * j + e);
    // The candidates' values, indexed by bit (one copy of the round code,
    // not 32); read only through the bits of cand.
    float v[32];
    if (cand) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        v[2 * j] = x[4 * j + 2 * H];
        v[2 * j + 1] = x[4 * j + 2 * H + 1];
      }
    }
    // The quad's candidates: each round that enters the list takes one,
    // so after that many no round could.
    int n = __popc(cand);
    n += __shfl_xor_sync(0xffffffffu, n, 1);
    n += __shfl_xor_sync(0xffffffffu, n, 2);
    // (pv, pi): the last entry taken; the eligible entries come after it.
    // Bit c is column col0 + 8 (c / 2) + 2 q + c % 2: ids rise with c.
    float pv = INFINITY;
    int pi = -1;
    for (int r = 0; r < a.k; ++r) {
      if (!__any_sync(0xffffffffu, live)) break;
      float bv = -INFINITY;
      int bi = INT_MAX;
      if constexpr (EXTRACT == kMask) {
        for (uint32_t c = cand; c; c &= c - 1) {
          const int b = __ffs(c) - 1;
          const int i = col0 + 8 * (b >> 1) + 2 * q + (b & 1);
          if ((v[b] < pv || (v[b] == pv && i > pi)) && v[b] > bv) {
            bv = v[b];  // the first strict max is the lowest id
            bi = i;
          }
        }
        quad_best(bv, bi);
      } else {
        if (r == 0) {
          bv = tm;
        } else {
          for (uint32_t c = cand; c; c &= c - 1) {
            const int b = __ffs(c) - 1;
            const int i = col0 + 8 * (b >> 1) + 2 * q + (b & 1);
            if (v[b] < pv || (v[b] == pv && i > pi)) bv = fmaxf(bv, v[b]);
          }
          bv = quad_max(bv);
        }
        for (uint32_t c = cand; c; c &= c - 1) {
          const int b = __ffs(c) - 1;
          const int i = col0 + 8 * (b >> 1) + 2 * q + (b & 1);
          if (v[b] == bv && (bv < pv || i > pi)) bi = min(bi, i);
        }
        bi = quad_min(bi);
      }
      live = live && better(bv, bi, st.lv[H][KMAX - 1], st.li[H][KMAX - 1]);
      if (live) insert(st.lv[H], st.li[H], bv, bi);
      live = live && r + 1 < n;
      pv = bv;
      pi = bi;
    }
  }

  // Row h's partial state, by quad thread 0: the quad's (M, S) (m is alike
  // in the quad) and the running list.
  template <int h>
  __device__ __forceinline__ static void write(State& st, int k, int q,
                                               int wg, float* row_part) {
    float S = st.s[h];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      S += __shfl_xor_sync(0xffffffffu, S, off);
    if (q == 0) {
      float* p = row_part + (OWN ? 0 : wg) * PART;
      p[0] = st.m[h];
      p[1] = S;
      // The merge wants each list sorted, best first: the top-k at slots
      // 0 .. k - 1, the sentinels after them as empty entries (the slot is
      // computed in the address, not by indexing the registers).
      const int c = KMAX - k;
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        const bool real = i >= c;
        const int d = real ? i - c : i - c + KMAX;
        p[2 + d] = real ? st.lv[h][i] : -INFINITY;
        reinterpret_cast<int*>(p)[2 + KMAX + d] = real ? st.li[h][i] : INT_MAX;
      }
    }
  }
};

template <int KMAX>
using Sweep = SweepEpi<KMAX, false>;
template <int KMAX>
using MaskEpi = Extract<kMask, KMAX>;
template <int KMAX>
using ThreshEpi = Extract<kThresh, KMAX>;
// The F32 consumers' epilogues (a thread folds one row).
template <int KMAX>
using MaskEpiF32 = Extract<kMask, KMAX, true>;
template <int KMAX>
using ThreshEpiF32 = Extract<kThresh, KMAX, true>;
template <int KMAX>
using SweepF32 = SweepEpi<KMAX, true>;

// ---------------------------------------------------------------------------
// The F32 consumers
// ---------------------------------------------------------------------------

// One F32 stage's products (64 K) for a thread's 4 x 8 block: tile rows r0
// + 8 i (r0 = 32 wg + rg, rg < 8, so a row's swizzle is rg), columns 4 cg +
// e and 64 + 4 cg + e (W boxes cg / 8 and cg / 8 + 2, chunk cc = cg % 8).
// Per 4 K: four 16-byte loads of A (4 K of a row) and eight of W (4
// columns of a K row), 128 FMAs. A warp's lanes hold 4 row groups x 8
// column groups, so each of its loads touches 4 (A) or 8 (W) distinct
// 16-byte chunks, which the swizzle puts in distinct banks.
__device__ __forceinline__ void f32_stage(float (&acc)[4][8],
                                          const unsigned char* st, int r0,
                                          int rg, int cg) {
  const unsigned char* ab = st + W_STAGE + r0 * 128;
  const unsigned char* wb = st + (cg >> 3) * F32::W_BOX;
  const int cc = cg & 7;
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the stage's two A boxes, 32 K each
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {  // 4 K a chunk
      float4 av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(ab + r * A_BOX + i * 1024 +
                                                 ((kc ^ rg) << 4));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = 32 * r + 4 * kc + e;  // the W row
        const int off = kk * 128 + ((cc ^ (kk & 7)) << 4);
        const float4 b0 = *reinterpret_cast<const float4*>(wb + off);
        const float4 b1 =
            *reinterpret_cast<const float4*>(wb + 2 * F32::W_BOX + off);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = e == 0   ? av[i].x
                          : e == 1 ? av[i].y
                          : e == 2 ? av[i].z
                                   : av[i].w;
          acc[i][0] = fmaf(x, b0.x, acc[i][0]);
          acc[i][1] = fmaf(x, b0.y, acc[i][1]);
          acc[i][2] = fmaf(x, b0.z, acc[i][2]);
          acc[i][3] = fmaf(x, b0.w, acc[i][3]);
          acc[i][4] = fmaf(x, b1.x, acc[i][4]);
          acc[i][5] = fmaf(x, b1.y, acc[i][5]);
          acc[i][6] = fmaf(x, b1.z, acc[i][6]);
          acc[i][7] = fmaf(x, b1.w, acc[i][7]);
        }
      }
    }
  }
}

// The F32 consumers' walk over the CTA's share. Warpgroup wg owns the
// tile rows [32 wg, 32 wg + 32): it multiplies them for every tile (every
// K in order, one fp32 FMA chain a logit, as a sequential fp32 GEMM sums),
// writes their logits (bias added, columns past V at -inf) to shared tile t
// % 2, meets its own warps at a barrier, reads them back a row a thread in
// the layout of wgmma's accumulator's first row (row 32 wg + 8 (warp % 4) +
// lane / 4, columns 8 j + 2 q + {0, 1}) and folds them into its running
// state with the bf16 epilogue (Epi has OWN set). The warpgroup's barrier
// of tile t + 1 comes after that fold, so tile t + 2 may overwrite the
// shared tile. The two warpgroups meet only at the ring, which frees a
// stage when both have read it.
template <class Epi>
__device__ __forceinline__ void f32_tiles(
    const Args& a, const unsigned char* ring, const unsigned char* side,
    float* logits, uint64_t* full, uint64_t* empty, typename Epi::State& es,
    int my_tiles, int t_begin, int rot, int KB, int wg, int warp, int lane) {
  constexpr int STAGE = W_STAGE + 2 * A_BOX;
  constexpr int LDC = F32::LDC;
  const int wi = warp % 4;
  const int rg = 4 * (wi >> 1) + (lane >> 3);  // row group 0..7
  const int cg = 8 * (wi & 1) + (lane & 7);    // column group 0..15
  const int r0 = 32 * wg + rg;
  const int q = lane % 4;
  const int rl = 32 * wg + 8 * wi + lane / 4;  // the row this thread folds
  for (int t = 0; t < my_tiles; ++t) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int kb = 0; kb < KB; ++kb) {
      const int it = t * KB + kb;
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      f32_stage(acc, ring + s * STAGE, r0, rg, cg);
      if (kb + 1 < KB) {  // the last stage goes once its bias is read
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }
    const int last = (t * KB + KB - 1) % STAGES;
    const int col0 = (t_begin + (t + rot) % my_tiles) * TN;
    const float* bias = reinterpret_cast<const float*>(side + last * F32::SIDE);
    float* tile = logits + (t & 1) * BM * LDC;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = 64 * half + 4 * cg;
      const bool in = col0 + c < a.V;  // V % 8 == 0: c .. c + 3 alike
      const float4 b = in ? *reinterpret_cast<const float4*>(bias + c)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* p = acc[i] + 4 * half;
        *reinterpret_cast<float4*>(tile + (r0 + 8 * i) * LDC + c) =
            in ? make_float4(p[0] + b.x, p[1] + b.y, p[2] + b.z, p[3] + b.w)
               : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[last]);
    named_sync(3 + wg, 128);  // the warpgroup's rows of the tile are complete
    float x[64];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 v =
          *reinterpret_cast<const float2*>(tile + rl * LDC + 8 * j + 2 * q);
      x[4 * j] = v.x;
      x[4 * j + 1] = v.y;
      x[4 * j + 2] = x[4 * j + 3] = -INFINITY;  // no second row
    }
    Epi::fold(x, col0, a.V, q, a, es);
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// The shared-memory layout of one instance: A resident (HMAX / BOXK boxes)
// or, STREAM, two A boxes in every stage; the ring; F32's two logits
// tiles; a side slot a stage (bias, scales); S8's row scales; the
// mbarriers.
template <class Ops, class Epi, bool STREAM>
struct Plan {
  static_assert(STREAM || !Ops::SIMT, "fp32 rows stream with W");
  static constexpr int STAGE = STREAM ? W_STAGE + 2 * A_BOX : W_STAGE;
  static constexpr int RESIDENT = STREAM ? 0 : (HMAX / Ops::BOXK) * A_BOX;
  static constexpr int LOGITS = Ops::SIMT ? 2 * BM * F32::LDC * 4 : 0;
  static constexpr int ROW_SCALES = Ops::QUANT ? BM * 4 : 0;
  static constexpr int SMEM = 1024 + RESIDENT + STAGES * (STAGE + Ops::SIDE) +
                              LOGITS + ROW_SCALES + (2 * STAGES + 3) * 8;
  // The partial states go over A and the ring.
  static_assert(BM * Epi::SLOTS * Epi::PART * 4 <=
                    RESIDENT + STAGES * STAGE,
                "the partial states fit");
  static_assert(STAGE % 1024 == 0 && RESIDENT % 1024 == 0,
                "stages stay on 1024-byte boundaries");
  static_assert(SMEM <= 232448, "one CTA's shared memory");
};

template <class Ops, class Epi, bool STREAM>
__global__ void __launch_bounds__(NTHREADS, 1)
    head_kernel(const __grid_constant__ CUtensorMap a_map,
                const __grid_constant__ CUtensorMap w_map,
                const __grid_constant__ Args a) {
  using P = Plan<Ops, Epi, STREAM>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* as = smem;  // resident A
  unsigned char* ring = smem + P::RESIDENT;
  float* logits = reinterpret_cast<float*>(ring + STAGES * P::STAGE);
  unsigned char* side = ring + STAGES * P::STAGE + P::LOGITS;
  float* s_rows = reinterpret_cast<float*>(side + STAGES * Ops::SIDE);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(side + STAGES * Ops::SIDE + P::ROW_SCALES);
  uint64_t* empty = full + STAGES;
  uint64_t* a_full = empty + STAGES;
  uint64_t* order = a_full + 1;  // order[c]: warpgroup c may start a tile

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int shares = gridDim.x;  // the cluster: the CTAs of one row block
  const int share = blockIdx.x;
  const int row0 = blockIdx.y * BM;
  const int a_row0 = Ops::QUANT ? share * a.Np + row0 : row0;
  const int V = a.V;
  const int n_tiles = (V + TN - 1) / TN;
  const int per = (n_tiles + shares - 1) / shares;
  const int t_begin = share * per;
  const int my_tiles = max(0, min(n_tiles, t_begin + per) - t_begin);
  // The share is swept from a tile that depends on the row block, so the
  // clusters do not all read the same W tile at the same time.
  const int rot = my_tiles > 0 ? static_cast<int>(blockIdx.y) % my_tiles : 0;
  const int K = Ops::QUANT ? a.Hp : a.H;
  const int KB = (K + Ops::KS - 1) / Ops::KS;  // W stages a tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      // The consuming warpgroup's 4 warps; F32: both warpgroups' 8.
      mbar_init(&empty[s], Ops::SIMT ? 8 : 4);
    }
    mbar_init(a_full, 1);
    mbar_init(&order[0], 4);
    mbar_init(&order[1], 4);
    fence_barrier_init();
  }
  __syncthreads();

  if constexpr (Ops::QUANT) {
    // The consumers quantize the block's rows; the producer's warp waits
    // for them before its first A load.
    if (wg < 2) {
      S8::quantize(a, share, row0, warp, lane, s_rows);
      fence_proxy_async_global();
    }
    if (wg < 2 || warp == 8) named_sync(2, 288);
  }

  if (wg == 2) {
    if (threadIdx.x == 256) {  // producer
      if constexpr (!STREAM) {
        mbar_expect_tx(a_full, 2 * KB * A_BOX);  // K past the end reads 0
        for (int kb = 0; kb < 2 * KB; ++kb)
          tma_load_2d(as + kb * A_BOX, &a_map, a_full, kb * Ops::BOXK,
                      a_row0);
      }
      for (int t = 0; t < my_tiles; ++t) {
        const int col = (t_begin + (t + rot) % my_tiles) * TN;
        for (int kb = 0; kb < KB; ++kb) {
          const int it = t * KB + kb;
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          unsigned char* st = ring + s * P::STAGE;
          // The tile's last stage also brings its side data (bias,
          // scales: 4 bytes a column each).
          const uint32_t side_bytes = kb == KB - 1 ? 4 * min(TN, V - col) : 0;
          mbar_expect_tx(&full[s],
                         P::STAGE + Ops::SIDE_ARRAYS * side_bytes);
          if (side_bytes)
            Ops::load_side(side + s * Ops::SIDE, a, col, side_bytes,
                           &full[s]);
          Ops::load_w(st, &w_map, &full[s], col, kb);
          if (STREAM)  // the stage's K range of A
#pragma unroll
            for (int r = 0; r < 2; ++r)
              tma_load_2d(st + W_STAGE + r * A_BOX, &a_map, &full[s],
                          kb * Ops::KS + r * Ops::BOXK, a_row0);
        }
      }
    }
  } else if constexpr (Ops::SIMT) {
    static_assert(Epi::ROWS == 1, "the F32 consumers fold a row a thread");
    const int q = lane % 4;
    const int rl = 32 * wg + 8 * (warp % 4) + lane / 4;  // the thread's row
    typename Epi::State es;
    Epi::init(es, a.k);
    f32_tiles<Epi>(a, ring, side, logits, full, empty, es, my_tiles, t_begin,
                   rot, KB, wg, warp, lane);
    named_sync(1, 256);
    float* part = reinterpret_cast<float*>(smem);
    Epi::template write<0>(es, a.k, q, wg,
                           part + rl * Epi::SLOTS * Epi::PART);
  } else {
    // Consumer warpgroup wg takes the share's tiles wg, wg + 2, ...
    const int q = lane % 4;
    const int rl = (warp % 4) * 16 + lane / 4;  // rows rl and rl + 8
    float sh[2] = {1.0f, 1.0f};
    if constexpr (Ops::QUANT) {
      sh[0] = s_rows[rl];
      sh[1] = s_rows[rl + 8];
    }
    typename Epi::State es;
    Epi::init(es, a.k);
    if (!STREAM) mbar_wait(a_full, 0);
    int n = 0;  // this warpgroup's tiles so far
    for (int t = wg; t < my_tiles; t += 2, ++n) {
      // Wait for the other warpgroup to have issued its previous tile.
      if (t > 0) mbar_wait(&order[wg], (wg == 0 ? n - 1 : n) & 1);
      typename Ops::Acc acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0;
      fence_regs(acc);
      for (int kb = 0; kb < KB; ++kb) {
        const int it = t * KB + kb;
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* st = ring + s * P::STAGE;
        wgmma_fence();
        if (STREAM)
          Ops::mma(acc, st + W_STAGE, st + W_STAGE + A_BOX, st);
        else
          Ops::mma(acc, as + 2 * kb * A_BOX, as + (2 * kb + 1) * A_BOX, st);
        wgmma_commit();
        if (kb > 0) {
          wgmma_wait<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&order[1 - wg]);
      wgmma_wait<0>();
      fence_regs(acc);
      const int last = (t * KB + KB - 1) % STAGES;
      const int col0 = (t_begin + (t + rot) % my_tiles) * TN;
      float x[64];
      Ops::logits(acc, x, side + last * Ops::SIDE, col0, V, q, sh);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[last]);
      Epi::fold(x, col0, V, q, a, es);
    }
    // Both warpgroups are done reading A and the ring: their partial
    // states go over them.
    named_sync(1, 256);
    float* part = reinterpret_cast<float*>(smem);
    Epi::template write<0>(es, a.k, q, wg,
                           part + rl * Epi::SLOTS * Epi::PART);
    Epi::template write<1>(es, a.k, q, wg,
                           part + (rl + 8) * Epi::SLOTS * Epi::PART);
  }
  cluster_sync();

  // The merge: rows share, share + shares, ... of the 64, one warp each,
  // over every CTA's partial states of the row.
  constexpr int KMAX = (Epi::PART - 2) / 2;
  const float* part = reinterpret_cast<const float*>(smem);
  for (int r = share + shares * warp; r < BM; r += shares * (NTHREADS / 32)) {
    const int gr = row0 + r;
    if (gr >= a.N) break;  // the same for the whole warp
    float m = -INFINITY, s = 0.0f;
    float lv[KMAX];
    int li[KMAX];
    clear(lv, li);
    if (lane < shares * Epi::SLOTS) {
      const float* p = cluster_map(part, lane / Epi::SLOTS) +
                       (r * Epi::SLOTS + lane % Epi::SLOTS) * Epi::PART;
      m = p[0];
      s = p[1];
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        lv[i] = p[2 + i];
        li[i] = reinterpret_cast<const int*>(p)[2 + KMAX + i];
      }
    }
    const float M = warp_max(m);
    const float S = warp_sum(m == -INFINITY ? 0.0f : s * expf(m - M));
    warp_pop_topk(lv, li, a.k, a.vals + static_cast<size_t>(gr) * a.k,
                  a.idx + static_cast<size_t>(gr) * a.k, lane);
    if (lane == 0) a.lse[gr] = M + logf(S);
  }
  cluster_sync();  // no CTA leaves while its partial states are read
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// The launch of clusters of `shares` CTAs over `row_blocks` blocks of rows
// (`attr` holds the cluster shape the config points to).
inline cudaLaunchConfig_t launch_config(int shares, int row_blocks, int smem,
                                        cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = shares;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(shares, row_blocks);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of `shares` CTAs of one instance the card holds at
// once; sets the kernel's shared-memory size first.
template <class Ops, class Epi, bool STREAM>
cudaError_t max_clusters(int shares, int* clusters) {
  constexpr int smem = Plan<Ops, Epi, STREAM>::SMEM;
  auto* kernel = head_kernel<Ops, Epi, STREAM>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(shares, 1, smem, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

template <class Ops, class Epi, bool STREAM>
cudaError_t launch(const CUtensorMap& a_map, const CUtensorMap& w_map,
                   const Args& a, int shares, cudaStream_t stream) {
  // The merge reads a row's partial states a lane each.
  if (shares * Epi::SLOTS > 32) return cudaErrorInvalidValue;
  // The first launch at each cluster size on a device checks that the
  // card holds one (and sets the kernel's shared-memory size there).
  static bool checked[sm90::kDevices][MAX_SHARES + 1] = {};
  const int dev = sm90::device_slot();
  if (dev < 0 || !checked[dev][shares]) {
    int clusters = 0;
    const cudaError_t err = max_clusters<Ops, Epi, STREAM>(shares, &clusters);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    if (dev >= 0) checked[dev][shares] = true;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(shares, (a.N + BM - 1) / BM,
                    Plan<Ops, Epi, STREAM>::SMEM, stream, &attr);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, head_kernel<Ops, Epi, STREAM>, a_map, w_map,
                         a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instance for k (kmax_for(k)) of epilogue family EpiK.
template <class Ops, template <int> class EpiK, bool STREAM>
cudaError_t launch_k(const CUtensorMap& a_map, const CUtensorMap& w_map,
                     const Args& a, int shares, cudaStream_t stream) {
  switch (kmax_for(a.k)) {
    case 8:
      return launch<Ops, EpiK<8>, STREAM>(a_map, w_map, a, shares, stream);
    case 16:
      return launch<Ops, EpiK<16>, STREAM>(a_map, w_map, a, shares, stream);
    case 32:
      return launch<Ops, EpiK<32>, STREAM>(a_map, w_map, a, shares, stream);
    default:
      return launch<Ops, EpiK<64>, STREAM>(a_map, w_map, a, shares, stream);
  }
}

template <class Ops, template <int> class EpiK>
cudaError_t launch_any(const CUtensorMap& a_map, const CUtensorMap& w_map,
                       const Args& a, int shares, bool stream_a,
                       cudaStream_t stream) {
  if constexpr (Ops::SIMT)  // fp32 rows always stream
    return launch_k<Ops, EpiK, true>(a_map, w_map, a, shares, stream);
  else
    return stream_a
               ? launch_k<Ops, EpiK, true>(a_map, w_map, a, shares, stream)
               : launch_k<Ops, EpiK, false>(a_map, w_map, a, shares, stream);
}

// The clusters query of a family (its k <= 8 instance, A resident or
// streamed; F32 always streamed): 0 when the card cannot hold one; a
// negative CUDA error code when the query fails.
template <class Ops, template <int> class EpiK>
int clusters_of(int shares, int wide, int device) {
  if (shares < 1 || shares > MAX_SHARES) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  int clusters = 0;
  if (err == cudaSuccess) {
    if constexpr (Ops::SIMT)
      err = max_clusters<Ops, EpiK<8>, true>(shares, &clusters);
    else
      err = wide ? max_clusters<Ops, EpiK<8>, true>(shares, &clusters)
                 : max_clusters<Ops, EpiK<8>, false>(shares, &clusters);
  }
  return err == cudaSuccess ? clusters : -(int)err;
}

// The bf16 maps: h [N, H] in 64 x 64 boxes, W [H, V] in 64 x 64 boxes,
// both 128-byte swizzled.
inline cudaError_t bf16_maps(CUtensorMap* a_map, CUtensorMap* w_map,
                             const void* h, const void* w, int N, int H,
                             int V) {
  cudaError_t err = tensor_map_2d(a_map, h, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                  2, N, H, H, BM, Bf16::BOXK,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  return tensor_map_2d(w_map, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, H, V, V,
                       64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The fp32 maps: h [N, H] in 64 x 32 boxes, W [H, V] in 64 x 32 boxes, both
// 128-byte swizzled.
inline cudaError_t f32_maps(CUtensorMap* a_map, CUtensorMap* w_map,
                            const void* h, const void* w, int N, int H,
                            int V) {
  cudaError_t err = tensor_map_2d(a_map, h, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                  4, N, H, H, BM, F32::BOXK,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  return tensor_map_2d(w_map, w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, H, V, V,
                       F32::KS, 32, CU_TENSOR_MAP_SWIZZLE_128B);
}

inline bool bad_shape(int N, int H, int V, int k, int shares) {
  return N < 1 || H < 1 || V < 1 || k < 1 || k > KMAX_LIMIT || k > V ||
         shares < 1 || shares > MAX_SHARES;
}

}  // namespace hsm
}  // namespace
