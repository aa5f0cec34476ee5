// Shared pieces of the vocab-head kernels (head_sm90.cuh and through it
// head_topk.cu, head_int8.cu, head_sweep.cu; wholestep.cu): the (value
// descending, vocab id ascending) order, the candidate lists and the warp
// arg-max merge, and the fp32 route: the per-row top-k of an fp32 logits
// tile in its two extractions, pass 2 (the merge of the tiles' partial
// results), the fp32 logits tile on the CUDA cores and the one-pass fp32
// sweep.
//
// Replaces the extraction and merge of the TPU kernels in
// captionkit/ops/head.py (_lse_topk_update: extract="mask" and "thresh").
//
// Every comparison orders by (value descending, vocab id ascending), so
// ties resolve as lax.top_k's whatever order the tiles finish in.
//
// Any k up to KMAX_LIMIT: the candidate lists are template parameters of
// their length (the k = 8 instance is the one every kernel had before),
// and the host picks the smallest instance that holds k (kmax_for). A
// tile row's own list needs no more than a lane's COLS_PER_LANE columns,
// whatever k; it keeps the 8 entries it always had.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int BN = 128;       // vocab columns per tile
constexpr int KMAX_LIMIT = 64;  // largest k of any instance
constexpr int THREADS = 256;  // 8 warps
constexpr int COLS_PER_LANE = BN / 32;
constexpr int TILE_LIST = 8;  // a lane's list in a tile row (>= COLS_PER_LANE)

// The smallest candidate-list instance that holds k (8, 16, 32 or 64).
__host__ __device__ constexpr int kmax_for(int k) {
  return k <= 8 ? 8 : k <= 16 ? 16 : k <= 32 ? 32 : 64;
}

enum Extract { kMask = 0, kThresh = 1 };

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Insert (v, i) into a list kept sorted by better(); the worst falls off.
// Static indices only, so a short list stays in registers.
template <int L>
__device__ __forceinline__ void insert(float (&lv)[L], int (&li)[L], float v,
                                       int i) {
#pragma unroll
  for (int q = 0; q < L; ++q) {
    if (better(v, i, lv[q], li[q])) {
      const float tv = lv[q];
      const int ti = li[q];
      lv[q] = v;
      li[q] = i;
      v = tv;
      i = ti;
    }
  }
}

template <int L>
__device__ __forceinline__ void clear(float (&lv)[L], int (&li)[L]) {
#pragma unroll
  for (int q = 0; q < L; ++q) {
    lv[q] = -INFINITY;
    li[q] = INT_MAX;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// k rounds over the warp: each lane offers the head of its sorted list,
// the best offer wins, and its owner pops it. Lane 0 writes the winners.
// The union of the lanes' lists holds the warp's top-k, so this is exact.
template <int L>
__device__ __forceinline__ void warp_pop_topk(float (&lv)[L], int (&li)[L],
                                              int k, float* out_v,
                                              int* out_i, int lane) {
  for (int r = 0; r < k; ++r) {
    float v = lv[0];
    int i = li[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (better(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    if (lv[0] == v && li[0] == i) {
#pragma unroll
      for (int q = 0; q < L - 1; ++q) {
        lv[q] = lv[q + 1];
        li[q] = li[q + 1];
      }
      lv[L - 1] = -INFINITY;
      li[L - 1] = INT_MAX;
    }
    if (lane == 0) {
      out_v[r] = v;
      out_i[r] = i;
    }
  }
}

// "thresh": the read-only extraction. After step r the extracted entries
// are exactly the lexicographic head of the row, so (v, i) of the last one
// marks them: an entry is still active iff x < v, or x == v and col > i.
// Step 1's value is the tile max m (already reduced for the log-sum-exp);
// each later step is a thresholded max, then the lowest eligible column.
// Columns past the vocab carry xi = INT_MAX and take no part; once the
// tile runs out, steps give (-inf, INT_MAX), as the mask extraction does.
__device__ __forceinline__ void warp_thresh_topk(
    const float (&x)[COLS_PER_LANE], const int (&xi)[COLS_PER_LANE],
    float m, int k, float* out_v, int* out_i, int lane) {
  float v = m;
  int i = INT_MAX;
#pragma unroll
  for (int q = 0; q < COLS_PER_LANE; ++q)
    if (xi[q] != INT_MAX && x[q] == v) i = min(i, xi[q]);
  i = warp_min(i);
  if (lane == 0) {
    out_v[0] = v;
    out_i[0] = i;
  }
  for (int r = 1; r < k; ++r) {
    float vn = -INFINITY;
#pragma unroll
    for (int q = 0; q < COLS_PER_LANE; ++q)
      if (xi[q] != INT_MAX && (x[q] < v || (x[q] == v && xi[q] > i)))
        vn = fmaxf(vn, x[q]);
    vn = warp_max(vn);
    int in = INT_MAX;
#pragma unroll
    for (int q = 0; q < COLS_PER_LANE; ++q)
      if (xi[q] != INT_MAX && x[q] == vn && (vn < v || xi[q] > i))
        in = min(in, xi[q]);
    in = warp_min(in);
    v = vn;
    i = in;
    if (lane == 0) {
      out_v[r] = v;
      out_i[r] = i;
    }
  }
}

// Row r of an fp32 logits tile in shared memory (row stride ldc) plus the
// bias, as one warp holds it: lane l has columns col0 + l + 32 q; columns
// past V get (-inf, INT_MAX).
__device__ __forceinline__ void load_row(const float* Cs, int ldc, int r,
                                         const float* bias, int col0, int V,
                                         int lane, float (&x)[COLS_PER_LANE],
                                         int (&xi)[COLS_PER_LANE]) {
#pragma unroll
  for (int q = 0; q < COLS_PER_LANE; ++q) {
    const int gc = col0 + lane + 32 * q;
    if (gc < V) {
      x[q] = Cs[r * ldc + lane + 32 * q] + bias[gc];
      xi[q] = gc;
    } else {
      x[q] = -INFINITY;
      xi[q] = INT_MAX;
    }
  }
}

// One row of one tile, held by one warp (lane l has columns l + 32 q;
// xi = INT_MAX past the vocab): its max m, its sum s = sum exp(x - m) and
// its top-k, written to the partials of slot (row, tile).
template <int EXTRACT>
__device__ __forceinline__ void emit_tile_row(
    const float (&x)[COLS_PER_LANE], const int (&xi)[COLS_PER_LANE], int k,
    size_t slot, float* __restrict__ part_m, float* __restrict__ part_s,
    float* __restrict__ part_v, int* __restrict__ part_i, int lane) {
  float m = -INFINITY;
#pragma unroll
  for (int q = 0; q < COLS_PER_LANE; ++q) m = fmaxf(m, x[q]);
  m = warp_max(m);
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < COLS_PER_LANE; ++q)
    if (xi[q] != INT_MAX) s += expf(x[q] - m);
  s = warp_sum(s);
  if (EXTRACT == kThresh) {
    warp_thresh_topk(x, xi, m, k, part_v + slot * k, part_i + slot * k,
                     lane);
  } else {
    float lv[TILE_LIST];
    int li[TILE_LIST];
    clear(lv, li);
#pragma unroll
    for (int q = 0; q < COLS_PER_LANE; ++q) insert(lv, li, x[q], xi[q]);
    warp_pop_topk(lv, li, k, part_v + slot * k, part_i + slot * k, lane);
  }
  if (lane == 0) {
    part_m[slot] = m;
    part_s[slot] = s;
  }
}

// Row `row` of pass 2, held by one warp: lse = M + log sum_j s_j exp(m_j -
// M) over the tiles, and the top-k of the tiles' candidates. (No
// __restrict__ here: the whole-step kernel merges partials it wrote itself
// earlier in the same launch, which must not be read through the
// read-only cache.) A lane keeps a KMAX-long list: all of the row's top-k
// may come from its candidates.
template <int KMAX>
__device__ __forceinline__ void merge_row(const float* part_m,
                                          const float* part_s,
                                          const float* part_v,
                                          const int* part_i, float* vals,
                                          int* idx, float* lse, int row,
                                          int n_tiles, int k, int lane) {
  const float* pm = part_m + (size_t)row * n_tiles;
  const float* ps = part_s + (size_t)row * n_tiles;
  float M = -INFINITY;
  for (int j = lane; j < n_tiles; j += 32) M = fmaxf(M, pm[j]);
  M = warp_max(M);
  float S = 0.0f;
  for (int j = lane; j < n_tiles; j += 32) S += ps[j] * expf(pm[j] - M);
  S = warp_sum(S);

  float lv[KMAX];
  int li[KMAX];
  clear(lv, li);
  const int n_cand = n_tiles * k;
  const float* pv = part_v + (size_t)row * n_cand;
  const int* pi = part_i + (size_t)row * n_cand;
  for (int c = lane; c < n_cand; c += 32) insert(lv, li, pv[c], pi[c]);
  warp_pop_topk(lv, li, k, vals + (size_t)row * k, idx + (size_t)row * k,
                lane);
  if (lane == 0) lse[row] = M + logf(S);
}

// Pass 2, one warp per row.
template <int KMAX>
__global__ void __launch_bounds__(THREADS)
head_merge_kernel(const float* __restrict__ part_m,
                  const float* __restrict__ part_s,
                  const float* __restrict__ part_v,
                  const int* __restrict__ part_i, float* __restrict__ vals,
                  int* __restrict__ idx, float* __restrict__ lse, int N,
                  int n_tiles, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (row >= N) return;  // the same for the whole warp
  merge_row<KMAX>(part_m, part_s, part_v, part_i, vals, idx, lse, row,
                  n_tiles, k, lane);
}

template <int KMAX>
cudaError_t launch_merge_k(const float* part_m, const float* part_s,
                           const float* part_v, const int* part_i,
                           float* vals, int* idx, float* lse, int N,
                           int n_tiles, int k, cudaStream_t s) {
  const int rows_per_block = THREADS / 32;
  head_merge_kernel<KMAX><<<(N + rows_per_block - 1) / rows_per_block,
                            THREADS, 0, s>>>(part_m, part_s, part_v, part_i,
                                             vals, idx, lse, N, n_tiles, k);
  return cudaGetLastError();
}

// Pass 2 at the instance kmax_for(k).
cudaError_t launch_merge(const float* part_m, const float* part_s,
                         const float* part_v, const int* part_i, float* vals,
                         int* idx, float* lse, int N, int n_tiles, int k,
                         cudaStream_t s) {
  switch (kmax_for(k)) {
    case 8:
      return launch_merge_k<8>(part_m, part_s, part_v, part_i, vals, idx,
                               lse, N, n_tiles, k, s);
    case 16:
      return launch_merge_k<16>(part_m, part_s, part_v, part_i, vals, idx,
                                lse, N, n_tiles, k, s);
    case 32:
      return launch_merge_k<32>(part_m, part_s, part_v, part_i, vals, idx,
                                lse, N, n_tiles, k, s);
    default:
      return launch_merge_k<64>(part_m, part_s, part_v, part_i, vals, idx,
                                lse, N, n_tiles, k, s);
  }
}

// ---------------------------------------------------------------------------
// The fp32 route (compute_dtype="float32"): fp32 products on the CUDA cores
// (no tensor cores: TF32 would keep 10 mantissa bits).
// ---------------------------------------------------------------------------

constexpr int F32_BK = 16;  // depth of one fp32 shared-memory stage

// Shared memory of f32_logits_tile for BM_ rows: h stage [F32_BK][BM_ + 4]
// (k-major), W stage [F32_BK][BN + 4].
template <int BM_>
__host__ __device__ constexpr int f32_tile_floats() {
  return F32_BK * (BM_ + 4) + F32_BK * (BN + 4);
}

// One [BM_, 128] fp32 tile of h @ W (no bias) into Cs (row stride ldc),
// rows [row0, row0 + BM_), vocab columns [col0, col0 + 128): fp32 h [N, H]
// and W [H, V] (H and V multiples of 4), plain FMA. Thread t of the
// block's THREADS owns columns 4 (t % 32) + {0..3} of rows (t / 32) BM_/8
// + {0..BM_/8 - 1}; a warp reads one h row broadcast and 128 consecutive W
// columns. Ends with the block synchronised and Cs complete; Cs may not
// alias `stage`.
template <int BM_>
__device__ __forceinline__ void f32_logits_tile(
    const float* __restrict__ h, const float* __restrict__ w, int row0,
    int col0, int N, int H, int V, float* stage, float* Cs, int ldc) {
  constexpr int RPT = BM_ / 8;  // rows a thread
  constexpr int LDA = BM_ + 4;
  constexpr int LDB = BN + 4;
  float* As = stage;                 // [F32_BK][LDA]
  float* Bs = stage + F32_BK * LDA;  // [F32_BK][LDB]
  const int tid = threadIdx.x;
  const int tc = tid % 32;
  const int tr = tid / 32;
  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < H; k0 += F32_BK) {
    for (int v = tid; v < BM_ * (F32_BK / 4); v += THREADS) {  // h, k-major
      const int r = v / (F32_BK / 4);
      const int c = (v % (F32_BK / 4)) * 4;
      const int gr = row0 + r;
      const int gk = k0 + c;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gr < N && gk < H)
        x = *reinterpret_cast<const float4*>(h + (size_t)gr * H + gk);
      As[(c + 0) * LDA + r] = x.x;
      As[(c + 1) * LDA + r] = x.y;
      As[(c + 2) * LDA + r] = x.z;
      As[(c + 3) * LDA + r] = x.w;
    }
    for (int v = tid; v < F32_BK * (BN / 4); v += THREADS) {  // W
      const int r = v / (BN / 4);
      const int c = (v % (BN / 4)) * 4;
      const int gk = k0 + r;
      const int gc = col0 + c;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gk < H && gc < V)
        x = *reinterpret_cast<const float4*>(w + (size_t)gk * V + gc);
      *reinterpret_cast<float4*>(Bs + r * LDB + c) = x;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F32_BK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(Bs + kk * LDB + 4 * tc);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float a = As[kk * LDA + tr * RPT + i];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    *reinterpret_cast<float4*>(Cs + (tr * RPT + i) * ldc + 4 * tc) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
}

// The one-pass fp32 sweep (the sm90 sweep's and the whole-step kernel's
// fp32 route): a block of SWEEP_F32_ROWS rows walks every vocab tile in
// order, as the TPU grid does, carrying per row an online (m, s) and a
// running top-k in shared memory; no partial results reach device memory.
// Per tile, one warp a row merges the tile's columns with the running
// list: a lane holds its COLS_PER_LANE columns and running entries lane +
// 32 j, all in one sorted list, and k rounds of warp_pop_topk write the
// new running list.
constexpr int SWEEP_F32_ROWS = 32;

template <int KMAX>
__global__ void __launch_bounds__(THREADS)
head_sweep_f32_kernel(const float* __restrict__ h,
                      const float* __restrict__ w,
                      const float* __restrict__ bias,
                      float* __restrict__ vals, int* __restrict__ idx,
                      float* __restrict__ lse, int N, int H, int V, int k) {
  constexpr int R = SWEEP_F32_ROWS;
  constexpr int LDC = BN + 4;
  constexpr int RUN = (KMAX + 31) / 32;  // running entries a lane
  constexpr int L = COLS_PER_LANE + RUN;
  __shared__ __align__(16) float stage[f32_tile_floats<R>()];
  __shared__ __align__(16) float Cs[R * LDC];
  __shared__ float run_m[R], run_s[R];
  __shared__ float run_v[R][KMAX];
  __shared__ int run_i[R][KMAX];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * R;
  constexpr int RPW = R / (THREADS / 32);  // rows a warp
  for (int e = threadIdx.x; e < R * KMAX; e += THREADS) {
    run_v[e / KMAX][e % KMAX] = -INFINITY;
    run_i[e / KMAX][e % KMAX] = INT_MAX;
  }
  for (int r = threadIdx.x; r < R; r += THREADS) {
    run_m[r] = -INFINITY;
    run_s[r] = 0.0f;
  }
  const int n_tiles = (V + BN - 1) / BN;
  for (int t = 0; t < n_tiles; ++t) {
    const int col0 = t * BN;
    f32_logits_tile<R>(h, w, row0, col0, N, H, V, stage, Cs, LDC);
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      if (row0 + r >= N) break;  // the same for the whole warp
      float x[COLS_PER_LANE];
      int xi[COLS_PER_LANE];
      load_row(Cs, LDC, r, bias, col0, V, lane, x, xi);
      float tm = -INFINITY;
#pragma unroll
      for (int q = 0; q < COLS_PER_LANE; ++q) tm = fmaxf(tm, x[q]);
      tm = warp_max(tm);
      const float m_old = run_m[r];
      const float m_new = fmaxf(m_old, tm);
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < COLS_PER_LANE; ++q)
        if (xi[q] != INT_MAX) s += expf(x[q] - m_new);
      s = warp_sum(s);
      float lv[L];
      int li[L];
      clear(lv, li);
#pragma unroll
      for (int q = 0; q < COLS_PER_LANE; ++q) insert(lv, li, x[q], xi[q]);
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        const int e = lane + 32 * j;
        if (e < k) insert(lv, li, run_v[r][e], run_i[r][e]);
      }
      __syncwarp();  // every lane has read the running list
      warp_pop_topk(lv, li, k, run_v[r], run_i[r], lane);
      if (lane == 0) {
        run_s[r] = (m_old == -INFINITY ? 0.0f : run_s[r] * expf(m_old - m_new))
                   + s;
        run_m[r] = m_new;
      }
      __syncwarp();
    }
    // The next tile's products overwrite neither Cs nor the running
    // state before f32_logits_tile's first barrier.
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * k; e += THREADS) {
    const int r = e / k;
    const int gr = row0 + r;
    if (gr < N) {
      vals[(size_t)gr * k + e % k] = run_v[r][e % k];
      idx[(size_t)gr * k + e % k] = run_i[r][e % k];
    }
  }
  for (int r = threadIdx.x; r < R; r += THREADS)
    if (row0 + r < N) lse[row0 + r] = run_m[r] + logf(run_s[r]);
}

template <int KMAX>
cudaError_t launch_sweep_f32_k(const float* h, const float* w,
                               const float* b, float* vals, int* idx,
                               float* lse, int N, int H, int V, int k,
                               cudaStream_t s) {
  head_sweep_f32_kernel<KMAX><<<(N + SWEEP_F32_ROWS - 1) / SWEEP_F32_ROWS,
                                THREADS, 0, s>>>(h, w, b, vals, idx, lse, N,
                                                 H, V, k);
  return cudaGetLastError();
}

// The fp32 sweep at the instance kmax_for(k): h [N, H], W [H, V] fp32 (H
// and V multiples of 4), b [V]. One launch.
cudaError_t launch_sweep_f32(const float* h, const float* w, const float* b,
                             float* vals, int* idx, float* lse, int N, int H,
                             int V, int k, cudaStream_t s) {
  switch (kmax_for(k)) {
    case 8:
      return launch_sweep_f32_k<8>(h, w, b, vals, idx, lse, N, H, V, k, s);
    case 16:
      return launch_sweep_f32_k<16>(h, w, b, vals, idx, lse, N, H, V, k, s);
    case 32:
      return launch_sweep_f32_k<32>(h, w, b, vals, idx, lse, N, H, V, k, s);
    default:
      return launch_sweep_f32_k<64>(h, w, b, vals, idx, lse, N, H, V, k, s);
  }
}

}  // namespace
