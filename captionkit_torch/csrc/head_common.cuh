// Shared pieces of the vocab-head kernels (head_topk.cu, head_int8.cu):
// the (value descending, vocab id ascending) order, the per-row top-k of a
// 128-column logits tile in its two extractions, and pass 2, the merge of
// the tiles' partial results.
//
// Replaces the extraction and merge of the TPU kernels in
// captionkit/ops/head.py (_lse_topk_update: extract="mask" and "thresh").
//
// Every comparison orders by (value descending, vocab id ascending), so
// ties resolve as lax.top_k's whatever order the tiles finish in.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int BN = 128;       // vocab columns per tile
constexpr int KMAX = 8;       // largest k
constexpr int THREADS = 256;  // 8 warps
constexpr int COLS_PER_LANE = BN / 32;

enum Extract { kMask = 0, kThresh = 1 };

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Insert (v, i) into a list kept sorted by better(); the worst falls off.
// Static indices only, so the list stays in registers.
__device__ __forceinline__ void insert(float (&lv)[KMAX], int (&li)[KMAX],
                                       float v, int i) {
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
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

__device__ __forceinline__ void clear(float (&lv)[KMAX], int (&li)[KMAX]) {
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
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
__device__ __forceinline__ void warp_pop_topk(float (&lv)[KMAX],
                                              int (&li)[KMAX], int k,
                                              float* out_v, int* out_i,
                                              int lane) {
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
      for (int q = 0; q < KMAX - 1; ++q) {
        lv[q] = lv[q + 1];
        li[q] = li[q + 1];
      }
      lv[KMAX - 1] = -INFINITY;
      li[KMAX - 1] = INT_MAX;
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
    float lv[KMAX];
    int li[KMAX];
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

// Pass 2, one warp per row: lse = M + log sum_j s_j exp(m_j - M) over the
// tiles, and the top-k of the tiles' candidates.
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

cudaError_t launch_merge(const float* part_m, const float* part_s,
                         const float* part_v, const int* part_i, float* vals,
                         int* idx, float* lse, int N, int n_tiles, int k,
                         cudaStream_t s) {
  const int rows_per_block = THREADS / 32;
  head_merge_kernel<<<(N + rows_per_block - 1) / rows_per_block, THREADS, 0,
                      s>>>(part_m, part_s, part_v, part_i, vals, idx, lse, N,
                           n_tiles, k);
  return cudaGetLastError();
}

}  // namespace
