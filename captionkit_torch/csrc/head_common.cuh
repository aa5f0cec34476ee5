// Shared pieces of the vocab-head kernels (head_sm90.cuh and through it
// head_topk.cu, head_int8.cu, head_sweep.cu; wholestep.cu): the (value
// descending, vocab id ascending) order, the candidate lists, the warp
// arg-max merge and the merge of per-tile partial results (the bf16 whole
// step's phase 3).
//
// Replaces the extraction and merge of the TPU kernels in
// captionkit/ops/head.py (_lse_topk_update: extract="mask" and "thresh").
//
// Every comparison orders by (value descending, vocab id ascending), so
// ties resolve as lax.top_k's whatever order the tiles finish in.
//
// Any k up to KMAX_LIMIT: the candidate lists are template parameters of
// their length (the k = 8 instance is the one every kernel had before),
// and the host picks the smallest instance that holds k (kmax_for).

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int BN = 128;       // vocab columns per tile
constexpr int KMAX_LIMIT = 64;  // largest k of any instance

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

// Row `row` of the merge of per-tile partials (the bf16 whole step's phase
// 3), held by one warp: lse = M + log sum_j s_j exp(m_j - M) over the
// tiles, and the top-k of the tiles' candidates. (No __restrict__ here: the
// whole-step kernel merges partials it wrote itself earlier in the same
// launch, which must not be read through the read-only cache.) A lane keeps
// a KMAX-long list: all of the row's top-k may come from its candidates.
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

}  // namespace
