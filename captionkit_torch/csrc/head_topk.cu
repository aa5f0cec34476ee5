// Fused vocab head for beam search: logits = h @ W + b, then per row the
// top-k logits (descending, equal values lowest index first), their vocab
// ids and the log-sum-exp, without writing the [N, V] logits to device
// memory.
//
// Replaces the TPU kernel captionkit/ops/head.py::fused_head_topk
// (extract="mask": _make_head_kernel + _lse_topk_update).
//
// Inputs:  h [N, H] bf16, W [H, V] bf16 (row-major, V a multiple of 8),
//          b [V] fp32 (padded vocab columns carry -1e30).
// Outputs: vals [N, k] fp32, idx [N, k] int32, lse [N] fp32.
//
// Design. On the TPU the grid runs in order on one core, so the kernel
// there carries a running top-k and an online log-sum-exp from one vocab
// tile to the next in scratch memory. On Hopper the blocks of a grid run
// in parallel and in no order, so that carry becomes a second pass:
//
//   pass 1 (head_tile_kernel), grid = vocab tiles x row tiles: a block
//     forms one 64 x 128 fp32 logits tile in shared memory with bf16
//     tensor-core MMA (nvcuda::wmma, fp32 accumulation), adds the bias,
//     and for each row writes the tile's max m, its sum s = sum exp(x - m)
//     and its own top-k (value, vocab id) to scratch.
//   pass 2 (head_merge_kernel), one warp per row: lse = M + log sum_j s_j
//     exp(m_j - M) over the tiles, and the top-k of the tiles' candidates.
//
// Ties: every comparison orders by (value descending, vocab id ascending),
// so the result is lax.top_k's whatever order the tiles finish in.
//
// Bound at the paper shape (N = 2560 = 512 images x 5 beams, H = 1024,
// V = 9490): 2 N H V = 49.8 GFLOP, 50 us at the H100's 989 TFLOP/s dense
// bf16; the bytes read (W 19.4 MB + h 5.2 MB) take 7 us at 3.35 TB/s. The
// kernel is bound by operations. This first version is plain: one stage of
// shared memory, no cp.async or TMA pipeline, wmma rather than wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cmath>
#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int BM = 64;         // rows per block
constexpr int BN = 128;        // vocab columns per block: the vocab tile
constexpr int BK = 32;         // depth of one shared-memory stage
constexpr int THREADS = 256;   // 8 warps: 2 (rows) x 4 (columns) of 32 x 32
constexpr int KMAX = 8;        // largest k
constexpr int LDA = BK + 8;    // shared-memory strides, in elements; the
constexpr int LDB = BN + 8;    // padding keeps wmma pointers 32-byte
constexpr int LDC = BN + 4;    // aligned and spreads the banks
constexpr int ROWS_PER_WARP = BM / (THREADS / 32);

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

__global__ void __launch_bounds__(THREADS)
head_tile_kernel(const __nv_bfloat16* __restrict__ h,
                 const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias,
                 float* __restrict__ part_m, float* __restrict__ part_s,
                 float* __restrict__ part_v, int* __restrict__ part_i,
                 int N, int H, int V, int k) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int col0 = tile * BN;
  const int row0 = blockIdx.y * BM;
  const int wr = warp >> 2;  // warp's 32-row band
  const int wc = warp & 3;   // warp's 32-column band

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < H; k0 += BK) {
    {  // h tile: 64 rows x 4 vectors of 8 bf16, one per thread
      const int r = tid >> 2;
      const int c = (tid & 3) * 8;
      const int gr = row0 + r;
      const int gk = k0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < N && gk < H)
        val = *reinterpret_cast<const uint4*>(h + (size_t)gr * H + gk);
      *reinterpret_cast<uint4*>(As + r * LDA + c) = val;
    }
    for (int v = tid; v < BK * (BN / 8); v += THREADS) {  // W tile
      const int r = v / (BN / 8);
      const int c = (v % (BN / 8)) * 8;
      const int gk = k0 + r;
      const int gc = col0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gk < H && gc < V)
        val = *reinterpret_cast<const uint4*>(w + (size_t)gk * V + gc);
      *reinterpret_cast<uint4*>(Bs + r * LDB + c) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wr * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDB + wc * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * LDC + wc * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  // Epilogue: each warp reduces ROWS_PER_WARP rows of the tile.
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    const int gr = row0 + r;
    if (gr >= N) break;  // the same for the whole warp
    float x[BN / 32];
    int xi[BN / 32];
    float m = -INFINITY;
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
      const int gc = col0 + lane + 32 * q;
      if (gc < V) {
        x[q] = Cs[r * LDC + lane + 32 * q] + bias[gc];
        xi[q] = gc;
      } else {
        x[q] = -INFINITY;
        xi[q] = INT_MAX;
      }
      m = fmaxf(m, x[q]);
    }
    m = warp_max(m);
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < BN / 32; ++q)
      if (xi[q] != INT_MAX) s += expf(x[q] - m);
    s = warp_sum(s);

    float lv[KMAX];
    int li[KMAX];
    clear(lv, li);
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) insert(lv, li, x[q], xi[q]);
    const size_t slot = (size_t)gr * n_tiles + tile;
    warp_pop_topk(lv, li, k, part_v + slot * k, part_i + slot * k, lane);
    if (lane == 0) {
      part_m[slot] = m;
      part_s[slot] = s;
    }
  }
}

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

}  // namespace

extern "C" {

// Scratch (allocated by the caller): part_m, part_s [N * n_tiles] fp32,
// part_v [N * n_tiles * k] fp32, part_i [N * n_tiles * k] int32, with
// n_tiles = ceil(V / 128). Launches both passes on `stream` and returns
// the CUDA error code of the launches (0 = success).
int ck_head_topk(const void* h, const void* w, const void* b, void* vals,
                 void* idx, void* lse, void* part_m, void* part_s,
                 void* part_v, void* part_i, int N, int H, int V, int k,
                 int device, void* stream) {
  if (N < 1 || H < 1 || V < 1 || k < 1 || k > KMAX || k > V || H % 8 ||
      V % 8)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (V + BN - 1) / BN;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  head_tile_kernel<<<dim3(n_tiles, (N + BM - 1) / BM), THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(b),
      static_cast<float*>(part_m), static_cast<float*>(part_s),
      static_cast<float*>(part_v), static_cast<int*>(part_i), N, H, V, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows_per_block = THREADS / 32;
  head_merge_kernel<<<(N + rows_per_block - 1) / rows_per_block, THREADS, 0,
                      s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(lse), N, n_tiles, k);
  return (int)cudaGetLastError();
}

const char* ck_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ck_head_tile_width() { return BN; }

int ck_head_kmax() { return KMAX; }

}  // extern "C"
