// Fused vocab head for beam search: logits = h @ W + b, then per row the
// top-k logits (descending, equal values lowest index first), their vocab
// ids and the log-sum-exp, without writing the [N, V] logits to device
// memory.
//
// Replaces the TPU kernels of captionkit/ops/head.py:
//   ck_head_topk, extract = 0  -> fused_head_topk, extract="mask"
//   ck_head_topk, extract = 1  -> fused_head_topk, extract="thresh"
//   ck_head_sweep              -> _sweep_head_topk (CAPTIONKIT_HEAD_SWEEP)
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
//     and its own top-k (value, vocab id) to scratch, by either extraction
//     of head_common.cuh (a template parameter: the logits tile is the same
//     code, so the two give bit-identical results).
//   pass 2 (head_merge_kernel), one warp per row: lse = M + log sum_j s_j
//     exp(m_j - M) over the tiles, and the top-k of the tiles' candidates.
//
// The sweep (head_sweep_kernel) is the TPU grid's in-order carry done
// inside one block: a block owns 32 rows and walks every vocab tile in
// order, carrying an online (m, s) and a running top-k per row in shared
// memory; one launch, no partials in device memory. The row tile is 32:
// at N = 2560 that gives 80 blocks for 132 SMs. Every block streams all of
// W (from L2), so 16-row tiles would fill the card but double that
// traffic, and 64-row tiles (the pass-1 tile) would leave 92 SMs idle.
//
// Bound at the paper shape (N = 2560 = 512 images x 5 beams, H = 1024,
// V = 9490): 2 N H V = 49.8 GFLOP, 50 us at the H100's 989 TFLOP/s dense
// bf16; the bytes read (W 19.4 MB + h 5.2 MB) take 7 us at 3.35 TB/s. The
// kernels are bound by operations. This first version is plain: one stage
// of shared memory, no cp.async or TMA pipeline, wmma rather than wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "head_common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;         // rows per pass-1 block
constexpr int BM_SWEEP = 32;   // rows per sweep block
constexpr int BK = 32;         // depth of one shared-memory stage
constexpr int LDA = BK + 8;    // shared-memory strides, in elements; the
constexpr int LDB = BN + 8;    // padding keeps wmma pointers 32-byte
constexpr int LDC = BN + 4;    // aligned and spreads the banks

// One [BM_, 128] fp32 tile of h @ W (no bias) into Cs, for rows
// [row0, row0 + BM_) and vocab columns [col0, col0 + 128). 8 warps in a
// 2 (rows) x 4 (columns) grid, each BM_/2 x 32. Ends with the block
// synchronised and Cs complete.
template <int BM_>
__device__ __forceinline__ void bf16_logits_tile(
    const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ w,
    int row0, int col0, int N, int H, int V, __nv_bfloat16* As,
    __nv_bfloat16* Bs, float* Cs) {
  constexpr int WFR = BM_ / 32;  // 16-row fragments per warp
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 2;  // warp's band of BM_/2 rows
  const int wc = warp & 3;   // warp's 32-column band

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WFR][2];
#pragma unroll
  for (int i = 0; i < WFR; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < H; k0 += BK) {
    for (int v = tid; v < BM_ * (BK / 8); v += THREADS) {  // h tile
      const int r = v / (BK / 8);
      const int c = (v % (BK / 8)) * 8;
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
                     wmma::row_major> a[WFR];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < WFR; ++i)
        wmma::load_matrix_sync(
            a[i], As + (wr * WFR * 16 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDB + wc * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < WFR; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < WFR; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          Cs + (wr * WFR * 16 + i * 16) * LDC + wc * 32 + j * 16, acc[i][j],
          LDC, wmma::mem_row_major);
  __syncthreads();
}

// Row r of the tile in Cs plus the bias, as one warp holds it: lane l has
// columns col0 + l + 32 q; columns past V get (-inf, INT_MAX).
__device__ __forceinline__ void load_row(const float* Cs, int r,
                                         const float* __restrict__ bias,
                                         int col0, int V, int lane,
                                         float (&x)[COLS_PER_LANE],
                                         int (&xi)[COLS_PER_LANE]) {
#pragma unroll
  for (int q = 0; q < COLS_PER_LANE; ++q) {
    const int gc = col0 + lane + 32 * q;
    if (gc < V) {
      x[q] = Cs[r * LDC + lane + 32 * q] + bias[gc];
      xi[q] = gc;
    } else {
      x[q] = -INFINITY;
      xi[q] = INT_MAX;
    }
  }
}

template <int EXTRACT>
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

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int col0 = tile * BN;
  const int row0 = blockIdx.y * BM;
  bf16_logits_tile<BM>(h, w, row0, col0, N, H, V, As, Bs, Cs);

  // Epilogue: each warp reduces BM / 8 rows of the tile.
  constexpr int rows_per_warp = BM / (THREADS / 32);
  for (int rr = 0; rr < rows_per_warp; ++rr) {
    const int r = warp * rows_per_warp + rr;
    const int gr = row0 + r;
    if (gr >= N) break;  // the same for the whole warp
    float x[COLS_PER_LANE];
    int xi[COLS_PER_LANE];
    load_row(Cs, r, bias, col0, V, lane, x, xi);
    emit_tile_row<EXTRACT>(x, xi, k, (size_t)gr * n_tiles + tile, part_m,
                           part_s, part_v, part_i, lane);
  }
}

__global__ void __launch_bounds__(THREADS)
head_sweep_kernel(const __nv_bfloat16* __restrict__ h,
                  const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ vals,
                  int* __restrict__ idx, float* __restrict__ lse, int N,
                  int H, int V, int k) {
  __shared__ __align__(128) __nv_bfloat16 As[BM_SWEEP * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM_SWEEP * LDC];
  __shared__ float run_v[BM_SWEEP][KMAX];  // running top-k per row
  __shared__ int run_i[BM_SWEEP][KMAX];
  __shared__ float run_m[BM_SWEEP];  // running max and exp-sum per row
  __shared__ float run_s[BM_SWEEP];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BM_SWEEP;
  constexpr int rows_per_warp = BM_SWEEP / (THREADS / 32);
  for (int rr = 0; rr < rows_per_warp; ++rr) {
    const int r = warp * rows_per_warp + rr;
    if (lane < KMAX) {
      run_v[r][lane] = -INFINITY;
      run_i[r][lane] = INT_MAX;
    }
    if (lane == 0) {
      run_m[r] = -INFINITY;
      run_s[r] = 0.0f;
    }
  }
  // (bf16_logits_tile synchronises the block before the first epilogue.)

  const int n_tiles = (V + BN - 1) / BN;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int col0 = tile * BN;
    bf16_logits_tile<BM_SWEEP>(h, w, row0, col0, N, H, V, As, Bs, Cs);
    for (int rr = 0; rr < rows_per_warp; ++rr) {
      const int r = warp * rows_per_warp + rr;
      if (row0 + r >= N) break;  // the same for the whole warp
      float x[COLS_PER_LANE];
      int xi[COLS_PER_LANE];
      load_row(Cs, r, bias, col0, V, lane, x, xi);
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
      const float s_new = run_s[r] * expf(m_old - m_new) + s;
      // The running top-k joins the lanes' lists (lane q < k takes entry
      // q), so the warp's pop merges it with the tile's candidates.
      float lv[KMAX];
      int li[KMAX];
      clear(lv, li);
#pragma unroll
      for (int q = 0; q < COLS_PER_LANE; ++q) insert(lv, li, x[q], xi[q]);
      if (lane < k) insert(lv, li, run_v[r][lane], run_i[r][lane]);
      __syncwarp();
      warp_pop_topk(lv, li, k, run_v[r], run_i[r], lane);
      if (lane == 0) {
        run_m[r] = m_new;
        run_s[r] = s_new;
      }
      __syncwarp();
    }
    // The next tile's products overwrite As, Bs and Cs only after the
    // block's first barrier inside bf16_logits_tile, which every warp
    // reaches after its epilogue.
  }
  for (int rr = 0; rr < rows_per_warp; ++rr) {
    const int r = warp * rows_per_warp + rr;
    const int gr = row0 + r;
    if (gr >= N) break;
    if (lane < k) {
      vals[(size_t)gr * k + lane] = run_v[r][lane];
      idx[(size_t)gr * k + lane] = run_i[r][lane];
    }
    if (lane == 0) lse[gr] = run_m[r] + logf(run_s[r]);
  }
}

bool bad_shape(int N, int H, int V, int k) {
  return N < 1 || H < 1 || V < 1 || k < 1 || k > KMAX || k > V || H % 8 ||
         V % 8;
}

}  // namespace

extern "C" {

// Scratch (allocated by the caller): part_m, part_s [N * n_tiles] fp32,
// part_v [N * n_tiles * k] fp32, part_i [N * n_tiles * k] int32, with
// n_tiles = ceil(V / 128). extract: 0 = mask, 1 = thresh. Launches both
// passes on `stream` and returns the CUDA error code of the launches
// (0 = success).
int ck_head_topk(const void* h, const void* w, const void* b, void* vals,
                 void* idx, void* lse, void* part_m, void* part_s,
                 void* part_v, void* part_i, int N, int H, int V, int k,
                 int extract, int device, void* stream) {
  if (bad_shape(N, H, V, k) || (extract != kMask && extract != kThresh))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (V + BN - 1) / BN;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles, (N + BM - 1) / BM);
  const auto* hp = static_cast<const __nv_bfloat16*>(h);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* bp = static_cast<const float*>(b);
  auto* pm = static_cast<float*>(part_m);
  auto* ps = static_cast<float*>(part_s);
  auto* pv = static_cast<float*>(part_v);
  auto* pi = static_cast<int*>(part_i);
  if (extract == kThresh)
    head_tile_kernel<kThresh><<<grid, THREADS, 0, s>>>(hp, wp, bp, pm, ps,
                                                       pv, pi, N, H, V, k);
  else
    head_tile_kernel<kMask><<<grid, THREADS, 0, s>>>(hp, wp, bp, pm, ps, pv,
                                                     pi, N, H, V, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(pm, ps, pv, pi, static_cast<float*>(vals),
                           static_cast<int*>(idx), static_cast<float*>(lse),
                           N, n_tiles, k, s);
}

// The single-sweep head: one launch, no scratch.
int ck_head_sweep(const void* h, const void* w, const void* b, void* vals,
                  void* idx, void* lse, int N, int H, int V, int k,
                  int device, void* stream) {
  if (bad_shape(N, H, V, k)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  head_sweep_kernel<<<(N + BM_SWEEP - 1) / BM_SWEEP, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(b),
      static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(lse), N, H, V, k);
  return (int)cudaGetLastError();
}

const char* ck_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ck_head_tile_width() { return BN; }

int ck_head_kmax() { return KMAX; }

}  // extern "C"
