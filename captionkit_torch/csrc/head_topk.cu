// Fused vocab head for beam search: logits = h @ W + b, then per row the
// top-k logits (descending, equal values lowest index first), their vocab
// ids and the log-sum-exp, without writing the [N, V] logits to device
// memory.
//
// Replaces the TPU kernels of captionkit/ops/head.py:
//   ck_head_topk, extract = 0  -> fused_head_topk, extract="mask"
//   ck_head_topk, extract = 1  -> fused_head_topk, extract="thresh"
// (_sweep_head_topk, the single sweep, is head_sweep.cu.)
//
// Inputs:  h [N, H], W [H, V] (row-major, V a multiple of 8), both bf16
//          or both fp32 (compute_dtype="float32"), b [V] fp32 (padded
//          vocab columns carry -1e30); any k up to KMAX_LIMIT.
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
// Bound at the paper shape (N = 2560 = 512 images x 5 beams, H = 1024,
// V = 9490): 2 N H V = 49.8 GFLOP, 50 us at the H100's 989 TFLOP/s dense
// bf16; the bytes read (W 19.4 MB + h 5.2 MB) take 7 us at 3.35 TB/s. The
// kernels are bound by operations. This first version is plain: one stage
// of shared memory, no cp.async or TMA pipeline, wmma rather than wgmma.
//
// fp32 (compute_dtype="float32"): the same two passes with the logits tile
// of head_common.cuh's f32_logits_tile, fp32 FMA on the CUDA cores (not
// TF32); bound by the 67 TFLOP/s of fp32 outside the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "head_common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;         // rows per pass-1 block
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

template <typename T, int EXTRACT>
__global__ void __launch_bounds__(THREADS)
head_tile_kernel(const T* __restrict__ h, const T* __restrict__ w,
                 const float* __restrict__ bias,
                 float* __restrict__ part_m, float* __restrict__ part_s,
                 float* __restrict__ part_v, int* __restrict__ part_i,
                 int N, int H, int V, int k) {
  __shared__ __align__(128) float Cs[BM * LDC];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int col0 = tile * BN;
  const int row0 = blockIdx.y * BM;
  if constexpr (std::is_same<T, float>::value) {
    __shared__ __align__(16) float stage[f32_tile_floats<BM>()];
    f32_logits_tile<BM>(h, w, row0, col0, N, H, V, stage, Cs, LDC);
  } else {
    __shared__ __align__(128) __nv_bfloat16 As[BM * LDA];
    __shared__ __align__(128) __nv_bfloat16 Bs[BK * LDB];
    bf16_logits_tile<BM>(h, w, row0, col0, N, H, V, As, Bs, Cs);
  }

  // Epilogue: each warp reduces BM / 8 rows of the tile.
  constexpr int rows_per_warp = BM / (THREADS / 32);
  for (int rr = 0; rr < rows_per_warp; ++rr) {
    const int r = warp * rows_per_warp + rr;
    const int gr = row0 + r;
    if (gr >= N) break;  // the same for the whole warp
    float x[COLS_PER_LANE];
    int xi[COLS_PER_LANE];
    load_row(Cs, LDC, r, bias, col0, V, lane, x, xi);
    emit_tile_row<EXTRACT>(x, xi, k, (size_t)gr * n_tiles + tile, part_m,
                           part_s, part_v, part_i, lane);
  }
}

bool bad_shape(int N, int H, int V, int k) {
  return N < 1 || H < 1 || V < 1 || k < 1 || k > KMAX_LIMIT || k > V ||
         H % 8 || V % 8;
}

template <typename T>
cudaError_t launch_tiles(const void* h, const void* w, const float* b,
                         float* pm, float* ps, float* pv, int* pi, int N,
                         int H, int V, int k, int extract, cudaStream_t s) {
  const dim3 grid((V + BN - 1) / BN, (N + BM - 1) / BM);
  const auto* hp = static_cast<const T*>(h);
  const auto* wp = static_cast<const T*>(w);
  if (extract == kThresh)
    head_tile_kernel<T, kThresh><<<grid, THREADS, 0, s>>>(hp, wp, b, pm, ps,
                                                          pv, pi, N, H, V, k);
  else
    head_tile_kernel<T, kMask><<<grid, THREADS, 0, s>>>(hp, wp, b, pm, ps,
                                                        pv, pi, N, H, V, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch (allocated by the caller): part_m, part_s [N * n_tiles] fp32,
// part_v [N * n_tiles * k] fp32, part_i [N * n_tiles * k] int32, with
// n_tiles = ceil(V / 128). extract: 0 = mask, 1 = thresh; f32: h and W
// are fp32 (else bf16). Launches both passes on `stream` and returns the
// CUDA error code of the launches (0 = success).
int ck_head_topk(const void* h, const void* w, const void* b, void* vals,
                 void* idx, void* lse, void* part_m, void* part_s,
                 void* part_v, void* part_i, int N, int H, int V, int k,
                 int extract, int f32, int device, void* stream) {
  if (bad_shape(N, H, V, k) || (extract != kMask && extract != kThresh))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (V + BN - 1) / BN;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* bp = static_cast<const float*>(b);
  auto* pm = static_cast<float*>(part_m);
  auto* ps = static_cast<float*>(part_s);
  auto* pv = static_cast<float*>(part_v);
  auto* pi = static_cast<int*>(part_i);
  err = f32 ? launch_tiles<float>(h, w, bp, pm, ps, pv, pi, N, H, V, k,
                                  extract, s)
            : launch_tiles<__nv_bfloat16>(h, w, bp, pm, ps, pv, pi, N, H, V,
                                          k, extract, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(pm, ps, pv, pi, static_cast<float*>(vals),
                           static_cast<int*>(idx), static_cast<float*>(lse),
                           N, n_tiles, k, s);
}

const char* ck_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ck_head_tile_width() { return BN; }

int ck_head_kmax() { return KMAX_LIMIT; }

}  // extern "C"
