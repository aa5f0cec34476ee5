// int8 vocab head for beam search: per row, the top-k of the dequantized
// logits (q8(h) @ w_q) * (s_h * s_w) + b, their vocab ids and the
// log-sum-exp, without writing the [N, V] logits to device memory.
//
// Replaces the TPU kernel captionkit/ops/head.py::fused_head_topk_int8
// (_make_head_kernel_int8 + _quantize_rows + _lse_topk_update), with both
// extractions ("mask", "thresh").
//
// Inputs:  h [N, H] fp32 (H a multiple of 4, any size), w_q [H, V] int8
//          (row-major, V a multiple of 16), w_scale [V] fp32, b [V] fp32
//          (padded vocab columns: weight 0, scale 1, bias -1e30;
//          quantize_head).
// Outputs: vals [N, k] fp32, idx [N, k] int32, lse [N] fp32.
//
// Design. Pass 1, grid = vocab tiles x row tiles: a block owns 64 rows and
// all of H. It quantizes its rows into shared memory as int8, per row
// symmetric: s_h = max(max|h|, 1e-8) / 127, q = rint(h / s_h) (IEEE
// division, rounding half to even, no clip: the reference's
// _quantize_rows). Every vocab-tile block recomputes its rows'
// quantization; the result is the same each time, so the logits do not
// depend on the tile. The row scales come from a first pass over all of
// H; the quantized rows then stream through shared memory in K chunks of
// at most KCHUNK columns (64 x KCHUNK bytes), so any H fits: the int32
// sums carry across chunks in the accumulators, exact either way. The
// block then multiplies the int8 rows by streamed w_q tiles with s8
// tensor-core MMA (nvcuda::wmma m16n16k16, int32 accumulation, exact), and
// dequantizes in the epilogue as
// acc * (s_h * s_w) + b, each operation rounded on its own (__fmul_rn,
// __fadd_rn: no contraction into an FMA), which is the plain version's
// arithmetic, so the logits are bit-identical to it. The extraction and
// pass 2 (the merge) are head_common.cuh's, as in the float head.
//
// wmma wants 32-byte aligned fragment pointers, and an int8 fragment is 16
// bytes deep, so both operands live in shared memory in 16-byte-deep
// blocks: the rows as [K / 16][64][16], a w_q stage as [128 / 16][64][16]
// (each stored from one 16-byte global load). The products' int32 tile
// reuses the rows' space once the products are done.
//
// Bound at the paper shape (N = 2560, H = 1024, V = 9490): 2 N H V = 49.8
// G int8 operations, 25 us at the H100's 1,979 TOPS dense; the bytes (h
// fp32 10.5 MB, w_q 9.7 MB, scales and bias, outputs) take 6 us at 3.35
// TB/s, so the kernel is bound by operations. This first version is plain:
// one shared-memory stage, wmma rather than wgmma, no TMA.

#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "head_common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;                 // rows per block
constexpr int BK = 64;                 // depth of one w_q stage
constexpr int KB = 16;                 // bytes per operand block row
constexpr int LDC = BN + 4;            // int32 products tile stride
constexpr int B_STRIDE = BK * KB + 32;  // bytes per 16-column w_q block;
                                        // the pad spreads the banks and
                                        // keeps 32-byte alignment
constexpr int ROWS_PER_WARP = BM / (THREADS / 32);
constexpr int KCHUNK = 2048;  // quantized columns held at once (a multiple
                              // of BK): 128 KB of rows

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared memory of a block for a chunk of Kc quantized columns: the rows
// (or, after the products, the int32 tile), a w_q stage, the row scales.
__host__ __device__ constexpr int a_bytes(int Kp) {
  return round_up(Kp * BM > BM * LDC * 4 ? Kp * BM : BM * LDC * 4, 128);
}
__host__ __device__ constexpr int smem_bytes(int Kp) {
  return a_bytes(Kp) + (BN / KB) * B_STRIDE + BM * 4;
}

// Columns [c0, c0 + Kc) of one row quantized into a chunk of the rows'
// shared memory ([Kc/16][BM][16]), q = rint(h / s) (IEEE division, half to
// even, no clip), four columns a lane at a time in one 32-bit store;
// columns past H (and rows past N: live = false) are zeros.
__device__ __forceinline__ void quantize_row(const float* hrow, bool live,
                                             int H, int c0, int Kc, float s,
                                             int r, int lane,
                                             signed char* As) {
  for (int c = lane * 4; c < Kc; c += 128) {
    uint32_t packed = 0u;
    if (live && c0 + c < H) {
      const float4 x = *reinterpret_cast<const float4*>(hrow + c0 + c);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = __float2int_rn(rintf(__fdiv_rn(xs[e], s)));
        packed |= (uint32_t)(q & 0xff) << (8 * e);
      }
    }
    *reinterpret_cast<uint32_t*>(As + (c / KB) * (BM * KB) + r * KB +
                                 (c % KB)) = packed;
  }
}

// CHUNKED: the rows take more than one chunk (Kp > KCHUNK). The one-chunk
// instance quantizes before its accumulators exist, as the kernel always
// has (79 registers; quantizing with them live took 94).
template <int EXTRACT, bool CHUNKED>
__global__ void __launch_bounds__(THREADS)
head_int8_tile_kernel(const float* __restrict__ h,
                      const int8_t* __restrict__ wq,
                      const float* __restrict__ w_scale,
                      const float* __restrict__ bias,
                      float* __restrict__ part_m, float* __restrict__ part_s,
                      float* __restrict__ part_v, int* __restrict__ part_i,
                      int N, int H, int V, int Kp, int Kc, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  signed char* As = reinterpret_cast<signed char*>(smem);  // [Kc/16][BM][16]
  int* Cs = reinterpret_cast<int*>(smem);                   // [BM][LDC]
  signed char* Bs = reinterpret_cast<signed char*>(smem + a_bytes(Kc));
  float* s_rows = reinterpret_cast<float*>(Bs + (BN / KB) * B_STRIDE);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int col0 = tile * BN;
  const int row0 = blockIdx.y * BM;

  // 1. Row scales, one warp a row: amax over all of H, s_h = amax / 127;
  // one chunk: the rows quantized right away, q = rint(h / s_h), four
  // columns a lane at a time, packed into one 32-bit store. Rows past N
  // and columns past H are zeros.
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    const int gr = row0 + r;
    const float* hrow = h + (size_t)gr * H;
    float amax = 0.0f;
    if (gr < N)
      for (int c = lane * 4; c < H; c += 128) {
        const float4 x = *reinterpret_cast<const float4*>(hrow + c);
        amax = fmaxf(amax, fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)),
                                 fmaxf(fabsf(x.z), fabsf(x.w))));
      }
    amax = warp_max(amax);
    const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
    if (lane == 0) s_rows[r] = s;
    if (!CHUNKED) quantize_row(hrow, gr < N, H, 0, Kc, s, r, lane, As);
  }
  __syncthreads();

  // 2. The products, chunk by chunk: 8 warps in a 2 (rows) x 4 (columns)
  // grid of 32 x 32.
  const int wr = warp >> 2;
  const int wc = warp & 3;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int c0 = 0; c0 < Kp; c0 += Kc) {
    if (CHUNKED) {
      // Columns [c0, c0 + Kc) of each row (the previous chunk's products
      // ended with a barrier).
      for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
        const int r = warp * ROWS_PER_WARP + rr;
        const int gr = row0 + r;
        quantize_row(h + (size_t)gr * H, gr < N, H, c0, Kc, s_rows[r], r,
                     lane, As);
      }
      __syncthreads();
    }

    for (int k0 = c0; k0 < c0 + Kc && k0 < Kp; k0 += BK) {
      for (int v = tid; v < BK * (BN / KB); v += THREADS) {  // w_q stage
        const int r = v / (BN / KB);
        const int cb = v % (BN / KB);
        const int gk = k0 + r;
        const int gc = col0 + cb * KB;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (gk < H && gc < V)
          val = *reinterpret_cast<const uint4*>(wq + (size_t)gk * V + gc);
        *reinterpret_cast<uint4*>(Bs + cb * B_STRIDE + r * KB) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i],
                                 As + ((k0 - c0 + kk) / KB) * (BM * KB) +
                                     (wr * 32 + i * 16) * KB,
                                 KB);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Bs + (wc * 2 + j) * B_STRIDE + kk * KB,
                                 KB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  // The rows are no longer read: the int32 tile takes their space.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * LDC + wc * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  // 3. Dequantize and extract: each warp reduces ROWS_PER_WARP rows.
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    const int gr = row0 + r;
    if (gr >= N) break;  // the same for the whole warp
    const float s_h = s_rows[r];
    float x[COLS_PER_LANE];
    int xi[COLS_PER_LANE];
#pragma unroll
    for (int q = 0; q < COLS_PER_LANE; ++q) {
      const int gc = col0 + lane + 32 * q;
      if (gc < V) {
        const float scale = __fmul_rn(s_h, w_scale[gc]);
        x[q] = __fadd_rn(
            __fmul_rn((float)Cs[r * LDC + lane + 32 * q], scale), bias[gc]);
        xi[q] = gc;
      } else {
        x[q] = -INFINITY;
        xi[q] = INT_MAX;
      }
    }
    emit_tile_row<EXTRACT>(x, xi, k, (size_t)gr * n_tiles + tile, part_m,
                           part_s, part_v, part_i, lane);
  }
}

template <int EXTRACT, bool CHUNKED>
cudaError_t launch_tiles(dim3 grid, int smem, cudaStream_t s, const float* hp,
                         const int8_t* wp, const float* sp, const float* bp,
                         float* pm, float* ps, float* pv, int* pi, int N,
                         int H, int V, int Kp, int Kc, int k) {
  const cudaError_t err = cudaFuncSetAttribute(
      head_int8_tile_kernel<EXTRACT, CHUNKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  head_int8_tile_kernel<EXTRACT, CHUNKED><<<grid, THREADS, smem, s>>>(
      hp, wp, sp, bp, pm, ps, pv, pi, N, H, V, Kp, Kc, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch (allocated by the caller): part_m, part_s [N * n_tiles] fp32,
// part_v [N * n_tiles * k] fp32, part_i [N * n_tiles * k] int32, with
// n_tiles = ceil(V / 128). extract: 0 = mask, 1 = thresh. Launches both
// passes on `stream` and returns the CUDA error code (0 = success).
int ck_head_topk_int8(const void* h, const void* w_q, const void* w_scale,
                      const void* b, void* vals, void* idx, void* lse,
                      void* part_m, void* part_s, void* part_v, void* part_i,
                      int N, int H, int V, int k, int extract, int device,
                      void* stream) {
  if (N < 1 || H < 1 || V < 1 || k < 1 || k > KMAX_LIMIT || k > V ||
      H % 4 || V % KB || (extract != kMask && extract != kThresh))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int Kp = round_up(H, BK);
  const int Kc = Kp < KCHUNK ? Kp : KCHUNK;
  const int smem = smem_bytes(Kc);
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  if (smem > smem_max) return (int)cudaErrorInvalidValue;
  const int n_tiles = (V + BN - 1) / BN;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles, (N + BM - 1) / BM);
  const auto* hp = static_cast<const float*>(h);
  const auto* wp = static_cast<const int8_t*>(w_q);
  const auto* sp = static_cast<const float*>(w_scale);
  const auto* bp = static_cast<const float*>(b);
  auto* pm = static_cast<float*>(part_m);
  auto* ps = static_cast<float*>(part_s);
  auto* pv = static_cast<float*>(part_v);
  auto* pi = static_cast<int*>(part_i);
  const bool chunked = Kp > Kc;
  if (extract == kThresh)
    err = chunked ? launch_tiles<kThresh, true>(grid, smem, s, hp, wp, sp, bp,
                                                pm, ps, pv, pi, N, H, V, Kp,
                                                Kc, k)
                  : launch_tiles<kThresh, false>(grid, smem, s, hp, wp, sp,
                                                 bp, pm, ps, pv, pi, N, H, V,
                                                 Kp, Kc, k);
  else
    err = chunked ? launch_tiles<kMask, true>(grid, smem, s, hp, wp, sp, bp,
                                              pm, ps, pv, pi, N, H, V, Kp, Kc,
                                              k)
                  : launch_tiles<kMask, false>(grid, smem, s, hp, wp, sp, bp,
                                               pm, ps, pv, pi, N, H, V, Kp,
                                               Kc, k);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(pm, ps, pv, pi, static_cast<float*>(vals),
                           static_cast<int*>(idx), static_cast<float*>(lse),
                           N, n_tiles, k, s);
}

const char* ck_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ck_head_int8_tile_width() { return BN; }

int ck_head_int8_kmax() { return KMAX_LIMIT; }

}  // extern "C"
