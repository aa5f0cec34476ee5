// Shared pieces of the decode-cell kernels (megastep.cu, lstm.cu,
// attention.cu, wholestep.cu): the fp32 split-operand GEMM tile with its
// gated (LSTM, Copy-LSTM) and plain epilogues, which every fp32 instance
// (compute_dtype="float32") of a cell kernel runs. The bf16 products run on
// sm90_cell.cuh.
//
// gemm_tile<G, EPI, NT>: one block owns a 64-row tile and G column groups
// of 32. The operands are successive K ranges of one accumulation, so a
// split operand ([x | h | c*], [v_hat | h_att | h_lang | c*]) never exists
// concatenated in device memory. fp32 operands and fp32 weights are staged
// through shared memory and multiplied with fp32 FMA on the CUDA cores (not
// TF32), each of the tile's first 64 G threads register-blocked over 8 rows
// x 4 columns. The fp32 result tile lands in shared memory and the
// epilogue runs on it. In the gated epilogues a block owns hidden columns
// [j, j+32) and its column groups are the i, f, g, o (and copy-gate r)
// tiles of those columns, read straight from gate-major [K, 4H] weights;
// the gate pre-activations are never written out.
//
// Everything lives in namespace `cell`, so a source can include this and
// head_common.cuh side by side.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {
namespace cell {

constexpr int BM = 64;  // rows per tile
constexpr int BN = 32;  // columns per group (one gate tile)
constexpr int BK = 32;  // operands' K ranges are multiples of this
constexpr int MAX_OPS = 4;
constexpr int BKF = 16;       // fp32: depth of one shared-memory stage
constexpr int LDAF = BM + 4;  // fp32: the k-major activation stage's stride

enum Epilogue : int {
  EPI_LSTM = 0,       // 4 gate groups; h, c = LSTM(z + zadd + bias, c_prev)
  EPI_COPY_LSTM = 1,  // 5 gate groups (i f g o r); the Copy-LSTM update
  EPI_GATE_MUL = 2,   // out fp32 = sigmoid(z + bias) * x
  EPI_STORE = 3,      // out fp32 = z
};

struct Operand {
  const void* a;  // [N, k] row-major fp32
  int k;          // a multiple of BK
  // Gated epilogues: [k, 4 cols] gate-major (i|f|g|o), or null when this
  // operand does not feed those gates. Plain epilogues: [k, cols]. fp32.
  const void* w_gates;
  const void* w_copy;  // EPI_COPY_LSTM: [k, cols], or null
};

struct GemmArgs {
  Operand op[MAX_OPS];
  int n_ops;
  int N;
  int cols;            // hidden width H (gated) or output width (plain)
  const float* zadd;   // EPI_LSTM: [N, 4 cols] added to z, or null
  const float* bias;   // [4 cols] (gated) or [cols] (EPI_GATE_MUL), or null
  const float* bias_r;      // EPI_COPY_LSTM: [cols]
  const float* c_prev;      // gated: [N, cols]
  const float* c_star;      // EPI_COPY_LSTM: [N, cols]
  const float* x;           // EPI_GATE_MUL: [N, cols]
  float* h_out;             // gated: [N, cols]
  float* c_out;             // gated: [N, cols]
  void* out;                // EPI_GATE_MUL, EPI_STORE: fp32 [N, cols]
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The fp32 result tile's row stride (elements) and the shared memory a
// tile of G column groups needs: the operand tiles and, after the
// products, the fp32 result tile share one buffer.
template <int G>
__host__ __device__ constexpr int tile_ldc() {
  return G * BN + 4;
}

template <int G>
__host__ __device__ constexpr int tile_smem() {
  return (BKF * LDAF + BKF * (G * BN + 4)) * 4 > BM * tile_ldc<G>() * 4
             ? (BKF * LDAF + BKF * (G * BN + 4)) * 4
             : BM * tile_ldc<G>() * 4;
}

// The fp32 products of one tile into Cs: for every operand,
// K in stages of BKF; activations k-major [BKF][LDAF], weights [BKF][TN +
// 4]. Thread t < 64 G owns columns 4 (t % 8G) + {0..3} of rows 8 (t / 8G)
// + {0..7}; an operand that feeds none of its columns' group is skipped.
// Ends with the block synchronised and the fp32 tile in Cs.
template <int G, bool GATED, int NT>
__device__ __forceinline__ void f32_products(const GemmArgs& args, int nb,
                                             int row0, unsigned char* smem) {
  constexpr int TN = G * BN;
  constexpr int LDB = TN + 4;
  constexpr int LDC = tile_ldc<G>();
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + BKF * LDAF;
  float* Cs = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  const bool mma_thread = tid < 64 * G;
  const int tc = tid % (8 * G);
  const int tr = tid / (8 * G);
  const int grp = (4 * tc) / BN;  // the thread's column group
  const int N = args.N;
  const int cols = args.cols;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int s = 0; s < args.n_ops; ++s) {
    const Operand op = args.op[s];
    const float* a = static_cast<const float*>(op.a);
    const float* wg = static_cast<const float*>(op.w_gates);
    const float* wc = static_cast<const float*>(op.w_copy);
    const bool active =
        mma_thread && (!GATED || (grp < 4 ? wg != nullptr : wc != nullptr));
    for (int k0 = 0; k0 < op.k; k0 += BKF) {
      for (int v = tid; v < BM * BKF / 4; v += NT) {  // activations
        const int r = v / (BKF / 4);
        const int c = (v % (BKF / 4)) * 4;
        const int gr = row0 + r;
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (gr < N)
          x = *reinterpret_cast<const float4*>(a + (size_t)gr * op.k + k0 +
                                               c);
        As[(c + 0) * LDAF + r] = x.x;
        As[(c + 1) * LDAF + r] = x.y;
        As[(c + 2) * LDAF + r] = x.z;
        As[(c + 3) * LDAF + r] = x.w;
      }
      for (int v = tid; v < BKF * TN / 4; v += NT) {  // weights
        const int r = v / (TN / 4);
        const int t = (v % (TN / 4)) * 4;
        const size_t krow = (size_t)(k0 + r);
        const float* src = nullptr;
        if (GATED) {
          const int g = t / BN;
          const int col = nb * BN + t % BN;
          if (g < 4) {
            if (wg) src = wg + krow * 4 * cols + g * cols + col;
          } else if (wc) {
            src = wc + krow * cols + col;
          }
        } else {
          src = wg + krow * cols + nb * TN + t;
        }
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (src) x = *reinterpret_cast<const float4*>(src);
        *reinterpret_cast<float4*>(Bs + r * LDB + t) = x;
      }
      __syncthreads();
      if (active) {
#pragma unroll
        for (int kk = 0; kk < BKF; ++kk) {
          const float4 b =
              *reinterpret_cast<const float4*>(Bs + kk * LDB + 4 * tc);
          const float4 a0 =
              *reinterpret_cast<const float4*>(As + kk * LDAF + 8 * tr);
          const float4 a1 =
              *reinterpret_cast<const float4*>(As + kk * LDAF + 8 * tr + 4);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w,
                               a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
            acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
            acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
            acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
          }
        }
      }
      __syncthreads();
    }
  }
  if (mma_thread) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(Cs + (8 * tr + i) * LDC + 4 * tc) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  __syncthreads();
}

// One tile: rows [row0, row0 + 64), column block nb (hidden columns
// [32 nb, 32 nb + 32) of every gate group when gated, else output columns
// [32 G nb, 32 G (nb + 1))). Every thread of the block calls it; it ends
// with the epilogue's writes issued.
template <int G, int EPI, int NT>
__device__ __forceinline__ void gemm_tile(const GemmArgs& args, int nb,
                                          int row0, unsigned char* smem) {
  constexpr int TN = G * BN;  // tile columns
  constexpr int LDC = tile_ldc<G>();
  constexpr bool GATED = (EPI == EPI_LSTM || EPI == EPI_COPY_LSTM);
  static_assert(NT >= 64 * G, "a tile needs 64 G threads");
  float* Cs = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  const int N = args.N;
  const int cols = args.cols;

  f32_products<G, GATED, NT>(args, nb, row0, smem);

  if (GATED) {
    for (int e = tid; e < BM * BN; e += NT) {
      const int r = e / BN;
      const int c = e % BN;
      const int gr = row0 + r;
      if (gr >= N) continue;
      const int j = nb * BN + c;
      const float* cr = Cs + r * LDC;
      float zi = cr[c], zf = cr[BN + c], zg = cr[2 * BN + c],
            zo = cr[3 * BN + c];
      if (args.zadd) {
        const float* za = args.zadd + (size_t)gr * 4 * cols;
        zi += za[j];
        zf += za[cols + j];
        zg += za[2 * cols + j];
        zo += za[3 * cols + j];
      }
      if (args.bias) {
        zi += args.bias[j];
        zf += args.bias[cols + j];
        zg += args.bias[2 * cols + j];
        zo += args.bias[3 * cols + j];
      }
      const size_t idx = (size_t)gr * cols + j;
      float c_new = sigmoidf(zf) * args.c_prev[idx] + sigmoidf(zi) * tanhf(zg);
      if (EPI == EPI_COPY_LSTM) {
        const float rg = sigmoidf(cr[4 * BN + c] + args.bias_r[j]);
        c_new = rg * args.c_star[idx] + (1.0f - rg) * c_new;
      }
      args.h_out[idx] = sigmoidf(zo) * tanhf(c_new);
      args.c_out[idx] = c_new;
    }
  } else {
    for (int e = tid; e < BM * TN; e += NT) {
      const int r = e / TN;
      const int c = e % TN;
      const int gr = row0 + r;
      if (gr >= N) continue;
      const int col = nb * TN + c;
      const size_t idx = (size_t)gr * cols + col;
      const float z = Cs[r * LDC + c];
      static_cast<float*>(args.out)[idx] =
          EPI == EPI_GATE_MUL ? sigmoidf(z + args.bias[col]) * args.x[idx]
                              : z;
    }
  }
}

// One tile per block: grid = (column blocks, 64-row blocks). The gated
// instances leave the register count to the compiler; the plain ones ask
// for four resident blocks per SM.
template <int G, int EPI>
__global__ void __launch_bounds__(64 * G)
    gemm_kernel(const __grid_constant__ GemmArgs args) {
  __shared__ __align__(128) unsigned char smem[tile_smem<G>()];
  gemm_tile<G, EPI, 64 * G>(args, blockIdx.x, blockIdx.y * BM, smem);
}

template <int G, int EPI>
__global__ void __launch_bounds__(64 * G, 4)
    gemm_kernel_plain(const __grid_constant__ GemmArgs args) {
  __shared__ __align__(128) unsigned char smem[tile_smem<G>()];
  gemm_tile<G, EPI, 64 * G>(args, blockIdx.x, blockIdx.y * BM, smem);
}

// Column blocks of a GEMM: gated widths are multiples of BN, plain output
// widths of G BN.
template <int G, int EPI>
__host__ __device__ constexpr int column_width() {
  return (EPI == EPI_LSTM || EPI == EPI_COPY_LSTM) ? BN : G * BN;
}

// Shape checks of a GEMM's arguments; cudaSuccess when it can run.
template <int G, int EPI>
cudaError_t check_gemm(const GemmArgs& a) {
  for (int i = 0; i < a.n_ops; ++i)
    if (a.op[i].k < BK || a.op[i].k % BK) return cudaErrorInvalidValue;
  const int width = column_width<G, EPI>();
  if (a.N < 1 || a.cols < width || a.cols % width)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int G, int EPI>
cudaError_t launch_gemm(const GemmArgs& a, cudaStream_t s) {
  const cudaError_t err = check_gemm<G, EPI>(a);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.cols / column_width<G, EPI>(), (a.N + BM - 1) / BM);
  if constexpr (EPI == EPI_LSTM || EPI == EPI_COPY_LSTM)
    gemm_kernel<G, EPI><<<grid, 64 * G, 0, s>>>(a);
  else
    gemm_kernel_plain<G, EPI><<<grid, 64 * G, 0, s>>>(a);
  return cudaGetLastError();
}

inline Operand operand(const void* a, int k, const void* w_gates,
                       const void* w_copy = nullptr) {
  Operand o;
  o.a = a;
  o.k = k;
  o.w_gates = w_gates;
  o.w_copy = w_copy;
  return o;
}

inline GemmArgs gemm_args(int N, int cols) {
  GemmArgs g = {};
  g.N = N;
  g.cols = cols;
  return g;
}

inline const float* f32(const void* p) { return static_cast<const float*>(p); }

}  // namespace cell
}  // namespace
