// Shared pieces of the decode-cell kernels (megastep.cu, lstm.cu,
// attention.cu, wholestep.cu): the fp32 split-operand GEMM with its gated
// (LSTM, Copy-LSTM) and plain epilogues, which every fp32 instance
// (compute_dtype="float32") of a cell kernel runs. The bf16 products run on
// sm90_cell.cuh.
//
// gemm_kernel<EPI, NBOX>: one CTA owns 128 rows and NBOX boxes of 32
// product columns: gated, the i, f, g, o (and copy-gate r) tiles of 32
// hidden columns, read straight from gate-major [K, 4H] weights (the gate
// pre-activations are never written out); plain, 128 consecutive output
// columns. The operands are successive K ranges of one accumulation, so a
// split operand ([x | h | c*], [v_hat | h_att | h_lang | c*]) never exists
// concatenated in device memory; c* feeds only r, and its K range runs the
// r products alone. A plain product can instead be split over K: then its
// operands are K ranges of one product, CTA z of grid (column blocks,
// ceil(N / 128), split) runs range z alone and stores its fp32 partial as
// plane z of out [split, N, cols], which the next kernel adds in rank order
// (plain_split picks the count that fills the card best).
//
// What bounds it on the H100: fp32 FMA on the CUDA cores (not TF32), 67
// TFLOP/s; at DCNet's greedy LSTM (N = 512, K = 3072, 4H = 4096) 12.9
// GFLOP, 0.19 ms, against 0.03 ms for the bytes read once.
//
// Design (sm_90a, one launch, grid (column blocks, ceil(N / 128)), 288
// threads and one CTA an SM):
// - One producer thread keeps a ring of 4 stages of K = 32 filled with TMA
//   loads, completing on mbarriers: a 128 x 32 activation box and the
//   stage's 32 x 32 weight boxes, all fp32 and 128-byte swizzled, so the
//   loads overlap the products and no thread stages or transposes a value.
//   Rows past N read zeros. The consumers free a stage on a second ring.
// - 256 consumer threads, each 8 rows x 2 columns of every box (8 x 8 = 64
//   sums; the Copy-LSTM 8 x 10): per 4 K, eight 16-byte loads of the
//   activations (4 K of a row) and 4 NBOX 8-byte loads of the weights for
//   64 NBOX FMAs. A warp's lanes are 4 row groups x 8 column pairs, so each
//   of its loads touches 4 (activations) or 8 (weights) distinct addresses,
//   which the swizzle keeps in distinct banks (a TMA box cannot be padded).
// - The epilogues run in registers: a thread holds the four gates (and r)
//   of its two hidden columns for its 8 rows; the arithmetic is the plain
//   versions' (expf sigmoid, tanhf) in the same order.
// - Every CTA lets a programmatic dependent launch start at once
//   (sm90::launch_dependents); where the next launch is not one, that is a
//   no-op. The dependents (attention.cu's context_kernel, megastep.cu's
//   fp32 score_kernel) wait for the product with griddepcontrol.wait
//   before they read it.
//
// Everything lives in namespace `cell`, so a source can include this and
// head_common.cuh side by side.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "sm90_common.cuh"

namespace {
namespace cell {

constexpr int BN = 32;  // columns per box (one gate tile)
constexpr int BK = 32;  // operands' K ranges are multiples of this
constexpr int MAX_OPS = 4;
constexpr int TILE_ROWS = 128;                 // rows a CTA
constexpr int STAGE_K = 32;                    // K a stage
constexpr int RING = 4;                        // stages
constexpr int A_BOX = TILE_ROWS * STAGE_K * 4;  // 16 KB: 128 rows x 32 K
constexpr int W_BOX = STAGE_K * BN * 4;         // 4 KB: 32 K x 32 columns
constexpr int CONSUMERS = 256;                 // 8 warps
constexpr int GEMM_THREADS = CONSUMERS + 32;   // + the producer warp

enum Epilogue : int {
  EPI_LSTM = 0,       // 4 gate groups; h, c = LSTM(z + zadd + bias, c_prev)
  EPI_COPY_LSTM = 1,  // 5 gate groups (i f g o r); the Copy-LSTM update
  EPI_GATE_MUL = 2,   // out fp32 = sigmoid(z + bias) * x
  EPI_STORE = 3,      // out fp32 = z
};

struct Operand {
  const void* a;  // [N, k] fp32, row stride ld
  int k;          // a multiple of BK
  int ld;         // the row stride of a, in elements (>= k)
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
  void* out;                // EPI_GATE_MUL, EPI_STORE: fp32 [N, cols];
                            // split EPI_STORE: [split, N, cols]
  int split;                // EPI_STORE: the K ranges (operands) run by
                            // CTAs of their own (0 or 1: none)
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

// The kernel's arguments: the host's GemmArgs and the tensor maps of its
// operands (activations [N, k] in 128 x 32 boxes; base and copy-gate
// weights in 32 x 32 boxes), and where a tile's boxes start: box g of
// column block nb is column g box_stride + nb tile_cols of the base weight
// (gated: box_stride = cols, tile_cols = 32; plain: 32 and 128).
struct TileArgs {
  CUtensorMap a[MAX_OPS];
  CUtensorMap w[MAX_OPS];
  CUtensorMap wr[MAX_OPS];
  GemmArgs g;
  int box_stride;
  int tile_cols;
};

template <int NBOX>
__host__ __device__ constexpr int stage_bytes() {
  return A_BOX + NBOX * W_BOX;
}

template <int NBOX>
__host__ __device__ constexpr int gemm_smem() {
  return 1024 + RING * stage_bytes<NBOX>() + 2 * RING * 8;
}

// One stage's products (K = 32) of boxes FIRST .. NBOX - 1 for a thread's
// rows rg + 16 i (i < 8; so a row's swizzle is rg % 8) and box columns 2 p
// + {0, 1}: acc[i][g][e]. A chunk of 4 K of a row is one 16-byte load, a
// box's 2 columns of a K row one 8-byte load.
template <int NBOX, int FIRST>
__device__ __forceinline__ void stage_products(float (&acc)[8][NBOX][2],
                                               const unsigned char* st,
                                               int rg, int p) {
  const unsigned char* ab = st + rg * 128;
  const unsigned char* wb = st + A_BOX + (p & 1) * 8;
  const int pc = p >> 1;  // the pair's 16-byte chunk
#pragma unroll
  for (int kc = 0; kc < STAGE_K / 4; ++kc) {
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = *reinterpret_cast<const float4*>(ab + i * 2048 +
                                               ((kc ^ (rg & 7)) << 4));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * kc + e;
      float2 bv[NBOX];
#pragma unroll
      for (int g = FIRST; g < NBOX; ++g)
        bv[g] = *reinterpret_cast<const float2*>(wb + g * W_BOX + k * 128 +
                                                 ((pc ^ (k & 7)) << 4));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = e == 0   ? av[i].x
                        : e == 1 ? av[i].y
                        : e == 2 ? av[i].z
                                 : av[i].w;
#pragma unroll
        for (int g = FIRST; g < NBOX; ++g) {
          acc[i][g][0] = fmaf(x, bv[g].x, acc[i][g][0]);
          acc[i][g][1] = fmaf(x, bv[g].y, acc[i][g][1]);
        }
      }
    }
  }
}

// The producer: every operand's stages in order, each its activation box
// and the weight boxes it feeds (gated: the four base boxes when it has
// w_gates, r when it has w_copy; plain: the four).
template <int NBOX>
__device__ __forceinline__ void produce(const TileArgs& t, unsigned char* smem,
                                        uint64_t* full, uint64_t* empty,
                                        int row0, int nb, int s0, int s1) {
  int it = 0;
  for (int s = s0; s < s1; ++s) {
    const Operand& op = t.g.op[s];
    const bool base = op.w_gates != nullptr;
    const bool r = NBOX == 5 && op.w_copy != nullptr;
    const uint32_t bytes = A_BOX + (base ? 4 * W_BOX : 0) + (r ? W_BOX : 0);
    for (int k0 = 0; k0 < op.k; k0 += STAGE_K, ++it) {
      const int slot = it % RING;
      if (it >= RING) sm90::mbar_wait(&empty[slot], ((it / RING) - 1) & 1);
      unsigned char* st = smem + slot * stage_bytes<NBOX>();
      sm90::mbar_expect_tx(&full[slot], bytes);
      sm90::tma_load_2d(st, &t.a[s], &full[slot], k0, row0);
      if (base)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          sm90::tma_load_2d(st + A_BOX + g * W_BOX, &t.w[s], &full[slot],
                            g * t.box_stride + nb * t.tile_cols, k0);
      if (r)
        sm90::tma_load_2d(st + A_BOX + 4 * W_BOX, &t.wr[s], &full[slot],
                          nb * BN, k0);
    }
  }
}

// Gated epilogue: hidden columns j = 32 nb + 2 p + e of rows row0 + rg + 16
// i. The plain versions' arithmetic in their order: z = acc (+ zadd) (+
// bias); c' = sigmoid(f) c + sigmoid(i) tanh(g); Copy-LSTM: r = sigmoid(z_r
// + b_r), c' = r c* + (1 - r) c'; h' = sigmoid(o) tanh(c').
template <int NBOX>
__device__ __forceinline__ void epi_gated(const GemmArgs& a,
                                          const float (&acc)[8][NBOX][2],
                                          int row0, int rg, int p, int nb) {
  const int cols = a.cols;
  const int j = nb * BN + 2 * p;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + rg + 16 * i;
    if (gr >= a.N) continue;
    const size_t idx = static_cast<size_t>(gr) * cols + j;
    const float2 cp = *reinterpret_cast<const float2*>(a.c_prev + idx);
    float hv[2], cv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        z[g] = acc[i][g][e];
        if (a.zadd) z[g] += a.zadd[static_cast<size_t>(gr) * 4 * cols +
                                   g * cols + j + e];
        if (a.bias) z[g] += a.bias[g * cols + j + e];
      }
      float c_new = sigmoidf(z[1]) * (e ? cp.y : cp.x) +
                    sigmoidf(z[0]) * tanhf(z[2]);
      if constexpr (NBOX == 5) {
        const float rgate = sigmoidf(acc[i][4][e] + a.bias_r[j + e]);
        c_new = rgate * a.c_star[idx + e] + (1.0f - rgate) * c_new;
      }
      cv[e] = c_new;
      hv[e] = sigmoidf(z[3]) * tanhf(c_new);
    }
    *reinterpret_cast<float2*>(a.h_out + idx) = make_float2(hv[0], hv[1]);
    *reinterpret_cast<float2*>(a.c_out + idx) = make_float2(cv[0], cv[1]);
  }
}

// Plain epilogue: output columns 128 nb + 32 g + 2 p + e.
template <int EPI>
__device__ __forceinline__ void epi_plain(const GemmArgs& a,
                                          const float (&acc)[8][4][2],
                                          int row0, int rg, int p, int nb) {
  const int cols = a.cols;
  float* out = static_cast<float*>(a.out) + (size_t)blockIdx.z * a.N * cols;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + rg + 16 * i;
    if (gr >= a.N) continue;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int col = nb * 4 * BN + g * BN + 2 * p;
      const size_t idx = static_cast<size_t>(gr) * cols + col;
      float2 v = make_float2(acc[i][g][0], acc[i][g][1]);
      if constexpr (EPI == EPI_GATE_MUL) {
        const float2 x = *reinterpret_cast<const float2*>(a.x + idx);
        v.x = sigmoidf(v.x + a.bias[col]) * x.x;
        v.y = sigmoidf(v.y + a.bias[col + 1]) * x.y;
      }
      *reinterpret_cast<float2*>(out + idx) = v;
    }
  }
}

// One tile per CTA: grid (column blocks, ceil(N / 128), the K ranges of a
// split product). Warps 0-7 consume (warp w: row groups 4 (w % 4) + lane /
// 8, column pairs 8 (w / 4) + lane % 8); warp 8's first thread produces.
template <int EPI, int NBOX>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    gemm_kernel(const __grid_constant__ TileArgs t) {
  sm90::launch_dependents();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + RING * stage_bytes<NBOX>());
  uint64_t* empty = full + RING;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nb = blockIdx.x;
  const int row0 = blockIdx.y * TILE_ROWS;
  // The operands this CTA runs: all, or K range z of a split product.
  const int s0 = gridDim.z > 1 ? blockIdx.z : 0;
  const int s1 = gridDim.z > 1 ? s0 + 1 : t.g.n_ops;

  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS / 32);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    if (lane == 0) produce<NBOX>(t, smem, full, empty, row0, nb, s0, s1);
    return;
  }
  const int rg = 4 * (warp % 4) + lane / 8;  // row group 0..15
  const int p = 8 * (warp / 4) + lane % 8;   // column pair 0..15
  float acc[8][NBOX][2];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int g = 0; g < NBOX; ++g) acc[i][g][0] = acc[i][g][1] = 0.0f;
  int it = 0;
  for (int s = s0; s < s1; ++s) {
    const Operand& op = t.g.op[s];
    const bool r_only = NBOX == 5 && op.w_gates == nullptr;
    for (int k0 = 0; k0 < op.k; k0 += STAGE_K, ++it) {
      const int slot = it % RING;
      sm90::mbar_wait(&full[slot], (it / RING) & 1);
      const unsigned char* st = smem + slot * stage_bytes<NBOX>();
      if (r_only)
        stage_products<NBOX, 4>(acc, st, rg, p);
      else
        stage_products<NBOX, 0>(acc, st, rg, p);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[slot]);
    }
  }
  if constexpr (EPI == EPI_LSTM || EPI == EPI_COPY_LSTM)
    epi_gated<NBOX>(t.g, acc, row0, rg, p, nb);
  else
    epi_plain<EPI>(t.g, acc, row0, rg, p, nb);
}

// Column blocks of a GEMM: gated widths are multiples of BN, plain output
// widths of 4 BN.
template <int EPI>
__host__ __device__ constexpr int column_width() {
  return (EPI == EPI_LSTM || EPI == EPI_COPY_LSTM) ? BN : 4 * BN;
}

// Shape checks of a GEMM's arguments; cudaSuccess when it can run. Every
// operand of an LSTM or plain GEMM feeds the base boxes; a Copy-LSTM
// operand feeds r and, unless it is r-only (c*), the base boxes.
template <int G, int EPI>
cudaError_t check_gemm(const GemmArgs& a) {
  static_assert(G == (EPI == EPI_COPY_LSTM ? 5 : 4), "boxes of the epilogue");
  if (a.n_ops < 1 || a.n_ops > MAX_OPS) return cudaErrorInvalidValue;
  if (a.split > 1 && (EPI != EPI_STORE || a.split != a.n_ops))
    return cudaErrorInvalidValue;
  for (int i = 0; i < a.n_ops; ++i) {
    const Operand& op = a.op[i];
    if (op.k < BK || op.k % BK || op.ld < op.k) return cudaErrorInvalidValue;
    if (EPI == EPI_COPY_LSTM ? op.w_copy == nullptr
                             : op.w_gates == nullptr || op.w_copy != nullptr)
      return cudaErrorInvalidValue;
  }
  const int width = column_width<EPI>();
  if (a.N < 1 || a.cols < width || a.cols % width)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The map of an fp32 row-major [rows, cols] matrix (row stride ld, cols
// when 0) in box_rows x 32 boxes, 128-byte swizzled.
inline cudaError_t f32_map(CUtensorMap* map, const void* p, int rows,
                           int cols, int box_rows, int ld = 0) {
  return sm90::tensor_map_2d(map, p, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, rows,
                             cols, ld ? ld : cols, box_rows, 32,
                             CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int G, int EPI>
cudaError_t launch_gemm(const GemmArgs& a, cudaStream_t s) {
  constexpr bool gated = EPI == EPI_LSTM || EPI == EPI_COPY_LSTM;
  cudaError_t err = check_gemm<G, EPI>(a);
  if (err != cudaSuccess) return err;
  TileArgs t = {};
  t.g = a;
  t.box_stride = gated ? a.cols : BN;
  t.tile_cols = column_width<EPI>();
  for (int i = 0; i < a.n_ops; ++i) {
    const Operand& op = a.op[i];
    err = f32_map(&t.a[i], op.a, a.N, op.k, TILE_ROWS, op.ld);
    if (err == cudaSuccess && op.w_gates)
      err = f32_map(&t.w[i], op.w_gates, op.k, gated ? 4 * a.cols : a.cols,
                    STAGE_K);
    if (err == cudaSuccess && op.w_copy)
      err = f32_map(&t.wr[i], op.w_copy, op.k, a.cols, STAGE_K);
    if (err != cudaSuccess) return err;
  }
  auto* kernel = gemm_kernel<EPI, G>;
  constexpr int smem = gemm_smem<G>();
  static bool sized[sm90::kDevices] = {};
  const int dev = sm90::device_slot();
  if (dev < 0 || !sized[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev >= 0) sized[dev] = true;
  }
  const dim3 grid(a.cols / column_width<EPI>(),
                  (a.N + TILE_ROWS - 1) / TILE_ROWS,
                  a.split > 1 ? a.split : 1);
  kernel<<<grid, GEMM_THREADS, smem, s>>>(t);
  return cudaGetLastError();
}

inline Operand operand(const void* a, int k, const void* w_gates,
                       const void* w_copy = nullptr) {
  Operand o;
  o.a = a;
  o.k = k;
  o.ld = k;
  o.w_gates = w_gates;
  o.w_copy = w_copy;
  return o;
}

// The K ranges of a plain fp32 product over `steps` stages of BK whose
// `tiles` 128 x 128 output tiles would fill too few of the card's `sms`
// SMs (one CTA an SM): the count s <= MAX_OPS (and <= steps) that
// minimizes the waves of s tiles' CTAs times the stages of the longest
// range, the smallest on a tie (megastep.cu exports it as ck_f32_split
// for the wrappers, which size the partials' scratch by it).
inline int plain_split(int tiles, int steps, int sms) {
  int best = 1;
  long long best_cost = (long long)((tiles + sms - 1) / sms) * steps;
  for (int s = 2; s <= MAX_OPS && s <= steps; ++s) {
    const long long cost =
        (long long)((tiles * s + sms - 1) / sms) * ((steps + s - 1) / s);
    if (cost < best_cost) best = s, best_cost = cost;
  }
  return best;
}

// The operands of a product of a [N, k] (row stride k) and w [k, cols],
// split over K into `split` ranges of whole BK stages: range c holds
// stages [c S / split, (c + 1) S / split) of S = k / BK.
inline void split_operands(GemmArgs& g, const void* a, int k, const void* w,
                           int split) {
  const int steps = k / BK;
  for (int c = 0; c < split; ++c) {
    const int k0 = steps * c / split * BK;
    const int k1 = steps * (c + 1) / split * BK;
    g.op[c] = operand(static_cast<const float*>(a) + k0, k1 - k0,
                      static_cast<const float*>(w) + (size_t)k0 * g.cols);
    g.op[c].ld = k;
  }
  g.n_ops = split;
  g.split = split;
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
