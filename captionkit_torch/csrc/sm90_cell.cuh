// The shared sm90 split-operand gated GEMM of the cell kernels: lstm.cu
// (fused_lstm_cell, fused_copy_lstm_cell), megastep.cu's bf16 cells
// (att_cell, lang_cell, dcnet_cell, dcnet_score's query product),
// wholestep.cu's persistent kernel and, through its producer and consumer
// pieces, attention.cu's K-split query product.
//
// Replaces, on the H100, the products of the TPU kernels of
// captionkit/ops/lstm.py (_run_cell), captionkit/ops/megastep.py
// (att_phase: the att-LSTM and the query product; fused_step_hidden: the
// visual gate and the Copy-LSTM; dcnet_fused_step_hidden's LSTM kernel:
// the context gate and the decoder LSTM) and
// captionkit/ops/wholestep.py (fused_lang_head_topk): on the TPU one grid
// step multiplies a row block by every gate column in VMEM; here a CTA owns
// 128 rows x 128 product columns and streams K.
//
// What bounds these GEMMs on the H100: at the paper's beam shape (N = 2560
// rows, F = 2048, H = 1024) the lang cell is 123.5 GFLOP of bf16 products
// (0.125 ms at 989 TFLOP/s) over 132 MB of inputs and outputs (0.04 ms at
// 3.35 TB/s), so operations bound it; what stands between a tile and the
// tensor-core rate is the L2 -> SM traffic (each 128-row block reads the
// weights of its columns; each column block reads its rows' activations)
// and the wgmma issue rate of one 64-row chain per warpgroup.
//
// The design (lstm.cu's main loop, lifted and generalised):
// - A CTA of 384 threads owns 128 rows. One producer thread fills a ring of
//   STAGES stages of K = 64 with TMA loads, completing on mbarriers: two
//   128 x 32 activation boxes (fp32, 128-byte swizzle; or bf16, 64-byte)
//   and up to five 64 x 32 bf16 weight boxes (64-byte swizzle). Rows past
//   N and K past an operand's end read zeros. The consumers free a stage
//   on a second ring of mbarriers.
// - Up to MAX_OPS split operands are successive K ranges of one
//   accumulation, each with its own tensor maps, K range and dtype (a
//   template bit: fp32 is rounded to bf16 in registers, once per CTA), so a
//   concatenation such as [v_hat | h_att | h_lang | c*] never exists in
//   device memory. Per operand, two more template bits say whether it feeds
//   the four base boxes and the copy gate's box (c* feeds only r).
// - Two consumer warpgroups, 64 rows each, read their activation fragments
//   from the stage into registers and run wgmma m64n128k16 with A from
//   registers and the four weight boxes as one MN-major B operand (LBO =
//   one box); the copy gate is its own m64n32k16 chain on the same A
//   registers. Two register buffers alternate under wgmma.wait_group 1.
// - The four boxes of a tile sit `box_stride` columns apart: the i, f, g, o
//   blocks of 32 hidden columns of a gate-major [K, 4H] weight (gated), or
//   128 consecutive columns of a [K, cols] weight (box_stride 32).
// - The producer warpgroup's other 127 threads may take a side job while
//   the products run: fp32 arrays rounded to bf16 for a later launch (the
//   lang cell's gate launch writes bf16 copies of h_att, h_lang and c*, so
//   its Copy-LSTM reads half the activation bytes).
// - The epilogues run in registers. wgmma's accumulator puts column 8 j +
//   2 (lane % 4) + e of rows lane / 4 + {0, 8} in a thread, a set closed
//   under + 32, so a gated tile's four gates (and r) of a hidden column are
//   one thread's: LSTM (bias per column, or a per-row zadd term),
//   Copy-LSTM (either optionally also writes h' rounded to bf16),
//   gate-multiply (sigmoid(z + b) * x -> bf16, x rounded to bf16 first or
//   not) and store. Each variant is its own template instance, so adding
//   one leaves the registers of the others as they were.
//
// The one-tile-per-CTA kernel is cell_kernel; wholestep.cu drives
// produce_tile / consume_tile / the epilogues from its persistent kernel,
// carrying the ring's counters from tile to tile.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "sm90_common.cuh"

namespace {
namespace sm90cell {

using namespace sm90;

constexpr int TILE = 32;     // columns of one weight box
constexpr int BM = 128;      // rows per CTA: two consumer warpgroups
constexpr int BK = 64;       // depth of one stage: two 32-wide boxes
constexpr int STAGES = 4;
constexpr int MAX_OPS = 4;
constexpr int A_HALF = BM * 32 * 4;        // one 128 x 32 activation box
constexpr int A_SLOT = 2 * A_HALF;         // (fp32 size; bf16 uses half)
constexpr int W_BOX = BK * TILE * 2;       // one 64 x 32 bf16 weight box
constexpr int STAGE = A_SLOT + 5 * W_BOX;  // + four base boxes and r
constexpr int THREADS = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
static_assert(STAGE % 1024 == 0, "stages stay on 1024-byte boundaries");

// kLstmZadd: the LSTM with a per-row term zadd [N, 4 cols] added to the
// gates in place of the per-column bias (EditNet's att-LSTM: the hoisted
// v_mean product, which carries the bias). kGateMulX32: the gate-multiply
// with x taken unrounded (DCNet's context gate multiplies the fp32
// context; EditNet's visual gate rounds v_hat's raw input first).
enum Epi : int {
  kLstm = 0,
  kCopyLstm = 1,
  kGateMul = 2,
  kStore = 3,
  kLstmZadd = 4,
  kGateMulX32 = 5,
};

struct CellArgs {
  CUtensorMap a[MAX_OPS];   // activations [N, K_op]: 128 x 32 boxes
  CUtensorMap w[MAX_OPS];   // base weights [K_op, *]: 64 x 32 boxes
  CUtensorMap wr[MAX_OPS];  // copy-gate weights [K_op, cols]: 64 x 32
  int steps[MAX_OPS];       // stages of each operand: ceil(K_op / 64)
  int a_rows;      // rows of an activation box: 128, or 64 for one
                   // warpgroup's tile
  int box_stride;  // columns between a tile's four base boxes
  int tile_cols;   // columns between tiles: 32 (gated) or 128 (plain)
  const float* bias;    // gated [4 cols]; gate-mul [cols]
  const float* bias_r;  // copy [cols]
  const float* c_prev;  // gated [N, cols]
  const float* c_star;  // copy [N, cols]
  const float* x;       // gate-mul [N, cols] (kGateMul rounds it to bf16)
  float* h_out;         // gated [N, cols]
  float* c_out;         // gated [N, cols]
  __nv_bfloat16* h_bf16;  // gated: h' rounded to bf16 [N, cols], or null
  void* out;            // gate-mul bf16 / store fp32 [N, cols]
  int N;
  int cols;  // hidden width (gated) or output width (plain)
  // A side job for the producer warpgroup's idle threads: cvt_src[i]
  // (fp32, cvt_n elements, a multiple of 8) rounded to bf16 into
  // cvt_dst[i], split evenly over the grid's CTAs; cvt_n = 0: none.
  const float* cvt_src[3];
  __nv_bfloat16* cvt_dst[3];
  long long cvt_n;
  const float* zadd;  // kLstmZadd [N, 4 cols], gate-major
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The four k16 A fragments of this thread's rows (tile rows r and r + 8,
// r = `row`) from a stage's two activation boxes: fp32 (128-byte rows,
// 128-byte swizzle) rounded to bf16 here, or bf16 (64-byte rows, 64-byte
// swizzle).
template <bool F32>
__device__ __forceinline__ void load_a(const unsigned char* stage, int row,
                                       int q, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c8 = 0; c8 < 2; ++c8)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const unsigned char* box = stage + (kk / 2) * A_HALF;
        const int k2 = kk % 2;
        const int r = row + 8 * hr;
        if (F32) {
          const int chunk = 4 * k2 + 2 * c8 + (q >> 1);
          const float2 v = *reinterpret_cast<const float2*>(
              box + r * 128 + ((chunk ^ (r & 7)) << 4) + 8 * (q & 1));
          a[kk][hr + 2 * c8] = pack2(v.x, v.y);
        } else {
          const int chunk = 2 * k2 + c8;
          a[kk][hr + 2 * c8] = *reinterpret_cast<const uint32_t*>(
              box + r * 64 + ((chunk ^ ((r >> 1) & 3)) << 4) + 4 * q);
        }
      }
}

// The consumer side of the ring: which stage comes next, and the stage
// whose products may still be in flight (freed once they are done). A
// persistent kernel keeps one Ring from tile to tile.
struct Ring {
  unsigned char* smem;
  uint64_t* full;
  uint64_t* empty;
  int it;    // stages consumed so far
  int prev;  // stage slot still read by the products in flight, or -1
  int lane;

  __device__ __forceinline__ void release() {
    if (prev < 0) return;
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);
    prev = -1;
  }
};

// One stage: wait for it, read the A fragments, issue its products (the
// base boxes' m64n128k16 and the copy gate's m64n32k16, four k16 steps
// each) as one commit group, then free the stage before it.
template <bool F32, bool GATES, bool COPY>
__device__ __forceinline__ void mma_stage(Ring& ring, int row, int q,
                                          uint32_t (&a)[4][4],
                                          float (&acc)[64],
                                          float (&accr)[16]) {
  const int s = ring.it % STAGES;
  mbar_wait(&ring.full[s], (ring.it / STAGES) & 1);
  const unsigned char* st = ring.smem + s * STAGE;
  load_a<F32>(st, row, q, a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // k16 step kk: 16 weight rows of 64 bytes further into each box.
    if (GATES)
      wgmma_m64n128k16_rs(
          acc, a[kk],
          smem_desc(st + A_SLOT + kk * 1024, W_BOX, 512, kSwizzle64B));
    if (COPY)
      wgmma_m64n32k16_rs(accr, a[kk],
                         smem_desc(st + A_SLOT + 4 * W_BOX + kk * 1024,
                                   W_BOX, 512, kSwizzle64B));
  }
  wgmma_commit();
  wgmma_wait<1>();  // the previous stage's products are done
  ring.release();
  ring.prev = s;
  ++ring.it;
}

// The `steps` stages of one operand. Two register buffers alternate, so a
// stage's A fragments are written while the previous stage's products
// still read the other buffer.
template <bool F32, bool GATES, bool COPY>
__device__ __forceinline__ void mma_operand(Ring& ring, int steps, int row,
                                            int q, float (&acc)[64],
                                            float (&accr)[16]) {
  uint32_t a0[4][4], a1[4][4];
  int i = 0;
  for (; i + 1 < steps; i += 2) {
    mma_stage<F32, GATES, COPY>(ring, row, q, a0, acc, accr);
    mma_stage<F32, GATES, COPY>(ring, row, q, a1, acc, accr);
  }
  if (i < steps) mma_stage<F32, GATES, COPY>(ring, row, q, a0, acc, accr);
  wgmma_wait<0>();  // the next operand writes a0 again
  ring.release();
}

template <uint32_t MASK, int OP>
__host__ __device__ constexpr bool bit() {
  return (MASK >> OP) & 1u;
}

// Operand OP of a tile, consumer side.
template <uint32_t F32, uint32_t GATES, uint32_t COPY, int OP>
__device__ __forceinline__ void consume_op(const CellArgs& args, Ring& ring,
                                           int row, int q, float (&acc)[64],
                                           float (&accr)[16]) {
  mma_operand<bit<F32, OP>(), bit<GATES, OP>(), bit<COPY, OP>()>(
      ring, args.steps[OP], row, q, acc, accr);
}

// A tile's products for the consumer warpgroups: warpgroup wg's thread
// holds rows `row` and `row` + 8 of the tile (row = 64 wg + 16 (warp % 4) +
// lane / 4). The K walk is operand 0, 1, ... as the producer fills it.
template <int NOPS, uint32_t F32, uint32_t GATES, uint32_t COPY>
__device__ __forceinline__ void consume_tile(const CellArgs& args,
                                             Ring& ring, int row, int q,
                                             float (&acc)[64],
                                             float (&accr)[16]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) accr[i] = 0.0f;
  fence_regs(acc);
  fence_regs(accr);
  consume_op<F32, GATES, COPY, 0>(args, ring, row, q, acc, accr);
  if constexpr (NOPS > 1)
    consume_op<F32, GATES, COPY, 1>(args, ring, row, q, acc, accr);
  if constexpr (NOPS > 2)
    consume_op<F32, GATES, COPY, 2>(args, ring, row, q, acc, accr);
  if constexpr (NOPS > 3)
    consume_op<F32, GATES, COPY, 3>(args, ring, row, q, acc, accr);
  fence_regs(acc);
  fence_regs(accr);
}

// Operand OP of a tile, producer side: stage i holds its K rows [64 i,
// 64 i + 64): two activation boxes and the weight boxes it feeds.
template <uint32_t F32, uint32_t GATES, uint32_t COPY, int OP>
__device__ __forceinline__ void produce_op(const CellArgs& args,
                                           unsigned char* smem,
                                           uint64_t* full, uint64_t* empty,
                                           int& it, int row0, int nb) {
  constexpr bool f32 = bit<F32, OP>();
  constexpr bool gates = bit<GATES, OP>();
  constexpr bool copy = bit<COPY, OP>();
  const uint32_t bytes = 2 * args.a_rows * 32 * (f32 ? 4 : 2) +
                         (gates ? 4 * W_BOX : 0) + (copy ? W_BOX : 0);
  for (int i = 0; i < args.steps[OP]; ++i, ++it) {
    const int s = it % STAGES;
    const int k0 = i * BK;
    if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
    unsigned char* st = smem + s * STAGE;
    mbar_expect_tx(&full[s], bytes);
    tma_load_2d(st, &args.a[OP], &full[s], k0, row0);
    tma_load_2d(st + A_HALF, &args.a[OP], &full[s], k0 + 32, row0);
    if (gates) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        tma_load_2d(st + A_SLOT + g * W_BOX, &args.w[OP], &full[s],
                    g * args.box_stride + nb * args.tile_cols, k0);
    }
    if (copy)
      tma_load_2d(st + A_SLOT + 4 * W_BOX, &args.wr[OP], &full[s],
                  nb * TILE, k0);
  }
}

// One tile (rows [row0, row0 + 128), column block nb), producer side; `it`
// counts the stages filled so far and carries over to the next tile.
template <int NOPS, uint32_t F32, uint32_t GATES, uint32_t COPY>
__device__ __forceinline__ void produce_tile(const CellArgs& args,
                                             unsigned char* smem,
                                             uint64_t* full, uint64_t* empty,
                                             int& it, int row0, int nb) {
  produce_op<F32, GATES, COPY, 0>(args, smem, full, empty, it, row0, nb);
  if constexpr (NOPS > 1)
    produce_op<F32, GATES, COPY, 1>(args, smem, full, empty, it, row0, nb);
  if constexpr (NOPS > 2)
    produce_op<F32, GATES, COPY, 2>(args, smem, full, empty, it, row0, nb);
  if constexpr (NOPS > 3)
    produce_op<F32, GATES, COPY, 3>(args, smem, full, empty, it, row0, nb);
}

// ---------------------------------------------------------------------------
// Epilogues, in registers. gr0: the thread's first row (row0 + row); its
// second is gr0 + 8. q = lane % 4.
// ---------------------------------------------------------------------------

// LSTM / Copy-LSTM: gate g of hidden column 8 jj + 2 q + e (of the tile's
// 32) is acc[4 (4 g + jj) + 2 hr + e]; r is accr[4 jj + 2 hr + e]. ZADD:
// the gates add the row's zadd instead of bias.
template <bool COPY, bool ZADD = false>
__device__ __forceinline__ void epi_gated(const CellArgs& args,
                                          const float (&acc)[64],
                                          const float (&accr)[16], int gr0,
                                          int q, int nb) {
  const int Hp = args.cols;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int gr = gr0 + 8 * hr;
    if (gr >= args.N) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = nb * TILE + 8 * jj + 2 * q;
      const size_t idx = static_cast<size_t>(gr) * Hp + col;
      const float2 cp = *reinterpret_cast<const float2*>(args.c_prev + idx);
      float2 cs = make_float2(0.0f, 0.0f);
      if (COPY) cs = *reinterpret_cast<const float2*>(args.c_star + idx);
      // The additive term of each gate: bias [4 Hp], or the row's zadd.
      const float* add =
          ZADD ? args.zadd + static_cast<size_t>(gr) * 4 * Hp : args.bias;
      float hv[2], cv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = col + e;
        const int d = 2 * hr + e;
        const float zi = acc[4 * jj + d] + add[j];
        const float zf = acc[4 * (4 + jj) + d] + add[Hp + j];
        const float zg = acc[4 * (8 + jj) + d] + add[2 * Hp + j];
        const float zo = acc[4 * (12 + jj) + d] + add[3 * Hp + j];
        float c_new = sigmoidf(zf) * (e ? cp.y : cp.x) +
                      sigmoidf(zi) * tanhf(zg);
        if (COPY) {
          const float rg = sigmoidf(accr[4 * jj + d] + args.bias_r[j]);
          c_new = rg * (e ? cs.y : cs.x) + (1.0f - rg) * c_new;
        }
        cv[e] = c_new;
        hv[e] = sigmoidf(zo) * tanhf(c_new);
      }
      *reinterpret_cast<float2*>(args.h_out + idx) = make_float2(hv[0], hv[1]);
      *reinterpret_cast<float2*>(args.c_out + idx) = make_float2(cv[0], cv[1]);
      if (args.h_bf16)
        *reinterpret_cast<uint32_t*>(args.h_bf16 + idx) = pack2(hv[0], hv[1]);
    }
  }
}

// Plain tiles: column nb * 128 + 8 j + 2 q + e is acc[4 j + 2 hr + e].
// Gate-multiply: out = bf16(sigmoid(z + b) * round_bf16(x)), or, X32,
// bf16(sigmoid(z + b) * x).
template <bool X32 = false>
__device__ __forceinline__ void epi_gate_mul(const CellArgs& args,
                                             const float (&acc)[64], int gr0,
                                             int q, int nb) {
  const int cols = args.cols;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int gr = gr0 + 8 * hr;
    if (gr >= args.N) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = nb * 128 + 8 * j + 2 * q;
      const size_t idx = static_cast<size_t>(gr) * cols + col;
      const float2 x = *reinterpret_cast<const float2*>(args.x + idx);
      const float2 b = *reinterpret_cast<const float2*>(args.bias + col);
      const float v0 = sigmoidf(acc[4 * j + 2 * hr] + b.x) *
                       (X32 ? x.x : round_bf16(x.x));
      const float v1 = sigmoidf(acc[4 * j + 2 * hr + 1] + b.y) *
                       (X32 ? x.y : round_bf16(x.y));
      *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(args.out) +
                                   idx) = pack2(v0, v1);
    }
  }
}

// Store: out = z, fp32.
__device__ __forceinline__ void epi_store(const CellArgs& args,
                                          const float (&acc)[64], int gr0,
                                          int q, int nb) {
  const int cols = args.cols;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int gr = gr0 + 8 * hr;
    if (gr >= args.N) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = nb * 128 + 8 * j + 2 * q;
      *reinterpret_cast<float2*>(static_cast<float*>(args.out) +
                                 static_cast<size_t>(gr) * cols + col) =
          make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
    }
  }
}

template <int EPI>
__device__ __forceinline__ void epilogue(const CellArgs& args,
                                         const float (&acc)[64],
                                         const float (&accr)[16], int gr0,
                                         int q, int nb) {
  if constexpr (EPI == kLstm) epi_gated<false>(args, acc, accr, gr0, q, nb);
  if constexpr (EPI == kCopyLstm) epi_gated<true>(args, acc, accr, gr0, q, nb);
  if constexpr (EPI == kGateMul) epi_gate_mul(args, acc, gr0, q, nb);
  if constexpr (EPI == kStore) epi_store(args, acc, gr0, q, nb);
  if constexpr (EPI == kLstmZadd)
    epi_gated<false, true>(args, acc, accr, gr0, q, nb);
  if constexpr (EPI == kGateMulX32) epi_gate_mul<true>(args, acc, gr0, q, nb);
}

// The 1024-aligned dynamic shared memory: the ring, then the full and
// empty barriers.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// Thread 0 sets up the ring's barriers (every CTA thread must then
// synchronise before the ring is used).
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], 8);  // one arrival per consumer warp
  }
  fence_barrier_init();
}

// The side job of CellArgs for thread `t` of `nt` idle threads of CTA
// `cta` of `ctas`: its share of each array, eight elements a vector and
// four vectors in flight (one at a time left the job latency-bound and
// longer than a gate tile).
__device__ __forceinline__ void convert_share(const CellArgs& args, int cta,
                                              int ctas, int t, int nt) {
  constexpr int U = 4;
  const long long n8 = args.cvt_n / 8;
  const long long per = (n8 + ctas - 1) / ctas;
  const long long end = per * (cta + 1) < n8 ? per * (cta + 1) : n8;
  for (int i = 0; i < 3; ++i) {
    if (args.cvt_src[i] == nullptr) continue;
    const float4* src = reinterpret_cast<const float4*>(args.cvt_src[i]);
    uint4* dst = reinterpret_cast<uint4*>(args.cvt_dst[i]);
    long long v = per * cta + t;
    for (; v + (U - 1) * nt < end; v += U * nt) {
      float4 x[2 * U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        x[2 * u] = src[2 * (v + u * nt)];
        x[2 * u + 1] = src[2 * (v + u * nt) + 1];
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        dst[v + u * nt] = make_uint4(
            pack2(x[2 * u].x, x[2 * u].y), pack2(x[2 * u].z, x[2 * u].w),
            pack2(x[2 * u + 1].x, x[2 * u + 1].y),
            pack2(x[2 * u + 1].z, x[2 * u + 1].w));
    }
    for (; v < end; v += nt) {
      const float4 lo = src[2 * v], hi = src[2 * v + 1];
      dst[v] = make_uint4(pack2(lo.x, lo.y), pack2(lo.z, lo.w),
                          pack2(hi.x, hi.y), pack2(hi.z, hi.w));
    }
  }
}

// One tile per CTA: grid (column blocks, ceil(N / 128)).
template <int EPI, int NOPS, uint32_t F32, uint32_t GATES, uint32_t COPY>
__global__ void __launch_bounds__(THREADS, 1)
    cell_kernel(const __grid_constant__ CellArgs args) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int nb = blockIdx.x;
  const int row0 = blockIdx.y * BM;
  // A plain product's next launch (megastep.cu's score_kernel) may start
  // and stage its keys once every CTA of this one runs; it waits for q.
  if constexpr (EPI == kStore) launch_dependents();

  if (threadIdx.x == 0) init_ring(full, empty);
  __syncthreads();

  if (wg == 2) {
    if (threadIdx.x == 256) {
      int it = 0;
      produce_tile<NOPS, F32, GATES, COPY>(args, smem, full, empty, it, row0,
                                           nb);
    } else if (args.cvt_n) {
      convert_share(args, blockIdx.y * gridDim.x + blockIdx.x,
                    gridDim.x * gridDim.y, threadIdx.x - 257, THREADS - 257);
    }
  } else {
    Ring ring{smem, full, empty, 0, -1, lane};
    const int q = lane % 4;
    const int row = wg * 64 + (warp % 4) * 16 + lane / 4;
    float acc[64];
    float accr[16];
    consume_tile<NOPS, F32, GATES, COPY>(args, ring, row, q, acc, accr);
    epilogue<EPI>(args, acc, accr, row0 + row, q, nb);
  }
}

// One launch of cell_kernel over `col_blocks` x ceil(N / 128) CTAs. The
// first launch of each instance on a device sets its shared-memory size
// there.
template <int EPI, int NOPS, uint32_t F32, uint32_t GATES, uint32_t COPY>
cudaError_t launch_cell(const CellArgs& args, int col_blocks,
                        cudaStream_t stream) {
  auto* kernel = cell_kernel<EPI, NOPS, F32, GATES, COPY>;
  static bool sized[sm90::kDevices] = {};
  const int dev = sm90::device_slot();
  if (dev < 0 || !sized[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    if (dev >= 0) sized[dev] = true;
  }
  const dim3 grid(col_blocks, (args.N + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM, stream>>>(args);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Host: tensor maps and arguments
// ---------------------------------------------------------------------------

// The map of an activation operand [N, k] (fp32 or bf16) in rows x 32
// boxes.
inline cudaError_t activation_map(CUtensorMap* map, const void* a, int f32,
                                  int N, int k, int rows) {
  return f32 ? tensor_map_2d(map, a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, N, k,
                             k, rows, 32, CU_TENSOR_MAP_SWIZZLE_128B)
             : tensor_map_2d(map, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N,
                             k, k, rows, 32, CU_TENSOR_MAP_SWIZZLE_64B);
}

// The map of a bf16 weight [k, cols] in 64 x 32 boxes.
inline cudaError_t weight_map(CUtensorMap* map, const void* w, int k,
                              int cols) {
  return tensor_map_2d(map, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, cols,
                       cols, BK, TILE, CU_TENSOR_MAP_SWIZZLE_64B);
}

#define CK_TRY(expr)                            \
  do {                                          \
    const cudaError_t ck_err_ = (expr);         \
    if (ck_err_ != cudaSuccess) return ck_err_; \
  } while (0)

// Operand `op` [N, k] (fp32 if f32) with its base weight [k, w_cols] and,
// or null, its copy-gate weight [k, cols].
inline cudaError_t set_operand(CellArgs& g, int op, const void* a, int f32,
                               int k, const void* w, int w_cols,
                               const void* wr) {
  CK_TRY(activation_map(&g.a[op], a, f32, g.N, k, g.a_rows));
  if (w) CK_TRY(weight_map(&g.w[op], w, k, w_cols));
  if (wr) CK_TRY(weight_map(&g.wr[op], wr, k, g.cols));
  g.steps[op] = (k + BK - 1) / BK;
  return cudaSuccess;
}

// Arguments of a gated GEMM (hidden width Hp: gate-major [K, 4Hp] weights)
// or a plain one (cols output columns), with no operand set yet.
inline CellArgs gated_args(int N, int Hp) {
  CellArgs g = {};
  g.N = N;
  g.cols = Hp;
  g.a_rows = BM;
  g.box_stride = Hp;
  g.tile_cols = TILE;
  return g;
}

inline CellArgs plain_args(int N, int cols, int a_rows = BM) {
  CellArgs g = {};
  g.N = N;
  g.cols = cols;
  g.a_rows = a_rows;
  g.box_stride = TILE;
  g.tile_cols = 4 * TILE;
  return g;
}

}  // namespace sm90cell
}  // namespace
