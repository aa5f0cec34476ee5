// Fused additive (Bahdanau) attention, one query row per key row.
//
// Replaces the TPU kernel of captionkit/ops/attention.py
// (fused_additive_attention, which captionkit/nn/dispatch.py returns with
// use_pallas=True):
//   qa  = q Wq                               (bf16 operands, fp32 sum)
//   e   = tanh(keys + qa + b);  s = e . v    (fp32)
//   s   = -1e9 at positions >= the row's valid count (a prefix mask)
//   w   = softmax(s)                         (fp32, written fp32)
//   ctx = sum_n w_n values_n                 (w fp32, values bf16 -> fp32)
//
// What bounds it on the H100: the values. EditNet's visual attention at
// the greedy step reads 512 rows x 36 regions x 2048 features in bf16
// (75.5 MB) and 18.9 MB of keys for 0.54 GFLOP of query product, 9.4 M
// tanh and 75 MFLOP of context: bytes, 0.03 ms at 3.35 TB/s. The masked
// SCMA and DCNet text attentions (22 positions x 1024) need the keys and
// values of the valid positions only, and are bound the same way.
//
// Design (bf16, two launches on one stream):
// 1. query_kernel: the query product on sm90_cell.cuh's TMA ring and
//    register-A wgmma (an fp32 query rounded to bf16 in registers), each
//    128 x 128 tile split over K into up to 4 CTAs that write fp32
//    partials: 64 CTAs at 512 rows, where one a tile would be 16 and each
//    stream 4x the bytes. Its CTAs let the second launch start at once
//    (programmatic dependent launch).
// 2. context_kernel, persistent: 3 CTAs an SM walk the rows (row r goes to
//    CTA r mod grid). One producer thread streams each row's keys and then
//    its values into a ring of 4 x 14 KB shared-memory stages with TMA bulk
//    copies completing on mbarriers, and fills the ring from the start of
//    the call, while the product runs. Only the keys of the valid prefix
//    are read, and only the
//    values whose weights are not exactly 0: the valid prefix, or all P
//    positions of a row with none valid (uniform weights, as the
//    reference's softmax over -1e9 gives). Four consumer warps wait for the
//    product once (griddepcontrol.wait), then, per row: add its qa
//    partials (copied in by cp.async during the row before); each warp
//    scores two positions of a key stage at a time (qa, b and v of a lane's
//    8 + 8 columns in registers, keys as 16-byte shared-memory reads, tanh
//    as ex2 and rcp: sm90_common.cuh's tanh_ex2), reduced over A with
//    shuffles; one warp takes the softmax; then each thread owns 8 columns
//    of a 1024-column group and sums w_n values_n over the positions of
//    each value stage, the 128 threads split into position groups when the
//    group is narrower (96 columns: ten groups), whose partial sums meet in
//    shared memory.
// Two launches beat one because the product wants wgmma tiles of 64 rows
// and more (8 row tiles at 512 rows) while the context wants every SM's
// memory pipe: one launch would stream 75 MB through a few row tiles or
// run the product in every row's CTA.
//
// fp32 (compute_dtype="float32"): the query product runs as
// cell_common.cuh's fp32 tile (fp32 FMA, not TF32), then attention_kernel
// (one 256-thread block a row: scores, softmax, context) reads fp32 keys
// and values.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cell_common.cuh"
#include "sm90_cell.cuh"

namespace {

constexpr float NEG_INF = -1e9f;  // captionkit nn/masking.py
// Today's limit on the rows' widths and positions: the fp32 instance's
// per-row shared memory, 4 (3 Ap + P) bytes.
constexpr int AT_SMEM_LIMIT = 48 * 1024;

// ---------------------------------------------------------------------------
// bf16: query_kernel, the query product split over K
// ---------------------------------------------------------------------------

// A 128 x 128 tile of the query product is `split` CTAs (1, 2 or
// QK_SPLIT: as many as one wave of CTAs holds; the wrapper picks it and
// sizes qa for it, kernels/attention.py::query_split): CTA c runs
// sm90_cell.cuh's products over operand c, the K range [c Kc, c Kc + Kc)
// of q and Wq (Kc = Qp / split), and stores its fp32 partial tile as
// partial c of qa [split, B, A]; context_kernel adds the partials in rank
// order. At 512 rows that
// is 64 CTAs where one K range a tile would be 16, each streaming a
// quarter of the bytes (one CTA's TMA ring moves some 64 GB/s; PERF.md).
// The CTAs let the context launch start at once.
constexpr int QK_SPLIT = 4;

template <uint32_t F32>
__global__ void __launch_bounds__(sm90cell::THREADS, 1)
    query_kernel(const __grid_constant__ sm90cell::CellArgs args) {
  using namespace sm90cell;
  sm90::launch_dependents();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int split = gridDim.x / (args.cols / 128);
  const int rank = blockIdx.x % split;
  const int nb = blockIdx.x / split;
  const int row0 = blockIdx.y * BM;

  if (threadIdx.x == 0) init_ring(full, empty);
  __syncthreads();

  if (wg == 2) {
    if (threadIdx.x == 256) {
      int it = 0;
      if (rank == 0)
        produce_op<F32, 15u, 0u, 0>(args, smem, full, empty, it, row0, nb);
      if (rank == 1)
        produce_op<F32, 15u, 0u, 1>(args, smem, full, empty, it, row0, nb);
      if (rank == 2)
        produce_op<F32, 15u, 0u, 2>(args, smem, full, empty, it, row0, nb);
      if (rank == 3)
        produce_op<F32, 15u, 0u, 3>(args, smem, full, empty, it, row0, nb);
    }
    return;
  }
  Ring ring{smem, full, empty, 0, -1, lane};
  const int q = lane % 4;
  const int row = wg * 64 + (warp % 4) * 16 + lane / 4;
  float acc[64], accr[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  fence_regs(acc);
  if (rank == 0) consume_op<F32, 15u, 0u, 0>(args, ring, row, q, acc, accr);
  if (rank == 1) consume_op<F32, 15u, 0u, 1>(args, ring, row, q, acc, accr);
  if (rank == 2) consume_op<F32, 15u, 0u, 2>(args, ring, row, q, acc, accr);
  if (rank == 3) consume_op<F32, 15u, 0u, 3>(args, ring, row, q, acc, accr);
  fence_regs(acc);
  // Partial `rank`: column nb * 128 + 8 j + 2 q + e of rows gr, gr + 8.
  float* out = static_cast<float*>(args.out) +
               (size_t)rank * args.N * args.cols;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int gr = row0 + row + 8 * hr;
    if (gr >= args.N) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(out + (size_t)gr * args.cols + nb * 128 +
                                 8 * j + 2 * q) =
          make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
  }
}

// The partials of qa = q Wq on query_kernel: q [B, Qp] (fp32, rounded to
// bf16 in registers, or bf16), Wq [Qp, Ap] bf16; operand c is the columns
// [c Kc, c Kc + Kc) of q (row stride Qp) and the rows [c Kc, c Kc + Kc) of
// Wq.
cudaError_t query_product(const void* q, int q_f32, const void* wq,
                          void* parts, int B, int Qp, int Ap, int split,
                          cudaStream_t s) {
  using namespace sm90cell;
  const int Kc = Qp / split;  // a multiple of 8: Qp is one of 32
  const int elem = q_f32 ? 4 : 2;
  CellArgs g = plain_args(B, Ap);
  for (int c = 0; c < split; ++c) {
    const auto* qc =
        static_cast<const unsigned char*>(q) + (size_t)c * Kc * elem;
    CK_TRY(q_f32 ? sm90::tensor_map_2d(&g.a[c], qc,
                                       CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B,
                                       Kc, Qp, BM, 32,
                                       CU_TENSOR_MAP_SWIZZLE_128B)
                 : sm90::tensor_map_2d(&g.a[c], qc,
                                       CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B,
                                       Kc, Qp, BM, 32,
                                       CU_TENSOR_MAP_SWIZZLE_64B));
    CK_TRY(weight_map(
        &g.w[c], static_cast<const __nv_bfloat16*>(wq) + (size_t)c * Kc * Ap,
        Kc, Ap));
    g.steps[c] = (Kc + BK - 1) / BK;
  }
  g.out = parts;
  auto* kernel = q_f32 ? query_kernel<15u> : query_kernel<0u>;
  static bool sized[2][sm90::kDevices] = {};
  const int dev = sm90::device_slot();
  if (dev < 0 || !sized[q_f32][dev]) {
    CK_TRY(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM));
    if (dev >= 0) sized[q_f32][dev] = true;
  }
  const dim3 grid(split * (Ap / 128), (B + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM, s>>>(g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: context_kernel
// ---------------------------------------------------------------------------

constexpr int CX_CONSUMERS = 128;              // 4 consumer warps
constexpr int CX_WARPS = CX_CONSUMERS / 32;
constexpr int CX_THREADS = CX_CONSUMERS + 32;  // + the producer warp
constexpr int CX_CTAS = 3;                     // resident CTAs an SM
constexpr int CX_STAGE = 14 * 1024;            // bytes of one ring stage
constexpr int CX_STAGES = 4;
constexpr int CX_VCOLS = 8 * CX_CONSUMERS;     // columns of a value group
constexpr int CX_BARRIER = 1;  // the consumers' named barrier
constexpr int CX_AREG = 2;     // 256-column chunks of A kept in registers

struct CtxArgs {
  const float* qa;                 // [split, B, A] fp32 partials
                                   // (launch 1)
  const float* b;                  // [A]
  const float* v;                  // [A]
  const __nv_bfloat16* keys;       // [B, P, A]
  const __nv_bfloat16* values;     // [B, P, V]
  const int* nvalid;               // [B] valid prefix length per row
  float* ctx;                      // [B, V]
  float* w;                        // [B, P]
  int B;
  int P;
  int A;  // a multiple of 128, at most CX_STAGE / 2
  int V;  // a multiple of 8
  int split;  // partials of qa
};

// The dynamic shared memory: the ring, its full and empty barriers, then
// the next row's partial qa rows (copied in while this row runs),
// this row's qa, b, v [A], the groups' partial sums and the scores /
// weights [P].
struct CtxSmem {
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  float* parts;  // [QK_SPLIT, A]
  float* qs;
  float* bs;
  float* vs;
  float* red;  // [CX_CONSUMERS * 8]
  float* ss;
};

__host__ __device__ constexpr size_t ctx_smem_bytes(int A, int P) {
  return (size_t)CX_STAGES * CX_STAGE + 2 * CX_STAGES * 8 +
         4 * ((QK_SPLIT + 3) * (size_t)A + P) + 4 * 8 * CX_CONSUMERS;
}

__device__ __forceinline__ CtxSmem ctx_smem(unsigned char* raw, int A) {
  CtxSmem s;
  s.ring = raw;
  s.full = reinterpret_cast<uint64_t*>(raw + CX_STAGES * CX_STAGE);
  s.empty = s.full + CX_STAGES;
  s.parts = reinterpret_cast<float*>(s.empty + CX_STAGES);
  s.qs = s.parts + QK_SPLIT * A;
  s.bs = s.qs + A;
  s.vs = s.bs + A;
  s.red = s.vs + A;  // 16-byte aligned: A is a multiple of 128
  s.ss = s.red + 8 * CX_CONSUMERS;
  return s;
}

// The positions a row needs: keys for the valid prefix; values for the
// valid prefix, or for all P positions when none is valid (the softmax of
// P equal scores).
struct RowPlan {
  int nk;
  int nval;
};

__device__ __forceinline__ RowPlan row_plan(const CtxArgs& a, int row) {
  int nv = a.nvalid[row];
  nv = nv < 0 ? 0 : (nv > a.P ? a.P : nv);
  return {nv, nv > 0 ? nv : a.P};
}

// The producer's side of a ring slot: wait until the consumers freed it.
__device__ __forceinline__ unsigned char* wait_empty(const CtxSmem& s,
                                                   int it) {
  const int slot = it % CX_STAGES;
  if (it >= CX_STAGES)
    sm90::mbar_wait(&s.empty[slot], ((it / CX_STAGES) - 1) & 1);
  return s.ring + slot * CX_STAGE;
}

// The consumers' side: wait until the slot is full; release() frees it.
__device__ __forceinline__ const __nv_bfloat16* wait_full(const CtxSmem& s,
                                                          int it) {
  const int slot = it % CX_STAGES;
  sm90::mbar_wait(&s.full[slot], (it / CX_STAGES) & 1);
  return reinterpret_cast<const __nv_bfloat16*>(s.ring + slot * CX_STAGE);
}

__device__ __forceinline__ void release(const CtxSmem& s, int it, int lane) {
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(&s.empty[it % CX_STAGES]);
}

// A row's `split` partial qa rows into s.parts by the consumers' 16-byte
// cp.async copies, waited for with cp_async_wait.
__device__ __forceinline__ void copy_qa(const CtxArgs& a, const CtxSmem& s,
                                        int row) {
  for (int e = 4 * threadIdx.x; e < a.split * a.A; e += 4 * CX_CONSUMERS) {
    const int c = e / a.A, col = e % a.A;
    const float* src = a.qa + ((size_t)c * a.B + row) * a.A + col;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     sm90::smem_u32(s.parts + e)),
                 "l"(src)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Eight consecutive bf16 as fp32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = __bfloat162float(h[j]);
}

// One thread streams every stage of the CTA's rows, in the order the
// consumers take them: a row's key stages (kc positions each), then, per
// column group, its value stages (pc positions each, one bulk copy, or one
// a position when the group is narrower than the row).
__device__ void produce(const CtxArgs& a, const CtxSmem& s) {
  const int kc = CX_STAGE / (2 * a.A);
  int it = 0;
  for (int row = blockIdx.x; row < a.B; row += gridDim.x) {
    const RowPlan pl = row_plan(a, row);
    for (int p0 = 0; p0 < pl.nk; p0 += kc, ++it) {
      const int n = min(kc, pl.nk - p0);
      unsigned char* st = wait_empty(s, it);
      uint64_t* bar = &s.full[it % CX_STAGES];
      const uint32_t bytes = 2u * n * a.A;
      sm90::mbar_expect_tx(bar, bytes);
      sm90::bulk_load(st, a.keys + ((size_t)row * a.P + p0) * a.A, bytes,
                      bar);
    }
    for (int c0 = 0; c0 < a.V; c0 += CX_VCOLS) {
      const int cw = min(CX_VCOLS, a.V - c0);
      const int pc = CX_STAGE / (2 * cw);
      for (int p0 = 0; p0 < pl.nval; p0 += pc, ++it) {
        const int n = min(pc, pl.nval - p0);
        unsigned char* st = wait_empty(s, it);
        uint64_t* bar = &s.full[it % CX_STAGES];
        sm90::mbar_expect_tx(bar, 2u * n * cw);
        const __nv_bfloat16* src =
            a.values + ((size_t)row * a.P + p0) * a.V + c0;
        if (cw == a.V) {
          sm90::bulk_load(st, src, 2u * n * cw, bar);
        } else {
          for (int j = 0; j < n; ++j)
            sm90::bulk_load(st + 2 * j * cw, src + (size_t)j * a.V, 2u * cw,
                            bar);
        }
      }
    }
  }
}

// The scores of key positions p0, p1 of a stage (lane's columns 8 lane +
// 256 t + {0..7} with qa, b and v in registers), two chains at once.
__device__ __forceinline__ void score_pair(
    const __nv_bfloat16* k0, const __nv_bfloat16* k1, int A, int lane,
    const float (&qr)[CX_AREG][8], const float (&br)[CX_AREG][8],
    const float (&vr)[CX_AREG][8], float& acc0, float& acc1) {
#pragma unroll
  for (int t = 0; t < CX_AREG; ++t) {
    const int col = lane * 8 + 256 * t;
    if (col >= A) break;
    float x0[8], x1[8];
    load8(k0 + col, x0);
    load8(k1 + col, x1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc0 += sm90::tanh_ex2(x0[j] + qr[t][j] + br[t][j]) * vr[t][j];
      acc1 += sm90::tanh_ex2(x1[j] + qr[t][j] + br[t][j]) * vr[t][j];
    }
  }
}

__device__ void consume(const CtxArgs& a, const CtxSmem& s) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int A = a.A, P = a.P, V = a.V;
  const int kc = CX_STAGE / (2 * A);
  // A <= 256 CX_AREG: each lane keeps qa, b and v of its key columns
  // (lane * 8 + 256 t + {0..7}) in registers for the row.
  const bool in_regs = A <= 256 * CX_AREG;
  float qr[CX_AREG][8], br[CX_AREG][8], vr[CX_AREG][8];
  for (int e = tid; e < A; e += CX_CONSUMERS) {
    s.bs[e] = a.b[e];
    s.vs[e] = a.v[e];
  }
  sm90::grid_dependency_wait();  // qa is the query launch's output
  if (blockIdx.x < a.B) copy_qa(a, s, blockIdx.x);
  const float* qs = s.qs;
  int it = 0;
  for (int row = blockIdx.x; row < a.B; row += gridDim.x) {
    const RowPlan pl = row_plan(a, row);
    cp_async_wait();
    sm90::named_sync(CX_BARRIER, CX_CONSUMERS);
    for (int e = tid; e < A; e += CX_CONSUMERS) {
      float x = s.parts[e];
      for (int c = 1; c < a.split; ++c) x += s.parts[c * A + e];
      s.qs[e] = x;
    }
    sm90::named_sync(CX_BARRIER, CX_CONSUMERS);
    // The next row's partials come in while this one runs.
    if (row + gridDim.x < a.B) copy_qa(a, s, row + gridDim.x);
    if (in_regs) {
#pragma unroll
      for (int t = 0; t < CX_AREG; ++t)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = min(lane * 8 + 256 * t + j, A - 1);
          qr[t][j] = qs[col];
          br[t][j] = s.bs[col];
          vr[t][j] = s.vs[col];
        }
    }

    // Scores of the valid prefix, a key stage at a time: warp w takes
    // the stage's positions w, w + 4, ..., two at a time.
    for (int p0 = 0; p0 < pl.nk; p0 += kc, ++it) {
      const int n = min(kc, pl.nk - p0);
      const __nv_bfloat16* st = wait_full(s, it);
      for (int p = warp; p < n; p += 2 * CX_WARPS) {
        const int q = p + CX_WARPS < n ? p + CX_WARPS : p;  // p again
        float acc0 = 0.0f, acc1 = 0.0f;
        if (in_regs) {
          score_pair(st + (size_t)p * A, st + (size_t)q * A, A, lane, qr, br,
                     vr, acc0, acc1);
        } else {
          for (int a0 = lane * 8; a0 < A; a0 += 32 * 8) {
            float x0[8], x1[8];
            load8(st + (size_t)p * A + a0, x0);
            load8(st + (size_t)q * A + a0, x1);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              acc0 += sm90::tanh_ex2(x0[j] + qs[a0 + j] + s.bs[a0 + j]) *
                      s.vs[a0 + j];
              acc1 += sm90::tanh_ex2(x1[j] + qs[a0 + j] + s.bs[a0 + j]) *
                      s.vs[a0 + j];
            }
          }
        }
        acc0 = cell::warp_sum(acc0);
        acc1 = cell::warp_sum(acc1);
        if (lane == 0) {
          s.ss[p0 + p] = acc0;
          s.ss[p0 + q] = acc1;
        }
      }
      release(s, it, lane);
    }
    for (int p = pl.nk + tid; p < P; p += CX_CONSUMERS) s.ss[p] = NEG_INF;
    sm90::named_sync(CX_BARRIER, CX_CONSUMERS);

    if (warp == 0) {
      float m = -INFINITY;
      for (int p = lane; p < P; p += 32) m = fmaxf(m, s.ss[p]);
      m = cell::warp_max(m);
      float sum = 0.0f;
      for (int p = lane; p < P; p += 32) sum += expf(s.ss[p] - m);
      sum = cell::warp_sum(sum);
      for (int p = lane; p < P; p += 32) {
        const float wt = expf(s.ss[p] - m) / sum;
        s.ss[p] = wt;
        a.w[(size_t)row * P + p] = wt;
      }
    }
    sm90::named_sync(CX_BARRIER, CX_CONSUMERS);

    // The context, a column group at a time: thread (grp, col) sums the
    // positions grp, grp + G, ... of each value stage for columns
    // 8 col .. 8 col + 7 of the group.
    for (int c0 = 0; c0 < V; c0 += CX_VCOLS) {
      const int cw = min(CX_VCOLS, V - c0);
      const int pc = CX_STAGE / (2 * cw);
      const int n8 = cw / 8;
      const int G = CX_CONSUMERS / n8;
      const int col = tid % n8, grp = tid / n8;
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
      for (int p0 = 0; p0 < pl.nval; p0 += pc, ++it) {
        const int n = min(pc, pl.nval - p0);
        const __nv_bfloat16* st = wait_full(s, it);
        if (grp < G) {
          for (int j = grp; j < n; j += G) {
            const float wt = s.ss[p0 + j];
            float val[8];
            load8(st + (size_t)j * cw + 8 * col, val);
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[k] += wt * val[k];
          }
        }
        release(s, it, lane);
      }
      float* out = a.ctx + (size_t)row * V + c0 + 8 * col;
      if (G == 1) {  // one position group: its threads write their sums
        if (grp == 0) {
          *reinterpret_cast<float4*>(out) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
          *reinterpret_cast<float4*>(out + 4) =
              make_float4(acc[4], acc[5], acc[6], acc[7]);
        }
        continue;
      }
      if (grp < G) {
        float* r = s.red + 8 * (grp * n8 + col);
        *reinterpret_cast<float4*>(r) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
        *reinterpret_cast<float4*>(r + 4) =
            make_float4(acc[4], acc[5], acc[6], acc[7]);
      }
      sm90::named_sync(CX_BARRIER, CX_CONSUMERS);
      if (tid < n8) {
        float sum[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) sum[k] = 0.0f;
        for (int g = 0; g < G; ++g) {
          const float* r = s.red + 8 * (g * n8 + tid);
#pragma unroll
          for (int k = 0; k < 8; ++k) sum[k] += r[k];
        }
        *reinterpret_cast<float4*>(out) =
            make_float4(sum[0], sum[1], sum[2], sum[3]);
        *reinterpret_cast<float4*>(out + 4) =
            make_float4(sum[4], sum[5], sum[6], sum[7]);
      }
      sm90::named_sync(CX_BARRIER, CX_CONSUMERS);
    }
    // The next row rewrites qs and ss.
    sm90::named_sync(CX_BARRIER, CX_CONSUMERS);
  }
}

__global__ void __launch_bounds__(CX_THREADS, CX_CTAS)
    context_kernel(const __grid_constant__ CtxArgs a) {
  extern __shared__ __align__(128) unsigned char ctx_smem_raw[];
  const CtxSmem s = ctx_smem(ctx_smem_raw, a.A);
  if (threadIdx.x == 0) {
    for (int i = 0; i < CX_STAGES; ++i) {
      sm90::mbar_init(&s.full[i], 1);
      sm90::mbar_init(&s.empty[i], CX_WARPS);  // one arrival a warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= CX_CONSUMERS) {
    if (threadIdx.x == CX_CONSUMERS) produce(a, s);
    return;
  }
  consume(a, s);
}

// The two bf16 launches: the query product's `a.split` partials (a
// programmatic primary), then context_kernel on as many CTAs as the SMs
// hold (CX_CTAS an SM at the paths' widths), as a programmatic dependent.
cudaError_t attention_bf16(const void* q, int q_f32, const void* wq,
                           CtxArgs a, void* qa, int Qp, int device,
                           cudaStream_t s) {
  if (a.A > CX_STAGE / 2) return cudaErrorInvalidValue;
  CK_TRY(query_product(q, q_f32, wq, qa, a.B, Qp, a.A, a.split, s));

  // On each device: the kernel's shared-memory limit, set for the largest
  // size seen, and the resident CTAs at the last size counted.
  const size_t smem = ctx_smem_bytes(a.A, a.P);
  static size_t sizes[sm90::kDevices] = {}, counts[sm90::kDevices] = {};
  static int residents[sm90::kDevices] = {};
  const int dev = sm90::device_slot();
  size_t spare_size = 0, spare_count = 0;
  int spare_resident = 0;
  size_t& sized = dev < 0 ? spare_size : sizes[dev];
  size_t& counted = dev < 0 ? spare_count : counts[dev];
  int& resident = dev < 0 ? spare_resident : residents[dev];
  if (smem > sized) {
    CK_TRY(cudaFuncSetAttribute(context_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem));
    sized = smem;
  }
  if (smem != counted) {
    int sms = 0, per_sm = 0;
    CK_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device));
    CK_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, context_kernel, CX_THREADS, smem));
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = per_sm * sms;
    counted = smem;
  }
  const int grid = a.B < resident ? a.B : resident;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(CX_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  CK_TRY(cudaLaunchKernelEx(&cfg, context_kernel, a));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: attention_kernel
// ---------------------------------------------------------------------------

constexpr int AT_THREADS = 256;  // 8 warps
constexpr int AT_WARPS = AT_THREADS / 32;

struct AttArgs {
  const float* qa;      // [B, A] fp32 (the query product)
  const float* b;       // [A]
  const float* v;       // [A]
  const float* keys;    // [B, P, A]
  const float* values;  // [B, P, V]
  const int* nvalid;    // [B] valid prefix length per row
  float* ctx;           // [B, V]
  float* w;             // [B, P]
  int P;
  int A;  // a multiple of 8
  int V;  // a multiple of 8
};

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
  x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
}

// One block per row: each warp takes key positions and reduces
// tanh(k + qa + b) . v over A with shuffles; one warp takes the softmax;
// then every thread owns 8 value columns and sums w_n values_n.
__global__ void __launch_bounds__(AT_THREADS)
    attention_kernel(const __grid_constant__ AttArgs a) {
  extern __shared__ float sm[];
  const int A = a.A, P = a.P, V = a.V;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* qs = sm;      // [A]
  float* bs = qs + A;  // [A]
  float* vs = bs + A;  // [A]
  float* ss = vs + A;  // [P] scores, then weights

  for (int e = tid; e < A; e += AT_THREADS) {
    qs[e] = a.qa[(size_t)row * A + e];
    bs[e] = a.b[e];
    vs[e] = a.v[e];
  }
  __syncthreads();

  const int nv = a.nvalid[row];
  for (int p = warp; p < P; p += AT_WARPS) {
    if (p >= nv) {
      if (lane == 0) ss[p] = NEG_INF;
      continue;
    }
    const float* kr = a.keys + ((size_t)row * P + p) * A;
    float acc = 0.0f;
    for (int a0 = lane * 8; a0 < A; a0 += 32 * 8) {
      float kv[8];
      load8(kr + a0, kv);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc += tanhf(kv[j] + qs[a0 + j] + bs[a0 + j]) * vs[a0 + j];
    }
    acc = cell::warp_sum(acc);
    if (lane == 0) ss[p] = acc;
  }
  __syncthreads();

  if (warp == 0) {
    float m = -INFINITY;
    for (int p = lane; p < P; p += 32) m = fmaxf(m, ss[p]);
    m = cell::warp_max(m);
    float sum = 0.0f;
    for (int p = lane; p < P; p += 32) sum += expf(ss[p] - m);
    sum = cell::warp_sum(sum);
    for (int p = lane; p < P; p += 32) {
      const float w = expf(ss[p] - m) / sum;
      ss[p] = w;
      a.w[(size_t)row * P + p] = w;
    }
  }
  __syncthreads();

  const float* vr = a.values + (size_t)row * P * V;
  for (int c0 = tid * 8; c0 < V; c0 += AT_THREADS * 8) {
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
    for (int p = 0; p < P; ++p) {
      const float w = ss[p];
      float val[8];
      load8(vr + (size_t)p * V + c0, val);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += w * val[j];
    }
    float* out = a.ctx + (size_t)row * V + c0;
    *reinterpret_cast<float4*>(out) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(out + 4) =
        make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

cudaError_t attention_f32(const void* q, const void* wq, const AttArgs& a,
                          void* qa, int B, int Qp, cudaStream_t s) {
  cell::GemmArgs gq = cell::gemm_args(B, a.A);
  gq.op[0] = cell::operand(q, Qp, wq);
  gq.n_ops = 1;
  gq.out = qa;
  const cudaError_t err = cell::launch_gemm<4, cell::EPI_STORE>(gq, s);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * (3 * (size_t)a.A + a.P);
  attention_kernel<<<B, AT_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Qp] (fp32 if q_f32 else bf16); wq [Qp, Ap]; fp32 b, v [Ap]; keys
// [B, P, Ap], values [B, P, V]; int32 nvalid [B]. wq, keys and values are
// bf16, or fp32 when f32 (then q is fp32 too). Outputs ctx [B, V] fp32, w
// [B, P] fp32. Scratch: qa [split, B, Ap] fp32 (the bf16 query
// product's K-range partials, split 1, 2 or ck_attention_query_split();
// fp32 takes split 1). Qp a multiple of 32, Ap of 128, V of 8; 4 (3 Ap +
// P) bytes at most AT_SMEM_LIMIT. Two launches.
int ck_additive_attention(const void* q, const void* wq, const void* b,
                          const void* v, const void* keys, const void* values,
                          const void* nvalid, void* ctx, void* w, void* qa,
                          int B, int Qp, int Ap, int P, int V, int q_f32,
                          int f32, int split, int device, void* stream) {
  if (f32 && !q_f32) return (int)cudaErrorInvalidValue;
  if (split < 1 || split > (f32 ? 1 : QK_SPLIT) || (split & (split - 1)))
    return (int)cudaErrorInvalidValue;
  if (B < 1 || P < 1 || V < 8 || V % 8 || Ap < 128 || Ap % 128 || Qp < 32 ||
      Qp % 32)
    return (int)cudaErrorInvalidValue;
  if (sizeof(float) * (3 * (size_t)Ap + P) > AT_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    AttArgs a;
    a.qa = static_cast<const float*>(qa);
    a.b = cell::f32(b);
    a.v = cell::f32(v);
    a.keys = static_cast<const float*>(keys);
    a.values = static_cast<const float*>(values);
    a.nvalid = static_cast<const int*>(nvalid);
    a.ctx = static_cast<float*>(ctx);
    a.w = static_cast<float*>(w);
    a.P = P;
    a.A = Ap;
    a.V = V;
    return (int)attention_f32(q, wq, a, qa, B, Qp, s);
  }
  CtxArgs a;
  a.qa = static_cast<const float*>(qa);
  a.b = cell::f32(b);
  a.v = cell::f32(v);
  a.keys = static_cast<const __nv_bfloat16*>(keys);
  a.values = static_cast<const __nv_bfloat16*>(values);
  a.nvalid = static_cast<const int*>(nvalid);
  a.ctx = static_cast<float*>(ctx);
  a.w = static_cast<float*>(w);
  a.B = B;
  a.P = P;
  a.A = Ap;
  a.V = V;
  a.split = split;
  return (int)attention_bf16(q, q_f32, wq, a, qa, Qp, device, s);
}

const char* ck_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The width the Python side pads A (the query product's columns) to.
int ck_attention_width() { return 4 * cell::BN; }

// The most K ranges of the bf16 query product (partials of the scratch
// qa).
int ck_attention_query_split() { return QK_SPLIT; }

}  // extern "C"
