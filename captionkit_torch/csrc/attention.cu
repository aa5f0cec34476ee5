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
// Design (bf16, two launches on one stream; fp32 below):
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
// fp32 (compute_dtype="float32"; fp32 keys, values and products, the FMA
// on the CUDA cores, not TF32), the same two launches:
// 1. cell_common.cuh's fp32 tile, split over K into the ranges (whole
//    stages of 32) that fill the card best (cell::plain_split: 4 at 512
//    rows, 64 CTAs where one a tile would be 16 each running all 1024 K),
//    each CTA storing its fp32 partial and letting context_kernel start at
//    once;
// 2. context_kernel<float>: the bf16 design on the same ring geometry
//    (4 x 14 KB stages, 3 CTAs an SM: the bytes in flight an SM are what
//    they are in bf16, and a stage holds half the positions: 7 keys of A =
//    512, 3 value positions of a 1024-column group, 12 of its 14 KB). A
//    lane keeps 4 + 4 + 4 + 4 key columns (4 lane + 128 t) and a thread 4
//    + 4 value columns (4 col and 4 (col + 128)), so each 16-byte load of a
//    warp reads 512 contiguous bytes of shared memory. The scores take the
//    accurate tanhf, as the plain version does (tanh_ex2's 3e-7 would
//    count against the fp32 bar of 1e-5).
// What bounds it: the bytes, twice bf16's (151 MB of values, 37.7 MB of
// keys and 8 MB of query, weights and context at the greedy step: 0.059
// ms), not the product (0.54 GFLOP, 0.008 ms at 67 TFLOP/s).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cell_common.cuh"
#include "sm90_cell.cuh"

namespace {

constexpr float NEG_INF = -1e9f;  // captionkit nn/masking.py

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
// context_kernel (bf16 and fp32 keys and values)
// ---------------------------------------------------------------------------

constexpr int CX_CONSUMERS = 128;              // 4 consumer warps
constexpr int CX_WARPS = CX_CONSUMERS / 32;
constexpr int CX_THREADS = CX_CONSUMERS + 32;  // + the producer warp
constexpr int CX_CTAS = 3;                     // resident CTAs an SM
constexpr int CX_STAGE = 14 * 1024;            // bytes of one ring stage
constexpr int CX_STAGES = 4;
constexpr int CX_VCOLS = 8 * CX_CONSUMERS;     // columns of a value group
constexpr int CX_BARRIER = 1;  // the consumers' named barrier
constexpr int CX_AKEEP = 512;  // key columns whose qa, b, v stay in registers

// A lane's key columns for element type T: VEC (one 16-byte load) at
// VEC lane + CHUNK t, t < AREG (bf16: 8 lane + 256 t, t < 2; fp32: 4 lane
// + 128 t, t < 4, so each load of a warp reads 512 contiguous bytes).
template <typename T>
struct Lanes {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int CHUNK = 32 * VEC;
  static constexpr int AREG = CX_AKEEP / CHUNK;
};

template <typename T>
struct CtxArgs {
  const float* qa;   // [split, B, A] fp32 partials (launch 1)
  const float* b;    // [A]
  const float* v;    // [A]
  const T* keys;     // [B, P, A]
  const T* values;   // [B, P, V]
  const int* nvalid; // [B] valid prefix length per row
  float* ctx;        // [B, V]
  float* w;          // [B, P]
  int B;
  int P;
  int A;      // a multiple of 128, at most CX_STAGE / sizeof(T)
  int V;      // a multiple of 8
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

template <typename T>
__device__ __forceinline__ RowPlan row_plan(const CtxArgs<T>& a, int row) {
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
template <typename T>
__device__ __forceinline__ const T* wait_full(const CtxSmem& s, int it) {
  const int slot = it % CX_STAGES;
  sm90::mbar_wait(&s.full[slot], (it / CX_STAGES) & 1);
  return reinterpret_cast<const T*>(s.ring + slot * CX_STAGE);
}

__device__ __forceinline__ void release(const CtxSmem& s, int it, int lane) {
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(&s.empty[it % CX_STAGES]);
}

// A row's `split` partial qa rows into s.parts by the consumers' 16-byte
// cp.async copies, waited for with cp_async_wait.
template <typename T>
__device__ __forceinline__ void copy_qa(const CtxArgs<T>& a,
                                        const CtxSmem& s, int row) {
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

// One 16-byte load as fp32: eight bf16, or four fp32.
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = __bfloat162float(h[j]);
}

__device__ __forceinline__ void loadv(const float* p, float (&x)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  x[0] = r.x, x[1] = r.y, x[2] = r.z, x[3] = r.w;
}

// Thread `col` of a value group of 8 n8 columns owns eight of them: bf16
// 8 col .. 8 col + 7 (one 16-byte load); fp32 4 col .. 4 col + 3 and 4 (col
// + n8) .. 4 (col + n8) + 3 (two, each a warp's 512 contiguous bytes).
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, int col,
                                          int, float (&x)[8]) {
  loadv(p + 8 * col, x);
}

__device__ __forceinline__ void load_cols(const float* p, int col, int n8,
                                          float (&x)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p + 4 * col);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4 * (col + n8));
  x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
  x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
}

template <typename T>
__device__ __forceinline__ void store_cols(float* out, int col, int n8,
                                           const float (&x)[8]) {
  float* lo = out + (sizeof(T) == 2 ? 8 * col : 4 * col);
  float* hi = sizeof(T) == 2 ? lo + 4 : out + 4 * (col + n8);
  *reinterpret_cast<float4*>(lo) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(hi) = make_float4(x[4], x[5], x[6], x[7]);
}

// The scores' tanh: bf16 tanh_ex2 (ex2 and rcp); fp32 the accurate tanhf,
// as the plain version takes it.
template <typename T>
__device__ __forceinline__ float score_tanh(float x) {
  if constexpr (sizeof(T) == 2)
    return sm90::tanh_ex2(x);
  else
    return tanhf(x);
}

// One thread streams every stage of the CTA's rows, in the order the
// consumers take them: a row's key stages (kc positions each), then, per
// column group, its value stages (pc positions each, one bulk copy, or one
// a position when the group is narrower than the row).
template <typename T>
__device__ void produce(const CtxArgs<T>& a, const CtxSmem& s) {
  constexpr int E = sizeof(T);
  const int kc = CX_STAGE / (E * a.A);
  int it = 0;
  for (int row = blockIdx.x; row < a.B; row += gridDim.x) {
    const RowPlan pl = row_plan(a, row);
    for (int p0 = 0; p0 < pl.nk; p0 += kc, ++it) {
      const int n = min(kc, pl.nk - p0);
      unsigned char* st = wait_empty(s, it);
      uint64_t* bar = &s.full[it % CX_STAGES];
      const uint32_t bytes = (uint32_t)E * n * a.A;
      sm90::mbar_expect_tx(bar, bytes);
      sm90::bulk_load(st, a.keys + ((size_t)row * a.P + p0) * a.A, bytes,
                      bar);
    }
    for (int c0 = 0; c0 < a.V; c0 += CX_VCOLS) {
      const int cw = min(CX_VCOLS, a.V - c0);
      const int pc = CX_STAGE / (E * cw);
      for (int p0 = 0; p0 < pl.nval; p0 += pc, ++it) {
        const int n = min(pc, pl.nval - p0);
        unsigned char* st = wait_empty(s, it);
        uint64_t* bar = &s.full[it % CX_STAGES];
        sm90::mbar_expect_tx(bar, (uint32_t)E * n * cw);
        const T* src = a.values + ((size_t)row * a.P + p0) * a.V + c0;
        if (cw == a.V) {
          sm90::bulk_load(st, src, (uint32_t)E * n * cw, bar);
        } else {
          for (int j = 0; j < n; ++j)
            sm90::bulk_load(st + E * j * cw, src + (size_t)j * a.V,
                            (uint32_t)E * cw, bar);
        }
      }
    }
  }
}

// The scores of key positions p0, p1 of a stage (the lane's columns with
// qa, b and v in registers), two chains at once.
template <typename T>
__device__ __forceinline__ void score_pair(
    const T* k0, const T* k1, int A, int lane,
    const float (&qr)[Lanes<T>::AREG][Lanes<T>::VEC],
    const float (&br)[Lanes<T>::AREG][Lanes<T>::VEC],
    const float (&vr)[Lanes<T>::AREG][Lanes<T>::VEC], float& acc0,
    float& acc1) {
  using L = Lanes<T>;
#pragma unroll
  for (int t = 0; t < L::AREG; ++t) {
    const int col = lane * L::VEC + L::CHUNK * t;
    if (col >= A) break;
    float x0[L::VEC], x1[L::VEC];
    loadv(k0 + col, x0);
    loadv(k1 + col, x1);
#pragma unroll
    for (int j = 0; j < L::VEC; ++j) {
      acc0 += score_tanh<T>(x0[j] + qr[t][j] + br[t][j]) * vr[t][j];
      acc1 += score_tanh<T>(x1[j] + qr[t][j] + br[t][j]) * vr[t][j];
    }
  }
}

template <typename T>
__device__ void consume(const CtxArgs<T>& a, const CtxSmem& s) {
  using L = Lanes<T>;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int A = a.A, P = a.P, V = a.V;
  const int kc = CX_STAGE / ((int)sizeof(T) * A);
  // A <= CX_AKEEP: each lane keeps qa, b and v of its key columns in
  // registers for the row.
  const bool in_regs = A <= CX_AKEEP;
  float qr[L::AREG][L::VEC], br[L::AREG][L::VEC], vr[L::AREG][L::VEC];
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
      for (int t = 0; t < L::AREG; ++t)
#pragma unroll
        for (int j = 0; j < L::VEC; ++j) {
          const int col = min(lane * L::VEC + L::CHUNK * t + j, A - 1);
          qr[t][j] = qs[col];
          br[t][j] = s.bs[col];
          vr[t][j] = s.vs[col];
        }
    }

    // Scores of the valid prefix, a key stage at a time: warp w takes
    // the stage's positions w, w + 4, ..., two at a time.
    for (int p0 = 0; p0 < pl.nk; p0 += kc, ++it) {
      const int n = min(kc, pl.nk - p0);
      const T* st = wait_full<T>(s, it);
      for (int p = warp; p < n; p += 2 * CX_WARPS) {
        const int q = p + CX_WARPS < n ? p + CX_WARPS : p;  // p again
        float acc0 = 0.0f, acc1 = 0.0f;
        if (in_regs) {
          score_pair<T>(st + (size_t)p * A, st + (size_t)q * A, A, lane, qr,
                        br, vr, acc0, acc1);
        } else {
          for (int a0 = lane * L::VEC; a0 < A; a0 += L::CHUNK) {
            float x0[L::VEC], x1[L::VEC];
            loadv(st + (size_t)p * A + a0, x0);
            loadv(st + (size_t)q * A + a0, x1);
#pragma unroll
            for (int j = 0; j < L::VEC; ++j) {
              acc0 += score_tanh<T>(x0[j] + qs[a0 + j] + s.bs[a0 + j]) *
                      s.vs[a0 + j];
              acc1 += score_tanh<T>(x1[j] + qs[a0 + j] + s.bs[a0 + j]) *
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
    // positions grp, grp + G, ... of each value stage for its 8 columns
    // of the group (load_cols).
    for (int c0 = 0; c0 < V; c0 += CX_VCOLS) {
      const int cw = min(CX_VCOLS, V - c0);
      const int pc = CX_STAGE / ((int)sizeof(T) * cw);
      const int n8 = cw / 8;
      const int G = CX_CONSUMERS / n8;
      const int col = tid % n8, grp = tid / n8;
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
      for (int p0 = 0; p0 < pl.nval; p0 += pc, ++it) {
        const int n = min(pc, pl.nval - p0);
        const T* st = wait_full<T>(s, it);
        if (grp < G) {
          for (int j = grp; j < n; j += G) {
            const float wt = s.ss[p0 + j];
            float val[8];
            load_cols(st + (size_t)j * cw, col, n8, val);
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[k] += wt * val[k];
          }
        }
        release(s, it, lane);
      }
      float* out = a.ctx + (size_t)row * V + c0;
      if (G == 1) {  // one position group: its threads write their sums
        if (grp == 0) store_cols<T>(out, col, n8, acc);
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
        store_cols<T>(out, tid, n8, sum);
      }
      sm90::named_sync(CX_BARRIER, CX_CONSUMERS);
    }
    // The next row rewrites qs and ss.
    sm90::named_sync(CX_BARRIER, CX_CONSUMERS);
  }
}

template <typename T>
__global__ void __launch_bounds__(CX_THREADS, CX_CTAS)
    context_kernel(const __grid_constant__ CtxArgs<T> a) {
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

// context_kernel on as many CTAs as the SMs hold (CX_CTAS an SM at the
// paths' widths), as a programmatic dependent of the query product.
template <typename T>
cudaError_t launch_context(const CtxArgs<T>& a, int device, cudaStream_t s) {
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
    CK_TRY(cudaFuncSetAttribute(context_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem));
    sized = smem;
  }
  if (smem != counted) {
    int sms = 0, per_sm = 0;
    CK_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device));
    CK_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, context_kernel<T>, CX_THREADS, smem));
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
  CK_TRY(cudaLaunchKernelEx(&cfg, context_kernel<T>, a));
  return cudaGetLastError();
}

// bf16: the query product's `a.split` partials on query_kernel (a
// programmatic primary), then context_kernel.
cudaError_t attention_bf16(const void* q, int q_f32, const void* wq,
                           const CtxArgs<__nv_bfloat16>& a, void* qa, int Qp,
                           int device, cudaStream_t s) {
  CK_TRY(query_product(q, q_f32, wq, qa, a.B, Qp, a.A, a.split, s));
  return launch_context(a, device, s);
}

// fp32: the query product's `a.split` partials on cell_common.cuh's fp32
// tile (K ranges of whole stages; a programmatic primary), then
// context_kernel.
cudaError_t attention_f32(const void* q, const void* wq,
                          const CtxArgs<float>& a, void* qa, int Qp,
                          int device, cudaStream_t s) {
  cell::GemmArgs gq = cell::gemm_args(a.B, a.A);
  cell::split_operands(gq, q, Qp, wq, a.split);
  gq.out = qa;
  CK_TRY((cell::launch_gemm<4, cell::EPI_STORE>(gq, s)));
  return launch_context(a, device, s);
}

template <typename T>
CtxArgs<T> ctx_args(const void* b, const void* v, const void* keys,
                    const void* values, const void* nvalid, void* ctx,
                    void* w, const void* qa, int B, int Ap, int P, int V,
                    int split) {
  CtxArgs<T> a;
  a.qa = static_cast<const float*>(qa);
  a.b = cell::f32(b);
  a.v = cell::f32(v);
  a.keys = static_cast<const T*>(keys);
  a.values = static_cast<const T*>(values);
  a.nvalid = static_cast<const int*>(nvalid);
  a.ctx = static_cast<float*>(ctx);
  a.w = static_cast<float*>(w);
  a.B = B;
  a.P = P;
  a.A = Ap;
  a.V = V;
  a.split = split;
  return a;
}

}  // namespace

extern "C" {

// q [B, Qp] (fp32 if q_f32 else bf16); wq [Qp, Ap]; fp32 b, v [Ap]; keys
// [B, P, Ap], values [B, P, V]; int32 nvalid [B]. wq, keys and values are
// bf16, or fp32 when f32 (then q is fp32 too). Outputs ctx [B, V] fp32, w
// [B, P] fp32. Scratch: qa [split, B, Ap] fp32, the query product's
// K-range partials: bf16 split 1, 2 or ck_attention_query_split(); fp32
// any split up to that many and Qp / 32 (the wrappers take
// megastep.cu's ck_f32_split). Qp a multiple of 32, Ap of 128 and at most
// a ring stage's elements (CX_STAGE / 2 bf16, / 4 fp32), V of 8; Ap and P
// as far as context_kernel's shared memory fits on an SM. Two launches.
int ck_additive_attention(const void* q, const void* wq, const void* b,
                          const void* v, const void* keys, const void* values,
                          const void* nvalid, void* ctx, void* w, void* qa,
                          int B, int Qp, int Ap, int P, int V, int q_f32,
                          int f32, int split, int device, void* stream) {
  if (f32 && !q_f32) return (int)cudaErrorInvalidValue;
  if (B < 1 || P < 1 || V < 8 || V % 8 || Ap < 128 || Ap % 128 || Qp < 32 ||
      Qp % 32 || Ap > CX_STAGE / (f32 ? 4 : 2))
    return (int)cudaErrorInvalidValue;
  if (split < 1 || split > QK_SPLIT ||
      (f32 ? split > Qp / cell::BK : (split & (split - 1)) != 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    return (int)attention_f32(
        q, wq,
        ctx_args<float>(b, v, keys, values, nvalid, ctx, w, qa, B, Ap, P, V,
                        split),
        qa, Qp, device, s);
  return (int)attention_bf16(
      q, q_f32, wq,
      ctx_args<__nv_bfloat16>(b, v, keys, values, nvalid, ctx, w, qa, B, Ap,
                              P, V, split),
      qa, Qp, device, s);
}

const char* ck_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The width the Python side pads A (the query product's columns) to.
int ck_attention_width() { return 4 * cell::BN; }

// The most K ranges of the query product (partials of the scratch qa).
int ck_attention_query_split() { return QK_SPLIT; }

}  // extern "C"
