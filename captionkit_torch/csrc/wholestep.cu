// Whole-step kernel: EditNet's lang cell (visual context gate, Copy-LSTM
// base gates, copy gate, c*/c_gen blend) and the vocab head's log-sum-exp
// and top-k, in one launch.
//
// Replaces the TPU kernel of captionkit/ops/wholestep.py
// (fused_lang_head_topk, reached by fused_step_topk under
// model.cell_impl="wholestep"): the megastep lang kernel whose new h_lang,
// rounded to bf16, feeds the fused head's LSE/top-k body without a trip
// through a second program.
//
// Numerics: the cell is ck_lang_cell's (megastep.cu), the head is
// ck_head_topk's with extract="mask" (head_topk.cu): bf16 operands, fp32
// sums, gate math in fp32, ties to the lowest vocab id (the merge is
// head_common.cuh's).
//
// What bounds it on the H100 at N = 2560, H = 1024, F = 2048, V = 9490:
// 2 N H F + 2 N (F + 2H) 4H + 2 N (F + 3H) H = 123.5 GFLOP for the cell and
// 2 N H V = 49.8 GFLOP for the head, 173.3 GFLOP of bf16 products: 0.175 ms
// at 989 TFLOP/s, against ~152 MB of inputs and outputs (0.045 ms):
// operations. What keeps a tile from the tensor-core rate is L2 -> SM
// traffic and one 64-row wgmma chain a warpgroup (sm90_cell.cuh).
//
// Design. On the TPU the grid (row block, vocab tile) runs in order, so the
// cell body runs at vocab tile 0 and parks h_lang in VMEM for the row
// block's later tiles. On Hopper the blocks run in parallel and in no
// order, so this is one persistent cooperative launch (one 384-thread CTA
// an SM, 214 KB of shared memory: sm90_cell.cuh's ring) whose phases are
// separated by grid syncs; every phase runs sm90_cell.cuh's producer
// (TMA ring) and consumers (register-A wgmma, epilogue in registers), the
// ring's counters carried from tile to tile and from phase 0 to phase 1:
//   phase 0: the visual gate tiles (128 rows x 128 columns of Fp),
//     v_hat = sigmoid(h_att Wg + bg) * round_bf16(vhat_raw) -> bf16, while
//     the producer warpgroup's idle threads write bf16 copies of h_att,
//     h_lang and c* (megastep.cu's lang cell does the same);
//   phase 1: the Copy-LSTM tiles (128 rows x 32 hidden columns: i f g o and
//     r over [v_hat | h_att | h_lang | c*], all bf16); h', c' in fp32 and
//     h' rounded to bf16 (5.2 MB at N = 2560, which stays in the 50 MB
//     L2);
//   phase 2: the head tiles (64 rows x 128 vocab columns of h'_bf16 W + b)
//     in a ping-pong, as head_sweep.cu's: the two consumer warpgroups take
//     the CTA's tiles in turns on a ring of their own (one warpgroup frees
//     a stage), an mbarrier pair orders their main loops, so one
//     warpgroup's epilogue runs under the other's products; the epilogue
//     writes each row's tile max, exp-sum and top-k (k rounds of a quad
//     arg-max over the row's four threads, from registers) to partials;
//   phase 3: the merge, one warp a row (head_common.cuh's merge_row).
// Between phases the writers' generic stores are fenced for the next
// phase's TMA reads (fence.proxy.async) before the grid sync. Thread-block
// clusters were not used: the per-tile partials need no distributed shared
// memory, and a cooperative launch with a cluster dimension was not tried.
//
// fp32 (compute_dtype="float32"): ck_lang_head_topk_f32, three launches:
// cell_common.cuh's fp32 gate and Copy-LSTM tiles (fp32 FMA, not TF32),
// then head_sm90.cuh's kernel with the F32 operands and the Sweep
// epilogue over h' (clusters that split the vocab, the merge on chip; one
// launch, no partials in device memory).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "cell_common.cuh"
#include "head_common.cuh"
#include "head_sm90.cuh"
#include "sm90_cell.cuh"

namespace cg = cooperative_groups;

namespace {

namespace sc = sm90cell;

constexpr int HEAD_ROWS = 64;  // a phase-2 tile: one warpgroup's rows
// The ring's barriers (phases 0 and 1), the head ring's (full, empty: one
// consuming warpgroup), and the head's order pair.
constexpr int WS_SMEM = sc::SMEM + (2 * sc::STAGES + 2) * 8;

struct WholeArgs {
  sc::CellArgs gate;  // phase 0: plain, one fp32 operand (h_att), out vhat
  sc::CellArgs lang;  // phase 1: gated Copy-LSTM, h_bf16 set
  sc::CellArgs head;  // phase 2: plain, one bf16 operand (h_bf16), cols V
  const float* head_b;  // [V], padded columns -1e30
  float* part_m;        // [N * n_tiles]
  float* part_s;        // [N * n_tiles]
  float* part_v;        // [N * n_tiles * k]
  int* part_i;          // [N * n_tiles * k]
  float* vals;          // [N, k]
  int* idx;             // [N, k]
  float* lse;           // [N]
  int k;
};

// The operand signatures of the three phases (sm90_cell.cuh's masks:
// fp32 operands, operands feeding the base boxes, operands feeding r).
constexpr uint32_t GATE_F32 = 1u, GATE_W = 1u, GATE_R = 0u;
constexpr uint32_t LANG_F32 = 0u, LANG_W = 0b0111u, LANG_R = 0b1111u;
constexpr uint32_t HEAD_F32 = 0u, HEAD_W = 1u, HEAD_R = 0u;

// Generic-proxy global writes made visible to later TMA (async-proxy)
// reads.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// A head tile's epilogue for one thread: rows gr0 and gr0 + 8, columns
// col0 + 8 j + 2 q + e (acc[4 j + 2 hr + e]). Per row: the tile max m, s =
// sum exp(x - m) and the top-k (value desc, id asc) to slot gr * n_vt + vt
// of the partials, each by a reduction over the row's quad (lanes 4 r ..
// 4 r + 3). Rows past N take part in the shuffles and write nothing.
__device__ __forceinline__ void epi_head(const WholeArgs& a, float (&acc)[64],
                                         int gr0, int q, int vt, int n_vt) {
  const int col0 = vt * BN;
  const int N = a.head.N;
  const int k = a.k;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 b =
        *reinterpret_cast<const float2*>(a.head_b + col0 + 8 * j + 2 * q);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      acc[4 * j + 2 * hr] += b.x;
      acc[4 * j + 2 * hr + 1] += b.y;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int gr = gr0 + 8 * hr;
    const bool live = gr < N;
    const size_t slot = static_cast<size_t>(gr) * n_vt + vt;
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      m = fmaxf(m, fmaxf(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]));
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      s += expf(acc[4 * j + 2 * hr] - m) + expf(acc[4 * j + 2 * hr + 1] - m);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (live && q == 0) {
      a.part_m[slot] = m;
      a.part_s[slot] = s;
    }
    // Round r takes the best entry after the last one taken, (lv, li), in
    // (value desc, id asc) order.
    float lv = INFINITY;
    int li = -1;
    for (int r = 0; r < k; ++r) {
      float bv = -INFINITY;
      int bi = INT_MAX;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[4 * j + 2 * hr + e];
          const int i = col0 + 8 * j + 2 * q + e;
          if ((v < lv || (v == lv && i > li)) && better(v, i, bv, bi)) {
            bv = v;
            bi = i;
          }
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (live && q == 0) {
        a.part_v[slot * k + r] = bv;
        a.part_i[slot * k + r] = bi;
      }
      lv = bv;
      li = bi;
    }
  }
}

// KMAX: the merge's candidate-list instance (kmax_for(k)); a template
// parameter, so the k <= 8 instance carries none of the longer lists'
// registers.
template <int KMAX>
__global__ void __launch_bounds__(sc::THREADS, 1)
    lang_head_kernel(const __grid_constant__ WholeArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sc::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + sc::STAGES * sc::STAGE);
  uint64_t* empty = full + sc::STAGES;
  uint64_t* head_full = empty + sc::STAGES;
  uint64_t* head_empty = head_full + sc::STAGES;
  uint64_t* order = head_empty + sc::STAGES;  // order[c]: warpgroup c may
                                              // start a head tile
  const cg::grid_group grid = cg::this_grid();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int q = lane % 4;
  const int row = wg * 64 + (warp % 4) * 16 + lane / 4;
  const bool producer = threadIdx.x == 256;
  const bool consumer = wg < 2;
  const int N = a.lang.N;
  const int row_blocks = (N + sc::BM - 1) / sc::BM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < sc::STAGES; ++s) {
      sm90::mbar_init(&head_full[s], 1);
      sm90::mbar_init(&head_empty[s], 4);  // the consuming warpgroup's warps
    }
    sm90::mbar_init(&order[0], 4);
    sm90::mbar_init(&order[1], 4);
    sc::init_ring(full, empty);
  }
  __syncthreads();

  int it = 0;  // the producer's stages filled, over every phase
  sc::Ring ring{smem, full, empty, 0, -1, lane};
  float acc[64];
  float accr[16];

  // Phase 0: the visual gate; the producer warpgroup's idle threads write
  // this CTA's share of the bf16 activations meanwhile.
  if (wg == 2 && !producer)
    sc::convert_share(a.gate, blockIdx.x, gridDim.x, threadIdx.x - 257,
                      sc::THREADS - 257);
  const int gate_cols = a.gate.cols / 128;
  const int n_gate = gate_cols * row_blocks;
  for (int t = blockIdx.x; t < n_gate; t += gridDim.x) {
    const int nb = t % gate_cols, row0 = (t / gate_cols) * sc::BM;
    if (producer)
      sc::produce_tile<1, GATE_F32, GATE_W, GATE_R>(a.gate, smem, full, empty,
                                                    it, row0, nb);
    if (consumer) {
      sc::consume_tile<1, GATE_F32, GATE_W, GATE_R>(a.gate, ring, row, q, acc,
                                                    accr);
      sc::epi_gate_mul(a.gate, acc, row0 + row, q, nb);
    }
  }
  fence_proxy_async_global();
  grid.sync();  // v_hat and the bf16 activations complete
  fence_proxy_async_global();

  // Phase 1: the Copy-LSTM.
  const int cell_cols = a.lang.cols / sc::TILE;
  const int n_cell = cell_cols * row_blocks;
  for (int t = blockIdx.x; t < n_cell; t += gridDim.x) {
    const int nb = t % cell_cols, row0 = (t / cell_cols) * sc::BM;
    if (producer)
      sc::produce_tile<4, LANG_F32, LANG_W, LANG_R>(a.lang, smem, full, empty,
                                                    it, row0, nb);
    if (consumer) {
      sc::consume_tile<4, LANG_F32, LANG_W, LANG_R>(a.lang, ring, row, q, acc,
                                                    accr);
      sc::epi_gated<true>(a.lang, acc, accr, row0 + row, q, nb);
    }
  }
  fence_proxy_async_global();
  grid.sync();  // h', c' and h'_bf16 complete
  fence_proxy_async_global();

  // Phase 2: the head tiles; consecutive CTAs take consecutive vocab tiles
  // of one 64-row block, so its h' rows are read from L2 together. The
  // CTA's i-th tile belongs to warpgroup i % 2, whose stages are i * steps
  // .. of the head ring.
  const int n_vt = a.head.cols / BN;
  const int n_head = n_vt * ((N + HEAD_ROWS - 1) / HEAD_ROWS);
  if (producer) {
    int hit = 0;
    for (int t = blockIdx.x; t < n_head; t += gridDim.x)
      sc::produce_tile<1, HEAD_F32, HEAD_W, HEAD_R>(
          a.head, smem, head_full, head_empty, hit, (t / n_vt) * HEAD_ROWS,
          t % n_vt);
  }
  if (consumer) {
    const int hrow = (warp % 4) * 16 + lane / 4;  // rows hrow, hrow + 8
    sc::Ring head_ring{smem, head_full, head_empty, 0, -1, lane};
    int i = 0, n = 0;  // the CTA's tiles so far; this warpgroup's
    for (int t = blockIdx.x; t < n_head; t += gridDim.x, ++i) {
      if ((i & 1) != wg) continue;
      // Wait for the other warpgroup to have issued its previous tile.
      if (i > 0) sm90::mbar_wait(&order[wg], (wg == 0 ? n - 1 : n) & 1);
      head_ring.it = i * a.head.steps[0];
      sc::consume_tile<1, HEAD_F32, HEAD_W, HEAD_R>(a.head, head_ring, hrow,
                                                    q, acc, accr);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&order[1 - wg]);
      epi_head(a, acc, (t / n_vt) * HEAD_ROWS + hrow, q, t % n_vt, n_vt);
      ++n;
    }
  }
  grid.sync();  // every tile's partials complete

  // Phase 3: the merge, one warp a row.
  const int warps = sc::THREADS / 32;
  for (int r = blockIdx.x * warps + warp; r < N; r += gridDim.x * warps)
    merge_row<KMAX>(a.part_m, a.part_s, a.part_v, a.part_i, a.vals, a.idx,
                    a.lse, r, n_vt, a.k, lane);
}

template <int KMAX>
void* kernel_of() {
  return reinterpret_cast<void*>(lang_head_kernel<KMAX>);
}

// The instance for k (kmax_for(k)).
void* kernel_for(int k) {
  switch (kmax_for(k)) {
    case 8:
      return kernel_of<8>();
    case 16:
      return kernel_of<16>();
    case 32:
      return kernel_of<32>();
    default:
      return kernel_of<64>();
  }
}

// Resident CTAs of an instance of lang_head_kernel on `device` (CTAs per
// SM x SMs), or an error when a cooperative launch cannot place even one
// per SM. Sets the kernel's shared-memory size first.
cudaError_t resident_blocks(const void* kernel, int device, int* blocks) {
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WS_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, sc::THREADS, WS_SMEM);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

bool bad_shape(int N, int Hp, int Fp, int V, int k) {
  return N < 1 || Hp < 128 || Hp % 128 || Fp < 128 || Fp % 128 || V < BN ||
         V % BN || k < 1 || k > KMAX_LIMIT || k > V;
}

}  // namespace

extern "C" {

// The megastep lang cell's operands (ck_lang_cell: fp32 vhat_raw [N, Fp],
// h_att, h_lang, c_lang, c_star [N, Hp]; bf16 gate_w [Hp, Fp], lang_wv
// [Fp, 4Hp], lang_wha, lang_wh [Hp, 4Hp], wr_v [Fp, Hp], wr_ha, wr_hl, wr_c
// [Hp, Hp]; fp32 gate_b [Fp], lang_b [4Hp], br [Hp]) and the head's (bf16
// head_w [Hp, V], fp32 head_b [V], V a multiple of 128, 1 <= k <= 64).
// Outputs: h_out, c_out [N, Hp] fp32, vals [N, k] fp32, idx [N, k] int32,
// lse [N] fp32. Scratch: vhat [N, Fp] bf16, h_bf16 [N, Hp] bf16, part_m,
// part_s [N * V / 128] fp32, part_v [N * V / 128 * k] fp32, part_i [same]
// int32, act16 [3, N, Hp] bf16. One cooperative launch.
int ck_lang_head_topk(const void* vhat_raw, const void* h_att,
                      const void* h_lang, const void* c_lang,
                      const void* c_star, const void* gate_w,
                      const void* gate_b, const void* lang_wv,
                      const void* lang_wha, const void* lang_wh,
                      const void* lang_b, const void* wr_v, const void* wr_ha,
                      const void* wr_hl, const void* wr_c, const void* br,
                      const void* head_w, const void* head_b, void* h_out,
                      void* c_out, void* vals, void* idx, void* lse,
                      void* vhat, void* h_bf16, void* part_m, void* part_s,
                      void* part_v, void* part_i, void* act16, int N, int Hp,
                      int Fp, int V, int k, int device, void* stream) {
  if (bad_shape(N, Hp, Fp, V, k)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };

  auto* ha16 = static_cast<__nv_bfloat16*>(act16);
  auto* hl16 = ha16 + static_cast<size_t>(N) * Hp;
  auto* cs16 = hl16 + static_cast<size_t>(N) * Hp;
  WholeArgs a = {};
  a.gate = sc::plain_args(N, Fp);
  err = sc::set_operand(a.gate, 0, h_att, 1, Hp, gate_w, Fp, nullptr);
  a.gate.bias = f(gate_b);
  a.gate.x = f(vhat_raw);
  a.gate.out = vhat;
  a.gate.cvt_src[0] = f(h_att);
  a.gate.cvt_src[1] = f(h_lang);
  a.gate.cvt_src[2] = f(c_star);
  a.gate.cvt_dst[0] = ha16;
  a.gate.cvt_dst[1] = hl16;
  a.gate.cvt_dst[2] = cs16;
  a.gate.cvt_n = static_cast<long long>(N) * Hp;

  a.lang = sc::gated_args(N, Hp);
  if (err == cudaSuccess)
    err = sc::set_operand(a.lang, 0, vhat, 0, Fp, lang_wv, 4 * Hp, wr_v);
  if (err == cudaSuccess)
    err = sc::set_operand(a.lang, 1, ha16, 0, Hp, lang_wha, 4 * Hp, wr_ha);
  if (err == cudaSuccess)
    err = sc::set_operand(a.lang, 2, hl16, 0, Hp, lang_wh, 4 * Hp, wr_hl);
  if (err == cudaSuccess)
    err = sc::set_operand(a.lang, 3, cs16, 0, Hp, nullptr, 0, wr_c);
  a.lang.bias = f(lang_b);
  a.lang.bias_r = f(br);
  a.lang.c_prev = f(c_lang);
  a.lang.c_star = f(c_star);
  a.lang.h_out = static_cast<float*>(h_out);
  a.lang.c_out = static_cast<float*>(c_out);
  a.lang.h_bf16 = static_cast<__nv_bfloat16*>(h_bf16);

  a.head = sc::plain_args(N, V, HEAD_ROWS);
  if (err == cudaSuccess)
    err = sc::set_operand(a.head, 0, h_bf16, 0, Hp, head_w, V, nullptr);
  if (err != cudaSuccess) return (int)err;
  a.head_b = f(head_b);
  a.part_m = static_cast<float*>(part_m);
  a.part_s = static_cast<float*>(part_s);
  a.part_v = static_cast<float*>(part_v);
  a.part_i = static_cast<int*>(part_i);
  a.vals = static_cast<float*>(vals);
  a.idx = static_cast<int*>(idx);
  a.lse = static_cast<float*>(lse);
  a.k = k;

  // The grid of each instance on each device is queried at its first
  // launch there (the occupancy query costs host time every call).
  const void* kernel = kernel_for(k);
  static int grids[4][16] = {};
  const int inst = k <= 8 ? 0 : k <= 16 ? 1 : k <= 32 ? 2 : 3;
  int uncached = 0;
  int& blocks = device < 16 ? grids[inst][device] : uncached;
  if (blocks == 0) {
    err = resident_blocks(kernel, device, &blocks);
    if (err != cudaSuccess) {
      blocks = 0;
      return (int)err;
    }
  }
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(blocks),
                                          dim3(sc::THREADS), params, WS_SMEM,
                                          s);
}

// compute_dtype="float32": the same operands, weights and outputs all fp32
// (scratch vhat [N, Fp] fp32; no h_bf16, no partials). Three launches:
// cell_common.cuh's fp32 visual gate and Copy-LSTM, then head_sm90.cuh's
// fp32 sweep of the head over h' in clusters of `shares` CTAs
// (kernels/head.py::sweep_plan over ck_wholestep_head_f32_max_clusters).
int ck_lang_head_topk_f32(const void* vhat_raw, const void* h_att,
                          const void* h_lang, const void* c_lang,
                          const void* c_star, const void* gate_w,
                          const void* gate_b, const void* lang_wv,
                          const void* lang_wha, const void* lang_wh,
                          const void* lang_b, const void* wr_v,
                          const void* wr_ha, const void* wr_hl,
                          const void* wr_c, const void* br,
                          const void* head_w, const void* head_b, void* h_out,
                          void* c_out, void* vals, void* idx, void* lse,
                          void* vhat, int N, int Hp, int Fp, int V, int k,
                          int shares, int device, void* stream) {
  using namespace cell;
  if (bad_shape(N, Hp, Fp, V, k) || shares < 1 || shares > hsm::MAX_SHARES)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  GemmArgs gv = gemm_args(N, Fp);
  gv.op[0] = operand(h_att, Hp, gate_w);
  gv.n_ops = 1;
  gv.bias = f32(gate_b);
  gv.x = f32(vhat_raw);
  gv.out = vhat;
  err = launch_gemm<4, EPI_GATE_MUL>(gv, s);
  if (err != cudaSuccess) return (int)err;

  GemmArgs g = gemm_args(N, Hp);
  g.op[0] = operand(vhat, Fp, lang_wv, wr_v);
  g.op[1] = operand(h_att, Hp, lang_wha, wr_ha);
  g.op[2] = operand(h_lang, Hp, lang_wh, wr_hl);
  g.op[3] = operand(c_star, Hp, nullptr, wr_c);
  g.n_ops = 4;
  g.bias = f32(lang_b);
  g.bias_r = f32(br);
  g.c_prev = f32(c_lang);
  g.c_star = f32(c_star);
  g.h_out = static_cast<float*>(h_out);
  g.c_out = static_cast<float*>(c_out);
  err = launch_gemm<5, EPI_COPY_LSTM>(g, s);
  if (err != cudaSuccess) return (int)err;

  CUtensorMap h_map, w_map;
  err = hsm::f32_maps(&h_map, &w_map, h_out, head_w, N, Hp, V);
  if (err != cudaSuccess) return (int)err;
  hsm::Args ha = {};
  ha.bias = f32(head_b);
  ha.vals = static_cast<float*>(vals);
  ha.idx = static_cast<int*>(idx);
  ha.lse = static_cast<float*>(lse);
  ha.N = N;
  ha.H = Hp;
  ha.V = V;
  ha.k = k;
  return (int)hsm::launch_any<hsm::F32, hsm::SweepF32>(h_map, w_map, ha,
                                                       shares, true, s);
}

// How many clusters of `shares` CTAs of the fp32 head the card holds at
// once (`wide` is ignored: h' always streams), as the head libraries'
// queries answer.
int ck_wholestep_head_f32_max_clusters(int shares, int wide, int device) {
  return hsm::clusters_of<hsm::F32, hsm::SweepF32>(shares, wide, device);
}

// The cooperative grid on `device` (CTAs per SM x SMs) of the k <= 8
// instance, or minus the CUDA error code.
int ck_wholestep_grid(int device) {
  int blocks = 0;
  const cudaError_t err = resident_blocks(kernel_for(8), device, &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

// The k <= 8 instance's registers per thread, and its dynamic shared
// memory.
int ck_wholestep_regs() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel_for(8)) != cudaSuccess) return -1;
  return attr.numRegs;
}

int ck_wholestep_smem() { return WS_SMEM; }

int ck_wholestep_threads() { return sc::THREADS; }

const char* ck_wholestep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
