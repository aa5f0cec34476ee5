// Whole-step kernel: EditNet's lang cell (visual context gate, Copy-LSTM
// base gates, copy gate, c*/c_gen blend) and the vocab head's logits tiles
// with their per-tile log-sum-exp and top-k, in one launch.
//
// Replaces the TPU kernel of captionkit/ops/wholestep.py
// (fused_lang_head_topk, reached by fused_step_topk under
// model.cell_impl="wholestep"): the megastep lang kernel whose new h_lang,
// rounded to bf16, feeds the fused head's LSE/top-k body without a trip
// through a second program.
//
// Numerics: the cell is ck_lang_cell's (megastep.cu), the head is
// ck_head_topk's with extract="mask" (head_topk.cu): bf16 operands, fp32
// sums, the same 64 x 128 logits tile and the same extraction and merge
// (head_common.cuh), ties to the lowest vocab id.
//
// Design. On the TPU the grid (row block, vocab tile) runs in order, so the
// cell body runs at vocab tile 0 and parks h_lang in VMEM for the row
// block's later tiles. On Hopper the blocks run in parallel and in no
// order, and one block cannot hold a row block's 4H gate columns, so:
//
//   launch 1, cell_common.cuh's plain GEMM (EPI_GATE_MUL): the visual
//     gate, v_hat = sigmoid(h_att Wg + bg) * round_bf16(vhat_raw) in bf16;
//   launch 2, lang_head_kernel, a cooperative persistent kernel (every
//     block resident; grid = blocks per SM x SMs from the occupancy API;
//     the tile loops stride over the grid):
//       phase 1: the Copy-LSTM tiles (64 rows x 32 hidden columns x the
//         i f g o r gate groups over [v_hat | h_att | h_lang | c*]); the
//         epilogue writes h', c' in fp32 and h' rounded to bf16;
//       grid.sync();
//       phase 2: the head tiles (64 rows x 128 vocab columns, h'_bf16 W +
//         b), each row's tile max, exp-sum and top-k to scratch;
//       grid.sync();
//       phase 3: the merge, one warp per row: lse and the top-k.
//
// h'_bf16 (5.2 MB at N = 2560, H = 1024) is handed from phase 1 to phase 2
// inside the launch through device memory, where it stays in the 50 MB L2;
// no second launch reads it. Keeping it on chip (clusters sharing it
// through distributed shared memory) is a later design.
//
// What bounds it on the H100 at N = 2560, H = 1024, F = 2048, V = 9490:
// 2 N H F + 2 N (F + 2H) 4H + 2 N (F + 3H) H = 123.5 GFLOP for the cell and
// 2 N H V = 49.8 GFLOP for the head, 173.3 GFLOP of bf16 products: 0.175 ms
// at 989 TFLOP/s, against ~96 MB of inputs and outputs (0.029 ms):
// operations. This first version is plain: wmma, one shared-memory stage.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "cell_common.cuh"
#include "head_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WS_THREADS = 320;  // the Copy-LSTM tile's 2 x 5 warps
// Resident blocks per SM asked of the compiler: 64 registers a thread, so
// three blocks share an SM and hide more latency than two of 96 registers
// (the compiler's own choice); PERF.md has both times.
constexpr int WS_MIN_BLOCKS = 3;
constexpr int WS_WARPS = WS_THREADS / 32;
constexpr int HEAD_G = BN / cell::BN;  // a 128-wide vocab tile: 4 groups
static_assert(HEAD_G * cell::BN == BN, "vocab tile = 4 column groups");
static_assert(WS_THREADS >= 64 * 5, "the Copy-LSTM tile needs 10 warps");
constexpr int WS_SMEM = cell::tile_smem<5>() > cell::tile_smem<HEAD_G>()
                            ? cell::tile_smem<5>()
                            : cell::tile_smem<HEAD_G>();

struct WholeArgs {
  cell::GemmArgs lang;  // the Copy-LSTM update (EPI_COPY_LSTM, h_bf16 set)
  cell::GemmArgs head;  // h_bf16 [N, Hp] x W [Hp, V] (EPI_NONE), cols = V
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

__global__ void __launch_bounds__(WS_THREADS, WS_MIN_BLOCKS)
    lang_head_kernel(const __grid_constant__ WholeArgs a) {
  __shared__ __align__(128) unsigned char smem[WS_SMEM];
  const cg::grid_group grid = cg::this_grid();
  const int N = a.lang.N;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_blocks = (N + cell::BM - 1) / cell::BM;

  // Phase 1: the Copy-LSTM tiles.
  const int cell_cols = a.lang.cols / cell::BN;
  const int n_cell = cell_cols * row_blocks;
  for (int t = blockIdx.x; t < n_cell; t += gridDim.x) {
    cell::gemm_tile<5, cell::EPI_COPY_LSTM, WS_THREADS>(
        a.lang, t % cell_cols, (t / cell_cols) * cell::BM, smem);
    __syncthreads();  // the next tile reuses smem
  }
  grid.sync();  // h'_bf16 complete and visible to every block

  // Phase 2: the head tiles; consecutive blocks take consecutive vocab
  // tiles of one row block, so its h' rows are read from L2.
  const int n_vt = a.head.cols / BN;
  const int n_head = n_vt * row_blocks;
  const float* Cs = reinterpret_cast<const float*>(smem);
  for (int t = blockIdx.x; t < n_head; t += gridDim.x) {
    const int tile = t % n_vt;
    const int row0 = (t / n_vt) * cell::BM;
    cell::gemm_tile<HEAD_G, cell::EPI_NONE, WS_THREADS>(a.head, tile, row0,
                                                         smem);
    for (int r = warp; r < cell::BM; r += WS_WARPS) {
      const int gr = row0 + r;
      if (gr >= N) break;  // the same for the whole warp
      float x[COLS_PER_LANE];
      int xi[COLS_PER_LANE];
      load_row(Cs, cell::tile_ldc<HEAD_G>(), r, a.head_b, tile * BN,
               a.head.cols, lane, x, xi);
      emit_tile_row<kMask>(x, xi, a.k, (size_t)gr * n_vt + tile, a.part_m,
                           a.part_s, a.part_v, a.part_i, lane);
    }
    __syncthreads();  // the next tile reuses smem
  }
  grid.sync();  // every tile's partials complete

  // Phase 3: the merge, one warp per row.
  for (int row = blockIdx.x * WS_WARPS + warp; row < N;
       row += gridDim.x * WS_WARPS)
    merge_row(a.part_m, a.part_s, a.part_v, a.part_i, a.vals, a.idx, a.lse,
              row, n_vt, a.k, lane);
}

// Resident blocks of lang_head_kernel on `device` (blocks per SM x SMs),
// or an error when a cooperative launch cannot place even one per SM.
cudaError_t resident_blocks(int device, int* blocks) {
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lang_head_kernel, WS_THREADS, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The megastep lang cell's operands (ck_lang_cell: fp32 vhat_raw [N, Fp],
// h_att, h_lang, c_lang, c_star [N, Hp]; bf16 gate_w [Hp, Fp], lang_wv
// [Fp, 4Hp], lang_wha, lang_wh [Hp, 4Hp], wr_v [Fp, Hp], wr_ha, wr_hl, wr_c
// [Hp, Hp]; fp32 gate_b [Fp], lang_b [4Hp], br [Hp]) and the head's (bf16
// head_w [Hp, V], fp32 head_b [V], V a multiple of 128, 1 <= k <= 8).
// Outputs: h_out, c_out [N, Hp] fp32, vals [N, k] fp32, idx [N, k] int32,
// lse [N] fp32. Scratch: vhat [N, Fp] bf16, h_bf16 [N, Hp] bf16, part_m,
// part_s [N * V / 128] fp32, part_v [N * V / 128 * k] fp32, part_i [same]
// int32. Two launches; the second is cooperative.
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
                      void* part_v, void* part_i, int N, int Hp, int Fp,
                      int V, int k, int device, void* stream) {
  using namespace cell;
  if (k < 1 || k > KMAX || k > V) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  WholeArgs a = {};
  a.lang = gemm_args(N, Hp);
  a.lang.op[0] = operand(vhat, 0, Fp, lang_wv, wr_v);
  a.lang.op[1] = operand(h_att, 1, Hp, lang_wha, wr_ha);
  a.lang.op[2] = operand(h_lang, 1, Hp, lang_wh, wr_hl);
  a.lang.op[3] = operand(c_star, 1, Hp, nullptr, wr_c);
  a.lang.n_ops = 4;
  a.lang.bias = f32(lang_b);
  a.lang.bias_r = f32(br);
  a.lang.c_prev = f32(c_lang);
  a.lang.c_star = f32(c_star);
  a.lang.h_out = static_cast<float*>(h_out);
  a.lang.c_out = static_cast<float*>(c_out);
  a.lang.h_bf16 = static_cast<__nv_bfloat16*>(h_bf16);
  a.head = gemm_args(N, V);
  a.head.op[0] = operand(h_bf16, 0, Hp, head_w);
  a.head.n_ops = 1;
  a.head_b = f32(head_b);
  a.part_m = static_cast<float*>(part_m);
  a.part_s = static_cast<float*>(part_s);
  a.part_v = static_cast<float*>(part_v);
  a.part_i = static_cast<int*>(part_i);
  a.vals = static_cast<float*>(vals);
  a.idx = static_cast<int*>(idx);
  a.lse = static_cast<float*>(lse);
  a.k = k;
  err = check_gemm<5, EPI_COPY_LSTM>(a.lang);
  if (err == cudaSuccess) err = check_gemm<HEAD_G, EPI_NONE>(a.head);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = resident_blocks(device, &blocks);
  if (err != cudaSuccess) return (int)err;

  GemmArgs gv = gemm_args(N, Fp);
  gv.op[0] = operand(h_att, 1, Hp, gate_w);
  gv.n_ops = 1;
  gv.bias = f32(gate_b);
  gv.x = f32(vhat_raw);
  gv.x_round = 1;
  gv.out = vhat;
  err = launch_gemm<4, EPI_GATE_MUL>(gv, s);
  if (err != cudaSuccess) return (int)err;

  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lang_head_kernel), dim3(blocks),
      dim3(WS_THREADS), params, 0, s);
}

// The cooperative grid on `device` (blocks per SM x SMs), or minus the
// CUDA error code.
int ck_wholestep_grid(int device) {
  int blocks = 0;
  const cudaError_t err = resident_blocks(device, &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

// lang_head_kernel's registers per thread and static shared memory, as the
// runtime reports them.
int ck_wholestep_regs() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, lang_head_kernel) != cudaSuccess)
    return -1;
  return attr.numRegs;
}

int ck_wholestep_smem() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, lang_head_kernel) != cudaSuccess)
    return -1;
  return (int)attr.sharedSizeBytes;
}

const char* ck_wholestep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
