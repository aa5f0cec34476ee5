// Fused LSTM and Copy-LSTM cells, one step over a batch of rows.
//
// Replaces the TPU kernel of captionkit/ops/lstm.py (_run_cell, reached by
// fused_lstm_cell and fused_copy_lstm_cell, which captionkit/nn/dispatch.py
// returns with use_pallas=True):
//   ck_lstm_cell       z = [x | h] W + b (gates i|f|g|o), c' = f c + i g,
//                      h' = o tanh(c')
//   ck_copy_lstm_cell  the same base gates, plus the copy gate
//                      r = sigmoid([x | h | c*] W_r + b_r) and
//                      c' = r c* + (1 - r) c_gen
//
// Numerics are the reference's: product operands rounded to bf16 (fp32
// activations are rounded as they are loaded), fp32 accumulation, gate math
// in fp32, fp32 state.
//
// Design. The TPU kernel packs [x | h (| c*)] and a gate-major weight
// [G, K, H] and accumulates over K tiles in VMEM scratch. Here one launch of
// cell_common.cuh's gemm_kernel<4, EPI_LSTM> (or <5, EPI_COPY_LSTM>) does
// the step: x, h (and c*) are successive K ranges of one accumulation, so
// no concatenation exists in device memory, and a block's column groups
// are the i, f, g, o (and r) tiles of its 32 hidden columns, so the update
// runs on the tile in shared memory. c* feeds only the copy gate: its
// operand has no gate weights (w_gates = null) and the base-gate warps skip
// it, where the TPU kernel multiplies zero rows; the function is the same.
//
// What bounds it on the H100: at EditNet's greedy step (N = 512 rows, the
// Copy-LSTM's K = F + H = 3072 + 1024 over 4H = 4096 gate columns, and
// K = 5120 over H for the copy gate) the products are 2 N (4096 * 4096 +
// 5120 * 1024) = 22.5 GFLOP against 44 MB of bf16 weights read once:
// 0.023 ms of tensor-core time against 0.013 ms of bytes, so operations
// bound it. This first version is plain: wmma rather than wgmma, one
// shared-memory stage, every 64-row block streams its weight columns from
// L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cell_common.cuh"

using namespace cell;

static_assert(BK == BN, "one padding width serves K and H");

extern "C" {

// x [N, Dp] (fp32 if x_f32 else bf16), h [N, Hp] (fp32 if h_f32 else
// bf16), c [N, Hp] fp32; bf16 gate-major weights w_x [Dp, 4Hp], w_h [Hp,
// 4Hp]; fp32 b [4Hp]. Outputs h_out, c_out [N, Hp] fp32. Dp and Hp are
// multiples of 32. One launch.
int ck_lstm_cell(const void* x, const void* h, const void* c,
                 const void* w_x, const void* w_h, const void* b, void* h_out,
                 void* c_out, int N, int Dp, int Hp, int x_f32, int h_f32,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  GemmArgs g = gemm_args(N, Hp);
  g.op[0] = operand(x, x_f32, Dp, w_x);
  g.op[1] = operand(h, h_f32, Hp, w_h);
  g.n_ops = 2;
  g.bias = f32(b);
  g.c_prev = f32(c);
  g.h_out = static_cast<float*>(h_out);
  g.c_out = static_cast<float*>(c_out);
  return (int)launch_gemm<4, EPI_LSTM>(g, static_cast<cudaStream_t>(stream));
}

// As ck_lstm_cell, plus c_star [N, Hp] fp32 and the copy gate's bf16
// weights w_rx [Dp, Hp], w_rh, w_rc [Hp, Hp] and fp32 br [Hp]. One launch.
int ck_copy_lstm_cell(const void* x, const void* h, const void* c,
                      const void* c_star, const void* w_x, const void* w_h,
                      const void* w_rx, const void* w_rh, const void* w_rc,
                      const void* b, const void* br, void* h_out, void* c_out,
                      int N, int Dp, int Hp, int x_f32, int h_f32, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  GemmArgs g = gemm_args(N, Hp);
  g.op[0] = operand(x, x_f32, Dp, w_x, w_rx);
  g.op[1] = operand(h, h_f32, Hp, w_h, w_rh);
  g.op[2] = operand(c_star, 1, Hp, nullptr, w_rc);
  g.n_ops = 3;
  g.bias = f32(b);
  g.bias_r = f32(br);
  g.c_prev = f32(c);
  g.c_star = f32(c_star);
  g.h_out = static_cast<float*>(h_out);
  g.c_out = static_cast<float*>(c_out);
  return (int)launch_gemm<5, EPI_COPY_LSTM>(g,
                                            static_cast<cudaStream_t>(stream));
}

const char* ck_lstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The width the Python side pads D and H to (BK = BN = 32).
int ck_lstm_tile() { return BN; }

}  // extern "C"
