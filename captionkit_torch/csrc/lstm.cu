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
// activations are rounded as they are read), fp32 accumulation, gate math
// in fp32, fp32 state.
//
// What bounds it on the H100. At the greedy step (N = 512 rows; DCNet's
// LSTM K = 3072 over 4H = 4096 gate columns, 12.9 GFLOP; EditNet's
// Copy-LSTM K = 4096 plus the copy gate's K = 5120 over H = 1024, 22.5
// GFLOP) the products take 13 and 23 us at the H100's published 989
// TFLOP/s of dense bf16, against 11 and 18 us for the bytes read once at
// 3.35 TB/s, so operations bound it.
//
// Design (sm_90a, one launch, grid (Hp / 32, ceil(N / 128)) of 384-thread
// CTAs; registers and shared memory in PERF.md). The main loop is
// sm90_cell.cuh's, shared with megastep.cu's lang cell and wholestep.cu:
// - A CTA owns 128 rows x 32 hidden columns: its 128 product columns are
//   the i, f, g, o tiles of those hidden columns (plus 32 r columns for
//   the Copy-LSTM), read straight from the gate-major [K, 4Hp] weights.
//   At N = 512, H = 1024 that is 32 x 4 = 128 CTAs, one wave on 132 SMs.
// - x, h (and c*) are successive K ranges of one accumulation, so the
//   concatenation never exists in device memory. c* feeds only the copy
//   gate: its K range runs the r product alone, where the TPU kernel
//   multiplies zero gate rows; the function is the same.
// - One producer thread keeps a ring of 4 stages of K = 64 filled with TMA
//   loads, completing on mbarriers: two 128 x 32 activation boxes (fp32,
//   128-byte swizzle; or bf16, 64-byte) and a 64 x 32 box of each gate
//   (and r), 64-byte swizzle. Rows past N and K past an operand's end
//   read zeros. The consumers free a stage on a second ring of mbarriers.
// - Two consumer warpgroups, 64 rows each. A warpgroup reads its
//   activation fragments from the stage, rounds fp32 to bf16 in registers
//   (once per CTA; no pre-pass launch) and runs wgmma m64n128k16 with A
//   from registers and the four gate boxes as one MN-major B operand
//   (transpose bit, LBO = one box); the copy gate is its own m64n32k16 on
//   the same A registers. Two register buffers alternate, so one stage's
//   products run while the next stage's fragments are read.
// - The epilogue runs in registers: in wgmma's accumulator layout a thread
//   holds columns 8 j + 2 (lane % 4) + {0, 1}, a set closed under + 32, so
//   the four gates (and r) of each of its hidden columns are its own. No
//   gate pre-activation reaches shared or device memory.
// - Not done, slower on the H100 in each version tried (PERF.md):
//   multicasting the activation boxes over a cluster of CTAs along the
//   columns (their rows are the same), and splitting each warpgroup's
//   product into two n64 accumulator chains.
//
// fp32 (compute_dtype="float32"): ck_lstm_cell_f32 and
// ck_copy_lstm_cell_f32 run cell_common.cuh's gated GEMM with fp32
// operands and weights (fp32 FMA on the CUDA cores, not TF32) and its
// EPI_LSTM / EPI_COPY_LSTM epilogues in registers; one launch each. Its
// main loop was rewritten for Hopper rather than lifted from this file's
// bf16 ring: a CTA of 128 rows x 32 hidden columns (as here; 128 CTAs at N
// = 512, H = 1024, one wave), one producer thread keeping a 4-stage TMA
// ring of K = 32 (fp32 activation and weight boxes, 128-byte swizzle),
// and 256 SIMT consumers of 8 rows x 2 columns of each gate box. The bf16
// ring's stages (K = 64, two warpgroups in wgmma's layout) would hold 72
// KB of fp32 a stage and fit 3 in shared memory; the SIMT loop wants its
// own thread layout (four row groups x eight column pairs a warp, so every
// shared load is conflict-free under the swizzle), and a shallower stage
// gives 4 in flight. The alternative was not built; the times against the
// bound are in PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cell_common.cuh"
#include "sm90_cell.cuh"

namespace {

using sm90cell::CellArgs;

// The LSTM (operands x, h) and the Copy-LSTM (x, h, then c* for r alone):
// x and h fp32 or bf16 as the caller hands them, c* fp32.
template <bool COPY, bool XF32, bool HF32>
cudaError_t launch(const CellArgs& args, cudaStream_t stream) {
  using namespace sm90cell;
  constexpr uint32_t F32 = (XF32 ? 1u : 0u) | (HF32 ? 2u : 0u) | 4u;
  const int col_blocks = args.cols / TILE;
  if constexpr (COPY)
    return launch_cell<kCopyLstm, 3, F32, 3u, 7u>(args, col_blocks, stream);
  else
    return launch_cell<kLstm, 2, F32, 3u, 0u>(args, col_blocks, stream);
}

template <bool COPY>
cudaError_t launch(const CellArgs& args, int x_f32, int h_f32,
                   cudaStream_t stream) {
  if (x_f32)
    return h_f32 ? launch<COPY, true, true>(args, stream)
                 : launch<COPY, true, false>(args, stream);
  return h_f32 ? launch<COPY, false, true>(args, stream)
               : launch<COPY, false, false>(args, stream);
}

bool bad_shape(int N, int Dp, int Hp) {
  using sm90cell::TILE;
  return N < 1 || Dp < TILE || Dp % TILE || Hp < TILE || Hp % TILE;
}

// The operands and weights both cells share.
cudaError_t base_args(CellArgs& g, const void* x, const void* h,
                      const void* c, const void* w_x, const void* w_h,
                      const void* b, void* h_out, void* c_out, int N, int Dp,
                      int Hp, int x_f32, int h_f32, const void* w_rx,
                      const void* w_rh) {
  using namespace sm90cell;
  g = gated_args(N, Hp);
  CK_TRY(set_operand(g, 0, x, x_f32, Dp, w_x, 4 * Hp, w_rx));
  CK_TRY(set_operand(g, 1, h, h_f32, Hp, w_h, 4 * Hp, w_rh));
  g.bias = static_cast<const float*>(b);
  g.c_prev = static_cast<const float*>(c);
  g.h_out = static_cast<float*>(h_out);
  g.c_out = static_cast<float*>(c_out);
  return cudaSuccess;
}

// fp32: cell_common.cuh's gated GEMM, operands x [N, Dp], h (and c*) [N,
// Hp] and weights all fp32.
cudaError_t launch_f32(const void* x, const void* h, const void* c,
                       const void* c_star, const void* w_x, const void* w_h,
                       const void* w_rx, const void* w_rh, const void* w_rc,
                       const void* b, const void* br, void* h_out,
                       void* c_out, int N, int Dp, int Hp,
                       cudaStream_t stream) {
  using namespace cell;
  GemmArgs g = gemm_args(N, Hp);
  g.op[0] = operand(x, Dp, w_x, w_rx);
  g.op[1] = operand(h, Hp, w_h, w_rh);
  g.n_ops = 2;
  g.bias = f32(b);
  g.c_prev = f32(c);
  g.h_out = static_cast<float*>(h_out);
  g.c_out = static_cast<float*>(c_out);
  if (c_star == nullptr) return launch_gemm<4, EPI_LSTM>(g, stream);
  g.op[2] = operand(c_star, Hp, nullptr, w_rc);
  g.n_ops = 3;
  g.bias_r = f32(br);
  g.c_star = f32(c_star);
  return launch_gemm<5, EPI_COPY_LSTM>(g, stream);
}

}  // namespace

extern "C" {

// x [N, Dp] (fp32 if x_f32 else bf16), h [N, Hp] (fp32 if h_f32 else
// bf16), c [N, Hp] fp32; bf16 gate-major weights w_x [Dp, 4Hp], w_h [Hp,
// 4Hp]; fp32 b [4Hp]. Outputs h_out, c_out [N, Hp] fp32. Dp and Hp are
// multiples of 32; every pointer 16-byte aligned. One launch.
int ck_lstm_cell(const void* x, const void* h, const void* c,
                 const void* w_x, const void* w_h, const void* b, void* h_out,
                 void* c_out, int N, int Dp, int Hp, int x_f32, int h_f32,
                 int device, void* stream) {
  if (bad_shape(N, Dp, Hp)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CellArgs g;
  err = base_args(g, x, h, c, w_x, w_h, b, h_out, c_out, N, Dp, Hp, x_f32,
                  h_f32, nullptr, nullptr);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<false>(g, x_f32, h_f32,
                            static_cast<cudaStream_t>(stream));
}

// As ck_lstm_cell, plus c_star [N, Hp] fp32 and the copy gate's bf16
// weights w_rx [Dp, Hp], w_rh, w_rc [Hp, Hp] and fp32 br [Hp]. One launch.
int ck_copy_lstm_cell(const void* x, const void* h, const void* c,
                      const void* c_star, const void* w_x, const void* w_h,
                      const void* w_rx, const void* w_rh, const void* w_rc,
                      const void* b, const void* br, void* h_out, void* c_out,
                      int N, int Dp, int Hp, int x_f32, int h_f32, int device,
                      void* stream) {
  if (bad_shape(N, Dp, Hp)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CellArgs g;
  err = base_args(g, x, h, c, w_x, w_h, b, h_out, c_out, N, Dp, Hp, x_f32,
                  h_f32, w_rx, w_rh);
  if (err == cudaSuccess)
    err = sm90cell::set_operand(g, 2, c_star, 1, Hp, nullptr, 0, w_rc);
  if (err != cudaSuccess) return (int)err;
  g.bias_r = static_cast<const float*>(br);
  g.c_star = static_cast<const float*>(c_star);
  return (int)launch<true>(g, x_f32, h_f32,
                           static_cast<cudaStream_t>(stream));
}

// compute_dtype="float32": x [N, Dp], h, c [N, Hp] and the gate-major
// weights w_x [Dp, 4Hp], w_h [Hp, 4Hp] all fp32. One launch.
int ck_lstm_cell_f32(const void* x, const void* h, const void* c,
                     const void* w_x, const void* w_h, const void* b,
                     void* h_out, void* c_out, int N, int Dp, int Hp,
                     int device, void* stream) {
  if (bad_shape(N, Dp, Hp)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_f32(x, h, c, nullptr, w_x, w_h, nullptr, nullptr,
                         nullptr, b, nullptr, h_out, c_out, N, Dp, Hp,
                         static_cast<cudaStream_t>(stream));
}

// compute_dtype="float32" Copy-LSTM: ck_copy_lstm_cell's operands, all
// fp32. One launch.
int ck_copy_lstm_cell_f32(const void* x, const void* h, const void* c,
                          const void* c_star, const void* w_x,
                          const void* w_h, const void* w_rx, const void* w_rh,
                          const void* w_rc, const void* b, const void* br,
                          void* h_out, void* c_out, int N, int Dp, int Hp,
                          int device, void* stream) {
  if (bad_shape(N, Dp, Hp)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_f32(x, h, c, c_star, w_x, w_h, w_rx, w_rh, w_rc, b, br,
                         h_out, c_out, N, Dp, Hp,
                         static_cast<cudaStream_t>(stream));
}

const char* ck_lstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The width the Python side pads D and H to.
int ck_lstm_tile() { return sm90cell::TILE; }

}  // extern "C"
