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
// CTAs; registers and shared memory in PERF.md):
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int TILE = 32;     // hidden columns per CTA; D and H pad to this
constexpr int BM = 128;      // rows per CTA: two consumer warpgroups
constexpr int BK = 64;       // depth of one stage: two 32-wide boxes
constexpr int STAGES = 4;
constexpr int A_HALF = BM * 32 * 4;        // one 128 x 32 activation box
constexpr int A_SLOT = 2 * A_HALF;         // (fp32 size; bf16 uses half)
constexpr int W_BOX = BK * TILE * 2;       // one 64 x 32 bf16 weight box
constexpr int STAGE = A_SLOT + 5 * W_BOX;  // + the i, f, g, o, r boxes
constexpr int THREADS = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
static_assert(STAGE % 1024 == 0, "stages stay on 1024-byte boundaries");

struct CellArgs {
  CUtensorMap a[3];   // x [N, Dp], h [N, Hp], c* [N, Hp]: 128 x 32 boxes
  CUtensorMap wg[2];  // gate-major w_x [Dp, 4Hp], w_h [Hp, 4Hp]: 64 x 32
  CUtensorMap wr[3];  // copy gate w_rx [Dp, Hp], w_rh, w_rc [Hp, Hp]
  int steps[3];       // stages of each operand: ceil(K / 64)
  const float* bias;    // [4Hp]
  const float* bias_r;  // [Hp]
  const float* c_prev;  // [N, Hp]
  const float* c_star;  // [N, Hp]
  float* h_out;         // [N, Hp]
  float* c_out;         // [N, Hp]
  int N;
  int Hp;
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
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
// whose products may still be in flight (freed once they are done).
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
// base gates' m64n128k16 and the copy gate's m64n32k16, four k16 steps
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

// The consumer warpgroups: warpgroup wg owns tile rows [64 wg, 64 wg + 64).
// The K walk is x (base gates and r), h (the same), then c* (r alone).
template <bool COPY, bool XF32, bool HF32>
__device__ __forceinline__ void consume(const CellArgs& args, Ring& ring,
                                        int row0, int nb, int warp, int lane,
                                        int wg) {
  const int Hp = args.Hp;
  const int q = lane % 4;
  const int row = wg * 64 + (warp % 4) * 16 + lane / 4;
  float acc[64];   // gates i, f, g, o
  float accr[16];  // the copy gate r
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) accr[i] = 0.0f;
  fence_regs(acc);
  fence_regs(accr);
  mma_operand<XF32, true, COPY>(ring, args.steps[0], row, q, acc, accr);
  mma_operand<HF32, true, COPY>(ring, args.steps[1], row, q, acc, accr);
  if (COPY) mma_operand<true, false, true>(ring, args.steps[2], row, q, acc,
                                           accr);
  fence_regs(acc);
  fence_regs(accr);

  // Epilogue in registers: gate g of hidden column 8 jj + 2 q + e (of this
  // CTA's 32) is acc[4 (4 g + jj) + 2 hr + e]; r is accr[4 jj + 2 hr + e].
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int gr = row0 + row + 8 * hr;
    if (gr >= args.N) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = nb * TILE + 8 * jj + 2 * q;
      const size_t idx = static_cast<size_t>(gr) * Hp + col;
      const float2 cp = *reinterpret_cast<const float2*>(args.c_prev + idx);
      float2 cs = make_float2(0.0f, 0.0f);
      if (COPY) cs = *reinterpret_cast<const float2*>(args.c_star + idx);
      float hv[2], cv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = col + e;
        const int d = 2 * hr + e;
        const float zi = acc[4 * jj + d] + args.bias[j];
        const float zf = acc[4 * (4 + jj) + d] + args.bias[Hp + j];
        const float zg = acc[4 * (8 + jj) + d] + args.bias[2 * Hp + j];
        const float zo = acc[4 * (12 + jj) + d] + args.bias[3 * Hp + j];
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
    }
  }
}

// One producer thread: stage i of an operand holds its K rows [64 i,
// 64 i + 64): two activation boxes and the weight boxes. K past the
// operand's end reads zeros.
template <bool COPY, bool XF32, bool HF32>
__device__ __forceinline__ void produce(const CellArgs& args,
                                        unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, int row0, int nb) {
  const int Hp = args.Hp;
  int it = 0;
  for (int op = 0; op < (COPY ? 3 : 2); ++op) {
    const bool f32 = op == 0 ? XF32 : op == 1 ? HF32 : true;
    const uint32_t bytes = 2 * BM * 32 * (f32 ? 4 : 2) +
                           (op < 2 ? 4 * W_BOX : 0) + (COPY ? W_BOX : 0);
    for (int i = 0; i < args.steps[op]; ++i, ++it) {
      const int s = it % STAGES;
      const int k0 = i * BK;
      if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
      unsigned char* st = smem + s * STAGE;
      mbar_expect_tx(&full[s], bytes);
      tma_load_2d(st, &args.a[op], &full[s], k0, row0);
      tma_load_2d(st + A_HALF, &args.a[op], &full[s], k0 + 32, row0);
      if (op < 2) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
          tma_load_2d(st + A_SLOT + g * W_BOX, &args.wg[op], &full[s],
                      g * Hp + nb * TILE, k0);
      }
      if (COPY)
        tma_load_2d(st + A_SLOT + 4 * W_BOX, &args.wr[op], &full[s],
                    nb * TILE, k0);
    }
  }
}

template <bool COPY, bool XF32, bool HF32>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_cell_kernel(const __grid_constant__ CellArgs args) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int nb = blockIdx.x;  // hidden columns [32 nb, 32 nb + 32)
  const int row0 = blockIdx.y * BM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    if (threadIdx.x == 256)
      produce<COPY, XF32, HF32>(args, smem, full, empty, row0, nb);
  } else {
    Ring ring{smem, full, empty, 0, -1, lane};
    consume<COPY, XF32, HF32>(args, ring, row0, nb, warp, lane, wg);
  }
}

// The map of an activation operand [N, k] (fp32 or bf16) in 128 x 32
// boxes.
cudaError_t activation_map(CUtensorMap* map, const void* a, int f32, int N,
                           int k) {
  return f32 ? tensor_map_2d(map, a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, N, k,
                             k, BM, 32, CU_TENSOR_MAP_SWIZZLE_128B)
             : tensor_map_2d(map, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N,
                             k, k, BM, 32, CU_TENSOR_MAP_SWIZZLE_64B);
}

// The map of a bf16 weight [k, cols] in 64 x 32 boxes.
cudaError_t weight_map(CUtensorMap* map, const void* w, int k, int cols) {
  return tensor_map_2d(map, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, cols,
                       cols, BK, TILE, CU_TENSOR_MAP_SWIZZLE_64B);
}

bool bad_shape(int N, int Dp, int Hp) {
  return N < 1 || Dp < TILE || Dp % TILE || Hp < TILE || Hp % TILE;
}

// One launch, grid (Hp / 32, ceil(N / 128)). The first launch of each
// kernel sets its shared-memory size.
template <bool COPY, bool XF32, bool HF32>
cudaError_t launch(const CellArgs& args, cudaStream_t stream) {
  auto* kernel = lstm_cell_kernel<COPY, XF32, HF32>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid(args.Hp / TILE, (args.N + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM, stream>>>(args);
  return cudaGetLastError();
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

#define CK_TRY(expr)                            \
  do {                                          \
    const cudaError_t ck_err_ = (expr);         \
    if (ck_err_ != cudaSuccess) return ck_err_; \
  } while (0)

// The operands and weights both cells share.
cudaError_t base_args(CellArgs& g, const void* x, const void* h,
                      const void* c, const void* w_x, const void* w_h,
                      const void* b, void* h_out, void* c_out, int N, int Dp,
                      int Hp, int x_f32, int h_f32) {
  g = CellArgs{};
  CK_TRY(activation_map(&g.a[0], x, x_f32, N, Dp));
  CK_TRY(activation_map(&g.a[1], h, h_f32, N, Hp));
  CK_TRY(weight_map(&g.wg[0], w_x, Dp, 4 * Hp));
  CK_TRY(weight_map(&g.wg[1], w_h, Hp, 4 * Hp));
  g.steps[0] = (Dp + BK - 1) / BK;
  g.steps[1] = (Hp + BK - 1) / BK;
  g.steps[2] = (Hp + BK - 1) / BK;
  g.bias = static_cast<const float*>(b);
  g.c_prev = static_cast<const float*>(c);
  g.h_out = static_cast<float*>(h_out);
  g.c_out = static_cast<float*>(c_out);
  g.N = N;
  g.Hp = Hp;
  return cudaSuccess;
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
                  h_f32);
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
                  h_f32);
  if (err == cudaSuccess) err = activation_map(&g.a[2], c_star, 1, N, Hp);
  if (err == cudaSuccess) err = weight_map(&g.wr[0], w_rx, Dp, Hp);
  if (err == cudaSuccess) err = weight_map(&g.wr[1], w_rh, Hp, Hp);
  if (err == cudaSuccess) err = weight_map(&g.wr[2], w_rc, Hp, Hp);
  if (err != cudaSuccess) return (int)err;
  g.bias_r = static_cast<const float*>(br);
  g.c_star = static_cast<const float*>(c_star);
  return (int)launch<true>(g, x_f32, h_f32,
                           static_cast<cudaStream_t>(stream));
}

const char* ck_lstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The width the Python side pads D and H to.
int ck_lstm_tile() { return TILE; }

}  // extern "C"
