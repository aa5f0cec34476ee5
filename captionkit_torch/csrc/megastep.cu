// Fused decode-step cells of EditNet and DCNet beam search.
//
// Replaces the TPU kernels of captionkit/ops/megastep.py:
//   ck_att_cell     <- att_phase's pallas_call (_make_att_kernel):
//                      att-LSTM from split products, then the visual and
//                      SCMA additive-attention scores and softmaxes;
//   ck_lang_cell    <- fused_step_hidden's pallas_call (_make_lang_kernel):
//                      visual context gate, Copy-LSTM base gates, copy gate
//                      and the c*/c_gen blend;
//   ck_dcnet_score  <- dcnet_fused_step_hidden's score kernel
//                      (_make_dcnet_score_kernel);
//   ck_dcnet_cell   <- dcnet_fused_step_hidden's LSTM kernel
//                      (_make_dcnet_lstm_kernel).
//
// Numerics are the reference's: product operands rounded to bf16 (fp32
// activations are rounded as they are loaded), fp32 accumulation, gate
// math, tanh and softmax in fp32, the attention mask -1e9, attention
// weights written in bf16 (round to nearest even).
//
// Design. A TPU row block holds all 4H gate columns of its rows, so the
// Pallas kernels finish h_att and multiply it by Wq in the same kernel. On
// Hopper the blocks run in parallel and one cannot hold [rows, 4H] fp32,
// so each C entry point below is two or three launches on one stream.
//
// The bf16 cell GEMMs run on sm90_cell.cuh, the TMA-ring / register-A
// wgmma GEMM shared with lstm.cu and wholestep.cu: a CTA of 384 threads
// owns 128 rows and either 32 hidden columns of a gated product (its i, f,
// g, o boxes, plus r for the Copy-LSTM) or 128 columns of a plain one; the
// split operands of a cell ([emb | h_lang | h_att], [v_hat | h_att |
// h_lang | c*], [emb | part | h]) are successive K ranges of one
// accumulation, so no concat exists in device memory, and the LSTM update
// runs in registers. At N = 2560 a gated launch is 20 x 32 = 640 CTAs
// (4.8 waves on 132 SMs).
//
//   ck_att_cell (3 launches):
//     1. the att-LSTM over [emb | h_lang | h_att], all fp32 rounded to bf16
//        in registers, K = E + 2H = 3072, plus the row's zvb (kLstmZadd),
//        writing h' and c' in fp32 and h' rounded to bf16: 64.4 GFLOP;
//     2. the two query products as one plain GEMM of that bf16 h' against
//        [Wq_vis | Wq_scma] -> q fp32 [N, 2A] (kStore): 5.4 GFLOP;
//     3. score_kernel for both heads (a programmatic dependent of 2).
//   ck_lang_cell (2 launches):
//     1. the visual gate, v_hat = sigmoid(h_att Wg + bg) * round_bf16(
//        vhat_raw) -> bf16 [N, Fp] (kGateMul): 10.7 GFLOP; its idle threads
//        write bf16 copies of h_att, h_lang and c* (15.7 MB);
//     2. the Copy-LSTM over [v_hat | h_att | h_lang | c*], all bf16: K = F
//        + 2H = 4096 for the base gates and F + 3H = 5120 for r (c* feeds
//        only r), 112.7 GFLOP.
//   ck_dcnet_score (2 launches): the query product from fp32 h (rounded
//     to bf16 in registers) -> q fp32 [N, A] (kStore): 2.7 GFLOP; then
//     score_kernel for its one head (a programmatic dependent).
//   ck_dcnet_cell (2 launches):
//     1. the context gate, part = bf16(sigmoid(h Wg + bg) * ctx) with the
//        fp32 ctx unrounded (kGateMulX32, as the reference multiplies the
//        fp32 einsum): 5.4 GFLOP;
//     2. the decoder LSTM over [emb | part | h] (emb and h fp32 rounded in
//        registers, part bf16), K = 3072, bias b: 64.4 GFLOP.
//
//   score_kernel (both dtypes; att_cell's two heads in one launch,
//     dcnet_score's one), grid = (images, row blocks, heads): a block an
//     image and a head (the visual head's 36 x 512 with no mask, the SCMA
//     head's 22 x 512 masked; the heavier visual blocks first, the SCMA
//     ones filling the tail). Its threads copy the image's attendable keys
//     of the head into shared memory while the query product ends (the
//     kStore tile, like every cell_common.cuh tile, lets its dependent
//     start once all its CTAs run), then wait for q. One warp a row, with
//     the row's q, b and v in registers, takes the row's positions two at
//     a time from shared memory as two independent chains, 16-byte loads
//     of 8 bf16 or 4 fp32 columns a lane; tanh(key + q + b) . v is
//     reduced over A with shuffles; then the warp takes the row's softmax.
//     Each key crosses from L2 once an image and head: keys read through
//     L1 by every row made the stage 1.3-2.1x slower, two or four warps a
//     row 1.2-2.6x (PERF.md). The kernel it replaced in att_cell (a
//     warp a key position over the K rows, q, b and v from shared memory,
//     three loads and an accurate tanhf a term, a plain launch) ran at 18%
//     of its bound in bf16 (PERF.md).
//
// What bounds them on the H100 (paper shape, N = 512 images x 5 beams):
// the cell GEMMs are bound by operations (the att-LSTM's 64.4 GFLOP is 65
// us at 989 TFLOP/s) and score_kernel by its special-function operations:
// one tanh per attendable (row, position, A) term, against 8 MB
// (dcnet_score) or 30 MB (att_cell) of keys. The bf16 instances take it as
// one MUFU.TANH (tanh.approx.f32); tanh_ex2's two (MUFU.EX2, MUFU.RCP)
// made the stage twice as slow, so the special-function unit is its
// limit. The fp32 instances take the accurate tanhf (two MUFU operations
// among some 15 instructions), as the plain version does.
// What stands between the sm90 GEMMs and the tensor-core rate is the L2 ->
// SM traffic: each 128-row block reads its weight columns (the att-LSTM's
// 25.2 MB: 20 x 25.2 = 0.50 GB), each 32-column block its rows'
// activations (the att-LSTM's 12 KB of fp32 a row: 32 x 31.5 MB = 1.0 GB;
// the lang cell's 10 KB of bf16 a row, 0.84 GB, against 0.88 GB of
// weights).
//
// fp32 (compute_dtype="float32"): every entry point runs cell_common.cuh's
// fp32 tile (fp32 FMA on the CUDA cores, not TF32) with the same
// epilogues, then score_kernel's fp32 instance (fp32 keys and weights, the
// accurate tanhf as the plain version takes it, keys read as 4 columns of
// a lane a chunk: 512 contiguous bytes a warp). dcnet_score's product of
// 2560 x 1024 x 512 is 80 tiles of 128 x 128, 0.61 of a wave on 132 SMs,
// so it runs split over K (cell::plain_split: 3 ranges, 240 CTAs in two
// waves of a third of the K each), each row's q the sum of the partials;
// att_cell's 2560 x 1024 x 1024 (160 tiles) runs whole.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "cell_common.cuh"
#include "sm90_cell.cuh"

namespace {

using namespace cell;

constexpr float NEG_INF = -1e9f;  // captionkit nn/masking.py

__device__ __forceinline__ void store_t(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store_t(float* p, float x) { *p = x; }

// ck_lang_cell's bf16 launches on sm90_cell.cuh: the visual gate (one
// fp32 operand, h_att; its idle threads write act16), then the Copy-LSTM
// over [v_hat | h_att | h_lang | c*] in bf16, c* feeding only r.
cudaError_t lang_cell_sm90(const void* vhat_raw, const void* h_att,
                           const void* h_lang, const void* c_lang,
                           const void* c_star, const void* gate_w,
                           const void* gate_b, const void* lang_wv,
                           const void* lang_wha, const void* lang_wh,
                           const void* lang_b, const void* wr_v,
                           const void* wr_ha, const void* wr_hl,
                           const void* wr_c, const void* br, void* h_out,
                           void* c_out, void* vhat, void* act16, int N,
                           int Hp, int Fp, cudaStream_t s) {
  using namespace sm90cell;
  if (N < 1 || Hp < 128 || Hp % 128 || Fp < 128 || Fp % 128)
    return cudaErrorInvalidValue;
  // act16: bf16 copies of h_att, h_lang and c*, [3, N, Hp], written by the
  // gate launch's idle threads (the same rounding the Copy-LSTM would do
  // in registers) so the Copy-LSTM reads bf16 activations only.
  auto* ha16 = static_cast<__nv_bfloat16*>(act16);
  auto* hl16 = ha16 + static_cast<size_t>(N) * Hp;
  auto* cs16 = hl16 + static_cast<size_t>(N) * Hp;
  CellArgs gv = plain_args(N, Fp);
  CK_TRY(set_operand(gv, 0, h_att, 1, Hp, gate_w, Fp, nullptr));
  gv.bias = f32(gate_b);
  gv.x = f32(vhat_raw);
  gv.out = vhat;
  gv.cvt_src[0] = f32(h_att);
  gv.cvt_src[1] = f32(h_lang);
  gv.cvt_src[2] = f32(c_star);
  gv.cvt_dst[0] = ha16;
  gv.cvt_dst[1] = hl16;
  gv.cvt_dst[2] = cs16;
  gv.cvt_n = static_cast<long long>(N) * Hp;
  CK_TRY((launch_cell<kGateMul, 1, 1u, 1u, 0u>(gv, Fp / 128, s)));

  CellArgs g = gated_args(N, Hp);
  CK_TRY(set_operand(g, 0, vhat, 0, Fp, lang_wv, 4 * Hp, wr_v));
  CK_TRY(set_operand(g, 1, ha16, 0, Hp, lang_wha, 4 * Hp, wr_ha));
  CK_TRY(set_operand(g, 2, hl16, 0, Hp, lang_wh, 4 * Hp, wr_hl));
  CK_TRY(set_operand(g, 3, cs16, 0, Hp, nullptr, 0, wr_c));
  g.bias = f32(lang_b);
  g.bias_r = f32(br);
  g.c_prev = f32(c_lang);
  g.c_star = f32(c_star);
  g.h_out = static_cast<float*>(h_out);
  g.c_out = static_cast<float*>(c_out);
  return launch_cell<kCopyLstm, 4, 0u, 0b0111u, 0b1111u>(g, Hp / TILE, s);
}

// ck_att_cell's bf16 products on sm90_cell.cuh: the att-LSTM over [emb |
// h_lang | h_att] (fp32, rounded in registers) plus the row's zvb, writing
// h' also rounded to bf16 (h16), then the query product h16 [Wq_vis |
// Wq_scma] -> q fp32.
cudaError_t att_cell_sm90(const void* emb, const void* h_att,
                          const void* c_att, const void* h_lang,
                          const void* zvb, const void* w_emb,
                          const void* w_hl, const void* w_ha, const void* wq,
                          void* h_out, void* c_out, void* h16, void* q, int N,
                          int Ep, int Hp, int Ap, cudaStream_t s) {
  using namespace sm90cell;
  if (N < 1 || Ep < 128 || Ep % 128 || Hp < 128 || Hp % 128 || Ap < 64 ||
      Ap % 64)
    return cudaErrorInvalidValue;
  CellArgs g = gated_args(N, Hp);
  CK_TRY(set_operand(g, 0, emb, 1, Ep, w_emb, 4 * Hp, nullptr));
  CK_TRY(set_operand(g, 1, h_lang, 1, Hp, w_hl, 4 * Hp, nullptr));
  CK_TRY(set_operand(g, 2, h_att, 1, Hp, w_ha, 4 * Hp, nullptr));
  g.zadd = f32(zvb);
  g.c_prev = f32(c_att);
  g.h_out = static_cast<float*>(h_out);
  g.c_out = static_cast<float*>(c_out);
  g.h_bf16 = static_cast<__nv_bfloat16*>(h16);
  CK_TRY((launch_cell<kLstmZadd, 3, 0b111u, 0b111u, 0u>(g, Hp / TILE, s)));

  CellArgs gq = plain_args(N, 2 * Ap);
  CK_TRY(set_operand(gq, 0, h16, 0, Hp, wq, 2 * Ap, nullptr));
  gq.out = q;
  return launch_cell<kStore, 1, 0u, 1u, 0u>(gq, 2 * Ap / 128, s);
}

// ck_dcnet_cell's bf16 launches on sm90_cell.cuh: the context gate, part
// = bf16(sigmoid(h Wg + bg) * ctx) with ctx unrounded, then the decoder
// LSTM over [emb | part | h] (emb and h fp32, part bf16). A bf16 copy of h
// written by the gate launch's idle threads (as the lang cell does) made
// the pair slower on the card (PERF.md), so the LSTM rounds h itself.
cudaError_t dcnet_cell_sm90(const void* emb, const void* ctx, const void* h,
                            const void* c, const void* gate_w,
                            const void* gate_b, const void* w_emb,
                            const void* w_part, const void* w_h,
                            const void* b, void* h_out, void* c_out,
                            void* part, int N, int Ep, int Hp,
                            cudaStream_t s) {
  using namespace sm90cell;
  if (N < 1 || Ep < 128 || Ep % 128 || Hp < 128 || Hp % 128)
    return cudaErrorInvalidValue;
  CellArgs gp = plain_args(N, Hp);
  CK_TRY(set_operand(gp, 0, h, 1, Hp, gate_w, Hp, nullptr));
  gp.bias = f32(gate_b);
  gp.x = f32(ctx);
  gp.out = part;
  CK_TRY((launch_cell<kGateMulX32, 1, 1u, 1u, 0u>(gp, Hp / 128, s)));

  CellArgs g = gated_args(N, Hp);
  CK_TRY(set_operand(g, 0, emb, 1, Ep, w_emb, 4 * Hp, nullptr));
  CK_TRY(set_operand(g, 1, part, 0, Hp, w_part, 4 * Hp, nullptr));
  CK_TRY(set_operand(g, 2, h, 1, Hp, w_h, 4 * Hp, nullptr));
  g.bias = f32(b);
  g.c_prev = f32(c);
  g.h_out = static_cast<float*>(h_out);
  g.c_out = static_cast<float*>(c_out);
  return launch_cell<kLstm, 3, 0b101u, 0b111u, 0u>(g, Hp / TILE, s);
}

// ---------------------------------------------------------------------------
// score_kernel: the additive scores and softmaxes of ck_att_cell (two heads)
// and ck_dcnet_score (one), after their query products
// ---------------------------------------------------------------------------

// A block holds the rows of one image in one head (at most SK_ROWS of them;
// more take more blocks), SK_WARPS warps a row, and stages the image's
// attendable keys of that head in shared memory, SK_WINDOW positions at a
// time (all 36 regions or 22 caption positions at once). One warp a row
// beat two and four, in both dtypes and both calls (PERF.md).
constexpr int SK_ROWS = 8;
constexpr int SK_WARPS = 1;
constexpr int SK_WINDOW = 40;
constexpr int SK_HEADS = 2;

struct ScoreHead {
  const float* q;     // row n's query at q + n * ldq (partial r: + r plane)
  int ldq;
  const float* b;     // [A] bias inside tanh
  const float* v;     // [A] score vector
  const void* keys;   // [B, P, A] in the keys' type
  const float* mask;  // [B, P] (> 0 = attendable), or null: every position
                      // is (att_cell's visual head)
  void* out;          // [N, P] softmax weights in the keys' type
  int P;
};

struct ScoreKernelArgs {
  ScoreHead head[SK_HEADS];  // blockIdx.z's
  size_t plane;              // floats between two partials of the product
  int split;                 // the query product's partials (bf16: 1)
  int K;                     // query rows per image
  int A;                     // a multiple of 128, at most CHUNK NC
};

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
  x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = __bfloat162float(h[j]);
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  x[0] = r.x, x[1] = r.y, x[2] = r.z, x[3] = r.w;
}

// A lane's columns of A for keys of type KT: VEC (one 16-byte load) at VEC
// lane + CHUNK c, c < NC (bf16: 8 lane + 256 c; fp32: 4 lane + 128 c, so
// each load of a warp reads 512 contiguous bytes).
template <typename KT>
struct ScoreLanes {
  static constexpr int VEC = 16 / sizeof(KT);
  static constexpr int CHUNK = 32 * VEC;
};

__device__ __forceinline__ void loadv(const __nv_bfloat16* p,
                                      float (&x)[8]) {
  load8(p, x);
}
__device__ __forceinline__ void loadv(const float* p, float (&x)[8]) {
  load8(p, x);
}
__device__ __forceinline__ void loadv(const float* p, float (&x)[4]) {
  load4(p, x);
}

// Row `row`'s q in head `hd` (fp32: the sum of the product's `split`
// partials in rank order, their loads issued together), b and v at the
// lane's columns.
template <int NC, typename KT>
__device__ __forceinline__ void load_query(
    const ScoreHead& hd, const ScoreKernelArgs& a, int row, int lane,
    float (&qr)[NC][ScoreLanes<KT>::VEC], float (&br)[NC][ScoreLanes<KT>::VEC],
    float (&vr)[NC][ScoreLanes<KT>::VEC]) {
  constexpr int VEC = ScoreLanes<KT>::VEC, CHUNK = ScoreLanes<KT>::CHUNK;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = min(VEC * lane + CHUNK * c, a.A - VEC);
    const float* q = hd.q + (size_t)row * hd.ldq + col;
    loadv(q, qr[c]);
    if constexpr (sizeof(KT) == 4) {
      float x[MAX_OPS - 1][VEC];
#pragma unroll
      for (int r = 1; r < MAX_OPS; ++r)
        if (r < a.split) loadv(q + r * a.plane, x[r - 1]);
#pragma unroll
      for (int r = 1; r < MAX_OPS; ++r)
        if (r < a.split)
#pragma unroll
          for (int j = 0; j < VEC; ++j) qr[c][j] += x[r - 1][j];
    }
    loadv(hd.b + col, br[c]);
    loadv(hd.v + col, vr[c]);
  }
}

// The scores of positions whose keys are k0 and k1 (rows of A), two
// chains at once: (key + q) + b, as the plain version adds them; bf16 tanh
// as tanh_approx (one MUFU.TANH; tanh_ex2's two MUFU operations made the
// stage twice as slow: PERF.md), fp32 the accurate tanhf (as the plain
// version). Reduced over the warp with shuffles.
template <int NC, typename KT>
__device__ __forceinline__ void score_pair(
    const KT* k0, const KT* k1, int A, int lane,
    const float (&qr)[NC][ScoreLanes<KT>::VEC],
    const float (&br)[NC][ScoreLanes<KT>::VEC],
    const float (&vr)[NC][ScoreLanes<KT>::VEC], float& acc0, float& acc1) {
  constexpr int VEC = ScoreLanes<KT>::VEC, CHUNK = ScoreLanes<KT>::CHUNK;
  acc0 = 0.0f;
  acc1 = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = VEC * lane + CHUNK * c;
    if (col < A) {
      float x0[VEC], x1[VEC];
      loadv(k0 + col, x0);
      loadv(k1 + col, x1);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if constexpr (sizeof(KT) == 4) {
          acc0 += tanhf(x0[j] + qr[c][j] + br[c][j]) * vr[c][j];
          acc1 += tanhf(x1[j] + qr[c][j] + br[c][j]) * vr[c][j];
        } else {
          acc0 += sm90::tanh_approx(x0[j] + qr[c][j] + br[c][j]) * vr[c][j];
          acc1 += sm90::tanh_approx(x1[j] + qr[c][j] + br[c][j]) * vr[c][j];
        }
      }
    }
  }
  acc0 = warp_sum(acc0);
  acc1 = warp_sum(acc1);
}

// The next two attendable positions of `bits` (p1 = p0 when one is left).
__device__ __forceinline__ void next_pair(unsigned& bits, int t0, int& p0,
                                          int& p1) {
  p0 = t0 + __ffs(bits) - 1;
  bits &= bits - 1;
  p1 = p0;
  if (bits) {
    p1 = t0 + __ffs(bits) - 1;
    bits &= bits - 1;
  }
}

// A warp's softmax of its row's scores ss [P], written in KT.
template <typename KT>
__device__ __forceinline__ void row_softmax(const float* ss, int P, int lane,
                                            KT* o) {
  float m = -INFINITY;
  for (int p = lane; p < P; p += 32) m = fmaxf(m, ss[p]);
  m = warp_max(m);
  float sum = 0.0f;
  for (int p = lane; p < P; p += 32) sum += expf(ss[p] - m);
  sum = warp_sum(sum);
  for (int p = lane; p < P; p += 32) store_t(o + p, expf(ss[p] - m) / sum);
}

// grid (images, ceil(K / SK_ROWS), heads): a block holds rows [r0, r0 +
// rows) of image blockIdx.x in head blockIdx.z, SK_WARPS warps a row. A
// programmatic dependent of the query product: before it waits for the
// product, every thread copies the image's attendable keys of a window of
// SK_WINDOW positions into shared memory (cp.async, 16 bytes a copy), so
// each key crosses from L2 once a block while the product ends, and never
// once a row (keys read through L1 by every row made the stage 1.3-2.1x
// slower: PERF.md). Then each warp of a row keeps the row's
// q, b and v of its lane's columns (ScoreLanes, c < NC) in registers and
// takes every SK_WARPS-th pair of the window's attendable positions (a
// ballot of the mask, 32 positions at a time; a null mask attends to
// every position) from shared memory as two independent chains; tanh(key
// + q + b) . v is reduced over A with shuffles into the row's scores in
// shared memory. The row's warps meet (a named barrier; one warp, a warp
// barrier), and the first takes the row's softmax.
template <int NC, typename KT>
__global__ void __launch_bounds__(32 * SK_WARPS * SK_ROWS)
    score_kernel(const __grid_constant__ ScoreKernelArgs a) {
  constexpr int VEC = ScoreLanes<KT>::VEC;
  extern __shared__ __align__(16) unsigned char sk_smem[];
  // Read from the parameters where used (a copy selected in registers
  // made the fp32 stage 20% slower: PERF.md).
  const ScoreHead& hd = a.head[blockIdx.z];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int A = a.A, P = hd.P;
  const int win = min(P, SK_WINDOW);
  const int img = blockIdx.x;
  const int r0 = blockIdx.y * SK_ROWS;
  const int rows = min(SK_ROWS, a.K - r0);
  const int lr = warp / SK_WARPS, turn = warp % SK_WARPS;
  const bool active = lr < rows;
  const int row = img * a.K + r0 + lr;
  // Shared memory: a window's keys [win, A], then the rows' scores [rows,
  // P].
  KT* sk = reinterpret_cast<KT*>(sk_smem);
  float* ss = reinterpret_cast<float*>(sk + (size_t)win * A) + lr * P;
  const KT* kimg = static_cast<const KT*>(hd.keys) + (size_t)img * P * A;
  const float* mimg = hd.mask ? hd.mask + (size_t)img * P : nullptr;
  const int chunks = A / VEC;  // 16-byte copies a key
  float qr[NC][VEC], br[NC][VEC], vr[NC][VEC];
  float acc0, acc1;
  int p0, p1, k = 0;
  for (int t0 = 0; t0 < P; t0 += win) {
    const int n = min(win, P - t0);
    if (t0 > 0) __syncthreads();  // the last window's keys are read
    for (int i = threadIdx.x; i < n * chunks; i += blockDim.x) {
      const int p = i / chunks;
      if (mimg && !(mimg[t0 + p] > 0.0f)) continue;
      const size_t e = (size_t)p * A + (size_t)(i - p * chunks) * VEC;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       sm90::smem_u32(sk + e)),
                   "l"(kimg + (size_t)t0 * A + e)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    if (t0 == 0) {
      sm90::grid_dependency_wait();  // q is the query product's output
      if (active) load_query<NC, KT>(hd, a, row, lane, qr, br, vr);
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    if (!active) continue;
    for (int g0 = t0; g0 < t0 + n; g0 += 32) {
      const int pl = g0 + lane;
      const bool in = pl < t0 + n;
      const bool attend = in && (!mimg || mimg[pl] > 0.0f);
      if (in && !attend && turn == 0) ss[pl] = NEG_INF;
      unsigned bits = __ballot_sync(0xffffffffu, attend);
      for (; bits; ++k) {
        next_pair(bits, g0, p0, p1);
        if (k % SK_WARPS != turn) continue;
        score_pair<NC, KT>(sk + (size_t)(p0 - t0) * A,
                           sk + (size_t)(p1 - t0) * A, A, lane, qr, br, vr,
                           acc0, acc1);
        if (lane == 0) {
          ss[p0] = acc0;
          ss[p1] = acc1;
        }
      }
    }
  }
  if (!active) return;
  // The row's warps meet; the first takes the softmax.
  if constexpr (SK_WARPS > 1)
    sm90::named_sync(1 + lr, 32 * SK_WARPS);
  else
    __syncwarp();
  if (turn == 0)
    row_softmax(ss, P, lane, static_cast<KT*>(hd.out) + (size_t)row * P);
}

// One launch of score_kernel<NC, KT> over `heads` heads of B images, a
// programmatic dependent of the query product before it on the stream
// (whose CTAs trigger it as they start).
template <int NC, typename KT>
cudaError_t launch_score_kernel(const ScoreKernelArgs& a, int B, int heads,
                                cudaStream_t s) {
  const int rows = a.K < SK_ROWS ? a.K : SK_ROWS;
  size_t smem = 0;
  for (int h = 0; h < heads; ++h) {
    const int P = a.head[h].P, win = P < SK_WINDOW ? P : SK_WINDOW;
    const size_t need =
        sizeof(KT) * (size_t)win * a.A + sizeof(float) * (size_t)rows * P;
    if (need > smem) smem = need;
  }
  // The largest shared-memory size set on each device (48 KB needs none).
  static size_t sized[sm90::kDevices] = {};
  const int dev = sm90::device_slot();
  if (smem > 48 * 1024 && (dev < 0 || smem > sized[dev])) {
    CK_TRY(cudaFuncSetAttribute(score_kernel<NC, KT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem));
    if (dev >= 0) sized[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, (a.K + SK_ROWS - 1) / SK_ROWS, heads);
  cfg.blockDim = dim3(32 * SK_WARPS * rows);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  CK_TRY(cudaLaunchKernelEx(&cfg, score_kernel<NC, KT>, a));
  return cudaGetLastError();
}

// score_kernel's instance for A: the lanes' columns in NC register chunks
// (bf16: NC = A / 256 rounded up to 1, 2 or 4; fp32: A / 128, 1, 2, 4 or
// 8).
template <typename KT>
cudaError_t launch_scores(const ScoreKernelArgs& a, int B, int heads,
                          cudaStream_t s) {
  constexpr int CHUNK = ScoreLanes<KT>::CHUNK;
  if (a.A < 128 || a.A % 128 || a.A > 1024 || a.K < 1 || B < 1)
    return cudaErrorInvalidValue;
  if (a.A <= CHUNK) return launch_score_kernel<1, KT>(a, B, heads, s);
  if (a.A <= 2 * CHUNK) return launch_score_kernel<2, KT>(a, B, heads, s);
  if (a.A <= 4 * CHUNK) return launch_score_kernel<4, KT>(a, B, heads, s);
  if constexpr (CHUNK == 128) return launch_score_kernel<8, KT>(a, B, heads, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// ck_dcnet_score: the query product (bf16 on sm90_cell.cuh's wgmma; fp32 on
// cell_common.cuh's fp32 tile, split over K), then score_kernel
// ---------------------------------------------------------------------------

// score_kernel's one head for ck_dcnet_score: q [split, N, Ap] partials.
ScoreKernelArgs dcnet_score_args(const void* b, const void* v,
                                 const void* keys, const void* mask,
                                 void* omega, const void* q, int N, int B,
                                 int Ap, int T, int split) {
  ScoreKernelArgs a = {};
  a.head[0] = {static_cast<const float*>(q), Ap, cell::f32(b), cell::f32(v),
               keys, cell::f32(mask), omega, T};
  a.plane = (size_t)N * Ap;
  a.split = split;
  a.K = N / B;
  a.A = Ap;
  return a;
}

// ck_dcnet_score's bf16 launches: the query product on sm90_cell.cuh (fp32
// h rounded to bf16 in registers, q fp32: kStore), then score_kernel.
cudaError_t dcnet_score_sm90(const void* h, const void* wq, const void* b,
                             const void* v, const void* keys,
                             const void* mask, void* omega, void* q, int N,
                             int B, int Hp, int Ap, int T, cudaStream_t s) {
  using namespace sm90cell;
  if (N < 1 || Hp < 128 || Hp % 128 || Ap < 128 || Ap % 128 || Ap > 1024)
    return cudaErrorInvalidValue;
  CellArgs gq = plain_args(N, Ap);
  CK_TRY(set_operand(gq, 0, h, 1, Hp, wq, Ap, nullptr));
  gq.out = q;
  CK_TRY((launch_cell<kStore, 1, 1u, 1u, 0u>(gq, Ap / 128, s)));

  return launch_scores<__nv_bfloat16>(
      dcnet_score_args(b, v, keys, mask, omega, q, N, B, Ap, T, 1), B, 1, s);
}

// The K ranges of the fp32 query product of N rows, K = Hp, Ap columns on
// `device`'s SMs (cell::plain_split), or a negative CUDA error.
int f32_split(int N, int Hp, int Ap, int device) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  const int tiles = (Ap / (4 * BN)) * ((N + TILE_ROWS - 1) / TILE_ROWS);
  return plain_split(tiles, Hp / BK, sms);
}

// ck_dcnet_score's fp32 launches: the query product on cell_common.cuh's
// fp32 tile, split over K (q [split, N, Ap] fp32 partials), then
// score_kernel's fp32 instance.
cudaError_t dcnet_score_f32(const void* h, const void* wq, const void* b,
                            const void* v, const void* keys,
                            const void* mask, void* omega, void* q, int N,
                            int B, int Hp, int Ap, int T, int device,
                            cudaStream_t s) {
  if (N < 1 || Hp < BK || Hp % BK || Ap < 128 || Ap % 128 || Ap > 1024)
    return cudaErrorInvalidValue;
  const int split = f32_split(N, Hp, Ap, device);
  if (split < 1) return static_cast<cudaError_t>(-split);
  GemmArgs gq = gemm_args(N, Ap);
  split_operands(gq, h, Hp, wq, split);
  gq.out = q;
  CK_TRY((launch_gemm<4, EPI_STORE>(gq, s)));

  return launch_scores<float>(
      dcnet_score_args(b, v, keys, mask, omega, q, N, B, Ap, T, split), B, 1,
      s);
}

}  // namespace

extern "C" {

// EditNet, first half of the step (att_phase's kernel). fp32 inputs: emb
// [N, Ep], h_att, c_att, h_lang [N, Hp], zvb [N, 4Hp] (the hoisted v_mean
// product plus the bias, gate-major); weights w_emb [Ep, 4Hp], w_hl, w_ha
// [Hp, 4Hp], wq [Hp, 2Ap] (visual | SCMA query products); fp32 vis_b,
// vis_v, scma_b, scma_v [Ap]; keys vis_keys [B, R, Ap], scma_keys [B, T,
// Ap]; fp32 mask [B, T]. Outputs: h_out, c_out [N, Hp] fp32, alpha [N, R]
// and beta [N, T]. Scratch: q [N, 2Ap] fp32 and (bf16 only) h16 [N, Hp]
// bf16. Weights, keys, alpha and beta are bf16 (sm90_cell.cuh; Ep, Hp
// multiples of 128), or fp32 when f32 (cell_common.cuh's fp32 tile; h16
// unused).
int ck_att_cell(const void* emb, const void* h_att, const void* c_att,
                const void* h_lang, const void* zvb, const void* w_emb,
                const void* w_hl, const void* w_ha, const void* wq,
                const void* vis_b, const void* vis_v, const void* scma_b,
                const void* scma_v, const void* vis_keys,
                const void* scma_keys, const void* mask, void* h_out,
                void* c_out, void* alpha, void* beta, void* q, void* h16,
                int N, int B, int Ep, int Hp, int Ap, int R, int T, int f32,
                int device, void* stream) {
  if (B < 1 || N % B || R < 1 || T < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  if (f32) {
    GemmArgs g = gemm_args(N, Hp);
    g.op[0] = operand(emb, Ep, w_emb);
    g.op[1] = operand(h_lang, Hp, w_hl);
    g.op[2] = operand(h_att, Hp, w_ha);
    g.n_ops = 3;
    g.zadd = cell::f32(zvb);
    g.c_prev = cell::f32(c_att);
    g.h_out = static_cast<float*>(h_out);
    g.c_out = static_cast<float*>(c_out);
    err = launch_gemm<4, EPI_LSTM>(g, s);
    if (err != cudaSuccess) return (int)err;

    GemmArgs gq = gemm_args(N, 2 * Ap);
    gq.op[0] = operand(h_out, Hp, wq);
    gq.n_ops = 1;
    gq.out = q;
    err = launch_gemm<4, EPI_STORE>(gq, s);
  } else {
    err = att_cell_sm90(emb, h_att, c_att, h_lang, zvb, w_emb, w_hl, w_ha,
                        wq, h_out, c_out, h16, q, N, Ep, Hp, Ap, s);
  }
  if (err != cudaSuccess) return (int)err;

  // score_kernel over both heads: the visual one (no mask), then SCMA.
  ScoreKernelArgs sc = {};
  const float* qf = static_cast<const float*>(q);
  sc.head[0] = {qf, 2 * Ap, cell::f32(vis_b), cell::f32(vis_v), vis_keys,
                nullptr, alpha, R};
  sc.head[1] = {qf + Ap, 2 * Ap, cell::f32(scma_b), cell::f32(scma_v),
                scma_keys, cell::f32(mask), beta, T};
  sc.split = 1;
  sc.K = N / B;
  sc.A = Ap;
  return (int)(f32 ? launch_scores<float>(sc, B, 2, s)
                   : launch_scores<__nv_bfloat16>(sc, B, 2, s));
}

// EditNet, second half (the lang kernel). fp32 inputs: vhat_raw [N, Fp]
// (the alpha-weighted features, rounded to bf16 here as the reference
// rounds them), h_att, h_lang, c_lang, c_star [N, Hp]; weights gate_w [Hp,
// Fp], lang_wv [Fp, 4Hp], lang_wha, lang_wh [Hp, 4Hp], wr_v [Fp, Hp],
// wr_ha, wr_hl, wr_c [Hp, Hp]; fp32 gate_b [Fp], lang_b [4Hp], br [Hp].
// Outputs: h_out, c_out [N, Hp] fp32. Scratch: vhat [N, Fp] and (bf16
// only) act16 [3, N, Hp] bf16. Weights and vhat are bf16 (sm90_cell.cuh,
// Hp and Fp multiples of 128), or fp32 when f32 (cell_common.cuh's fp32
// tile; nothing rounded; act16 unused).
int ck_lang_cell(const void* vhat_raw, const void* h_att, const void* h_lang,
                 const void* c_lang, const void* c_star, const void* gate_w,
                 const void* gate_b, const void* lang_wv,
                 const void* lang_wha, const void* lang_wh,
                 const void* lang_b, const void* wr_v, const void* wr_ha,
                 const void* wr_hl, const void* wr_c, const void* br,
                 void* h_out, void* c_out, void* vhat, void* act16, int N,
                 int Hp, int Fp, int f32, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!f32)
    return (int)lang_cell_sm90(vhat_raw, h_att, h_lang, c_lang, c_star,
                               gate_w, gate_b, lang_wv, lang_wha, lang_wh,
                               lang_b, wr_v, wr_ha, wr_hl, wr_c, br, h_out,
                               c_out, vhat, act16, N, Hp, Fp, s);

  GemmArgs gv = gemm_args(N, Fp);
  gv.op[0] = operand(h_att, Hp, gate_w);
  gv.n_ops = 1;
  gv.bias = cell::f32(gate_b);
  gv.x = cell::f32(vhat_raw);
  gv.out = vhat;
  err = launch_gemm<4, EPI_GATE_MUL>(gv, s);
  if (err != cudaSuccess) return (int)err;

  GemmArgs g = gemm_args(N, Hp);
  g.op[0] = operand(vhat, Fp, lang_wv, wr_v);
  g.op[1] = operand(h_att, Hp, lang_wha, wr_ha);
  g.op[2] = operand(h_lang, Hp, lang_wh, wr_hl);
  g.op[3] = operand(c_star, Hp, nullptr, wr_c);
  g.n_ops = 4;
  g.bias = cell::f32(lang_b);
  g.bias_r = cell::f32(br);
  g.c_prev = cell::f32(c_lang);
  g.c_star = cell::f32(c_star);
  g.h_out = static_cast<float*>(h_out);
  g.c_out = static_cast<float*>(c_out);
  return (int)launch_gemm<5, EPI_COPY_LSTM>(g, s);
}

// DCNet score kernel. fp32 h [N, Hp]; att_wq [Hp, Ap]; fp32 att_b, att_v
// [Ap]; keys [B, T, Ap]; fp32 mask [B, T]. Output: omega [N, T]. Scratch:
// q [split, N, Ap] fp32, split = ck_f32_split(N, Hp, Ap, device) when f32,
// else 1. att_wq, keys and omega are bf16 (sm90_cell.cuh, then
// score_kernel; Ap at most 1024), or fp32 when f32 (cell_common.cuh's fp32
// tile split over K, then score_kernel's fp32 instance; Ap at most 1024).
int ck_dcnet_score(const void* h, const void* att_wq, const void* att_b,
                   const void* att_v, const void* keys, const void* mask,
                   void* omega, void* q, int N, int B, int Hp, int Ap, int T,
                   int f32, int device, void* stream) {
  if (B < 1 || N % B || T < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!f32)
    return (int)dcnet_score_sm90(h, att_wq, att_b, att_v, keys, mask, omega,
                                 q, N, B, Hp, Ap, T, s);
  return (int)dcnet_score_f32(h, att_wq, att_b, att_v, keys, mask, omega, q,
                              N, B, Hp, Ap, T, device, s);
}

// The partials of ck_dcnet_score's fp32 query product at N rows, K = Hp
// and Ap columns on `device` (the planes of its scratch q), or a negative
// CUDA error.
int ck_f32_split(int N, int Hp, int Ap, int device) {
  return f32_split(N, Hp, Ap, device);
}

// DCNet LSTM kernel. fp32 emb [N, Ep], ctx (the omega-weighted encoder
// states), h, c [N, Hp]; gate_w [Hp, Hp], w_emb [Ep, 4Hp], w_part, w_h [Hp,
// 4Hp]; fp32 gate_b [Hp], b [4Hp]. Outputs: h_out, c_out [N, Hp] fp32.
// Scratch: part [N, Hp]. Weights and part are bf16 (sm90_cell.cuh; Ep,
// Hp multiples of 128), or fp32 when f32 (cell_common.cuh's fp32 tile).
int ck_dcnet_cell(const void* emb, const void* ctx, const void* h,
                  const void* c, const void* gate_w, const void* gate_b,
                  const void* w_emb, const void* w_part, const void* w_h,
                  const void* b, void* h_out, void* c_out, void* part,
                  int N, int Ep, int Hp, int f32, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!f32)
    return (int)dcnet_cell_sm90(emb, ctx, h, c, gate_w, gate_b, w_emb, w_part,
                                w_h, b, h_out, c_out, part, N, Ep, Hp, s);

  GemmArgs gp = gemm_args(N, Hp);
  gp.op[0] = operand(h, Hp, gate_w);
  gp.n_ops = 1;
  gp.bias = cell::f32(gate_b);
  gp.x = cell::f32(ctx);
  gp.out = part;
  err = launch_gemm<4, EPI_GATE_MUL>(gp, s);
  if (err != cudaSuccess) return (int)err;

  GemmArgs g = gemm_args(N, Hp);
  g.op[0] = operand(emb, Ep, w_emb);
  g.op[1] = operand(part, Hp, w_part);
  g.op[2] = operand(h, Hp, w_h);
  g.n_ops = 3;
  g.bias = cell::f32(b);
  g.c_prev = cell::f32(c);
  g.h_out = static_cast<float*>(h_out);
  g.c_out = static_cast<float*>(c_out);
  return (int)launch_gemm<4, EPI_LSTM>(g, s);
}

const char* ck_megastep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The column tiles the Python side pads to: gated widths are multiples of
// ck_megastep_gate_width(), plain output widths and K ranges of
// ck_megastep_plain_width().
int ck_megastep_gate_width() { return BN; }

int ck_megastep_plain_width() { return 4 * BN; }

}  // extern "C"
