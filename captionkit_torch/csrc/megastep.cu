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
//     3. scores_kernel for both heads.
//   ck_lang_cell (2 launches):
//     1. the visual gate, v_hat = sigmoid(h_att Wg + bg) * round_bf16(
//        vhat_raw) -> bf16 [N, Fp] (kGateMul): 10.7 GFLOP; its idle threads
//        write bf16 copies of h_att, h_lang and c* (15.7 MB);
//     2. the Copy-LSTM over [v_hat | h_att | h_lang | c*], all bf16: K = F
//        + 2H = 4096 for the base gates and F + 3H = 5120 for r (c* feeds
//        only r), 112.7 GFLOP.
//   ck_dcnet_score (2 launches): the query product from fp32 h (rounded
//     to bf16 in registers) -> q fp32 [N, A] (kStore): 2.7 GFLOP; then
//     dcnet_scores_kernel.
//   ck_dcnet_cell (2 launches):
//     1. the context gate, part = bf16(sigmoid(h Wg + bg) * ctx) with the
//        fp32 ctx unrounded (kGateMulX32, as the reference multiplies the
//        fp32 einsum): 5.4 GFLOP;
//     2. the decoder LSTM over [emb | part | h] (emb and h fp32 rounded in
//        registers, part bf16), K = 3072, bias b: 64.4 GFLOP.
//
//   scores_kernel (att_cell, bf16 and fp32), grid = (images, attention
//     heads): one block per image. Each warp takes a key position, holds
//     that key row in registers and reuses it for the image's K query rows
//     (the keys are read once per image, never repeated K-fold in device
//     memory); tanh(key + q + b) . v is reduced over A with warp shuffles;
//     then one warp per query row takes the masked softmax.
//   dcnet_scores_kernel (dcnet_score, bf16 and fp32): one warp per query
//     row (fp32: two), its q, b and v in registers, walking its image's
//     attendable keys two at a time (bf16: read from L1 after the image's
//     first row; fp32: from shared memory, copied in once a block of the
//     image's rows); then the row's softmax.
//
// What bounds them on the H100 (paper shape, N = 512 images x 5 beams):
// the cell GEMMs are bound by operations (the att-LSTM's 64.4 GFLOP is 65
// us at 989 TFLOP/s) and the score kernels by the tanh: one per attendable
// (row, position, A) term, two special-function operations each (MUFU.EX2,
// MUFU.RCP; dcnet_scores_kernel's tanh_ex2 issues just those and three
// other instructions, the accurate tanhf of scores_kernel some 15), against
// 8 MB of keys.
// What stands between the sm90 GEMMs and the tensor-core rate is the L2 ->
// SM traffic: each 128-row block reads its weight columns (the att-LSTM's
// 25.2 MB: 20 x 25.2 = 0.50 GB), each 32-column block its rows'
// activations (the att-LSTM's 12 KB of fp32 a row: 32 x 31.5 MB = 1.0 GB;
// the lang cell's 10 KB of bf16 a row, 0.84 GB, against 0.88 GB of
// weights).
//
// fp32 (compute_dtype="float32"): every entry point runs cell_common.cuh's
// fp32 tile (fp32 FMA on the CUDA cores, not TF32) with the same
// epilogues; att_cell's scores_kernel reads fp32 keys and writes fp32
// weights. dcnet_score's product of 2560 x 1024 x 512 is 80 tiles of 128 x
// 128, 0.61 of a wave on 132 SMs, so it runs split over K (cell::
// plain_split: 3 ranges, 240 CTAs in two waves of a third of the K each),
// then dcnet_scores_kernel's fp32 instance, a programmatic dependent: a
// block an image, which copies the image's attendable keys into shared
// memory while the product ends, two warps a row, each row's q the sum
// of the partials, keys read as 4 columns of a lane a chunk (16-byte
// loads, 512 contiguous bytes a warp), the accurate tanhf as the plain
// version takes it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "cell_common.cuh"
#include "sm90_cell.cuh"

namespace {

using namespace cell;

constexpr float NEG_INF = -1e9f;  // captionkit nn/masking.py

constexpr int SC_THREADS = 256;  // scores_kernel: 8 warps
constexpr int SC_MAXV = 32;      // A <= 32 * 32 = 1024
constexpr int SMEM_LIMIT = 48 * 1024;

struct ScoreHead {
  const float* q;  // row n's query at q + n * ldq, [A] fp32
  int ldq;
  const float* b;                 // [A] bias inside tanh
  const float* v;                 // [A] score vector
  const void* keys;               // [B, P, A] in T
  const float* mask;              // [B, P] (> 0 = attendable), or null:
                                  // every position valid
  int P;
  void* out;                      // [N, P] softmax weights in T
};

struct ScoreArgs {
  ScoreHead head[2];
  int K;  // query rows per image
  int A;
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store_t(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store_t(float* p, float x) { *p = x; }

template <typename T>
__global__ void __launch_bounds__(SC_THREADS)
scores_kernel(const ScoreArgs args) {
  extern __shared__ float sm[];
  const ScoreHead hd = args.head[blockIdx.y];
  const int K = args.K;
  const int A = args.A;
  const int P = hd.P;
  const int img = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  constexpr int WARPS = SC_THREADS / 32;
  float* qs = sm;          // [K, A]
  float* bs = qs + K * A;  // [A]
  float* vs = bs + A;      // [A]
  float* ss = vs + A;      // [K, P] scores

  for (int e = tid; e < K * A; e += SC_THREADS)
    qs[e] = hd.q[(size_t)(img * K + e / A) * hd.ldq + e % A];
  for (int a = tid; a < A; a += SC_THREADS) {
    bs[a] = hd.b[a];
    vs[a] = hd.v[a];
  }
  __syncthreads();

  const int nv = A / 32;
  for (int p = warp; p < P; p += WARPS) {
    const bool valid = !hd.mask || hd.mask[(size_t)img * P + p] > 0.0f;
    if (!valid) {
      if (lane == 0)
        for (int r = 0; r < K; ++r) ss[r * P + p] = NEG_INF;
      continue;
    }
    const T* kr = static_cast<const T*>(hd.keys) + ((size_t)img * P + p) * A;
    float key[SC_MAXV];
#pragma unroll
    for (int i = 0; i < SC_MAXV; ++i)
      if (i < nv) key[i] = to_f32(kr[lane + 32 * i]);
    for (int r = 0; r < K; ++r) {
      const float* qr = qs + r * A;
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < SC_MAXV; ++i) {
        if (i < nv) {
          const int a = lane + 32 * i;
          acc += tanhf(key[i] + qr[a] + bs[a]) * vs[a];
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) ss[r * P + p] = acc;
    }
  }
  __syncthreads();

  for (int r = warp; r < K; r += WARPS) {
    const float* s = ss + r * P;
    float m = -INFINITY;
    for (int p = lane; p < P; p += 32) m = fmaxf(m, s[p]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int p = lane; p < P; p += 32) sum += expf(s[p] - m);
    sum = warp_sum(sum);
    T* o = static_cast<T*>(hd.out) + (size_t)(img * K + r) * P;
    for (int p = lane; p < P; p += 32) store_t(o + p, expf(s[p] - m) / sum);
  }
}

cudaError_t launch_scores(const ScoreArgs& a, int B, int n_heads, int f32,
                          cudaStream_t s) {
  int max_p = a.head[0].P;
  if (n_heads > 1 && a.head[1].P > max_p) max_p = a.head[1].P;
  if (a.A % 32 || a.A > 32 * SC_MAXV || a.K < 1 || B < 1)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)a.K * a.A + 2 * a.A +
                                       (size_t)a.K * max_p);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  if (f32)
    scores_kernel<float><<<dim3(B, n_heads), SC_THREADS, smem, s>>>(a);
  else
    scores_kernel<__nv_bfloat16><<<dim3(B, n_heads), SC_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

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
// ck_dcnet_score: the query product, then dcnet_scores_kernel (bf16 on
// sm90_cell.cuh's wgmma; fp32 on cell_common.cuh's fp32 tile, split over K)
// ---------------------------------------------------------------------------

constexpr int DS_ROWS = 4;  // bf16: query rows of a dcnet_scores_kernel block
// fp32: a block holds the rows of one image (at most DS_F32_ROWS of them;
// more take more blocks), two warps a row, and stages the image's
// attendable keys in shared memory, DS_F32_WINDOW positions at a time.
constexpr int DS_F32_ROWS = 8;
constexpr int DS_F32_WARPS = 2;
constexpr int DS_F32_WINDOW = 32;

template <typename KT>
struct DcnetScoreArgs {
  const float* q;     // [split, N, A] fp32 (the query product's partials)
  const float* b;     // [A] bias inside tanh
  const float* v;     // [A] score vector
  const KT* keys;     // [B, T, A]
  const float* mask;  // [B, T] (> 0 = attendable)
  KT* omega;          // [N, T] softmax weights
  int N;
  int K;  // query rows per image
  int T;
  int A;  // a multiple of 128, at most CHUNK NC
  int split;
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

// Row `row`'s q (the sum of the product's `split` partials in rank order,
// their loads issued together), b and v at the lane's columns.
template <int NC, typename KT>
__device__ __forceinline__ void load_query(
    const DcnetScoreArgs<KT>& a, int row, int lane,
    float (&qr)[NC][ScoreLanes<KT>::VEC], float (&br)[NC][ScoreLanes<KT>::VEC],
    float (&vr)[NC][ScoreLanes<KT>::VEC]) {
  constexpr int VEC = ScoreLanes<KT>::VEC, CHUNK = ScoreLanes<KT>::CHUNK;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = min(VEC * lane + CHUNK * c, a.A - VEC);
    loadv(a.q + (size_t)row * a.A + col, qr[c]);
    if constexpr (sizeof(KT) == 4) {
      float x[MAX_OPS - 1][VEC];
#pragma unroll
      for (int r = 1; r < MAX_OPS; ++r)
        if (r < a.split)
          loadv(a.q + ((size_t)r * a.N + row) * a.A + col, x[r - 1]);
#pragma unroll
      for (int r = 1; r < MAX_OPS; ++r)
        if (r < a.split)
#pragma unroll
          for (int j = 0; j < VEC; ++j) qr[c][j] += x[r - 1][j];
    }
    loadv(a.b + col, br[c]);
    loadv(a.v + col, vr[c]);
  }
}

// The scores of positions whose keys are k0 and k1 (rows of A), two
// chains at once; bf16 tanh as tanh_ex2, fp32 the accurate tanhf (as the
// plain version). Reduced over the warp with shuffles.
template <int NC, typename KT, typename Src>
__device__ __forceinline__ void score_pair(
    const Src* k0, const Src* k1, int A, int lane,
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
          acc0 += sm90::tanh_ex2(x0[j] + qr[c][j] + br[c][j]) * vr[c][j];
          acc1 += sm90::tanh_ex2(x1[j] + qr[c][j] + br[c][j]) * vr[c][j];
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

// A warp's softmax of its row's scores ss [T], written as omega in KT.
template <typename KT>
__device__ __forceinline__ void row_softmax(const float* ss, int T, int lane,
                                            KT* o) {
  float m = -INFINITY;
  for (int p = lane; p < T; p += 32) m = fmaxf(m, ss[p]);
  m = warp_max(m);
  float sum = 0.0f;
  for (int p = lane; p < T; p += 32) sum += expf(ss[p] - m);
  sum = warp_sum(sum);
  for (int p = lane; p < T; p += 32) store_t(o + p, expf(ss[p] - m) / sum);
}

// bf16: one warp a query row n of image n / K, DS_ROWS rows a block: lane
// l keeps q, b and v of its columns (ScoreLanes, c < NC) in registers for
// the row and walks the image's attendable positions (a ballot of the
// mask, 32 positions at a time) two at a time as two independent chains,
// each key read as 16-byte loads (an image's K rows run in neighbouring
// warps, so its keys come from L1 after the first); tanh(key + q + b) . v
// is reduced over A with shuffles into shared memory, then the warp takes
// its row's softmax and writes omega in bf16.
// fp32 (the same scoring, fp32 keys and omega, the accurate tanhf): a
// programmatic dependent of the split fp32 product. A block holds one
// image's rows [r0, r0 + rows) (blockIdx.y = r0 / DS_F32_ROWS), two warps
// a row. Before it waits for the product, it copies the image's
// attendable keys of a window of DS_F32_WINDOW positions into shared
// memory (cp.async, every thread), so each key crosses from L2 once an
// image, not once a row (reading them through L1 a row at a time made the
// stage twice as slow: PERF.md). Then each row's warps take its position
// pairs in turn from shared memory, meet on a named barrier, and the
// first takes the softmax.
template <int NC, typename KT>
__global__ void __launch_bounds__(sizeof(KT) == 4
                                      ? 32 * DS_F32_WARPS * DS_F32_ROWS
                                      : 32 * DS_ROWS)
    dcnet_scores_kernel(const __grid_constant__ DcnetScoreArgs<KT> a) {
  constexpr int VEC = ScoreLanes<KT>::VEC;
  extern __shared__ float ds_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int A = a.A, T = a.T;
  float qr[NC][VEC], br[NC][VEC], vr[NC][VEC];
  float acc0, acc1;
  int p0, p1;
  if constexpr (sizeof(KT) == 2) {
    float* ss = ds_smem + warp * T;  // [DS_ROWS, T]
    const int row = blockIdx.x * DS_ROWS + warp;
    if (row >= a.N) return;
    const int img = row / a.K;
    load_query<NC>(a, row, lane, qr, br, vr);
    const KT* kimg = a.keys + (size_t)img * T * A;
    for (int t0 = 0; t0 < T; t0 += 32) {
      const int pl = t0 + lane;
      const bool attend = pl < T && a.mask[(size_t)img * T + pl] > 0.0f;
      if (pl < T && !attend) ss[pl] = NEG_INF;
      unsigned bits = __ballot_sync(0xffffffffu, attend);
      while (bits) {
        next_pair(bits, t0, p0, p1);
        score_pair<NC, KT>(kimg + (size_t)p0 * A, kimg + (size_t)p1 * A, A,
                           lane, qr, br, vr, acc0, acc1);
        if (lane == 0) {
          ss[p0] = acc0;
          ss[p1] = acc1;
        }
      }
    }
    __syncwarp();
    row_softmax(ss, T, lane, a.omega + (size_t)row * T);
  } else {
    // Shared memory: a window's keys [min(T, DS_F32_WINDOW), A], then the
    // rows' scores [DS_F32_ROWS, T].
    float* sk = ds_smem;
    const int win = min(T, DS_F32_WINDOW);
    const int img = blockIdx.x;
    const int r0 = blockIdx.y * DS_F32_ROWS;
    const int rows = min(DS_F32_ROWS, a.K - r0);
    const int lr = warp / DS_F32_WARPS, turn = warp % DS_F32_WARPS;
    const bool active = lr < rows;
    const int row = img * a.K + r0 + lr;
    float* ss = sk + (size_t)win * A + lr * T;
    const KT* kimg = a.keys + (size_t)img * T * A;
    const float* mimg = a.mask + (size_t)img * T;
    for (int t0 = 0; t0 < T; t0 += DS_F32_WINDOW) {
      const int n = min(DS_F32_WINDOW, T - t0);
      if (t0 > 0) __syncthreads();  // the last window's keys are read
      for (int p = 0; p < n; ++p) {
        if (!(mimg[t0 + p] > 0.0f)) continue;
        for (int e = 4 * threadIdx.x; e < A; e += 4 * blockDim.x)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                           sm90::smem_u32(sk + (size_t)p * A + e)),
                       "l"(kimg + (size_t)(t0 + p) * A + e)
                       : "memory");
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
      if (t0 == 0) {
        sm90::grid_dependency_wait();  // q is the product's output
        if (active) load_query<NC>(a, row, lane, qr, br, vr);
      }
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();
      if (!active) continue;
      const int pl = t0 + lane;
      const bool attend = pl < t0 + n && mimg[pl] > 0.0f;
      if (pl < t0 + n && !attend && turn == 0) ss[pl] = NEG_INF;
      unsigned bits = __ballot_sync(0xffffffffu, attend);
      for (int k = 0; bits; ++k) {
        next_pair(bits, t0, p0, p1);
        if (k % DS_F32_WARPS != turn) continue;
        score_pair<NC, KT>(sk + (size_t)(p0 - t0) * A,
                           sk + (size_t)(p1 - t0) * A, A, lane, qr, br, vr,
                           acc0, acc1);
        if (lane == 0) {
          ss[p0] = acc0;
          ss[p1] = acc1;
        }
      }
    }
    if (!active) return;
    // The row's warps meet; the first takes the softmax.
    sm90::named_sync(1 + lr, 32 * DS_F32_WARPS);
    if (turn == 0) row_softmax(ss, T, lane, a.omega + (size_t)row * T);
  }
}

template <typename KT>
size_t dcnet_scores_smem(int A, int T) {
  if constexpr (sizeof(KT) == 2) {
    return sizeof(float) * DS_ROWS * (size_t)T;
  } else {
    const int win = T < DS_F32_WINDOW ? T : DS_F32_WINDOW;
    return sizeof(float) * ((size_t)win * A + (size_t)DS_F32_ROWS * T);
  }
}

// bf16: a plain launch after the query product, DS_ROWS rows a block.
// fp32: grid (images, ceil(K / DS_F32_ROWS)), a programmatic dependent of
// the fp32 tile (its blocks copy their keys, then wait in
// griddepcontrol.wait).
template <int NC, typename KT>
cudaError_t launch_dcnet_scores(const DcnetScoreArgs<KT>& a, cudaStream_t s) {
  const size_t smem = dcnet_scores_smem<KT>(a.A, a.T);
  // The largest shared-memory size set on each device (48 KB needs none).
  static size_t sized[sm90::kDevices] = {};
  const int dev = sm90::device_slot();
  if (smem > 48 * 1024 && (dev < 0 || smem > sized[dev])) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcnet_scores_kernel<NC, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev >= 0) sized[dev] = smem;
  }
  if constexpr (sizeof(KT) == 2) {
    const int blocks = (a.N + DS_ROWS - 1) / DS_ROWS;
    dcnet_scores_kernel<NC, KT><<<blocks, 32 * DS_ROWS, smem, s>>>(a);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.N / a.K, (a.K + DS_F32_ROWS - 1) / DS_F32_ROWS);
    cfg.blockDim =
        dim3(32 * DS_F32_WARPS * (a.K < DS_F32_ROWS ? a.K : DS_F32_ROWS));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, dcnet_scores_kernel<NC, KT>, a);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <typename KT>
DcnetScoreArgs<KT> dcnet_score_args(const void* b, const void* v,
                                   const void* keys, const void* mask,
                                   void* omega, const void* q, int N, int B,
                                   int Ap, int T_, int split) {
  DcnetScoreArgs<KT> a;
  a.q = static_cast<const float*>(q);
  a.b = cell::f32(b);
  a.v = cell::f32(v);
  a.keys = static_cast<const KT*>(keys);
  a.mask = cell::f32(mask);
  a.omega = static_cast<KT*>(omega);
  a.N = N;
  a.K = N / B;
  a.T = T_;
  a.A = Ap;
  a.split = split;
  return a;
}

// ck_dcnet_score's bf16 launches: the query product on sm90_cell.cuh (fp32
// h rounded to bf16 in registers, q fp32: kStore), then
// dcnet_scores_kernel with the lanes' columns in NC = A / 256 (1, 2 or 4)
// register chunks.
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

  const auto a = dcnet_score_args<__nv_bfloat16>(b, v, keys, mask, omega, q,
                                                 N, B, Ap, T, 1);
  if (Ap <= 256) return launch_dcnet_scores<1>(a, s);
  if (Ap <= 512) return launch_dcnet_scores<2>(a, s);
  return launch_dcnet_scores<4>(a, s);
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
// dcnet_scores_kernel<NC, float> (NC = A / 128 chunks of 4 columns) as its
// programmatic dependent.
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

  const auto a = dcnet_score_args<float>(b, v, keys, mask, omega, q, N, B,
                                         Ap, T, split);
  if (Ap <= 128) return launch_dcnet_scores<1>(a, s);
  if (Ap <= 256) return launch_dcnet_scores<2>(a, s);
  if (Ap <= 512) return launch_dcnet_scores<4>(a, s);
  return launch_dcnet_scores<8>(a, s);
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

  ScoreArgs sc = {};
  sc.K = N / B;
  sc.A = Ap;
  const float* qf = static_cast<const float*>(q);
  sc.head[0] = {qf, 2 * Ap, cell::f32(vis_b), cell::f32(vis_v), vis_keys,
                nullptr, R, alpha};
  sc.head[1] = {qf + Ap, 2 * Ap, cell::f32(scma_b), cell::f32(scma_v),
                scma_keys, cell::f32(mask), T, beta};
  return (int)launch_scores(sc, B, 2, f32, s);
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
// dcnet_scores_kernel; Ap at most 1024), or fp32 when f32
// (cell_common.cuh's fp32 tile split over K, then dcnet_scores_kernel's
// fp32 instance; Ap at most 1024).
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
