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
// so each C entry point below is two or three launches on one stream:
//
//   gemm_kernel<G, EPI> and gemm_kernel_plain<G, EPI> (cell_common.cuh,
//     shared with lstm.cu, attention.cu and wholestep.cu), grid = (column
//     blocks, 64-row blocks): a block
//     accumulates a 64-row tile against G column groups of 32 with bf16
//     tensor-core MMA (nvcuda::wmma, fp32 accumulation). The split operands
//     of a cell ([emb | h_lang | h_att], [v_hat | h_att | h_lang | c*],
//     [emb | part | h]) are successive K ranges of one accumulation, so no
//     concat exists in device memory. In the gated epilogues a block owns
//     hidden columns [j, j+32) and its column groups are the i, f, g, o
//     (and copy-gate r) tiles of those columns, read straight from the
//     gate-major [K, 4H] weights; the LSTM update runs on the tile in
//     shared memory and the gate pre-activations are never written out.
//   scores_kernel, grid = (images, attention heads): one block per image.
//     Each warp takes a key position, holds that key row in registers and
//     reuses it for the image's K query rows (the keys are read once per
//     image, never repeated K-fold in device memory); tanh(key + q + b) . v
//     is reduced over A with warp shuffles; then one warp per query row
//     takes the masked softmax over the positions.
//
// Launches per call: ck_att_cell 3 (gates + LSTM; the two query products
// as one GEMM against [Wq_vis | Wq_scma]; scores + softmax for both
// heads), ck_lang_cell 2 (visual gate -> v_hat; base + copy gates +
// blend), ck_dcnet_score 2 (query GEMM; scores + softmax), ck_dcnet_cell 2
// (context gate -> part; LSTM).
//
// What bounds them on the H100 (paper shape, N = 512 images x 5 beams):
// the cell GEMMs are bound by operations (2 N K 4H with K = 3072 for the
// att-LSTM: 64 GFLOP, 65 us at 989 TFLOP/s) and the score kernels by bytes
// (the per-image keys). This first version is plain: wmma rather than
// wgmma, one shared-memory stage, no cp.async or TMA pipeline, and every
// 64-row block streams its weight columns from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "cell_common.cuh"

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
  const __nv_bfloat16* keys;      // [B, P, A]
  const float* mask;              // [B, P] (> 0 = attendable), or null:
                                  // every position valid
  int P;
  __nv_bfloat16* out;             // [N, P] softmax weights
};

struct ScoreArgs {
  ScoreHead head[2];
  int K;  // query rows per image
  int A;
};

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
    const __nv_bfloat16* kr = hd.keys + ((size_t)img * P + p) * A;
    float key[SC_MAXV];
#pragma unroll
    for (int i = 0; i < SC_MAXV; ++i)
      if (i < nv) key[i] = __bfloat162float(kr[lane + 32 * i]);
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
    __nv_bfloat16* o = hd.out + (size_t)(img * K + r) * P;
    for (int p = lane; p < P; p += 32)
      o[p] = __float2bfloat16_rn(expf(s[p] - m) / sum);
  }
}

cudaError_t launch_scores(const ScoreArgs& a, int B, int n_heads,
                          cudaStream_t s) {
  int max_p = a.head[0].P;
  if (n_heads > 1 && a.head[1].P > max_p) max_p = a.head[1].P;
  if (a.A % 32 || a.A > 32 * SC_MAXV || a.K < 1 || B < 1)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)a.K * a.A + 2 * a.A +
                                       (size_t)a.K * max_p);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  scores_kernel<<<dim3(B, n_heads), SC_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// EditNet, first half of the step (att_phase's kernel). fp32 inputs: emb
// [N, Ep], h_att, c_att, h_lang [N, Hp], zvb [N, 4Hp] (the hoisted v_mean
// product plus the bias, gate-major); bf16 weights: w_emb [Ep, 4Hp], w_hl,
// w_ha [Hp, 4Hp], wq [Hp, 2Ap] (visual | SCMA query products); fp32 vis_b,
// vis_v, scma_b, scma_v [Ap]; bf16 keys vis_keys [B, R, Ap], scma_keys
// [B, T, Ap]; fp32 mask [B, T]. Outputs: h_out, c_out [N, Hp] fp32, alpha
// [N, R] and beta [N, T] bf16. Scratch: q [N, 2Ap] fp32.
int ck_att_cell(const void* emb, const void* h_att, const void* c_att,
                const void* h_lang, const void* zvb, const void* w_emb,
                const void* w_hl, const void* w_ha, const void* wq,
                const void* vis_b, const void* vis_v, const void* scma_b,
                const void* scma_v, const void* vis_keys,
                const void* scma_keys, const void* mask, void* h_out,
                void* c_out, void* alpha, void* beta, void* q, int N, int B,
                int Ep, int Hp, int Ap, int R, int T, int device,
                void* stream) {
  if (B < 1 || N % B || R < 1 || T < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  GemmArgs g = gemm_args(N, Hp);
  g.op[0] = operand(emb, 1, Ep, w_emb);
  g.op[1] = operand(h_lang, 1, Hp, w_hl);
  g.op[2] = operand(h_att, 1, Hp, w_ha);
  g.n_ops = 3;
  g.zadd = f32(zvb);
  g.c_prev = f32(c_att);
  g.h_out = static_cast<float*>(h_out);
  g.c_out = static_cast<float*>(c_out);
  err = launch_gemm<4, EPI_LSTM>(g, s);
  if (err != cudaSuccess) return (int)err;

  GemmArgs gq = gemm_args(N, 2 * Ap);
  gq.op[0] = operand(h_out, 1, Hp, wq);
  gq.n_ops = 1;
  gq.out = q;
  err = launch_gemm<4, EPI_STORE>(gq, s);
  if (err != cudaSuccess) return (int)err;

  ScoreArgs sc = {};
  sc.K = N / B;
  sc.A = Ap;
  const float* qf = static_cast<const float*>(q);
  sc.head[0] = {qf, 2 * Ap, f32(vis_b), f32(vis_v),
                static_cast<const __nv_bfloat16*>(vis_keys), nullptr, R,
                static_cast<__nv_bfloat16*>(alpha)};
  sc.head[1] = {qf + Ap, 2 * Ap, f32(scma_b), f32(scma_v),
                static_cast<const __nv_bfloat16*>(scma_keys), f32(mask), T,
                static_cast<__nv_bfloat16*>(beta)};
  return (int)launch_scores(sc, B, 2, s);
}

// EditNet, second half (the lang kernel). fp32 inputs: vhat_raw [N, Fp]
// (the alpha-weighted features, rounded to bf16 here as the reference
// rounds them), h_att, h_lang, c_lang, c_star [N, Hp]; bf16 weights:
// gate_w [Hp, Fp], lang_wv [Fp, 4Hp], lang_wha, lang_wh [Hp, 4Hp], wr_v
// [Fp, Hp], wr_ha, wr_hl, wr_c [Hp, Hp]; fp32 gate_b [Fp], lang_b [4Hp],
// br [Hp]. Outputs: h_out, c_out [N, Hp] fp32. Scratch: vhat [N, Fp] bf16.
int ck_lang_cell(const void* vhat_raw, const void* h_att, const void* h_lang,
                 const void* c_lang, const void* c_star, const void* gate_w,
                 const void* gate_b, const void* lang_wv,
                 const void* lang_wha, const void* lang_wh,
                 const void* lang_b, const void* wr_v, const void* wr_ha,
                 const void* wr_hl, const void* wr_c, const void* br,
                 void* h_out, void* c_out, void* vhat, int N, int Hp, int Fp,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  GemmArgs gv = gemm_args(N, Fp);
  gv.op[0] = operand(h_att, 1, Hp, gate_w);
  gv.n_ops = 1;
  gv.bias = f32(gate_b);
  gv.x = f32(vhat_raw);
  gv.x_round = 1;
  gv.out = vhat;
  err = launch_gemm<4, EPI_GATE_MUL>(gv, s);
  if (err != cudaSuccess) return (int)err;

  GemmArgs g = gemm_args(N, Hp);
  g.op[0] = operand(vhat, 0, Fp, lang_wv, wr_v);
  g.op[1] = operand(h_att, 1, Hp, lang_wha, wr_ha);
  g.op[2] = operand(h_lang, 1, Hp, lang_wh, wr_hl);
  g.op[3] = operand(c_star, 1, Hp, nullptr, wr_c);
  g.n_ops = 4;
  g.bias = f32(lang_b);
  g.bias_r = f32(br);
  g.c_prev = f32(c_lang);
  g.c_star = f32(c_star);
  g.h_out = static_cast<float*>(h_out);
  g.c_out = static_cast<float*>(c_out);
  return (int)launch_gemm<5, EPI_COPY_LSTM>(g, s);
}

// DCNet score kernel. fp32 h [N, Hp]; bf16 att_wq [Hp, Ap]; fp32 att_b,
// att_v [Ap]; bf16 keys [B, T, Ap]; fp32 mask [B, T]. Output: omega [N, T]
// bf16. Scratch: q [N, Ap] fp32.
int ck_dcnet_score(const void* h, const void* att_wq, const void* att_b,
                   const void* att_v, const void* keys, const void* mask,
                   void* omega, void* q, int N, int B, int Hp, int Ap, int T,
                   int device, void* stream) {
  if (B < 1 || N % B || T < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  GemmArgs gq = gemm_args(N, Ap);
  gq.op[0] = operand(h, 1, Hp, att_wq);
  gq.n_ops = 1;
  gq.out = q;
  err = launch_gemm<4, EPI_STORE>(gq, s);
  if (err != cudaSuccess) return (int)err;

  ScoreArgs sc = {};
  sc.K = N / B;
  sc.A = Ap;
  sc.head[0] = {static_cast<const float*>(q), Ap, f32(att_b), f32(att_v),
                static_cast<const __nv_bfloat16*>(keys), f32(mask), T,
                static_cast<__nv_bfloat16*>(omega)};
  return (int)launch_scores(sc, B, 1, s);
}

// DCNet LSTM kernel. fp32 emb [N, Ep], ctx (the omega-weighted encoder
// states), h, c [N, Hp]; bf16 gate_w [Hp, Hp], w_emb [Ep, 4Hp], w_part,
// w_h [Hp, 4Hp]; fp32 gate_b [Hp], b [4Hp]. Outputs: h_out, c_out [N, Hp]
// fp32. Scratch: part [N, Hp] bf16.
int ck_dcnet_cell(const void* emb, const void* ctx, const void* h,
                  const void* c, const void* gate_w, const void* gate_b,
                  const void* w_emb, const void* w_part, const void* w_h,
                  const void* b, void* h_out, void* c_out, void* part, int N,
                  int Ep, int Hp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  GemmArgs gp = gemm_args(N, Hp);
  gp.op[0] = operand(h, 1, Hp, gate_w);
  gp.n_ops = 1;
  gp.bias = f32(gate_b);
  gp.x = f32(ctx);
  gp.out = part;
  err = launch_gemm<4, EPI_GATE_MUL>(gp, s);
  if (err != cudaSuccess) return (int)err;

  GemmArgs g = gemm_args(N, Hp);
  g.op[0] = operand(emb, 1, Ep, w_emb);
  g.op[1] = operand(part, 0, Hp, w_part);
  g.op[2] = operand(h, 1, Hp, w_h);
  g.n_ops = 3;
  g.bias = f32(b);
  g.c_prev = f32(c);
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
