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
//   gemm_kernel<G, EPI>, grid = (column blocks, 64-row blocks): a block
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
#include <mma.h>

#include <cmath>
#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int BM = 64;       // rows per block
constexpr int BN = 32;       // columns per group (one gate tile)
constexpr int BK = 32;       // depth of one shared-memory stage
constexpr int LDA = BK + 8;  // shared-memory strides, in elements
constexpr int MAX_OPS = 4;
constexpr float NEG_INF = -1e9f;  // captionkit nn/masking.py

constexpr int SC_THREADS = 256;  // scores_kernel: 8 warps
constexpr int SC_MAXV = 32;      // A <= 32 * 32 = 1024
constexpr int SMEM_LIMIT = 48 * 1024;

enum Epilogue : int {
  EPI_LSTM = 0,       // 4 gate groups; h, c = LSTM(z + zadd + bias, c_prev)
  EPI_COPY_LSTM = 1,  // 5 gate groups (i f g o r); the Copy-LSTM update
  EPI_GATE_MUL = 2,   // out bf16 = sigmoid(z + bias) * x
  EPI_STORE = 3,      // out fp32 = z
};

struct Operand {
  const void* a;  // [N, k] row-major, fp32 (a_f32) or bf16
  int a_f32;
  int k;  // a multiple of BK
  // Gated epilogues: [k, 4 cols] gate-major (i|f|g|o), or null when this
  // operand does not feed those gates. Plain epilogues: [k, cols].
  const __nv_bfloat16* w_gates;
  const __nv_bfloat16* w_copy;  // EPI_COPY_LSTM: [k, cols], or null
};

struct GemmArgs {
  Operand op[MAX_OPS];
  int n_ops;
  int N;
  int cols;            // hidden width H (gated) or output width (plain)
  const float* zadd;   // EPI_LSTM: [N, 4 cols] added to z, or null
  const float* bias;   // [4 cols] (gated) or [cols] (EPI_GATE_MUL), or null
  const float* bias_r;      // EPI_COPY_LSTM: [cols]
  const float* c_prev;      // gated: [N, cols]
  const float* c_star;      // EPI_COPY_LSTM: [N, cols]
  const float* x;           // EPI_GATE_MUL: [N, cols]
  int x_round;              // EPI_GATE_MUL: round x to bf16 first
  float* h_out;             // gated: [N, cols]
  float* c_out;             // gated: [N, cols]
  void* out;                // EPI_GATE_MUL bf16 / EPI_STORE fp32 [N, cols]
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// Eight fp32 values rounded to bf16, as one 16-byte vector.
__device__ __forceinline__ uint4 round8(const float* src) {
  const float4 lo = *reinterpret_cast<const float4*>(src);
  const float4 hi = *reinterpret_cast<const float4*>(src + 4);
  return make_uint4(pack2(lo.x, lo.y), pack2(lo.z, lo.w), pack2(hi.x, hi.y),
                    pack2(hi.z, hi.w));
}

template <int G, int EPI>
__global__ void __launch_bounds__(64 * G) gemm_kernel(const GemmArgs args) {
  constexpr int THREADS = 64 * G;  // 2 (rows) x G (column groups) warps
  constexpr int TN = G * BN;       // tile columns
  constexpr int LDB = TN + 8;
  constexpr int LDC = TN + 4;
  constexpr bool GATED = (EPI == EPI_LSTM || EPI == EPI_COPY_LSTM);
  constexpr int SMEM_AB = (BM * LDA + BK * LDB) * 2;
  constexpr int SMEM_C = BM * LDC * 4;
  constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;
  // The operand tiles and, after the products, the fp32 result tile share
  // one buffer.
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp / G;  // warp's 32-row band
  const int wc = warp % G;  // warp's 32-column group
  const int nb = blockIdx.x;
  const int row0 = blockIdx.y * BM;
  const int N = args.N;
  const int cols = args.cols;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int s = 0; s < args.n_ops; ++s) {
    const Operand op = args.op[s];
    // A gated operand may feed only some gate groups (c* feeds only r).
    const bool active =
        !GATED || (wc < 4 ? op.w_gates != nullptr : op.w_copy != nullptr);
    for (int k0 = 0; k0 < op.k; k0 += BK) {
      for (int v = tid; v < BM * BK / 8; v += THREADS) {  // A tile
        const int r = v / (BK / 8);
        const int c = (v % (BK / 8)) * 8;
        const int gr = row0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (gr < N) {
          const size_t off = (size_t)gr * op.k + k0 + c;
          val = op.a_f32
                    ? round8(static_cast<const float*>(op.a) + off)
                    : *reinterpret_cast<const uint4*>(
                          static_cast<const __nv_bfloat16*>(op.a) + off);
        }
        *reinterpret_cast<uint4*>(As + r * LDA + c) = val;
      }
      for (int v = tid; v < BK * TN / 8; v += THREADS) {  // weight tile
        const int r = v / (TN / 8);
        const int t = (v % (TN / 8)) * 8;
        const size_t krow = (size_t)(k0 + r);
        const __nv_bfloat16* src = nullptr;
        if (GATED) {
          const int g = t / BN;
          const int col = nb * BN + t % BN;
          if (g < 4) {
            if (op.w_gates) src = op.w_gates + krow * 4 * cols + g * cols + col;
          } else if (op.w_copy) {
            src = op.w_copy + krow * cols + col;
          }
        } else {
          src = op.w_gates + krow * cols + nb * TN + t;
        }
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (src) val = *reinterpret_cast<const uint4*>(src);
        *reinterpret_cast<uint4*>(Bs + r * LDB + t) = val;
      }
      __syncthreads();
      if (active) {
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(a[i], As + (wr * 32 + i * 16) * LDA + kk,
                                   LDA);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(b[j], Bs + kk * LDB + wc * 32 + j * 16,
                                   LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * LDC + wc * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  if (GATED) {
    for (int e = tid; e < BM * BN; e += THREADS) {
      const int r = e / BN;
      const int c = e % BN;
      const int gr = row0 + r;
      if (gr >= N) continue;
      const int j = nb * BN + c;
      const float* cr = Cs + r * LDC;
      float zi = cr[c], zf = cr[BN + c], zg = cr[2 * BN + c],
            zo = cr[3 * BN + c];
      if (args.zadd) {
        const float* za = args.zadd + (size_t)gr * 4 * cols;
        zi += za[j];
        zf += za[cols + j];
        zg += za[2 * cols + j];
        zo += za[3 * cols + j];
      }
      if (args.bias) {
        zi += args.bias[j];
        zf += args.bias[cols + j];
        zg += args.bias[2 * cols + j];
        zo += args.bias[3 * cols + j];
      }
      const size_t idx = (size_t)gr * cols + j;
      float c_new = sigmoidf(zf) * args.c_prev[idx] + sigmoidf(zi) * tanhf(zg);
      if (EPI == EPI_COPY_LSTM) {
        const float rg = sigmoidf(cr[4 * BN + c] + args.bias_r[j]);
        c_new = rg * args.c_star[idx] + (1.0f - rg) * c_new;
      }
      args.h_out[idx] = sigmoidf(zo) * tanhf(c_new);
      args.c_out[idx] = c_new;
    }
  } else {
    for (int e = tid; e < BM * TN; e += THREADS) {
      const int r = e / TN;
      const int c = e % TN;
      const int gr = row0 + r;
      if (gr >= N) continue;
      const int col = nb * TN + c;
      const size_t idx = (size_t)gr * cols + col;
      const float z = Cs[r * LDC + c];
      if (EPI == EPI_GATE_MUL) {
        float x = args.x[idx];
        if (args.x_round) x = __bfloat162float(__float2bfloat16_rn(x));
        static_cast<__nv_bfloat16*>(args.out)[idx] =
            __float2bfloat16_rn(sigmoidf(z + args.bias[col]) * x);
      } else {
        static_cast<float*>(args.out)[idx] = z;
      }
    }
  }
}

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

template <int G, int EPI>
cudaError_t launch_gemm(const GemmArgs& a, cudaStream_t s) {
  for (int i = 0; i < a.n_ops; ++i)
    if (a.op[i].k < BK || a.op[i].k % BK) return cudaErrorInvalidValue;
  constexpr bool GATED = (EPI == EPI_LSTM || EPI == EPI_COPY_LSTM);
  const int width = GATED ? BN : G * BN;
  if (a.N < 1 || a.cols < width || a.cols % width)
    return cudaErrorInvalidValue;
  const dim3 grid(a.cols / width, (a.N + BM - 1) / BM);
  gemm_kernel<G, EPI><<<grid, 64 * G, 0, s>>>(a);
  return cudaGetLastError();
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

Operand operand(const void* a, int a_f32, int k, const void* w_gates,
                const void* w_copy = nullptr) {
  Operand o;
  o.a = a;
  o.a_f32 = a_f32;
  o.k = k;
  o.w_gates = static_cast<const __nv_bfloat16*>(w_gates);
  o.w_copy = static_cast<const __nv_bfloat16*>(w_copy);
  return o;
}

GemmArgs gemm_args(int N, int cols) {
  GemmArgs g = {};
  g.N = N;
  g.cols = cols;
  return g;
}

const float* f32(const void* p) { return static_cast<const float*>(p); }

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
