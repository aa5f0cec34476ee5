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
// Design. The query product runs as cell_common.cuh's plain GEMM
// (EPI_STORE, launch 1). Then attention_kernel (launch 2), one block per
// row: each warp takes key positions, reads the key row once (16 bytes a
// lane), computes tanh(k + qa + b) . v and reduces over A with shuffles;
// one warp takes the softmax over the row's positions in shared memory;
// then every thread owns 8 value columns and sums w_n values_n over the
// positions, so each row's values are read once, coalesced, and the
// weights never leave shared memory before the context is done. Unlike
// megastep.cu's scores_kernel the weights stay fp32 into the context
// product, as in the TPU kernel (the reference's jnp twin rounds them to
// the values' dtype first).
//
// What bounds it on the H100: the values. EditNet's visual attention at
// the greedy step reads 512 rows x 36 regions x 2048 features in bf16
// (75.5 MB) for 2 x 512 x 36 x 2048 = 75 MFLOP of context product: bytes,
// 0.023 ms at 3.35 TB/s. The SCMA attention (22 positions x 1024) and
// DCNet's text attention are smaller and bound the same way.
//
// fp32 (compute_dtype="float32"): the query product runs as
// cell_common.cuh's fp32 tile (fp32 FMA, not TF32) and the keys and values
// are read as fp32; the rest is the same code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cell_common.cuh"

using namespace cell;

namespace {

constexpr int AT_THREADS = 256;  // attention_kernel: 8 warps
constexpr int AT_WARPS = AT_THREADS / 32;
constexpr float NEG_INF = -1e9f;  // captionkit nn/masking.py
constexpr int AT_SMEM_LIMIT = 48 * 1024;

struct AttArgs {
  const float* qa;              // [B, A] fp32 (the query product)
  const float* b;               // [A]
  const float* v;               // [A]
  const void* keys;             // [B, P, A] in T
  const void* values;           // [B, P, V] in T
  const int* nvalid;            // [B] valid prefix length per row
  float* ctx;                   // [B, V]
  float* w;                     // [B, P]
  int P;
  int A;  // a multiple of 8
  int V;  // a multiple of 8
};

// Eight consecutive elements of T as fp32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = __bfloat162float(v[j]);
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
  x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
}

template <typename T>
__global__ void __launch_bounds__(AT_THREADS)
    attention_kernel(const __grid_constant__ AttArgs a) {
  extern __shared__ float sm[];
  const int A = a.A, P = a.P, V = a.V;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* qs = sm;      // [A]
  float* bs = qs + A;  // [A]
  float* vs = bs + A;  // [A]
  float* ss = vs + A;  // [P] scores, then weights

  for (int e = tid; e < A; e += AT_THREADS) {
    qs[e] = a.qa[(size_t)row * A + e];
    bs[e] = a.b[e];
    vs[e] = a.v[e];
  }
  __syncthreads();

  const int nv = a.nvalid[row];
  for (int p = warp; p < P; p += AT_WARPS) {
    if (p >= nv) {
      if (lane == 0) ss[p] = NEG_INF;
      continue;
    }
    const T* kr = static_cast<const T*>(a.keys) + ((size_t)row * P + p) * A;
    float acc = 0.0f;
    for (int a0 = lane * 8; a0 < A; a0 += 32 * 8) {
      float kv[8];
      load8(kr + a0, kv);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc += tanhf(kv[j] + qs[a0 + j] + bs[a0 + j]) * vs[a0 + j];
    }
    acc = warp_sum(acc);
    if (lane == 0) ss[p] = acc;
  }
  __syncthreads();

  if (warp == 0) {
    float m = -INFINITY;
    for (int p = lane; p < P; p += 32) m = fmaxf(m, ss[p]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int p = lane; p < P; p += 32) sum += expf(ss[p] - m);
    sum = warp_sum(sum);
    for (int p = lane; p < P; p += 32) {
      const float w = expf(ss[p] - m) / sum;
      ss[p] = w;
      a.w[(size_t)row * P + p] = w;
    }
  }
  __syncthreads();

  const T* vr = static_cast<const T*>(a.values) + (size_t)row * P * V;
  for (int c0 = tid * 8; c0 < V; c0 += AT_THREADS * 8) {
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
    for (int p = 0; p < P; ++p) {
      const float w = ss[p];
      float val[8];
      load8(vr + (size_t)p * V + c0, val);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += w * val[j];
    }
    float* out = a.ctx + (size_t)row * V + c0;
    *reinterpret_cast<float4*>(out) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(out + 4) =
        make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

}  // namespace

extern "C" {

// q [B, Qp] (fp32 if q_f32 else bf16); wq [Qp, Ap]; fp32 b, v [Ap]; keys
// [B, P, Ap], values [B, P, V]; int32 nvalid [B]. wq, keys and values are
// bf16, or fp32 when f32 (then q is fp32 too). Outputs ctx [B, V] fp32, w
// [B, P] fp32. Scratch: qa [B, Ap] fp32. Qp a multiple of 32, Ap of 128, V
// of 8. Two launches.
int ck_additive_attention(const void* q, const void* wq, const void* b,
                          const void* v, const void* keys, const void* values,
                          const void* nvalid, void* ctx, void* w, void* qa,
                          int B, int Qp, int Ap, int P, int V, int q_f32,
                          int f32, int device, void* stream) {
  if (f32 && !q_f32) return (int)cudaErrorInvalidValue;
  if (B < 1 || P < 1 || V < 8 || V % 8) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (3 * (size_t)Ap + P);
  if (smem > AT_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  GemmArgs gq = gemm_args(B, Ap);
  gq.op[0] = operand(q, q_f32, Qp, wq);
  gq.n_ops = 1;
  gq.out = qa;
  err = launch_gemm<4, EPI_STORE>(gq, f32, s);
  if (err != cudaSuccess) return (int)err;

  AttArgs a;
  a.qa = static_cast<const float*>(qa);
  a.b = cell::f32(b);
  a.v = cell::f32(v);
  a.keys = keys;
  a.values = values;
  a.nvalid = static_cast<const int*>(nvalid);
  a.ctx = static_cast<float*>(ctx);
  a.w = static_cast<float*>(w);
  a.P = P;
  a.A = Ap;
  a.V = V;
  if (f32)
    attention_kernel<float><<<B, AT_THREADS, smem, s>>>(a);
  else
    attention_kernel<__nv_bfloat16><<<B, AT_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

const char* ck_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The width the Python side pads A (the query product's columns) to.
int ck_attention_width() { return 4 * BN; }

}  // extern "C"
