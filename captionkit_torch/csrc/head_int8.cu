// int8 vocab head for beam search: per row, the top-k of the dequantized
// logits (q8(h) @ w_q) * (s_h * s_w) + b, their vocab ids and the
// log-sum-exp, without writing the [N, V] logits to device memory.
//
// Replaces the TPU kernel captionkit/ops/head.py::fused_head_topk_int8
// (_make_head_kernel_int8 + _quantize_rows + _lse_topk_update), with both
// extractions ("mask", "thresh").
//
// Inputs:  h [N, H] fp32 (H a multiple of 4, any size), w_qt [V, Hp] int8
//          (Hp = H rounded up to 16: the K-major copy of quantize_head's
//          w_q [H, V], zeros past H; kernels/head.py::kmajor_head), w_scale
//          [V] fp32, b [V] fp32 (V a multiple of 16; padded vocab columns:
//          weight 0, scale 1, bias -1e30); scratch qh [shares * Np, Hp]
//          int8 (Np = N rounded up to 64).
// Outputs: vals [N, k] fp32, idx [N, k] int32, lse [N] fp32.
//
// Design: head_sm90.cuh's kernel with the S8 operands and the Extract
// epilogue of the float head (head_topk.cu), one launch:
// - The rows. Each CTA quantizes its 64 rows once, before the sweep: per
//   row symmetric, s_h = max(max|h|, 1e-8) / 127, q = rint(h / s_h) (IEEE
//   division, half to even, no clip: the reference's _quantize_rows). It
//   writes them to the scratch and loads them back by TMA, 128-byte
//   swizzled and K-major as wgmma wants them, resident up to Hp = 1024 and
//   streamed beside w_qt above (any H). Quantizing straight into the
//   swizzled shared memory would skip the 2.6 MB round trip (at the paper
//   shape) but leave no way to stream wide rows in one launch; the scratch
//   serves both. Each CTA of a cluster writes its own copy, so no CTA
//   reads what another wrote.
// - The products: wgmma m64n128k32 s8 x s8 with int32 sums (exact), at
//   twice the bf16 rate. 8-bit wgmma takes both operands K-major only, so
//   the weights come as w_qt, made once a batch beside quantize_head.
// - The epilogue dequantizes as acc * (s_h * s_w) + b, each operation
//   rounded on its own (__int2float_rn, __fmul_rn, __fadd_rn: no
//   contraction into an FMA), the plain version's arithmetic, so the
//   values and ids are bit-identical to it; then the extraction and fold
//   of the float head.
//
// Bound at the paper shape (N = 2560, H = 1024, V = 9490): 2 N H V = 49.8
// G int8 operations, 25 us at the H100's 1,979 TOPS dense; the bytes (h
// fp32 10.5 MB, w_q 9.7 MB, scales and bias, outputs) take 6 us at 3.35
// TB/s, so the kernel is bound by operations.

#include "head_sm90.cuh"

extern "C" {

// One launch: `shares` CTAs a cluster split the vocab of each block of 64
// rows (kernels/head.py::sweep_plan). extract: 0 = mask, 1 = thresh. fault:
// as ck_head_topk's. Returns the CUDA error code (0 = success).
int ck_head_topk_int8(const void* h, const void* w_qt, const void* w_scale,
                      const void* b, void* vals, void* idx, void* lse,
                      void* qh, int N, int H, int V, int k, int extract,
                      int shares, int fault, int device, void* stream) {
  using namespace hsm;
  if (bad_shape(N, H, V, k, shares) || H % 4 || V % 16 ||
      (extract != kMask && extract != kThresh) || fault < 0 || fault > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int Hp = (H + 15) / 16 * 16;
  const int Np = (N + BM - 1) / BM * BM;
  CUtensorMap q_map, w_map;
  err = tensor_map_2d(&q_map, qh, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                      static_cast<uint64_t>(shares) * Np, Hp, Hp, BM,
                      S8::BOXK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  err = tensor_map_2d(&w_map, w_qt, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, V, Hp,
                      Hp, TN, S8::BOXK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  Args a = {};
  a.bias = static_cast<const float*>(b);
  a.scale = static_cast<const float*>(w_scale);
  a.h = static_cast<const float*>(h);
  a.qh = static_cast<int8_t*>(qh);
  a.vals = static_cast<float*>(vals);
  a.idx = static_cast<int*>(idx);
  a.lse = static_cast<float*>(lse);
  a.N = N;
  a.H = H;
  a.Hp = Hp;
  a.Np = Np;
  a.V = V;
  a.k = k;
  a.fault = fault;
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)(extract == kThresh
                   ? launch_any<S8, ThreshEpi>(q_map, w_map, a, shares,
                                               Hp > HMAX, s)
                   : launch_any<S8, MaskEpi>(q_map, w_map, a, shares,
                                             Hp > HMAX, s));
}

// How many clusters of `shares` CTAs the card holds at once, for the rows
// resident (wide = 0) or streamed (wide = 1) (0 when it cannot hold one; a
// negative CUDA error code when the query fails).
int ck_head_int8_max_clusters(int shares, int wide, int device) {
  return hsm::clusters_of<hsm::S8, hsm::MaskEpi>(shares, wide, device);
}

const char* ck_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ck_head_int8_tile_width() { return BN; }

int ck_head_int8_kmax() { return KMAX_LIMIT; }

}  // extern "C"
