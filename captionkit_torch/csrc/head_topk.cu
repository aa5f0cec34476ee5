// Fused vocab head for beam search: logits = h @ W + b, then per row the
// top-k logits (descending, equal values lowest index first), their vocab
// ids and the log-sum-exp, without writing the [N, V] logits to device
// memory.
//
// Replaces the TPU kernel of captionkit/ops/head.py, fused_head_topk (the
// pl.pallas_call of its tiled grid), with both of its extractions:
//   ck_head_topk, extract = 0  -> extract="mask"
//   ck_head_topk, extract = 1  -> extract="thresh"
// (_sweep_head_topk, the single sweep, is head_sweep.cu.) On the TPU the
// grid walks the vocab tiles in order on one core, carrying a running top-k
// and an online log-sum-exp in scratch; per tile it takes the tile's top-k
// by k rounds of a mask arg-max, or by the read-only threshold walk.
//
// Inputs:  h [N, H], W [H, V] (row-major, V a multiple of 8), both bf16
//          (any H, a multiple of 8) or both fp32 (compute_dtype="float32"),
//          b [V] fp32 (padded vocab columns carry -1e30); any k up to
//          KMAX_LIMIT.
// Outputs: vals [N, k] fp32, idx [N, k] int32, lse [N] fp32.
//
// Both dtypes run head_sm90.cuh's kernel, one launch with no partials in
// device memory (clusters that split the vocab, a TMA ring of W, the merge
// on chip), with the Extract epilogue: per 128-column tile and row, the
// extraction that `extract` names over the tile's logits in registers,
// folded into the warpgroup's running top-k; a tile whose max is strictly
// below the running k-th value skips the rounds. The two extractions see
// the same logits and take the same entries in the same order, so they
// give bit-identical results.
// - bf16: the Bf16 operands, a wgmma ping-pong of two consumer
//   warpgroups. Bound at the paper shape (N = 2560 = 512 images x 5 beams,
//   H = 1024, V = 9490): 2 N H V = 49.8 GFLOP, 50 us at the H100's 989
//   TFLOP/s dense bf16; the bytes read (W 19.4 MB + h 5.2 MB) take 7 us at
//   3.35 TB/s: bound by operations.
// - fp32 (compute_dtype="float32"): the F32 operands, fp32 FMA on the CUDA
//   cores (not TF32) by both warpgroups on each tile, h streamed with W;
//   0.74 ms at the 67 TFLOP/s of fp32 outside the tensor cores.

#include "head_sm90.cuh"

namespace {

// One launch of the Ops instance (Bf16 or F32) with its epilogues: see
// ck_head_topk.
template <class Ops, template <int> class Mask, template <int> class Thresh>
int head_topk(const void* h, const void* w, const void* b, void* vals,
              void* idx, void* lse, int N, int H, int V, int k, int extract,
              int shares, int fault, int device, void* stream) {
  using namespace hsm;
  if (bad_shape(N, H, V, k, shares) || H % 8 || V % 8 ||
      (extract != kMask && extract != kThresh) || fault < 0 || fault > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap h_map, w_map;
  err = Ops::SIMT ? f32_maps(&h_map, &w_map, h, w, N, H, V)
                  : bf16_maps(&h_map, &w_map, h, w, N, H, V);
  if (err != cudaSuccess) return (int)err;
  Args a = {};
  a.bias = static_cast<const float*>(b);
  a.vals = static_cast<float*>(vals);
  a.idx = static_cast<int*>(idx);
  a.lse = static_cast<float*>(lse);
  a.N = N;
  a.H = H;
  a.V = V;
  a.k = k;
  a.fault = fault;
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)(extract == kThresh
                   ? launch_any<Ops, Thresh>(h_map, w_map, a, shares,
                                             H > HMAX, s)
                   : launch_any<Ops, Mask>(h_map, w_map, a, shares, H > HMAX,
                                           s));
}

}  // namespace

extern "C" {

// bf16: one launch, no scratch: `shares` CTAs a cluster split the vocab of
// each block of 64 rows (kernels/head.py::sweep_plan); h streams with W
// above H = 1024. extract: 0 = mask, 1 = thresh. fault: 0, or 1 to plant
// the fault of skipping a tile whose max equals the running k-th value
// (tests only). Returns the CUDA error code (0 = success); a cluster shape
// the card cannot hold is an error, not a fallback.
int ck_head_topk(const void* h, const void* w, const void* b, void* vals,
                 void* idx, void* lse, int N, int H, int V, int k,
                 int extract, int shares, int fault, int device,
                 void* stream) {
  return head_topk<hsm::Bf16, hsm::MaskEpi, hsm::ThreshEpi>(
      h, w, b, vals, idx, lse, N, H, V, k, extract, shares, fault, device,
      stream);
}

// compute_dtype="float32": h [N, H] and W [H, V] fp32, the rest as
// ck_head_topk's (`shares` from the fp32 clusters query). One launch.
int ck_head_topk_f32(const void* h, const void* w, const void* b,
                     void* vals, void* idx, void* lse, int N, int H, int V,
                     int k, int extract, int shares, int fault, int device,
                     void* stream) {
  return head_topk<hsm::F32, hsm::MaskEpiF32, hsm::ThreshEpiF32>(
      h, w, b, vals, idx, lse, N, H, V, k, extract, shares, fault, device,
      stream);
}

// How many clusters of `shares` CTAs (1 to 8) of the bf16 kernel the card
// holds at once, for h resident (wide = 0) or streamed (wide = 1) (0 when
// it cannot hold one; a negative CUDA error code when the query fails).
int ck_head_topk_max_clusters(int shares, int wide, int device) {
  return hsm::clusters_of<hsm::Bf16, hsm::MaskEpi>(shares, wide, device);
}

// The same for the fp32 kernel (h always streamed; `wide` is ignored).
int ck_head_topk_f32_max_clusters(int shares, int wide, int device) {
  return hsm::clusters_of<hsm::F32, hsm::MaskEpiF32>(shares, wide, device);
}

const char* ck_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ck_head_tile_width() { return BN; }

int ck_head_kmax() { return KMAX_LIMIT; }

}  // extern "C"
