// The single-sweep vocab head: logits = h @ W + b, then per row the top-k
// logits (descending, equal values lowest index first), their vocab ids
// and the log-sum-exp, in one launch with no partial results in device
// memory.
//
// Replaces the TPU kernel of captionkit/ops/head.py, _sweep_head_topk
// (CAPTIONKIT_HEAD_SWEEP): there the grid walks the vocab tiles in order on
// one core, carrying an online (max, exp-sum) and a running top-k in
// scratch, and W is read once for the whole grid.
//
// Inputs:  h [N, H], W [H, V] (row-major, V a multiple of 8), both bf16
//          (any H, a multiple of 8) or both fp32 (compute_dtype="float32",
//          ck_head_sweep_f32), b [V] fp32 (padded vocab columns carry
//          -1e30); any k up to KMAX_LIMIT.
// Outputs: vals [N, k] fp32, idx [N, k] int32, lse [N] fp32.
//
// Design: head_sm90.cuh's kernel (clusters that split the vocab, a TMA
// ring of W, the merge on chip through distributed shared memory) with the
// Sweep epilogue: each thread checks its 32 columns of a tile against the
// bar of its row and inserts those that reach it into its own top-KMAX
// list. bf16: the Bf16 operands in a wgmma ping-pong; on an H100 80GB HBM3
// (700 W) N = 2560 (40 row blocks) runs 40 clusters of 2; the epilogue
// takes longer than a tile's products, so the sweep runs at the
// epilogue's pace (PERF.md). fp32: the F32 operands, fp32 FMA on the CUDA
// cores by both consumer warpgroups on every tile, h streamed with W, the
// epilogue a tile's in turns; the products bound it.

#include "head_sm90.cuh"

namespace {

// One launch of the Ops instance (Bf16 or F32) with its epilogue: see
// ck_head_sweep.
template <class Ops, template <int> class Epi>
int sweep(const void* h, const void* w, const void* b, void* vals, void* idx,
          void* lse, int N, int H, int V, int k, int shares, int device,
          void* stream) {
  using namespace hsm;
  if (bad_shape(N, H, V, k, shares) || H % 8 || V % 8)
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
  return (int)launch_any<Ops, Epi>(h_map, w_map, a, shares, H > HMAX,
                                   static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// One launch, no scratch: `shares` CTAs a cluster split the vocab of each
// block of 64 rows; h streams with W above H = 1024. Returns the CUDA
// error code (0 = success); a cluster shape the card cannot hold is an
// error, not a fallback.
int ck_head_sweep(const void* h, const void* w, const void* b, void* vals,
                  void* idx, void* lse, int N, int H, int V, int k,
                  int shares, int device, void* stream) {
  return sweep<hsm::Bf16, hsm::Sweep>(h, w, b, vals, idx, lse, N, H, V, k,
                                      shares, device, stream);
}

// compute_dtype="float32": h [N, H], W [H, V] fp32, the rest as
// ck_head_sweep's (`shares` from ck_head_sweep_f32_max_clusters). One
// launch, no scratch.
int ck_head_sweep_f32(const void* h, const void* w, const void* b,
                      void* vals, void* idx, void* lse, int N, int H, int V,
                      int k, int shares, int device, void* stream) {
  return sweep<hsm::F32, hsm::SweepF32>(h, w, b, vals, idx, lse, N, H, V, k,
                                       shares, device, stream);
}

// How many clusters of `shares` CTAs the card holds at once, for h
// resident (wide = 0) or streamed (wide = 1) (0 when it cannot hold one; a
// negative CUDA error code when the query fails).
int ck_head_sweep_max_clusters(int shares, int wide, int device) {
  return hsm::clusters_of<hsm::Bf16, hsm::Sweep>(shares, wide, device);
}

// The same for the fp32 kernel (h always streamed; `wide` is ignored).
int ck_head_sweep_f32_max_clusters(int shares, int wide, int device) {
  return hsm::clusters_of<hsm::F32, hsm::SweepF32>(shares, wide, device);
}

const char* ck_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ck_head_sweep_tile_width() { return BN; }

int ck_head_sweep_kmax() { return KMAX_LIMIT; }

// The h width above which h streams through the ring.
int ck_head_sweep_resident_h() { return hsm::HMAX; }

}  // extern "C"
