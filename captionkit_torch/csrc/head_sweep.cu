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
// Inputs:  h [N, H] bf16 (any H, a multiple of 8), W [H, V] bf16
//          (row-major, V a multiple of 8), b [V] fp32 (padded vocab
//          columns carry -1e30); any k up to KMAX_LIMIT.
// Outputs: vals [N, k] fp32, idx [N, k] int32, lse [N] fp32.
// (compute_dtype="float32": ck_head_sweep_f32, head_common.cuh's one-pass
// fp32 sweep on the CUDA cores.)
//
// Design: head_sm90.cuh's kernel (clusters that split the vocab, a TMA
// ring of W, a wgmma ping-pong, the merge on chip through distributed
// shared memory) with the Bf16 operands and the Sweep epilogue: each
// thread checks its 32 columns of a tile against the bar of its row and
// inserts those that reach it into its own top-KMAX list. On an H100 80GB
// HBM3 (700 W) N = 2560 (40 row blocks) runs 40 clusters of 2; the
// epilogue takes longer than a tile's products, so the sweep runs at the
// epilogue's pace (PERF.md).

#include "head_sm90.cuh"

extern "C" {

// One launch, no scratch: `shares` CTAs a cluster split the vocab of each
// block of 64 rows; h streams with W above H = 1024. Returns the CUDA
// error code (0 = success); a cluster shape the card cannot hold is an
// error, not a fallback.
int ck_head_sweep(const void* h, const void* w, const void* b, void* vals,
                  void* idx, void* lse, int N, int H, int V, int k,
                  int shares, int device, void* stream) {
  using namespace hsm;
  if (bad_shape(N, H, V, k, shares) || H % 8 || V % 8)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap h_map, w_map;
  err = bf16_maps(&h_map, &w_map, h, w, N, H, V);
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
  return (int)launch_any<Bf16, Sweep>(h_map, w_map, a, shares, H > HMAX,
                                      static_cast<cudaStream_t>(stream));
}

// compute_dtype="float32": head_common.cuh's one-pass fp32 sweep (h [N, H],
// W [H, V] fp32, H and V multiples of 4), one launch, no scratch.
int ck_head_sweep_f32(const void* h, const void* w, const void* b,
                      void* vals, void* idx, void* lse, int N, int H, int V,
                      int k, int device, void* stream) {
  if (N < 1 || H < 1 || V < 1 || k < 1 || k > KMAX_LIMIT || k > V || H % 4 ||
      V % 4)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sweep_f32(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(vals),
      static_cast<int*>(idx), static_cast<float*>(lse), N, H, V, k,
      static_cast<cudaStream_t>(stream));
}

// How many clusters of `shares` CTAs the card holds at once, for h
// resident (wide = 0) or streamed (wide = 1) (0 when it cannot hold one; a
// negative CUDA error code when the query fails).
int ck_head_sweep_max_clusters(int shares, int wide, int device) {
  return hsm::clusters_of<hsm::Bf16, hsm::Sweep>(shares, wide, device);
}

const char* ck_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ck_head_sweep_tile_width() { return BN; }

int ck_head_sweep_kmax() { return KMAX_LIMIT; }

// The h width above which h streams through the ring.
int ck_head_sweep_resident_h() { return hsm::HMAX; }

}  // extern "C"
