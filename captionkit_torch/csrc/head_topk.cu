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
// bf16: head_sm90.cuh's kernel, one launch with no partials in device
// memory (clusters that split the vocab, a TMA ring of W, a wgmma ping-pong
// of two consumer warpgroups, the merge on chip), with the Bf16 operands
// and the Extract epilogue: per 128-column tile and row, the extraction
// that `extract` names over the wgmma accumulator's registers, folded into
// the warpgroup's running top-k; a tile whose max is strictly below the
// running k-th value skips the rounds. The two extractions see the same
// logits and take the same entries in the same order, so they give
// bit-identical results. Bound at the paper shape (N = 2560 = 512 images x
// 5 beams, H = 1024, V = 9490): 2 N H V = 49.8 GFLOP, 50 us at the H100's
// 989 TFLOP/s dense bf16; the bytes read (W 19.4 MB + h 5.2 MB) take 7 us
// at 3.35 TB/s: bound by operations.
//
// fp32 (compute_dtype="float32"): two passes. Pass 1, grid = vocab tiles x
// row tiles: head_common.cuh's f32_logits_tile (fp32 FMA on the CUDA
// cores, not TF32) and, per row, the tile's max, exp-sum and top-k by
// either extraction (emit_tile_row) into scratch; pass 2 (launch_merge)
// merges the tiles. Bound by the 67 TFLOP/s of fp32 outside the tensor
// cores.

#include "head_sm90.cuh"

namespace {

constexpr int F32_BM = 64;      // rows per fp32 pass-1 block
constexpr int F32_LDC = BN + 4;  // fp32 logits tile stride

template <int EXTRACT>
__global__ void __launch_bounds__(THREADS)
head_f32_tile_kernel(const float* __restrict__ h,
                     const float* __restrict__ w,
                     const float* __restrict__ bias,
                     float* __restrict__ part_m, float* __restrict__ part_s,
                     float* __restrict__ part_v, int* __restrict__ part_i,
                     int N, int H, int V, int k) {
  __shared__ __align__(128) float Cs[F32_BM * F32_LDC];
  __shared__ __align__(16) float stage[f32_tile_floats<F32_BM>()];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int col0 = tile * BN;
  const int row0 = blockIdx.y * F32_BM;
  f32_logits_tile<F32_BM>(h, w, row0, col0, N, H, V, stage, Cs, F32_LDC);

  // Epilogue: each warp reduces F32_BM / 8 rows of the tile.
  constexpr int rows_per_warp = F32_BM / (THREADS / 32);
  for (int rr = 0; rr < rows_per_warp; ++rr) {
    const int r = warp * rows_per_warp + rr;
    const int gr = row0 + r;
    if (gr >= N) break;  // the same for the whole warp
    float x[COLS_PER_LANE];
    int xi[COLS_PER_LANE];
    load_row(Cs, F32_LDC, r, bias, col0, V, lane, x, xi);
    emit_tile_row<EXTRACT>(x, xi, k, (size_t)gr * n_tiles + tile, part_m,
                           part_s, part_v, part_i, lane);
  }
}

bool bad_f32_shape(int N, int H, int V, int k) {
  return N < 1 || H < 1 || V < 1 || k < 1 || k > KMAX_LIMIT || k > V ||
         H % 8 || V % 8;
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
  using namespace hsm;
  if (bad_shape(N, H, V, k, shares) || H % 8 || V % 8 ||
      (extract != kMask && extract != kThresh) || fault < 0 || fault > 1)
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
  a.fault = fault;
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)(extract == kThresh
                   ? launch_any<Bf16, ThreshEpi>(h_map, w_map, a, shares,
                                                 H > HMAX, s)
                   : launch_any<Bf16, MaskEpi>(h_map, w_map, a, shares,
                                               H > HMAX, s));
}

// fp32: both passes on `stream`. Scratch (allocated by the caller):
// part_m, part_s [N * n_tiles] fp32, part_v [N * n_tiles * k] fp32, part_i
// [N * n_tiles * k] int32, with n_tiles = ceil(V / 128).
int ck_head_topk_f32(const void* h, const void* w, const void* b,
                     void* vals, void* idx, void* lse, void* part_m,
                     void* part_s, void* part_v, void* part_i, int N, int H,
                     int V, int k, int extract, int device, void* stream) {
  if (bad_f32_shape(N, H, V, k) || (extract != kMask && extract != kThresh))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (V + BN - 1) / BN;
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles, (N + F32_BM - 1) / F32_BM);
  const auto* hp = static_cast<const float*>(h);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(b);
  auto* pm = static_cast<float*>(part_m);
  auto* ps = static_cast<float*>(part_s);
  auto* pv = static_cast<float*>(part_v);
  auto* pi = static_cast<int*>(part_i);
  if (extract == kThresh)
    head_f32_tile_kernel<kThresh><<<grid, THREADS, 0, s>>>(
        hp, wp, bp, pm, ps, pv, pi, N, H, V, k);
  else
    head_f32_tile_kernel<kMask><<<grid, THREADS, 0, s>>>(
        hp, wp, bp, pm, ps, pv, pi, N, H, V, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(pm, ps, pv, pi, static_cast<float*>(vals),
                           static_cast<int*>(idx), static_cast<float*>(lse),
                           N, n_tiles, k, s);
}

// How many clusters of `shares` CTAs of the bf16 kernel the card holds at
// once, for h resident (wide = 0) or streamed (wide = 1) (0 when it cannot
// hold one; a negative CUDA error code when the query fails).
int ck_head_topk_max_clusters(int shares, int wide, int device) {
  return hsm::clusters_of<hsm::Bf16, hsm::MaskEpi>(shares, wide, device);
}

const char* ck_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ck_head_tile_width() { return BN; }

int ck_head_kmax() { return KMAX_LIMIT; }

}  // extern "C"
