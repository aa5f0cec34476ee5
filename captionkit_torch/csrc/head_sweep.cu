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
// What bounds it on the H100. At the paper shape (N = 2560 = 512 images x
// 5 beams, H = 1024, V = 9490) the products are 2 N H V = 49.8 GFLOP, 50
// us at 989 TFLOP/s dense bf16, against 7 us for the bytes read once: it
// is bound by operations. Every CTA that owns a block of rows must see all
// of W, so W's reads from L2 grow with the number of row blocks: 19.4 MB
// per block of 64 rows.
//
// Design (sm_90a, one launch, a thread-block cluster per 64 rows; 384
// threads a CTA, one CTA an SM; registers and shared memory in PERF.md):
// - The cluster's CTAs split the vocab: CTA rank c sweeps tiles [c P,
//   (c + 1) P) of 128 columns (P = ceil(tiles / shares)), so a cluster
//   reads W once for its rows. The host (kernels/head.py::sweep_plan)
//   takes the shares, at most 4, that need the fewest waves x tiles per
//   share, from the number of clusters of each size the card holds
//   (ck_head_sweep_max_clusters). An H100 80GB HBM3 (700 W) holds 39
//   clusters of 3 and 66 of 2, so there N = 2560 (40 row blocks) runs 40
//   clusters of 2.
// - h stays resident for H <= 1024: the CTA's 64 x H rows are loaded once
//   by TMA (128-byte swizzle, K-major) before the sweep. Above that
//   (STREAM), each W stage also brings the two 64 x 64 boxes of h for its
//   K range: h is read again for every tile (64 H bytes beside W's
//   128 H), the ring holds 3 stages of 48 KB, and the function and the
//   one launch with no partials stay.
// - One producer thread streams W through a 3-stage ring of 128 x 128
//   stages, four 64 x 64 TMA boxes each (128-byte swizzle, MN-major),
//   completing on mbarriers; a tile's last stage also brings the tile's
//   bias (a bulk copy beside the stage; read from L2 in the epilogue it
//   cost more, PERF.md). Each row block starts its share at another tile,
//   so the clusters spread their reads over W.
// - Two consumer warpgroups take the tiles in turns (a ping-pong): each
//   runs a tile's wgmma m64n128k16 chain (A = h, B = W's stage, both from
//   shared memory) and then its epilogue, which overlaps the other
//   warpgroup's products. An mbarrier pair orders their main loops, so
//   the ring is consumed in the order it is filled.
// - The epilogue stays in registers: in wgmma's accumulator layout a
//   thread holds two rows and 32 of the tile's columns; it carries, for
//   each row, an online (m, s) and a running top-KMAX over every column it
//   has held, across tiles (KMAX = 8, 16, 32 or 64, the smallest that
//   holds k; above 8 the lists outgrow the registers and the compiler
//   keeps them in local memory, PERF.md). A column is checked against a
//   bar shared by the row's four threads and inserted by one loop over a
//   candidate mask (32 inlined inserts made the code too large to run
//   fast). The
//   epilogue still takes longer than a tile's products, so the sweep runs
//   at the epilogue's pace (PERF.md).
// - The merge is on chip: each thread writes its partial states to its
//   CTA's shared memory (over h, no longer needed); after a cluster
//   barrier one warp a row reads all 8 x shares partial states through
//   distributed shared memory: lse = M + log sum_j s_j exp(m_j - M), and
//   the top-k by k rounds of a warp arg-max (head_common.cuh's
//   warp_pop_topk), so ties resolve by vocab id whatever share held them.
//   Above KMAX = 8 a row's four quad threads first merge their lists by k
//   rounds of a quad arg-max, so a CTA keeps 2 partial states a row (one
//   per warpgroup), which fit the space at every KMAX.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "head_common.cuh"
#include "sm90_common.cuh"

namespace {
namespace sweep {

using namespace sm90;

constexpr int BM = 64;              // rows per CTA
constexpr int TN = BN;              // vocab columns per tile (128)
constexpr int BKH = 64;             // K per h box and per W box
constexpr int KS = 2 * BKH;         // K per W stage
constexpr int HMAX = 1024;          // h resident up to here; streamed above
constexpr int KB_MAX = HMAX / BKH;  // h boxes
constexpr int STAGES = 3;
constexpr int H_BOX = BM * BKH * 2;   // 64 rows x 64 K, bf16
constexpr int W_HALF = BKH * 64 * 2;  // one W box: 64 K x 64 columns
constexpr int W_STAGE = 4 * W_HALF;   // 128 K x 128 columns: 4 boxes
constexpr int MAX_SHARES = 4;         // shares x slots partials <= 32 lanes
constexpr int NTHREADS = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr float kLog2e = 1.4426950408889634f;
constexpr int BIAS_SLOT = TN * 4;  // a tile's bias, beside each stage

// The layout of one instance: STREAM adds h's two boxes to every stage in
// place of the resident h. Partial states a row per CTA: 8 (one per
// thread of the row's quads) at KMAX = 8, else 2 (one per warpgroup).
template <int KMAX, bool STREAM>
struct Plan {
  static constexpr int STAGE = STREAM ? W_STAGE + 2 * H_BOX : W_STAGE;
  static constexpr int RESIDENT = STREAM ? 0 : KB_MAX * H_BOX;
  static constexpr int SMEM =
      1024 + RESIDENT + STAGES * (STAGE + BIAS_SLOT) + (2 * STAGES + 3) * 8;
  static constexpr int SLOTS = KMAX == 8 ? 8 : 2;
  static constexpr int PART = 2 + 2 * KMAX;  // m, s, KMAX values, ids
  // The partial states go over h, or over the ring when h streams.
  static_assert(BM * SLOTS * PART * 4 <=
                    (STREAM ? STAGES * STAGE : KB_MAX * H_BOX),
                "the partial states fit");
  static_assert(STAGE % 1024 == 0, "stages stay on 1024-byte boundaries");
};

// A thread's running state of its two rows h = 0, 1: the online (m, s)
// and a top-KMAX list of the columns it has held, and the bar a column must
// beat to matter: the best of the quad's (the row's four threads') last
// list entries. The row's top-KMAX all beat that bar (the quad thread that
// holds it has KMAX entries at least as good), so a column that does not
// is left out, and the check rarely passes after the first tiles.
template <int KMAX>
struct RowState {
  float m[2];
  float s[2];
  float lv[2][KMAX];
  int li[2][KMAX];
  float bar_v[2];
  int bar_i[2];
};

// Adds a tile's bias (from its stage's bias slot) to a thread's share of
// the accumulator (column col0 + 8 j + 2 q + e is acc[4 j + 2 h + e] of
// rows h = 0, 1) and sets columns past V to -inf.
__device__ __forceinline__ void add_bias(float (&acc)[64], const float* bias_s,
                                         int col0, int V, int q) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * q;  // V % 8 == 0: c, c + 1 alike
    const bool in = col0 + c < V;
    const float2 b =
        in ? *reinterpret_cast<const float2*>(bias_s + c) : float2{};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[4 * j + 2 * h] = in ? acc[4 * j + 2 * h] + b.x : -INFINITY;
      acc[4 * j + 2 * h + 1] = in ? acc[4 * j + 2 * h + 1] + b.y : -INFINITY;
    }
  }
}

// Folds a thread's share of one biased tile into its running state.
template <int KMAX>
__device__ __forceinline__ void fold_tile(const float (&acc)[64], int col0,
                                          int V, int q, RowState<KMAX>& st) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float tm = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      tm = fmaxf(tm, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
    const float m_new = fmaxf(st.m[h], tm);
    if (m_new != -INFINITY) {
      // exp(x - m) as 2^(x log2 e - m log2 e): one FMA and one ex2 each.
      const float mb = m_new * kLog2e;
      float s = st.s[h] * exp2f(st.m[h] * kLog2e - mb);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        s += exp2f(fmaf(acc[4 * j + 2 * h], kLog2e, -mb)) +
             exp2f(fmaf(acc[4 * j + 2 * h + 1], kLog2e, -mb));
      st.s[h] = s;
      st.m[h] = m_new;
    }
    if (!(tm < st.bar_v[h])) {
      // The columns that reach the bar, as a mask (a superset of those
      // that beat it: insert() orders equal values by id), then one insert
      // loop over them (one copy of the insert code, not 32).
      uint32_t cand = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (acc[4 * j + 2 * h + e] >= st.bar_v[h] &&
              col0 + 8 * j + 2 * q + e < V)
            cand |= 1u << (2 * j + e);
      if (cand) {
        float v[32];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          v[2 * j] = acc[4 * j + 2 * h];
          v[2 * j + 1] = acc[4 * j + 2 * h + 1];
        }
        do {
          const int x = __ffs(cand) - 1;
          cand &= cand - 1;
          insert(st.lv[h], st.li[h], v[x], col0 + 8 * (x >> 1) + 2 * q +
                                               (x & 1));
        } while (cand);
      }
    }
    // The new bar: the best of the quad's last entries (lanes 4 r .. 4 r
    // + 3 hold row r).
    float bv = st.lv[h][KMAX - 1];
    int bi = st.li[h][KMAX - 1];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    st.bar_v[h] = bv;
    st.bar_i[h] = bi;
  }
}

// KMAX > 8: the quad's (the row's four threads') merged state of row h,
// written by quad thread 0 to `p` (m, s, then k values and k ids at their
// KMAX places): k rounds of a quad arg-max over the lists' heads, the
// winner's owner popping it.
template <int KMAX>
__device__ __forceinline__ void quad_merge(RowState<KMAX>& st, int h, int k,
                                           int q, float* p) {
  const float m = st.m[h];
  float M = m;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  float S = M == -INFINITY ? 0.0f : st.s[h] * expf(m - M);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1)
    S += __shfl_xor_sync(0xffffffffu, S, off);
  for (int r = 0; r < k; ++r) {
    float v = st.lv[h][0];
    int i = st.li[h][0];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (better(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    if (st.lv[h][0] == v && st.li[h][0] == i) {
#pragma unroll
      for (int x = 0; x < KMAX - 1; ++x) {
        st.lv[h][x] = st.lv[h][x + 1];
        st.li[h][x] = st.li[h][x + 1];
      }
      st.lv[h][KMAX - 1] = -INFINITY;
      st.li[h][KMAX - 1] = INT_MAX;
    }
    if (q == 0) {
      p[2 + r] = v;
      reinterpret_cast<int*>(p)[2 + KMAX + r] = i;
    }
  }
  if (q == 0) {
    p[0] = M;
    p[1] = S;
    for (int r = k; r < KMAX; ++r) {
      p[2 + r] = -INFINITY;
      reinterpret_cast<int*>(p)[2 + KMAX + r] = INT_MAX;
    }
  }
}

template <int KMAX, bool STREAM>
__global__ void __launch_bounds__(NTHREADS, 1)
    head_sweep_kernel(const __grid_constant__ CUtensorMap h_map,
                      const __grid_constant__ CUtensorMap w_map,
                      const float* __restrict__ bias,
                      float* __restrict__ vals, int* __restrict__ idx,
                      float* __restrict__ lse, int N, int H, int V, int k) {
  using P = Plan<KMAX, STREAM>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* hs = smem;  // resident h: KB boxes of 64 rows x 64 K
  unsigned char* ring = smem + P::RESIDENT;
  float* bias_s = reinterpret_cast<float*>(ring + STAGES * P::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + STAGES * TN);
  uint64_t* empty = full + STAGES;
  uint64_t* h_full = empty + STAGES;
  uint64_t* order = h_full + 1;  // order[c]: warpgroup c may start a tile

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int shares = gridDim.x;  // the cluster: the CTAs of one row block
  const int share = blockIdx.x;
  const int row0 = blockIdx.y * BM;
  const int n_tiles = (V + TN - 1) / TN;
  const int per = (n_tiles + shares - 1) / shares;
  const int t_begin = share * per;
  const int my_tiles = max(0, min(n_tiles, t_begin + per) - t_begin);
  // The share is swept from a tile that depends on the row block, so the
  // clusters do not all read the same W tile at the same time.
  const int rot = my_tiles > 0 ? static_cast<int>(blockIdx.y) % my_tiles : 0;
  const int KB = (H + KS - 1) / KS;  // W stages a tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the consuming warpgroup's 4 warps
    }
    mbar_init(h_full, 1);
    mbar_init(&order[0], 4);
    mbar_init(&order[1], 4);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    if (threadIdx.x == 256) {  // producer
      if constexpr (!STREAM) {
        mbar_expect_tx(h_full, 2 * KB * H_BOX);  // K past H reads zeros
        for (int kb = 0; kb < 2 * KB; ++kb)
          tma_load_2d(hs + kb * H_BOX, &h_map, h_full, kb * BKH, row0);
      }
      for (int t = 0; t < my_tiles; ++t) {
        const int col = (t_begin + (t + rot) % my_tiles) * TN;
        for (int kb = 0; kb < KB; ++kb) {
          const int it = t * KB + kb;
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          unsigned char* st = ring + s * P::STAGE;
          // The tile's last stage also brings its bias.
          const uint32_t bias_bytes =
              kb == KB - 1 ? 4 * min(TN, V - col) : 0;
          mbar_expect_tx(&full[s], P::STAGE + bias_bytes);
          if (bias_bytes)
            bulk_load(bias_s + s * TN, bias + col, bias_bytes, &full[s]);
#pragma unroll
          for (int r = 0; r < 2; ++r)  // K halves x column halves
#pragma unroll
            for (int c = 0; c < 2; ++c)
              tma_load_2d(st + (2 * r + c) * W_HALF, &w_map, &full[s],
                          col + 64 * c, kb * KS + r * BKH);
          if (STREAM)  // the stage's K range of h
#pragma unroll
            for (int r = 0; r < 2; ++r)
              tma_load_2d(st + W_STAGE + r * H_BOX, &h_map, &full[s],
                          kb * KS + r * BKH, row0);
        }
      }
    }
  } else {
    // Consumer warpgroup wg takes the share's tiles wg, wg + 2, ...
    const int q = lane % 4;
    const int rl = (warp % 4) * 16 + lane / 4;  // rows rl and rl + 8
    RowState<KMAX> rs;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs.m[h] = -INFINITY;
      rs.s[h] = 0.0f;
      clear(rs.lv[h], rs.li[h]);
      rs.bar_v[h] = -INFINITY;
      rs.bar_i[h] = INT_MAX;
    }
    if (!STREAM) mbar_wait(h_full, 0);
    int n = 0;  // this warpgroup's tiles so far
    for (int t = wg; t < my_tiles; t += 2, ++n) {
      // Wait for the other warpgroup to have issued its previous tile.
      if (t > 0) mbar_wait(&order[wg], (wg == 0 ? n - 1 : n) & 1);
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      fence_regs(acc);
      for (int kb = 0; kb < KB; ++kb) {
        const int it = t * KB + kb;
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* st = ring + s * P::STAGE;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // k16 steps: 32 bytes of h, 16 W rows
          const int r = j / 4;  // the stage's K half
          const unsigned char* a =
              STREAM ? st + W_STAGE + r * H_BOX : hs + (2 * kb + r) * H_BOX;
          wgmma_m64n128k16_ss(
              acc, smem_desc(a + 32 * (j % 4), 16, 1024, kSwizzle128B),
              smem_desc(st + 2 * r * W_HALF + 2048 * (j % 4), W_HALF, 1024,
                        kSwizzle128B));
        }
        wgmma_commit();
        if (kb > 0) {
          wgmma_wait<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&order[1 - wg]);
      wgmma_wait<0>();
      fence_regs(acc);
      const int last = (t * KB + KB - 1) % STAGES;
      const int col0 = (t_begin + (t + rot) % my_tiles) * TN;
      add_bias(acc, bias_s + last * TN, col0, V, q);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[last]);
      fold_tile(acc, col0, V, q, rs);
    }
    // Both warpgroups are done reading h and the ring: their partial
    // states go over the first of them.
    named_sync(1, 256);
    float* part = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (KMAX == 8) {
        float* p = part + ((rl + 8 * h) * P::SLOTS + wg * 4 + q) * P::PART;
        p[0] = rs.m[h];
        p[1] = rs.s[h];
#pragma unroll
        for (int i = 0; i < KMAX; ++i) {
          p[2 + i] = rs.lv[h][i];
          reinterpret_cast<int*>(p)[2 + KMAX + i] = rs.li[h][i];
        }
      } else {
        quad_merge(rs, h, k, q,
                   part + ((rl + 8 * h) * P::SLOTS + wg) * P::PART);
      }
    }
  }
  cluster_sync();

  // The merge: rows share, share + shares, ... of the 64, one warp each,
  // over every CTA's partial states of the row.
  const float* part = reinterpret_cast<const float*>(smem);
  for (int r = share + shares * warp; r < BM; r += shares * (NTHREADS / 32)) {
    const int gr = row0 + r;
    if (gr >= N) break;  // the same for the whole warp
    float m = -INFINITY, s = 0.0f;
    float lv[KMAX];
    int li[KMAX];
    clear(lv, li);
    if (lane < shares * P::SLOTS) {
      const float* p = cluster_map(part, lane / P::SLOTS) +
                       (r * P::SLOTS + lane % P::SLOTS) * P::PART;
      m = p[0];
      s = p[1];
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        lv[i] = p[2 + i];
        li[i] = reinterpret_cast<const int*>(p)[2 + KMAX + i];
      }
    }
    const float M = warp_max(m);
    const float S = warp_sum(m == -INFINITY ? 0.0f : s * expf(m - M));
    warp_pop_topk(lv, li, k, vals + static_cast<size_t>(gr) * k,
                  idx + static_cast<size_t>(gr) * k, lane);
    if (lane == 0) lse[gr] = M + logf(S);
  }
  cluster_sync();  // no CTA leaves while its partial states are read
}

}  // namespace sweep

bool bad_shape(int N, int H, int V, int k, int shares) {
  return N < 1 || H < 1 || V < 1 || k < 1 || k > KMAX_LIMIT || k > V ||
         H % 8 || V % 8 || shares < 1 || shares > sweep::MAX_SHARES;
}

// The launch of clusters of `shares` CTAs over `row_blocks` blocks of rows
// (`attr` holds the cluster shape the config points to).
cudaLaunchConfig_t launch_config(int shares, int row_blocks, int smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = shares;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(shares, row_blocks);
  cfg.blockDim = dim3(sweep::NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of `shares` CTAs of one instance the card holds at
// once; sets the kernel's shared-memory size first.
template <int KMAX, bool STREAM>
cudaError_t max_clusters(int shares, int* clusters) {
  constexpr int smem = sweep::Plan<KMAX, STREAM>::SMEM;
  auto* kernel = sweep::head_sweep_kernel<KMAX, STREAM>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(shares, 1, smem, nullptr,
                                               &attr);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

template <int KMAX, bool STREAM>
cudaError_t launch_sweep(const CUtensorMap& h_map, const CUtensorMap& w_map,
                         const float* b, float* vals, int* idx, float* lse,
                         int N, int H, int V, int k, int shares,
                         cudaStream_t stream) {
  using namespace sweep;
  // The first launch at each cluster size checks that the card holds one.
  static bool checked[MAX_SHARES + 1] = {};
  if (!checked[shares]) {
    int clusters = 0;
    const cudaError_t err = max_clusters<KMAX, STREAM>(shares, &clusters);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    checked[shares] = true;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(shares, (N + BM - 1) / BM, Plan<KMAX, STREAM>::SMEM,
                    stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, head_sweep_kernel<KMAX, STREAM>, h_map, w_map, b, vals, idx, lse,
      N, H, V, k);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool STREAM>
cudaError_t launch_sweep(const CUtensorMap& h_map, const CUtensorMap& w_map,
                         const float* b, float* vals, int* idx, float* lse,
                         int N, int H, int V, int k, int shares,
                         cudaStream_t stream) {
  switch (kmax_for(k)) {
    case 8:
      return launch_sweep<8, STREAM>(h_map, w_map, b, vals, idx, lse, N, H,
                                     V, k, shares, stream);
    case 16:
      return launch_sweep<16, STREAM>(h_map, w_map, b, vals, idx, lse, N, H,
                                      V, k, shares, stream);
    case 32:
      return launch_sweep<32, STREAM>(h_map, w_map, b, vals, idx, lse, N, H,
                                      V, k, shares, stream);
    default:
      return launch_sweep<64, STREAM>(h_map, w_map, b, vals, idx, lse, N, H,
                                      V, k, shares, stream);
  }
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
  using namespace sweep;
  if (bad_shape(N, H, V, k, shares)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap h_map, w_map;
  err = tensor_map_2d(&h_map, h, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, H,
                      H, BM, BKH, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  err = tensor_map_2d(&w_map, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, H, V,
                      V, BKH, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* bp = static_cast<const float*>(b);
  auto* vp = static_cast<float*>(vals);
  auto* ip = static_cast<int*>(idx);
  auto* lp = static_cast<float*>(lse);
  return (int)(H > HMAX ? launch_sweep<true>(h_map, w_map, bp, vp, ip, lp, N,
                                             H, V, k, shares, s)
                        : launch_sweep<false>(h_map, w_map, bp, vp, ip, lp,
                                              N, H, V, k, shares, s));
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
  if (shares < 1 || shares > sweep::MAX_SHARES)
    return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  int clusters = 0;
  if (err == cudaSuccess)
    err = wide ? max_clusters<8, true>(shares, &clusters)
               : max_clusters<8, false>(shares, &clusters);
  return err == cudaSuccess ? clusters : -(int)err;
}

const char* ck_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ck_head_sweep_tile_width() { return BN; }

int ck_head_sweep_kmax() { return KMAX_LIMIT; }

// The h width above which h streams through the ring.
int ck_head_sweep_resident_h() { return sweep::HMAX; }

}  // extern "C"
