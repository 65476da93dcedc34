// The final nearest-centroid assignment, alone and fused with bit-plane
// packing.
//
// `fused_planes_kernel` replaces the Pallas TPU kernel `_fused_kernel` of
// the reference package (consensus_clustering_tpu/ops/pallas_fused_block.py),
// launched by `_pallas_fused_planes` and wrapped by `fused_assign_pack`.
// `assign_kernel` is the same assignment without the packing: KMeans' final
// labels and min-distances (models/kmeans.py), so a fused label is, by
// construction, the final assignment's own.
//
// What fused_planes_kernel computes, for lanes l (one resample each, global
// bit row0 + l of the block's planes) and element columns j: if bit
// (row0 + l) % 32 of coplanes[(row0 + l) / 32][j] is set (j is in lane l's
// resample), the label c of x_cols[j] under lane l's final centroids, and
// then bit (row0 + l) % 32 of planes[c][(row0 + l) / 32][j].  Output
// (k_max, n_words, n_cols) int32 words holding uint32 bit patterns; the
// labels never reach device memory.
//
// What bounds both on the H100: operations.  A (lane, row) pair costs
// 2 * d * k FLOPs of distances (issued as separate multiplies and adds, so
// the floor is twice the FMA-rate bound); the data is a few MB.
//
// assign_kernel: one block per (128-row tile, group of per_block
// consecutive lanes), the lanes in turn, two threads per row, the shared
// tile routine of common.cuh (rows staged at an odd stride, once for the
// lanes of a resample, centroids transposed and read as 16-byte
// broadcasts, register groups of 8 slots, chunks of slots where they do
// not all fit in shared memory); labels written as int64 straight from
// registers.  Sharing the staged rows among a resample's n_init lanes took
// the headline's time from 0.0452 to 0.0386 ms (PERF.md, Findings).  It
// takes 40 registers a thread (ptxas, sm_90a) and 30 KB of shared memory
// a block at the headline, so 6 blocks of 8 warps fit an SM: its 512
// blocks are one wave of ~4 per SM.
//
// fused_planes_kernel: one block per (128-column tile, plane word); one
// thread owns one column.  The block stages its x tile and the centroids
// of the (at most 32) lanes of its word in shared memory in the routine's
// layout, groups of lanes at a time when they do not all fit; per lane a
// thread tests its co-sample bit, and where it is set takes the label from
// the shared routine and ORs the bit into its own word of a (k_max, 128)
// shared tile.  Each thread then writes each of its k_max output words
// once, zeros included: every output word is written exactly once and no
// atomics are needed.  Lanes outside [0, n_lanes) own no bits.
#include <stdint.h>

#include "common.cuh"

#define CC_ASSIGN_THREADS (2 * CC_TILE)

template <bool VEC>
__global__ void __launch_bounds__(CC_ASSIGN_THREADS)
    assign_kernel(const float* __restrict__ x,
                  const int* __restrict__ lane_src,
                  const float* __restrict__ cen, int lanes, int per_block,
                  int n, int d, int k_max, int k, int xs, int ks, int cg,
                  int64_t* __restrict__ labels, float* __restrict__ dmin) {
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;                  // (d, ks) a chunk of centroids
  float* csq = ct + (size_t)ks * d;  // (ks,)
  float* xt = csq + ks;              // (TILE, xs)
  // Where the halves of a row meet (2 * TILE words): over ct and csq, which
  // every lane stages anew, where they are that large, else after xt; never
  // over xt, which the next lane may share.
  float* mv = ks * (d + 1) >= 2 * CC_TILE ? smem : xt + CC_TILE * xs;
  const int row0 = blockIdx.x * CC_TILE;
  const int rows = min(CC_TILE, n - row0);
  const int lane0 = blockIdx.y * per_block;
  const int lane_end = min(lanes, lane0 + per_block);
  float xsq = 0.0f;
  int staged = -1;
  for (int lane = lane0; lane < lane_end; ++lane) {
    // Lanes of one resample share the staged rows and their norms.
    const int src = lane_src[lane];
    if (lane > lane0) __syncthreads();  // every thread is done with the last
    if (src != staged) {
      cc_stage_rows<4>(x + ((size_t)src * n + row0) * d, rows, d, xs, xt);
    }
    float best;
    const int bj = cc_tile_nearest<VEC>(
        cen + (size_t)lane * k_max * d, d, k, xs, ks, cg, rows, ct, csq, xt,
        mv, reinterpret_cast<int*>(mv + CC_TILE), src != staged, xsq, &best);
    staged = src;
    const int r = threadIdx.x;
    if (r < rows) {
      labels[(size_t)lane * n + row0 + r] = bj;
      dmin[(size_t)lane * n + row0 + r] = best;
    }
  }
}

template <bool VEC>
__global__ void fused_planes_kernel(const float* __restrict__ x_cols,
                                    const float* __restrict__ cen,
                                    int n_lanes, int n_cols, int d, int k_max,
                                    int k, int xs, int ks,
                                    const int* __restrict__ cop, int row0,
                                    int n_words, int lane_group,
                                    int* __restrict__ planes) {
  extern __shared__ __align__(16) float smem[];
  const size_t lane_words = (size_t)ks * (d + 1);  // (d, ks) + (ks,) norms
  float* cg = smem;                                 // (group, lane_words)
  int* acc = reinterpret_cast<int*>(cg + lane_group * lane_words);
  float* xt = reinterpret_cast<float*>(acc + k_max * CC_TILE);  // (TILE, xs)

  const int t = threadIdx.x;
  const int col0 = blockIdx.x * CC_TILE;
  const int w = blockIdx.y;
  const int cols = min(CC_TILE, n_cols - col0);
  const bool live = t < cols;
  cc_stage_rows<8>(x_cols + (size_t)col0 * d, cols, d, xs, xt);
  for (int j = 0; j < k_max; ++j) acc[j * CC_TILE + t] = 0;
  const unsigned sampled = live ? (unsigned)cop[(size_t)w * n_cols + col0 + t]
                                : 0u;
  // Lanes whose bit row0 + l lies in word w.
  const int l_lo = max(0, w * 32 - row0);
  const int l_hi = min(n_lanes, (w + 1) * 32 - row0);
  __syncthreads();
  const float* xr = xt + t * xs;
  const float xsq = live ? cc_sq_norm(xr, d) : 0.0f;

  for (int g0 = l_lo; g0 < l_hi; g0 += lane_group) {
    const int g_n = min(lane_group, l_hi - g0);
    cc_stage_centroids<8>(cen + (size_t)g0 * k_max * d, (size_t)k_max * d, g_n,
                       lane_words, 0, k, d, ks, cg);
    __syncthreads();
    for (int p = t; p < g_n * k; p += blockDim.x) {
      const int l = p / k;
      const int j = p - l * k;
      float* ct = cg + l * lane_words;
      ct[(size_t)ks * d + j] = cc_staged_norm(ct, j, d, ks);
    }
    __syncthreads();
    if (live) {
      for (int l = 0; l < g_n; ++l) {
        const int bit = row0 + g0 + l - w * 32;
        if (!((sampled >> bit) & 1u)) continue;
        const float* ct = cg + l * lane_words;
        float bv = INFINITY;
        int bj = 0;
        cc_nearest_slots<VEC>(xr, xsq, ct, ct + (size_t)ks * d, ks, d, 0, k,
                              0, bv, bj);
        acc[bj * CC_TILE + t] |= (int)(1u << bit);
      }
    }
    __syncthreads();
  }
  if (live) {
    for (int j = 0; j < k_max; ++j) {
      planes[((size_t)j * n_words + w) * n_cols + col0 + t] =
          acc[j * CC_TILE + t];
    }
  }
}

static int g_assign_reserved_vec[CC_MAX_DEVICES];
static int g_assign_reserved_scalar[CC_MAX_DEVICES];
static int g_fused_reserved_vec[CC_MAX_DEVICES];
static int g_fused_reserved_scalar[CC_MAX_DEVICES];

// x (B, n, d); lane l reads resample lane_src[l]; cen (lanes, k_max, d).
// The layout (xs, ks, cg, vec) comes from ops/fused_block.tile_layout.
// A block takes per_block consecutive lanes of one tile.  Outputs labels
// (lanes, n) int64 and dmin (lanes, n) float.
CC_EXPORT int cc_assign_labels(const float* x, const int* lane_src,
                               const float* cen, int lanes, int per_block,
                               int n, int d, int k_max, int k, int xs, int ks,
                               int cg, int vec, int64_t* labels, float* dmin,
                               void* stream) {
  if (lanes < 1 || per_block < 1 || n < 1 || d < 1 || k_max < 1 || k < 1 ||
      k > k_max || xs < d || cg < 1 || cg > k_max || ks < cg ||
      (vec && ks % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = (lanes + per_block - 1) / per_block;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t chunk = (size_t)ks * (d + 1);
  const size_t smem =
      sizeof(float) * (chunk + (size_t)CC_TILE * xs +
                       (chunk >= 2 * CC_TILE ? 0 : 2 * CC_TILE));
  if (smem > CC_MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = vec ? (const void*)assign_kernel<true>
                           : (const void*)assign_kernel<false>;
  cudaError_t err = cc_reserve_smem(
      kernel, smem, vec ? g_assign_reserved_vec : g_assign_reserved_scalar);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + CC_TILE - 1) / CC_TILE, groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    assign_kernel<true><<<grid, CC_ASSIGN_THREADS, smem, s>>>(
        x, lane_src, cen, lanes, per_block, n, d, k_max, k, xs, ks, cg,
        labels, dmin);
  } else {
    assign_kernel<false><<<grid, CC_ASSIGN_THREADS, smem, s>>>(
        x, lane_src, cen, lanes, per_block, n, d, k_max, k, xs, ks, cg,
        labels, dmin);
  }
  return static_cast<int>(cudaGetLastError());
}

// x_cols (n_cols, d), cen (n_lanes, k_max, d), cop (n_words, n_cols) int32;
// planes (k_max, n_words, n_cols) int32, every word written.  lane_group
// lanes' centroids are staged at a time in the layout (xs, ks, vec) of
// ops/fused_block.fused_layout, which sizes them to fit.
CC_EXPORT int cc_fused_assign_pack(const float* x_cols, const float* cen,
                                   int n_lanes, int n_cols, int d, int k_max,
                                   int k, int xs, int ks, int vec,
                                   const int* cop, int row0, int n_words,
                                   int lane_group, int* planes,
                                   void* stream) {
  if (n_lanes < 0 || n_cols < 1 || d < 1 || k_max < 1 || k < 1 ||
      k > k_max || xs < d || ks < k_max || (vec && ks % 4 != 0) ||
      row0 < 0 || n_words < 1 || n_words > 65535 || lane_group < 1 ||
      lane_group > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      sizeof(float) * ((size_t)lane_group * ks * (d + 1) +
                       (size_t)CC_TILE * xs) +
      sizeof(int) * (size_t)k_max * CC_TILE;
  if (smem > CC_MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = vec ? (const void*)fused_planes_kernel<true>
                           : (const void*)fused_planes_kernel<false>;
  cudaError_t err = cc_reserve_smem(
      kernel, smem, vec ? g_fused_reserved_vec : g_fused_reserved_scalar);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_cols + CC_TILE - 1) / CC_TILE, n_words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    fused_planes_kernel<true><<<grid, CC_TILE, smem, s>>>(
        x_cols, cen, n_lanes, n_cols, d, k_max, k, xs, ks, cop, row0,
        n_words, lane_group, planes);
  } else {
    fused_planes_kernel<false><<<grid, CC_TILE, smem, s>>>(
        x_cols, cen, n_lanes, n_cols, d, k_max, k, xs, ks, cop, row0,
        n_words, lane_group, planes);
  }
  return static_cast<int>(cudaGetLastError());
}
