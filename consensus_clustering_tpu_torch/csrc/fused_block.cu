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
// What bounds it on the H100: operations.  A (lane, column) pair costs
// 2 * d * k FLOPs of distances; the data (x_cols once, the planes once) is
// a few MB.  The design: one block per (128-column tile, plane word); one
// thread owns one column.  The block stages its x tile and the centroids
// of the (at most 32) lanes of its word in shared memory, groups of lanes
// at a time when they do not all fit; per lane a thread tests its
// co-sample bit, and where it is set takes the label from the shared
// routine of common.cuh and ORs the bit into its own word of a (k_max, 128)
// shared tile.  Each thread then writes each of its k_max output words
// once, zeros included: every output word is written exactly once and no
// atomics are needed.  Lanes outside [0, n_lanes) own no bits.
#include <stdint.h>

#include "common.cuh"

#define CC_FUSED_TILE 128
#define CC_FUSED_MAX_SMEM 232448

__global__ void assign_kernel(const float* __restrict__ x,
                              const int* __restrict__ lane_src,
                              const float* __restrict__ cen, int n, int d,
                              int k_max, int k, int* __restrict__ labels,
                              float* __restrict__ dmin) {
  extern __shared__ float smem[];
  float* c = smem;                // (k_max, d)
  float* csq = c + k_max * d;     // (k_max,)
  float* xs = csq + k_max;        // (TILE, d)
  const int lane = blockIdx.y;
  const int row0 = blockIdx.x * CC_FUSED_TILE;
  const int rows = min(CC_FUSED_TILE, n - row0);
  const float* xl = x + ((size_t)lane_src[lane] * n + row0) * d;
  const float* cl = cen + (size_t)lane * k_max * d;
  for (int i = threadIdx.x; i < k_max * d; i += blockDim.x) c[i] = cl[i];
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) xs[i] = xl[i];
  __syncthreads();
  for (int j = threadIdx.x; j < k_max; j += blockDim.x) {
    csq[j] = cc_sq_norm(c + j * d, d);
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < rows) {
    const float* xr = xs + r * d;
    float best;
    const int lab = cc_nearest(xr, cc_sq_norm(xr, d), c, csq, d, k, &best);
    labels[(size_t)lane * n + row0 + r] = lab;
    dmin[(size_t)lane * n + row0 + r] = best;
  }
}

__global__ void fused_planes_kernel(const float* __restrict__ x_cols,
                                    const float* __restrict__ cen,
                                    int n_lanes, int n_cols, int d, int k_max,
                                    int k, const int* __restrict__ cop,
                                    int row0, int n_words, int lane_group,
                                    int* __restrict__ planes) {
  extern __shared__ float smem[];
  float* xs = smem;                                       // (TILE, d)
  int* acc = reinterpret_cast<int*>(xs + CC_FUSED_TILE * d);  // (k_max, TILE)
  float* cg = reinterpret_cast<float*>(acc + k_max * CC_FUSED_TILE);
  float* csq = cg + (size_t)lane_group * k_max * d;      // (group, k_max)

  const int t = threadIdx.x;
  const int col0 = blockIdx.x * CC_FUSED_TILE;
  const int w = blockIdx.y;
  const int cols = min(CC_FUSED_TILE, n_cols - col0);
  const bool live = t < cols;
  for (int i = t; i < cols * d; i += blockDim.x) {
    xs[i] = x_cols[(size_t)col0 * d + i];
  }
  for (int j = 0; j < k_max; ++j) acc[j * CC_FUSED_TILE + t] = 0;
  const unsigned sampled = live ? (unsigned)cop[(size_t)w * n_cols + col0 + t]
                                : 0u;
  // Lanes whose bit row0 + l lies in word w.
  const int l_lo = max(0, w * 32 - row0);
  const int l_hi = min(n_lanes, (w + 1) * 32 - row0);
  __syncthreads();
  const float xsq = live ? cc_sq_norm(xs + t * d, d) : 0.0f;

  for (int g0 = l_lo; g0 < l_hi; g0 += lane_group) {
    const int g_n = min(lane_group, l_hi - g0);
    const float* src = cen + (size_t)g0 * k_max * d;
    for (int i = t; i < g_n * k_max * d; i += blockDim.x) cg[i] = src[i];
    __syncthreads();
    for (int i = t; i < g_n * k_max; i += blockDim.x) {
      csq[i] = cc_sq_norm(cg + (size_t)i * d, d);
    }
    __syncthreads();
    if (live) {
      for (int l = 0; l < g_n; ++l) {
        const int bit = row0 + g0 + l - w * 32;
        if (!((sampled >> bit) & 1u)) continue;
        float best;
        const int lab = cc_nearest(xs + t * d, xsq,
                                   cg + (size_t)l * k_max * d,
                                   csq + l * k_max, d, k, &best);
        acc[lab * CC_FUSED_TILE + t] |= (int)(1u << bit);
      }
    }
    __syncthreads();
  }
  if (live) {
    for (int j = 0; j < k_max; ++j) {
      planes[((size_t)j * n_words + w) * n_cols + col0 + t] =
          acc[j * CC_FUSED_TILE + t];
    }
  }
}

static size_t assign_smem_bytes(int d, int k_max) {
  return sizeof(float) *
         ((size_t)k_max * d + k_max + (size_t)CC_FUSED_TILE * d);
}

static size_t fused_smem_bytes(int d, int k_max, int lane_group) {
  return sizeof(float) * ((size_t)CC_FUSED_TILE * d +
                          (size_t)lane_group * k_max * (d + 1)) +
         sizeof(int) * (size_t)k_max * CC_FUSED_TILE;
}

// x (B, n, d); lane l reads resample lane_src[l]; cen (lanes, k_max, d).
// Outputs labels (lanes, n) int32 and dmin (lanes, n) float.
CC_EXPORT int cc_assign_labels(const float* x, const int* lane_src,
                               const float* cen, int lanes, int n, int d,
                               int k_max, int k, int* labels, float* dmin,
                               void* stream) {
  if (lanes < 1 || lanes > 65535 || n < 1 || d < 1 || k_max < 1 || k < 1 ||
      k > k_max) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = assign_smem_bytes(d, k_max);
  if (smem > CC_FUSED_MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n + CC_FUSED_TILE - 1) / CC_FUSED_TILE;
  assign_kernel<<<dim3(n_tiles, lanes), CC_FUSED_TILE, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      x, lane_src, cen, n, d, k_max, k, labels, dmin);
  return static_cast<int>(cudaGetLastError());
}

// x_cols (n_cols, d), cen (n_lanes, k_max, d), cop (n_words, n_cols) int32;
// planes (k_max, n_words, n_cols) int32, every word written.  lane_group
// lanes' centroids are staged at a time (the wrapper sizes it to fit).
CC_EXPORT int cc_fused_assign_pack(const float* x_cols, const float* cen,
                                   int n_lanes, int n_cols, int d, int k_max,
                                   int k, const int* cop, int row0,
                                   int n_words, int lane_group, int* planes,
                                   void* stream) {
  if (n_lanes < 0 || n_cols < 1 || d < 1 || k_max < 1 || k < 1 ||
      k > k_max || row0 < 0 || n_words < 1 || n_words > 65535 ||
      lane_group < 1 || lane_group > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = fused_smem_bytes(d, k_max, lane_group);
  if (smem > CC_FUSED_MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n_cols + CC_FUSED_TILE - 1) / CC_FUSED_TILE;
  fused_planes_kernel<<<dim3(n_tiles, n_words), CC_FUSED_TILE, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x_cols, cen, n_lanes, n_cols, d, k_max, k, cop, row0, n_words,
      lane_group, planes);
  return static_cast<int>(cudaGetLastError());
}
