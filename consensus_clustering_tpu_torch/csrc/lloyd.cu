// One fused Lloyd step (assign + accumulate) over a batch of KMeans lanes.
//
// Replaces the Pallas TPU kernel `_lloyd_kernel` of the reference package
// (consensus_clustering_tpu/ops/pallas_lloyd.py), launched by
// `_lloyd_step_padded` and wrapped by `lloyd_step`.
//
// What it computes, per lane l (one KMeans restart on one resample):
//   dist[i, j] = max(|x_i|^2 - 2 x_i.c_j + |c_j|^2, 0) for slots j < k,
//                +inf for slots j >= k;
//   label[i]   = argmin_j dist[i, j], the lowest slot on ties;
//   sums[j]    = sum of x_i with label j, counts[j] = their number;
//   far[b]     = for bucket b (rows i with i mod k_max == b), the lowest row
//                of the largest min-distance, clamped to [0, n - 1] (n - 1
//                for a bucket without rows) — the empty-cluster relocation
//                candidates of models/kmeans.py.
// x is (B, n, d); lane l reads resample lane_src[l], so the n_init restarts
// of one resample share its rows instead of copies of them.
//
// What bounds it on the H100: arithmetic.  A row costs 2 * d * k FLOPs of
// distances for 4 * d bytes, about 10 FLOP per byte at d = 50, k = 20, and
// the rows of one resample are read by each of its n_init lanes.  The
// design keeps everything a row tile needs in shared memory: the lane's
// centroids and their norms, the tile of x (read from device memory once,
// coalesced), and the tile's labels and min-distances.  One thread assigns
// one row through the nearest-centroid routine of common.cuh (the
// reference's term order, d summed in a fixed order, a strict '<' scan over
// ascending slots), which the final assignment and fused_block.cu call too.
//
// Deterministic reduction: float atomics on the sums would make a run's
// result depend on block order, and with it the labels of the next Lloyd
// step near ties.  So each (lane, row tile) block writes its partial sums,
// counts and per-bucket (max, lowest row) pairs to scratch the wrapper
// allocated, each summed in row order inside the tile; a second kernel
// reduces the tiles of each lane in tile order.  Same inputs, same bits.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

#define CC_LLOYD_TILE 128
#define CC_LLOYD_REDUCE_THREADS 256
#define CC_LLOYD_MAX_SMEM 232448

static size_t lloyd_smem_bytes(int d, int k_max) {
  // centroids, centroid norms, x tile, min-distances, labels
  return sizeof(float) * ((size_t)k_max * d + k_max +
                          (size_t)CC_LLOYD_TILE * d + CC_LLOYD_TILE) +
         sizeof(int) * CC_LLOYD_TILE;
}

__global__ void lloyd_tile_kernel(const float* __restrict__ x,
                                  const int* __restrict__ lane_src,
                                  const float* __restrict__ cen, int n, int d,
                                  int k_max, int k, int n_tiles,
                                  float* __restrict__ part_sums,
                                  float* __restrict__ part_fval,
                                  int* __restrict__ part_fidx) {
  extern __shared__ float smem[];
  float* c = smem;                      // (k_max, d)
  float* csq = c + k_max * d;           // (k_max,)
  float* xs = csq + k_max;              // (TILE, d)
  float* dmin = xs + CC_LLOYD_TILE * d;  // (TILE,)
  int* lab = reinterpret_cast<int*>(dmin + CC_LLOYD_TILE);  // (TILE,)

  const int t = blockIdx.x;
  const int lane = blockIdx.y;
  const int row0 = t * CC_LLOYD_TILE;
  const int rows = min(CC_LLOYD_TILE, n - row0);
  const float* xl = x + ((size_t)lane_src[lane] * n + row0) * d;
  const float* cl = cen + (size_t)lane * k_max * d;

  for (int i = threadIdx.x; i < k_max * d; i += blockDim.x) c[i] = cl[i];
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) xs[i] = xl[i];
  __syncthreads();
  for (int j = threadIdx.x; j < k_max; j += blockDim.x) {
    csq[j] = cc_sq_norm(c + j * d, d);
  }
  __syncthreads();

  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const float* xr = xs + r * d;
    float best;
    lab[r] = cc_nearest(xr, cc_sq_norm(xr, d), c, csq, d, k, &best);
    dmin[r] = best;
  }
  __syncthreads();

  // Partial sums of this tile, rows in order; column d holds the counts.
  const int w = d + 1;
  float* ps = part_sums + ((size_t)lane * n_tiles + t) * k_max * w;
  for (int p = threadIdx.x; p < k_max * w; p += blockDim.x) {
    const int j = p / w;
    const int f = p - j * w;
    float acc = 0.0f;
    if (f < d) {
      for (int r = 0; r < rows; ++r) {
        if (lab[r] == j) acc += xs[r * d + f];
      }
    } else {
      for (int r = 0; r < rows; ++r) {
        if (lab[r] == j) acc += 1.0f;
      }
    }
    ps[p] = acc;
  }

  // Per bucket: largest min-distance of the tile, lowest row on ties.
  const size_t fbase = ((size_t)lane * n_tiles + t) * k_max;
  for (int b = threadIdx.x; b < k_max; b += blockDim.x) {
    float bv = -INFINITY;
    int bi = -1;
    for (int r = ((b - row0 % k_max) % k_max + k_max) % k_max; r < rows;
         r += k_max) {
      if (dmin[r] > bv) {
        bv = dmin[r];
        bi = row0 + r;
      }
    }
    part_fval[fbase + b] = bv;
    part_fidx[fbase + b] = bi;
  }
}

__global__ void lloyd_reduce_kernel(const float* __restrict__ part_sums,
                                    const float* __restrict__ part_fval,
                                    const int* __restrict__ part_fidx, int n,
                                    int d, int k_max, int n_tiles,
                                    float* __restrict__ sums,
                                    float* __restrict__ counts,
                                    int* __restrict__ far_idx) {
  const int lane = blockIdx.x;
  const int w = d + 1;
  const float* ps = part_sums + (size_t)lane * n_tiles * k_max * w;
  for (int p = threadIdx.x; p < k_max * w; p += blockDim.x) {
    float acc = 0.0f;
    for (int t = 0; t < n_tiles; ++t) acc += ps[(size_t)t * k_max * w + p];
    const int j = p / w;
    const int f = p - j * w;
    if (f < d) {
      sums[((size_t)lane * k_max + j) * d + f] = acc;
    } else {
      counts[(size_t)lane * k_max + j] = acc;
    }
  }
  const size_t fbase = (size_t)lane * n_tiles * k_max;
  for (int b = threadIdx.x; b < k_max; b += blockDim.x) {
    float bv = -INFINITY;
    int bi = n - 1;
    for (int t = 0; t < n_tiles; ++t) {
      const float v = part_fval[fbase + (size_t)t * k_max + b];
      if (v > bv) {  // strict: an earlier tile (lower rows) wins ties
        bv = v;
        bi = part_fidx[fbase + (size_t)t * k_max + b];
      }
    }
    far_idx[(size_t)lane * k_max + b] = min(max(bi, 0), n - 1);
  }
}

// Scratch: part_sums (lanes, n_tiles, k_max, d + 1), part_fval and part_fidx
// (lanes, n_tiles, k_max), n_tiles = ceil(n / 128).  Outputs: sums
// (lanes, k_max, d), counts (lanes, k_max), far_idx (lanes, k_max).
CC_EXPORT int cc_lloyd_step(const float* x, const int* lane_src,
                            const float* cen, int lanes, int n, int d,
                            int k_max, int k, float* part_sums,
                            float* part_fval, int* part_fidx, float* sums,
                            float* counts, int* far_idx, void* stream) {
  if (lanes < 1 || lanes > 65535 || n < 1 || d < 1 || k_max < 1 || k < 1 ||
      k > k_max) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = lloyd_smem_bytes(d, k_max);
  if (smem > CC_LLOYD_MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      lloyd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n + CC_LLOYD_TILE - 1) / CC_LLOYD_TILE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  lloyd_tile_kernel<<<dim3(n_tiles, lanes), CC_LLOYD_TILE, smem, s>>>(
      x, lane_src, cen, n, d, k_max, k, n_tiles, part_sums, part_fval,
      part_fidx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lloyd_reduce_kernel<<<lanes, CC_LLOYD_REDUCE_THREADS, 0, s>>>(
      part_sums, part_fval, part_fidx, n, d, k_max, n_tiles, sums, counts,
      far_idx);
  return static_cast<int>(cudaGetLastError());
}
