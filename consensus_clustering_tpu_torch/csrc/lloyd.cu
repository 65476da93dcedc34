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
// The bits are fixed (ops/lloyd.lloyd_step_ordered_plain repeats them op by
// op): distances by the routine of common.cuh; a slot's partial sum over a
// 128-row tile taken in ascending row order from 0.0f; a lane's tiles summed
// in ascending tile order from 0.0f; far points by a strict '>' over rows,
// then over tiles, in ascending order.  Float atomics would make the sums
// depend on block order, and with them the next step's labels near ties.
//
// What bounds it on the H100.  The distances are arithmetic: 2 * d * k
// FLOPs a row for 4 * d bytes, issued as separate multiplies and adds, so
// their floor is twice the FMA-rate bound.  What the kernel waits on is its
// tail after them, partial sums and the reduction, which are latency: each
// is a chain of dependent adds in a fixed order.  The design:
//   1. lloyd_step_kernel, one block of 256 threads per (128-row tile, group
//      of per_block consecutive lanes), the lanes in turn: the tile's rows
//      staged in shared memory at an odd stride once for the lanes of a
//      resample, the lane's centroids transposed, (d, ks), in chunks of cg
//      slots where they do not all fit;
//   2. two threads per row, each over half of the slots, in register groups
//      of 8 (common.cuh: cc_tile_nearest), merged in shared memory;
//   3. partial sums in O(rows * (d + 1)): a ballot per slot gives the
//      slot's rows as a mask, then a warp per slot, each thread owning two
//      columns (column d: the counts), walks the mask's rows in ascending
//      order — one pass over the rows where there was one per (slot,
//      column) — while the other half of the block takes the tile's far
//      points;
//   4. lloyd_reduce_kernel, a second launch: a thread per output of a lane
//      sums its tiles in tile order, 16 tiles' loads in flight at a time.
//      A reduction in each lane's last block (an atomic tile count) made
//      one launch but put the last lane's reduction, one block's worth of
//      L2 latency, in series after everything else: measured slower at the
//      headline (PERF.md, Findings).
// Occupancy at the headline (48 lanes x 4000 x 50, k_max 20): the tile
// kernel takes 48 registers a thread (ptxas, sm_90a) and 31 KB of shared
// memory a block, so 5 blocks of 8 warps fit an SM; 3 lanes a block make
// 512 blocks, one wave of ~4 per SM.  The reduce kernel takes 32.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

#define CC_LLOYD_THREADS (2 * CC_TILE)
#define CC_REDUCE_THREADS 256
// Tiles whose partial sums a reduce thread loads before it adds any.
#define CC_REDUCE_LOADS 16

// One lane's share of a block: its tile's labels, far candidates and
// partial sums.
template <bool VEC>
__device__ __forceinline__ void lloyd_lane_tile(
    int lane, int t, int n, int d, int k_max, int k, int xs, int ks, int cg,
    int n_tiles, const float* __restrict__ cen, float* ct, float* csq,
    const float* xt, float* dmin, unsigned* masks, bool new_rows, float& xsq,
    float* __restrict__ part_sums, float* __restrict__ part_fval,
    int* __restrict__ part_fidx) {
  const int row0 = t * CC_TILE;
  const int rows = min(CC_TILE, n - row0);
  const float* cl = cen + (size_t)lane * k_max * d;
  float best;
  // The halves meet in dmin and masks, both unused until after the merge.
  const int bj = cc_tile_nearest<VEC>(cl, d, k, xs, ks, cg, rows, ct, csq,
                                      xt, dmin,
                                      reinterpret_cast<int*>(masks),
                                      new_rows, xsq, &best);
  const int r = threadIdx.x;  // threads < TILE hold row r's slot
  const bool live = r < rows;
  __syncthreads();  // every half has been read from dmin and masks
  if (live) dmin[r] = best;
  __syncthreads();

  // Per bucket: largest min-distance of the tile, lowest row on ties.  The
  // upper half of the block does it while the lower half takes the ballots
  // below.
  const size_t fbase = ((size_t)lane * n_tiles + t) * k_max;
  for (int b = (int)threadIdx.x - CC_TILE; b >= 0 && b < k_max;
       b += CC_TILE) {
    float bv = -INFINITY;
    int bi = -1;
    for (int q = ((b - row0 % k_max) % k_max + k_max) % k_max; q < rows;
         q += k_max) {
      if (dmin[q] > bv) {
        bv = dmin[q];
        bi = row0 + q;
      }
    }
    part_fval[fbase + b] = bv;
    part_fidx[fbase + b] = bi;
  }

  // Partial sums of this tile, 32 slots at a time.  Warps 0-3 hold rows
  // 0-127 in order, so a ballot per slot gives the slot's rows as a
  // 128-bit mask; then one warp per slot, lane f owning columns f and
  // f + 32 (f = d: the counts), walks the mask's bits in ascending order
  // once for both.  Every row is read once per column: O(rows * (d + 1))
  // adds, in the rows' order.
  const int w = d + 1;
  const int warp = threadIdx.x >> 5;
  const int wl = threadIdx.x & 31;
  float* ps_out = part_sums + ((size_t)lane * n_tiles + t) * k_max * w;
  for (int j0 = 0; j0 < k_max; j0 += 32) {
    const int cn = min(32, k_max - j0);
    if (warp < CC_TILE / 32) {
      for (int j = 0; j < cn; ++j) {
        const unsigned m = __ballot_sync(0xffffffffu, live && bj == j0 + j);
        if (wl == 0) masks[j * (CC_TILE / 32) + warp] = m;
      }
    }
    __syncthreads();
    for (int j = warp; j < cn; j += CC_LLOYD_THREADS / 32) {
      const unsigned* mj = masks + j * (CC_TILE / 32);
      float* out = ps_out + (size_t)(j0 + j) * w;
      for (int f = wl; f < w; f += 64) {
        const int f2 = f + 32;
        float acc = 0.0f, acc2 = 0.0f;
        for (int q = 0; q < CC_TILE / 32; ++q) {
          for (unsigned m = mj[q]; m != 0u; m &= m - 1u) {
            const float* xr = xt + (q * 32 + __ffs(m) - 1) * xs;
            acc = __fadd_rn(acc, f < d ? xr[f] : 1.0f);
            acc2 = __fadd_rn(acc2, f2 < d ? xr[f2] : 1.0f);
          }
        }
        out[f] = acc;
        if (f2 < w) out[f2] = acc2;
      }
    }
    __syncthreads();
  }
}

// Block (tile t, lanes [y * per_block, (y + 1) * per_block)): the lanes in
// turn, in ascending order; the rows are staged again only where a lane's
// resample differs from the last lane's, so the n_init lanes of a resample
// share one copy of its tile and of its row norms.
template <bool VEC>
__global__ void __launch_bounds__(CC_LLOYD_THREADS)
    lloyd_step_kernel(const float* __restrict__ x,
                      const int* __restrict__ lane_src,
                      const float* __restrict__ cen, int lanes,
                      int per_block, int n, int d, int k_max, int k, int xs,
                      int ks, int cg, int n_tiles,
                      float* __restrict__ part_sums,
                      float* __restrict__ part_fval,
                      int* __restrict__ part_fidx) {
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;                      // (d, ks) a chunk of centroids
  float* csq = ct + (size_t)ks * d;      // (ks,)
  float* xt = csq + ks;                  // (TILE, xs)
  float* dmin = xt + CC_TILE * xs;       // (TILE,)
  unsigned* masks = reinterpret_cast<unsigned*>(dmin + CC_TILE);
                                         // (32 slots, TILE / 32 words)
  const int t = blockIdx.x;
  const int row0 = t * CC_TILE;
  const int rows = min(CC_TILE, n - row0);
  const int lane0 = blockIdx.y * per_block;
  const int lane_end = min(lanes, lane0 + per_block);
  float xsq = 0.0f;
  int staged = -1;
  for (int lane = lane0; lane < lane_end; ++lane) {
    const int src = lane_src[lane];
    if (lane > lane0) __syncthreads();  // every thread is done with the last
    if (src != staged) {
      cc_stage_rows<4>(x + ((size_t)src * n + row0) * d, rows, d, xs, xt);
    }
    lloyd_lane_tile<VEC>(lane, t, n, d, k_max, k, xs, ks, cg, n_tiles, cen,
                         ct, csq, xt, dmin, masks, src != staged, xsq,
                         part_sums, part_fval, part_fidx);
    staged = src;
  }
}

// Block (x, lane): outputs [x * 256, (x + 1) * 256) of the lane's k_max *
// (d + 1) sums and counts, one a thread, each summed over the lane's tiles
// in ascending order; block x = 0 also takes the lane's far points.
__global__ void __launch_bounds__(CC_REDUCE_THREADS)
    lloyd_reduce_kernel(const float* __restrict__ part_sums,
                        const float* __restrict__ part_fval,
                        const int* __restrict__ part_fidx, int n, int d,
                        int k_max, int n_tiles, float* __restrict__ sums,
                        float* __restrict__ counts,
                        int64_t* __restrict__ far_idx) {
  const int lane = blockIdx.y;
  const int w = d + 1;
  const int kw = k_max * w;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < kw) {
    const float* src = part_sums + (size_t)lane * n_tiles * kw + p;
    float acc = 0.0f;
    for (int t0 = 0; t0 < n_tiles; t0 += CC_REDUCE_LOADS) {
      float v[CC_REDUCE_LOADS];
#pragma unroll
      for (int u = 0; u < CC_REDUCE_LOADS; ++u) {
        v[u] = t0 + u < n_tiles ? src[(size_t)(t0 + u) * kw] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < CC_REDUCE_LOADS; ++u) {
        if (t0 + u < n_tiles) acc = __fadd_rn(acc, v[u]);
      }
    }
    const int j = p / w;
    const int f = p - j * w;
    if (f < d) {
      sums[((size_t)lane * k_max + j) * d + f] = acc;
    } else {
      counts[(size_t)lane * k_max + j] = acc;
    }
  }
  if (blockIdx.x != 0) return;
  const size_t fbase = (size_t)lane * n_tiles * k_max;
  for (int b = threadIdx.x; b < k_max; b += blockDim.x) {
    float bv = -INFINITY;
    int bi = n - 1;
    // Both loads unconditional: no load waits on a comparison.
#pragma unroll 8
    for (int t = 0; t < n_tiles; ++t) {
      const float v = part_fval[fbase + (size_t)t * k_max + b];
      const int i = part_fidx[fbase + (size_t)t * k_max + b];
      if (v > bv) {  // strict: an earlier tile (lower rows) wins ties
        bv = v;
        bi = i;
      }
    }
    far_idx[(size_t)lane * k_max + b] = min(max(bi, 0), n - 1);
  }
}

static int g_reserved_vec[CC_MAX_DEVICES];
static int g_reserved_scalar[CC_MAX_DEVICES];

// The shared-memory layout (xs, ks, cg, vec) comes from the wrapper
// (ops/fused_block.tile_layout), and so does per_block
// (ops/fused_block.lanes_per_block).  Scratch: part_sums (lanes, n_tiles,
// k_max, d + 1), part_fval and part_fidx (lanes, n_tiles, k_max), n_tiles
// = ceil(n / 128).  Outputs: sums (lanes, k_max, d), counts (lanes,
// k_max), far_idx (lanes, k_max) int64.
CC_EXPORT int cc_lloyd_step(const float* x, const int* lane_src,
                            const float* cen, int lanes, int per_block,
                            int n, int d, int k_max, int k, int xs, int ks,
                            int cg, int vec, float* part_sums,
                            float* part_fval, int* part_fidx, float* sums,
                            float* counts, int64_t* far_idx, void* stream) {
  if (lanes < 1 || lanes > 65535 || per_block < 1 || n < 1 || d < 1 ||
      k_max < 1 || k < 1 || k > k_max || xs < d || cg < 1 || cg > k_max ||
      ks < cg || (vec && ks % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      sizeof(float) * ((size_t)ks * (d + 1) + (size_t)CC_TILE * xs +
                       2 * CC_TILE);
  if (smem > CC_MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = vec ? (const void*)lloyd_step_kernel<true>
                           : (const void*)lloyd_step_kernel<false>;
  cudaError_t err = cc_reserve_smem(
      kernel, smem, vec ? g_reserved_vec : g_reserved_scalar);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n + CC_TILE - 1) / CC_TILE;
  const dim3 grid(n_tiles, (lanes + per_block - 1) / per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    lloyd_step_kernel<true><<<grid, CC_LLOYD_THREADS, smem, s>>>(
        x, lane_src, cen, lanes, per_block, n, d, k_max, k, xs, ks, cg,
        n_tiles, part_sums, part_fval, part_fidx);
  } else {
    lloyd_step_kernel<false><<<grid, CC_LLOYD_THREADS, smem, s>>>(
        x, lane_src, cen, lanes, per_block, n, d, k_max, k, xs, ks, cg,
        n_tiles, part_sums, part_fval, part_fidx);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kw = k_max * (d + 1);
  const dim3 reduce_grid((kw + CC_REDUCE_THREADS - 1) / CC_REDUCE_THREADS,
                         lanes);
  lloyd_reduce_kernel<<<reduce_grid, CC_REDUCE_THREADS, 0, s>>>(
      part_sums, part_fval, part_fidx, n, d, k_max, n_tiles, sums, counts,
      far_idx);
  return static_cast<int>(cudaGetLastError());
}
