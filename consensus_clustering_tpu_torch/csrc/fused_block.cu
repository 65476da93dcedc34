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
// fused_planes_kernel.  The first design (one block per (128-column tile,
// plane word), one thread per column walking its word's lanes in series)
// ran at 7% of the bound: at the stream's block, 160 blocks of 4 warps on
// 132 SMs; blocks of a full word walked 32 lanes while those of the last
// word walked 4; and a thread whose column a lane had not sampled idled
// while its warp computed.  This design:
//  - Lanes, not words, spread over the grid: each word's lanes are cut
//    into `splits` near-equal splits, one block per (tile, word, split).
//    The wrapper sizes them to fill 2 blocks an SM: at the stream's block
//    2 splits of 16 lanes, staged at once, measured fastest (more,
//    shorter blocks stage the x tile and a lane's centroids more often).
//  - Sampled pairs only: per stage of lanes, the warps of a 32-column group
//    list its sampled (lane, column) pairs from one ballot a lane and take
//    them 32 at a time, lane-major, so a round's pairs mostly share a lane
//    (its centroids are broadcasts) and no thread waits on an unsampled
//    pair.  A pair's label comes from cc_nearest_slots over all k slots.
//  - The x tile is staged once per block and shared by its lanes; the
//    lanes' centroids `stage` at a time in the routine's (d, ks) layout,
//    with their norms.  The layout is the first design's, so every
//    (d, k_max) it took still runs.
//  - Bits are ORed in a (k_max, 128) shared tile and each output word is
//    written once, zeros included; with more than one split a second
//    kernel ORs a word's splits.  The bits of a word's splits are disjoint,
//    so any order of the ORs gives the same word.
// Measured on the way (PERF.md, Findings): ORing each bit straight
// into zeroed planes with a global atomicOr cost a third of the kernel's
// time; two threads a column (the halves of the slots, merged by a
// shuffle) were slower than one.  Labels come from cc_nearest_slots,
// unchanged, so fused == unfused holds by construction.  Lanes whose bit
// lies past the planes' words own no bits.  ptxas (sm_90a): 64 registers
// a thread (63 scalar), so at most 4 blocks of 256 threads an SM; at the
// stream's block shared memory (101 KB with 16 lanes staged) allows 2.
// The merge kernel takes 32.
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

#define CC_FUSED_THREADS (2 * CC_TILE)

// Block (tile, word w, split s) of the fused kernel: the lanes of word w
// that fall in split s of `splits` near-equal splits, `stage` at a time.
// Warps g and g + 4 share the tile's columns 32 g .. 32 g + 31.  Per
// stage they list those columns' sampled (lane, column) pairs, lane-major,
// from one ballot a lane (thread l of the warp keeps lane l's), and take
// the list's rounds of 32 in turn: no thread waits on an unsampled pair,
// and a round's pairs mostly share a lane, whose centroids are then
// broadcasts.  Bits meet in a (k_max, TILE) shared tile (atomicOr: two
// lanes may set bits of one word), which the block writes to
// out[j][w * splits + s][col], zeros included (an empty split too).
template <bool VEC>
__global__ void __launch_bounds__(CC_FUSED_THREADS)
    fused_planes_kernel(const float* __restrict__ x_cols,
                        const float* __restrict__ cen, int n_lanes,
                        int n_cols, int d, int k_max, int k, int xs, int ks,
                        const int* __restrict__ cop, int row0, int splits,
                        int stage, int* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const size_t lane_words = (size_t)ks * (d + 1);  // (d, ks) + (ks,) norms
  float* cg = smem;                                 // (stage, lane_words)
  int* acc = reinterpret_cast<int*>(cg + stage * lane_words);  // (k_max, TILE)
  float* xt = reinterpret_cast<float*>(acc + k_max * CC_TILE);  // (TILE, xs)

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int group = (t >> 5) & 3;  // columns 32 group .. 32 group + 31
  const int turn = t >> 7;         // which of the group's two warps
  const int col0 = blockIdx.x * CC_TILE;
  const int cols = min(CC_TILE, n_cols - col0);
  const int w = blockIdx.y / splits;
  const int s = blockIdx.y - w * splits;
  // The lanes whose bit row0 + l lies in word w, then split s of them.
  const int w_lo = max(0, w * 32 - row0);
  const int w_hi = min(n_lanes, (w + 1) * 32 - row0);
  const int w_n = max(0, w_hi - w_lo);
  const int l_lo = w_lo + s * w_n / splits;
  const int l_hi = w_lo + (s + 1) * w_n / splits;
  for (int i = t; i < k_max * CC_TILE; i += blockDim.x) acc[i] = 0;
  // This thread's column for the ballots and the row norm.
  const int my_col = group * 32 + lane;
  const bool my_live = my_col < cols && l_lo < l_hi;
  const unsigned bits =
      my_live ? (unsigned)cop[(size_t)w * n_cols + col0 + my_col] : 0u;
  if (l_lo < l_hi) {
    cc_stage_rows<8>(x_cols + (size_t)col0 * d, cols, d, xs, xt);
  }
  float my_xsq = 0.0f;

  for (int g0 = l_lo; g0 < l_hi; g0 += stage) {
    const int g_n = min(stage, l_hi - g0);
    if (g0 > l_lo) __syncthreads();  // every thread is done with the last
    cc_stage_centroids<8>(cen + (size_t)g0 * k_max * d, (size_t)k_max * d,
                          g_n, lane_words, 0, k, d, ks, cg);
    __syncthreads();
    for (int p = t; p < g_n * k; p += blockDim.x) {
      const int l = p / k;
      const int j = p - l * k;
      float* ct = cg + l * lane_words;
      ct[(size_t)ks * d + j] = cc_staged_norm(ct, j, d, ks);
    }
    if (g0 == l_lo && my_live) my_xsq = cc_sq_norm(xt + my_col * xs, d);
    // Thread l keeps lane g0 + l's sampled columns of the group, and the
    // inclusive count of pairs up to that lane.
    unsigned my_mask = 0u;
    for (int l = 0; l < g_n; ++l) {
      const unsigned m = __ballot_sync(
          0xffffffffu, (bits >> ((row0 + g0 + l) & 31)) & 1u);
      if (lane == l) my_mask = m;
    }
    int upto = __popc(my_mask);
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, upto, o);
      if (lane >= o) upto += v;
    }
    const int total = __shfl_sync(0xffffffffu, upto, 31);
    __syncthreads();  // the norms are staged
    for (int r = turn; r * 32 < total; r += 2) {
      const int p = r * 32 + lane;
      int l = 0;  // the lane of pair p: lanes whose count ends at or before p
      for (int i = 0; i < g_n; ++i) {
        l += __shfl_sync(0xffffffffu, upto, i) <= p;
      }
      // Every thread takes part in each shuffle (the mask names them all).
      const int prev = __shfl_sync(0xffffffffu, upto, max(l - 1, 0));
      const int before = l > 0 ? prev : 0;
      const unsigned m = __shfl_sync(0xffffffffu, my_mask, min(l, 31));
      const bool active = p < total;
      const int c = active ? (int)__fns(m, 0, p - before + 1) : 0;
      const float xq = __shfl_sync(0xffffffffu, my_xsq, c);
      if (active) {
        const int col = group * 32 + c;
        const float* ct = cg + l * lane_words;
        float bv = INFINITY;
        int bj = 0;
        cc_nearest_slots<VEC>(xt + col * xs, xq, ct, ct + (size_t)ks * d, ks,
                              d, 0, k, 0, bv, bj);
        atomicOr(acc + bj * CC_TILE + col,
                 (int)(1u << ((row0 + g0 + l) & 31)));
      }
    }
  }
  __syncthreads();
  const int rows = gridDim.y;  // words x splits
  for (int i = t; i < k_max * CC_TILE; i += blockDim.x) {
    const int j = i / CC_TILE;
    const int c = i - j * CC_TILE;
    if (c < cols) {
      out[((size_t)j * rows + blockIdx.y) * n_cols + col0 + c] = acc[i];
    }
  }
}

// planes[j][w][c] = OR over s of parts[j][w * splits + s][c]: the bits of
// a word's splits are disjoint, so the OR of any order is the same word.
__global__ void fused_merge_kernel(const int* __restrict__ parts,
                                   long long words, int splits, int n_cols,
                                   int* __restrict__ planes) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= words * n_cols) return;
  const long long jw = i / n_cols;  // j * n_words + w
  const int c = (int)(i - jw * n_cols);
  const int* src = parts + (jw * splits) * n_cols + c;
  int v = 0;
  for (int s = 0; s < splits; ++s) v |= src[(size_t)s * n_cols];
  planes[i] = v;
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
// planes (k_max, n_words, n_cols) int32, every word written.  Each word's
// lanes are cut into `splits` near-equal splits, one block per (128-column
// tile, word, split); `stage` lanes' centroids are staged at a time in the
// layout (xs, ks, vec) of ops/fused_block.fused_layout, which sizes them to
// fit.  With splits > 1 the blocks write `parts` (k_max, n_words * splits,
// n_cols) and a second kernel ORs each word's splits into planes.
CC_EXPORT int cc_fused_assign_pack(const float* x_cols, const float* cen,
                                   int n_lanes, int n_cols, int d, int k_max,
                                   int k, int xs, int ks, int vec,
                                   const int* cop, int row0, int n_words,
                                   int splits, int stage, int* parts,
                                   int* planes, void* stream) {
  if (n_lanes < 0 || n_cols < 1 || d < 1 || k_max < 1 || k < 1 ||
      k > k_max || xs < d || ks < k_max || (vec && ks % 4 != 0) ||
      row0 < 0 || n_words < 1 || splits < 1 || splits > 32 || stage < 1 ||
      stage > 32 || (long long)n_words * splits > 65535 ||
      (splits > 1 && parts == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      sizeof(float) * ((size_t)stage * ks * (d + 1) + (size_t)CC_TILE * xs) +
      sizeof(int) * (size_t)k_max * CC_TILE;
  if (smem > CC_MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = vec ? (const void*)fused_planes_kernel<true>
                           : (const void*)fused_planes_kernel<false>;
  cudaError_t err = cc_reserve_smem(
      kernel, smem, vec ? g_fused_reserved_vec : g_fused_reserved_scalar);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_cols + CC_TILE - 1) / CC_TILE, n_words * splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* out = splits > 1 ? parts : planes;
  if (vec) {
    fused_planes_kernel<true><<<grid, CC_FUSED_THREADS, smem, s>>>(
        x_cols, cen, n_lanes, n_cols, d, k_max, k, xs, ks, cop, row0, splits,
        stage, out);
  } else {
    fused_planes_kernel<false><<<grid, CC_FUSED_THREADS, smem, s>>>(
        x_cols, cen, n_lanes, n_cols, d, k_max, k, xs, ks, cop, row0, splits,
        stage, out);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long words = (long long)k_max * n_words;
  const long long total = words * n_cols;
  fused_merge_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      parts, words, splits, n_cols, planes);
  return static_cast<int>(cudaGetLastError());
}
