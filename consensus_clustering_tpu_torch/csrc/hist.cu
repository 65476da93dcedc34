// Consensus-CDF histogram of the strict upper triangle of a Cij row block.
//
// Replaces the Pallas TPU kernel `_hist_kernel` of the reference package
// (consensus_clustering_tpu/ops/pallas_hist.py), launched by `_pallas_hist`
// and dispatched by `consensus_hist_counts`.
//
// What it computes: (bins,) int32 counts of v = cij[r, c] over the elements
// with global row g = row_offset + r, c > g, g < n_valid and c < n_valid,
// binned against the f32 edges the caller passes in (edges[b] <= v <
// edges[b + 1], the last bin right-closed, as np.histogram).  NaN and values
// outside [edges[0], edges[bins]] are never counted.
//
// What bounds it on the H100: device-memory bytes.  Each counted element is
// one 4-byte load and a handful of compares, so the card's 3.35 TB/s limits
// it long before its arithmetic does.  The design reads each element of the
// strict upper triangle once and nothing else: a block walks whole rows
// starting at the first column past the diagonal, neighbouring threads on
// neighbouring columns (coalesced loads).  Counts go to per-block bins in
// shared memory, then one integer atomicAdd per bin per block into `out`;
// integer atomics make the result independent of the block order.  The bin
// of a value is found by binary search over the edges held in shared memory,
// which is the edge-membership test exactly because the edges increase
// strictly.
#include <stdint.h>

#include "common.cuh"

#define CC_HIST_MAX_BINS 128
#define CC_HIST_THREADS 256

__global__ void hist_kernel(const float* __restrict__ cij, long long rows,
                            long long cols, long long row_offset,
                            long long n_valid, const float* __restrict__ edges,
                            int bins, int* __restrict__ out) {
  __shared__ float e[CC_HIST_MAX_BINS + 1];
  __shared__ int counts[CC_HIST_MAX_BINS];
  for (int i = threadIdx.x; i <= bins; i += blockDim.x) e[i] = edges[i];
  for (int i = threadIdx.x; i < bins; i += blockDim.x) counts[i] = 0;
  __syncthreads();

  const float lo = e[0];
  const float hi = e[bins];
  const long long col_end = cols < n_valid ? cols : n_valid;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long g = row_offset + r;
    if (g >= n_valid) break;  // rows are in increasing global order
    const float* row = cij + r * cols;
    long long c = (g + 1 > 0 ? g + 1 : 0) +
                  (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (; c < col_end; c += stride) {
      const float v = row[c];
      if (!(v >= lo && v <= hi)) continue;  // also drops NaN
      int b = bins - 1;
      if (v < hi) {
        int a = 0, z = bins;  // invariant: e[a] <= v < e[z]
        while (z - a > 1) {
          const int m = (a + z) >> 1;
          if (e[m] <= v) a = m; else z = m;
        }
        b = a;
      }
      atomicAdd(&counts[b], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bins; i += blockDim.x) {
    if (counts[i]) atomicAdd(&out[i], counts[i]);
  }
}

// out must hold `bins` zeroed int32; edges holds bins + 1 floats.
CC_EXPORT int cc_hist_counts(const float* cij, long long rows, long long cols,
                             long long row_offset, long long n_valid,
                             const float* edges, int bins, int* out,
                             void* stream) {
  if (bins < 1 || bins > CC_HIST_MAX_BINS || rows < 0 || cols < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || cols == 0) return 0;
  const long long per_row = (cols + CC_HIST_THREADS * 4 - 1) /
                            (CC_HIST_THREADS * 4);
  dim3 grid(static_cast<unsigned>(per_row),
            static_cast<unsigned>(rows < 2048 ? rows : 2048));
  hist_kernel<<<grid, CC_HIST_THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      cij, rows, cols, row_offset, n_valid, edges, bins, out);
  return static_cast<int>(cudaGetLastError());
}
