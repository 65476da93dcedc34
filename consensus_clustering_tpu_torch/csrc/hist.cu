// Consensus-CDF histogram of the strict upper triangle of a row block, from
// Cij or straight from the int32 counts Mij and Iij.
//
// Replaces the Pallas TPU kernel `_hist_kernel` of the reference package
// (consensus_clustering_tpu/ops/pallas_hist.py), launched by `_pallas_hist`
// and dispatched by `consensus_hist_counts`.  The reference forms Cij with
// `consensus_matrix` first and XLA fuses the two inside `jit`; the port has
// no such fusion, so the second entry takes the counts and forms Cij in
// registers.
//
// What it computes: (bins,) counts of v over the elements with global row
// g = row_offset + r, c > g, g < n_valid and c < n_valid, binned against
// the f32 edges the caller passes in (edges[b] <= v < edges[b + 1], the last
// bin right-closed, as np.histogram).  NaN and values outside
// [edges[0], edges[bins]] are never counted.  v is cij[r, c]
// (`cc_hist_counts`), or m / (i + 1e-6f) from mij[r, c] and iij[r, c]
// (`cc_hist_from_counts`): __int2float_rn, __fadd_rn and __fdiv_rn, each
// correctly rounded, the bits `consensus_matrix` gives.  The diagonal that
// `consensus_matrix` forces to 1.0 is outside the strict triangle.
//
// What bounds it on the H100: device-memory bytes, 4 a pair from Cij and 8
// from the counts, so 3.35 TB/s limits it long before its arithmetic.  The
// first design reached 27% of that bound on a full 5000 x 5000 Cij and 18% on a
// stream tile (256 x 5120): one scalar load and a dependent 5-step binary
// search over the edges per element, and the same 5 blocks for every row, so
// that over the triangle about half of the thread slots counted nothing.
// (Shared atomics to one counter were not what held it: on a bimodal Cij,
// nearly every pair in bin 0 or 19, it timed the same as on a uniform one.)
// This design:
//  - Threads where the work is.  Block row p takes the row pairs p,
//    p + gridDim.y, ..., each pair p and R - 1 - p, whose triangle lengths
//    add up to the same count for every pair of rows inside the triangle
//    (a row's length falls by one a row); gridDim.x blocks split a pair's
//    elements between them in units, neighbouring threads on neighbouring
//    units.  About 16 blocks an SM, each thread taking about 4 units of a
//    pair: ten waves of short blocks (the first design's grid, and an
//    early version of this one) each paid a barrier and a flush again.
//  - 16-byte loads.  Where the rows are 16-byte aligned (cols % 4 == 0 and
//    aligned bases) a unit is 4 columns, from the first multiple of 4 at or
//    below the row's first column past the diagonal; only a row's first and
//    last unit test their columns against (g, col_end).  Otherwise a unit
//    is one column.  A thread issues the loads of 4 units before it counts
//    any of them.
//  - A bin by arithmetic: p = v * bins (one rounding) and b = int(p), or
//    bins - 1 where p == bins.  p is within 2^-24 p of the true v * bins and
//    each edge within 2^-24 of b / bins, so for bins <= 128 the two differ
//    by less than 2^-16 in units of a bin: where p lies further than
//    CC_HIST_NEAR (2^-10) from an integer, b is the bin.  Nearer, b is
//    corrected by one step, down if v < e[b] or up if v >= e[b + 1],
//    against the shared f32 edges: the membership test of np.histogram.
//  - The edges come by value, as a kernel parameter, so no global load
//    stands before the first count.
//  - Counts go to shared-memory bins with atomics; one integer atomic per
//    bin per block then adds the block's counts into `out`, in any order
//    the same sum.  On a bimodal Cij (nearly every pair in bin 0 or 19)
//    they cost no more than on a uniform one: this card merges a warp's
//    atomics to one address.  Counting bins 0 and bins - 1 in registers
//    instead was slower on both (PERF.md, Findings).
// ptxas (sm_90a): 42 registers a thread with 16-byte Cij units, 71 with
// count units (two int4 loads each), 32 / 44 with scalar units; 1,028
// bytes of static shared memory.  So 5 blocks of 256 threads fit an SM
// from Cij and 3 from the counts.
#include <stdint.h>

#include "common.cuh"

#define CC_HIST_MAX_BINS 128
#define CC_HIST_THREADS 256
// Units a thread takes, on average, along one row pair of its block.
#define CC_HIST_UNITS 4
// Units whose loads a thread issues before it counts any of them.
#define CC_HIST_BATCH 4
// Blocks of the grid, about 16 an SM of an H100: more, shorter blocks
// each pay the barrier and the flush again.
#define CC_HIST_BLOCKS (16 * 132)
// Within this of an integer, v * bins may have rounded across a bin's
// edge; elsewhere its integer part is the bin (see the note above).
#define CC_HIST_NEAR (1.0f / 1024)

// The bin edges, passed by value: no global load before the first count.
struct CcEdges {
  float e[CC_HIST_MAX_BINS + 1];
};

// A loader reads the data of a unit (4 columns, or 1) as raw registers
// and turns them into values only when they are counted, so that a
// thread's loads are all in flight at once.
struct CijLoad {
  const float* cij;
  struct Raw4 {
    float4 v;
  };
  __device__ __forceinline__ Raw4 fetch4(size_t i) const {
    return {*reinterpret_cast<const float4*>(cij + i)};
  }
  __device__ __forceinline__ float fetch1(size_t i) const { return cij[i]; }
  static __device__ __forceinline__ float value(const Raw4& r, int q) {
    return q == 0 ? r.v.x : q == 1 ? r.v.y : q == 2 ? r.v.z : r.v.w;
  }
};

struct CountLoad {
  const int* mij;
  const int* iij;
  struct Raw4 {
    int4 m, d;
  };
  // 0 / (i + 1e-6f) is +0 for every count i >= 0: skip the divide, whose
  // slow path a zero numerator takes.
  static __device__ __forceinline__ float ratio(int m, int i) {
    return m == 0 ? 0.0f
                  : __fdiv_rn(__int2float_rn(m),
                              __fadd_rn(__int2float_rn(i), 1e-6f));
  }
  __device__ __forceinline__ Raw4 fetch4(size_t i) const {
    return {*reinterpret_cast<const int4*>(mij + i),
            *reinterpret_cast<const int4*>(iij + i)};
  }
  __device__ __forceinline__ float fetch1(size_t i) const {
    return ratio(mij[i], iij[i]);
  }
  static __device__ __forceinline__ float value(const Raw4& r, int q) {
    return q == 0   ? ratio(r.m.x, r.d.x)
           : q == 1 ? ratio(r.m.y, r.d.y)
           : q == 2 ? ratio(r.m.z, r.d.z)
                    : ratio(r.m.w, r.d.w);
  }
};

__device__ __forceinline__ void cc_add_out(int* out, int v) {
  atomicAdd(out, v);
}
__device__ __forceinline__ void cc_add_out(long long* out, int v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(out),
            static_cast<unsigned long long>(static_cast<long long>(v)));
}

// Units of W columns of row r and the column its first unit starts at;
// 0 units where the row has no element in the triangle.
template <int W>
__host__ __device__ __forceinline__ long long cc_row_units(
    long long r, long long row_offset, long long n_valid, long long col_end,
    long long& start) {
  const long long g = row_offset + r;
  const long long c0 = g + 1 > 0 ? g + 1 : 0;
  if (g >= n_valid || c0 >= col_end) return 0;
  start = W == 4 ? (c0 & ~3LL) : c0;
  return (col_end - start + W - 1) / W;
}

template <class Load, int W, typename Out>
__global__ void __launch_bounds__(CC_HIST_THREADS)
    hist_kernel(Load load, long long rows, long long cols,
                long long row_offset, long long n_valid, CcEdges edges,
                int bins, Out* __restrict__ out) {
  __shared__ float e[CC_HIST_MAX_BINS + 1];
  __shared__ int counts[CC_HIST_MAX_BINS];
  for (int i = threadIdx.x; i <= bins; i += blockDim.x) e[i] = edges.e[i];
  for (int i = threadIdx.x; i < bins; i += blockDim.x) counts[i] = 0;
  __syncthreads();

  const float lo = e[0];
  const float hi = e[bins];
  const float fbins = static_cast<float>(bins);
  const long long col_end = cols < n_valid ? cols : n_valid;
  auto count = [&](float v) {
    if (!(v >= lo && v <= hi)) return;  // also drops NaN
    const float p = __fmul_rn(v, fbins);
    int b = bins - 1;  // p == bins: v is within rounding of hi
    if (p < fbins) {
      b = __float2int_rz(p);
      const float frac = __fsub_rn(p, __int2float_rz(b));  // exact
      if ((frac < CC_HIST_NEAR && b > 0) || frac > 1.0f - CC_HIST_NEAR) {
        if (v < e[b]) {
          --b;
        } else if (b + 1 < bins && v >= e[b + 1]) {
          ++b;
        }
      }
    }
    atomicAdd(&counts[b], 1);
  };

  const long long pairs = (rows + 1) / 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = blockIdx.y; p < pairs; p += gridDim.y) {
    const long long ra = p, rb = rows - 1 - p;
    long long sa = 0, sb = 0;
    const long long na =
        cc_row_units<W>(ra, row_offset, n_valid, col_end, sa);
    const long long nb =
        rb != ra ? cc_row_units<W>(rb, row_offset, n_valid, col_end, sb) : 0;
    const long long n = na + nb;
    for (long long u0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         u0 < n; u0 += CC_HIST_BATCH * stride) {
      long long r[CC_HIST_BATCH], c[CC_HIST_BATCH];
#pragma unroll
      for (int q = 0; q < CC_HIST_BATCH; ++q) {
        const long long u = u0 + q * stride;
        const bool in_a = u < na;
        r[q] = in_a ? ra : rb;
        c[q] = u < n ? (in_a ? sa + u * W : sb + (u - na) * W) : -1;
      }
      if (W == 4) {
        typename Load::Raw4 raw[CC_HIST_BATCH];
#pragma unroll
        for (int q = 0; q < CC_HIST_BATCH; ++q) {
          if (c[q] >= 0) raw[q] = load.fetch4((size_t)r[q] * cols + c[q]);
        }
#pragma unroll
        for (int q = 0; q < CC_HIST_BATCH; ++q) {
          if (c[q] < 0) continue;
          const long long g = row_offset + r[q];
          if (c[q] > g && c[q] + 3 < col_end) {  // inside the triangle
#pragma unroll
            for (int j = 0; j < 4; ++j) count(Load::value(raw[q], j));
          } else {  // a row's first or last unit
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (c[q] + j > g && c[q] + j < col_end) {
                count(Load::value(raw[q], j));
              }
            }
          }
        }
      } else {
        float v[CC_HIST_BATCH];
#pragma unroll
        for (int q = 0; q < CC_HIST_BATCH; ++q) {
          if (c[q] >= 0) v[q] = load.fetch1((size_t)r[q] * cols + c[q]);
        }
#pragma unroll
        for (int q = 0; q < CC_HIST_BATCH; ++q) {
          if (c[q] >= 0) count(v[q]);
        }
      }
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < bins; i += blockDim.x) {
    if (counts[i]) cc_add_out(out + i, counts[i]);
  }
}

static bool cc_aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <class Load, typename Out>
static int cc_launch_hist(Load load, bool vec, long long rows, long long cols,
                          long long row_offset, long long n_valid,
                          const float* edges, int bins, Out* out,
                          void* stream) {
  if (bins < 1 || bins > CC_HIST_MAX_BINS || rows < 0 || cols < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || cols == 0) return 0;
  // Blocks for the longest pair, the first where row_offset >= 0 (a row's
  // length then falls linearly with r until it is 0, so len(p) +
  // len(R - 1 - p) is convex in p).  The units loop strides over the grid,
  // so a longer pair (row_offset < 0) is still counted whole.
  const long long col_end = cols < n_valid ? cols : n_valid;
  long long start = 0;
  const long long pair_units =
      vec ? cc_row_units<4>(0, row_offset, n_valid, col_end, start) +
                cc_row_units<4>(rows - 1, row_offset, n_valid, col_end,
                                start)
          : cc_row_units<1>(0, row_offset, n_valid, col_end, start) +
                cc_row_units<1>(rows - 1, row_offset, n_valid, col_end,
                                start);
  if (pair_units == 0) return 0;
  const long long per_block = (long long)CC_HIST_THREADS * CC_HIST_UNITS;
  const long long pairs = (rows + 1) / 2;
  const long long gx = (pair_units + per_block - 1) / per_block;
  long long gy = (CC_HIST_BLOCKS + gx - 1) / gx;
  gy = gy < pairs ? gy : pairs;
  const dim3 grid(static_cast<unsigned>(gx),
                  static_cast<unsigned>(gy < 65535 ? gy : 65535));
  CcEdges e;
  for (int i = 0; i <= bins; ++i) e.e[i] = edges[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    hist_kernel<Load, 4, Out><<<grid, CC_HIST_THREADS, 0, s>>>(
        load, rows, cols, row_offset, n_valid, e, bins, out);
  } else {
    hist_kernel<Load, 1, Out><<<grid, CC_HIST_THREADS, 0, s>>>(
        load, rows, cols, row_offset, n_valid, e, bins, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// cij (rows, cols) f32 row-major; out holds `bins` zeroed int32; edges
// holds bins + 1 floats in host memory.
CC_EXPORT int cc_hist_counts(const float* cij, long long rows, long long cols,
                             long long row_offset, long long n_valid,
                             const float* edges, int bins, int* out,
                             void* stream) {
  const bool vec = cols % 4 == 0 && cc_aligned16(cij);
  return cc_launch_hist(CijLoad{cij}, vec, rows, cols, row_offset, n_valid,
                        edges, bins, out, stream);
}

// mij, iij (rows, cols) int32 row-major; the counts are added into the
// `bins` int64 of out.
CC_EXPORT int cc_hist_from_counts(const int* mij, const int* iij,
                                  long long rows, long long cols,
                                  long long row_offset, long long n_valid,
                                  const float* edges, int bins,
                                  long long* out, void* stream) {
  const bool vec = cols % 4 == 0 && cc_aligned16(mij) && cc_aligned16(iij);
  return cc_launch_hist(CountLoad{mij, iij}, vec, rows, cols, row_offset,
                        n_valid, edges, bins, out, stream);
}
