// Popcount co-occurrence counts of packed bit-planes (packed Mij / Iij).
//
// Replaces the Pallas TPU kernel `_coassoc_kernel` of the reference package
// (consensus_clustering_tpu/ops/pallas_coassoc.py), launched by
// `_pallas_coassoc` and dispatched by `packed_coassoc_counts`.
//
// What it computes: out[i, j] = sum over w < L of
// popcount(rows[w, i] & cols[w, j]), an exact int32 count, for rows (L, R)
// and cols (L, C) int32 words holding uint32 bit patterns (resamples packed
// 32 to a word, cluster planes stacked along w).  Each operand has its own
// leading dimension, so a row tile of the planes is passed without a copy.
//
// What bounds it on the H100: operations.  Each (w, i, j) is one AND, one
// POPC and one integer add; POPC issues at 16 per clock per SM on compute
// capability 9.0 (a quarter of the integer ALU rate), so the popcounts set
// the bound.  The operands are 1/32 the bytes of a one-hot and are reused
// R (or C) times, so device memory is far from the limit.  The design keeps
// the reuse on chip: a block owns a 64 x 64 output tile, 256 threads each
// hold a 4 x 4 register tile of accumulators (rows ty + 16a, columns
// tx + 16b), and per step the block stages 32 words of both sides in shared
// memory with coalesced loads; every word a thread loads from shared memory
// then feeds four AND+POPC+ADD.  Integer sums commute, so the result is
// exact and independent of any order: no atomics.  Ragged edges are masked
// in the kernel (a zero word adds nothing), so the caller pads nothing.
#include <stdint.h>

#include "common.cuh"

#define CC_POP_TILE 64
#define CC_POP_WORDS 32
#define CC_POP_THREADS 256

__global__ void popcount_kernel(const int* __restrict__ rows,
                                const int* __restrict__ cols, int L, int R,
                                int C, long long ld_rows, long long ld_cols,
                                int* __restrict__ out) {
  __shared__ int a_s[CC_POP_WORDS][CC_POP_TILE];
  __shared__ int b_s[CC_POP_WORDS][CC_POP_TILE];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int r0 = blockIdx.y * CC_POP_TILE;
  const int c0 = blockIdx.x * CC_POP_TILE;
  int acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0;

  for (int w0 = 0; w0 < L; w0 += CC_POP_WORDS) {
    // 32 x 64 words per side, 8 per thread; neighbouring threads load
    // neighbouring elements of one word row.
    for (int e = threadIdx.x; e < CC_POP_WORDS * CC_POP_TILE;
         e += CC_POP_THREADS) {
      const int w = e / CC_POP_TILE;
      const int t = e % CC_POP_TILE;
      const bool w_ok = w0 + w < L;
      a_s[w][t] = (w_ok && r0 + t < R) ? rows[(w0 + w) * ld_rows + r0 + t] : 0;
      b_s[w][t] = (w_ok && c0 + t < C) ? cols[(w0 + w) * ld_cols + c0 + t] : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int w = 0; w < CC_POP_WORDS; ++w) {
      int av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = a_s[w][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = b_s[w][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] += __popc(av[a] & bv[b]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = r0 + ty + 16 * a;
    if (i >= R) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = c0 + tx + 16 * b;
      if (j < C) out[(long long)i * C + j] = acc[a][b];
    }
  }
}

// rows: L words of R elements, row stride ld_rows; cols: L words of C
// elements, row stride ld_cols; out: (R, C) int32, every entry written.
CC_EXPORT int cc_popcount_counts(const int* rows, const int* cols, int L,
                                 int R, int C, long long ld_rows,
                                 long long ld_cols, int* out, void* stream) {
  if (L < 0 || R < 0 || C < 0 || ld_rows < R || ld_cols < C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0 || C == 0) return 0;
  const long long gy = (R + CC_POP_TILE - 1) / CC_POP_TILE;
  const long long gx = (C + CC_POP_TILE - 1) / CC_POP_TILE;
  if (gy > 65535 || gx > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  popcount_kernel<<<grid, CC_POP_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      rows, cols, L, R, C, ld_rows, ld_cols, out);
  return static_cast<int>(cudaGetLastError());
}
