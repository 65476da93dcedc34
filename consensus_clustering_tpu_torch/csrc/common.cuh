// Shared by every kernel library of the port: each library is loaded with
// ctypes on its own, so each exports its own error-string entry.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define CC_EXPORT extern "C" __attribute__((visibility("default")))

// Rows per block of the Lloyd and assignment kernels, columns per block of
// the fused assign+pack kernel.
#define CC_TILE 128
// Shared memory one block may use on an H100 (227 KB).
#define CC_MAX_SMEM 232448
#define CC_MAX_DEVICES 64

CC_EXPORT const char* cc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Raise `kernel`'s dynamic shared-memory limit to `bytes` where the default
// 48 KB does not do, once per (device, size): `reserved` is the kernel's own
// per-device record of what it was last given.
static inline cudaError_t cc_reserve_smem(const void* kernel, size_t bytes,
                                          int* reserved) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < CC_MAX_DEVICES && reserved[dev] >= static_cast<int>(bytes)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < CC_MAX_DEVICES) {
    reserved[dev] = static_cast<int>(bytes);
  }
  return err;
}

// The nearest-centroid arithmetic of the Lloyd step (lloyd.cu), the final
// assignment and the fused assign+pack step (fused_block.cu).  All three
// call these, so a row's label is the same wherever it is computed.  Every
// product and sum is rounded on its own (__fmul_rn / __fadd_rn: nvcc may not
// contract them into FMAs) and d is summed in ascending order, which the
// plain PyTorch version (ops/fused_block.row_sqdist_plain) repeats op for op:
//   dist(x, c_j) = max((|x|^2 - 2 x.c_j) + |c_j|^2, 0),
// the nearest slot is the lowest of the least distance (a strict '<' over
// ascending slots), and slots >= k are never chosen.
//
// Layouts.  A block stages its rows row-major in shared memory at a stride
// `xs` (d, or d + 1 when d is even: an odd stride puts the 32 rows a warp
// reads in 32 banks), and a chunk of centroid slots transposed, (d, ks):
// element (f, j) at ct[f * ks + j].  With ks a multiple of 4 ("VEC") the
// values of slots j..j+3 at one f are one 16-byte load that every thread of
// the warp reads at the same address (a broadcast).
//
// Register blocking.  A thread walks f once per group of G slots: one load
// of its own x[f], G/4 broadcast loads of centroid values, and G
// independent multiply-add chains kept in registers.  Each chain is still
// the f-ascending, op-by-op sum of the scalar routine, so the bits do not
// change; what changes is that G chains overlap where one ran in series,
// and that x[f] is read once per G slots instead of once per slot.

// sum_f v[f]^2, f ascending.
__device__ __forceinline__ float cc_sq_norm(const float* v, int d) {
  float s = 0.0f;
  for (int f = 0; f < d; ++f) s = __fadd_rn(s, __fmul_rn(v[f], v[f]));
  return s;
}

// Slots jj..jj+G-1 of a staged chunk (chunk slot jj is global slot j0 + jj)
// merged into the running (bv, bj); chunk slots >= j_hi are not compared.
template <int G, bool VEC>
__device__ __forceinline__ void cc_group(const float* __restrict__ xr,
                                         float xsq,
                                         const float* __restrict__ ct,
                                         const float* __restrict__ csq,
                                         int ks, int d, int jj, int j_hi,
                                         int j0, float& bv, int& bj) {
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.0f;
  const float* cp = ct + jj;
#pragma unroll 4
  for (int f = 0; f < d; ++f) {
    const float xv = xr[f];
    if (VEC) {
#pragma unroll
      for (int q = 0; q < G; q += 4) {
        const float4 c4 = *reinterpret_cast<const float4*>(cp + q);
        acc[q] = __fadd_rn(acc[q], __fmul_rn(xv, c4.x));
        acc[q + 1] = __fadd_rn(acc[q + 1], __fmul_rn(xv, c4.y));
        acc[q + 2] = __fadd_rn(acc[q + 2], __fmul_rn(xv, c4.z));
        acc[q + 3] = __fadd_rn(acc[q + 3], __fmul_rn(xv, c4.w));
      }
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        acc[g] = __fadd_rn(acc[g], __fmul_rn(xv, cp[g]));
      }
    }
    cp += ks;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (jj + g < j_hi) {
      const float v = fmaxf(
          __fadd_rn(__fsub_rn(xsq, __fmul_rn(2.0f, acc[g])), csq[jj + g]),
          0.0f);
      if (v < bv) {
        bv = v;
        bj = j0 + jj + g;
      }
    }
  }
}

// Chunk slots [jj_lo, jj_hi) in ascending order, merged into (bv, bj).
// VEC: jj_lo is a multiple of 4, and the chunk's rows hold slots up to
// jj_hi rounded up to 4, which groups of 8 and a last group of 4 read (the
// padding slots' values are never compared).
template <bool VEC>
__device__ __forceinline__ void cc_nearest_slots(const float* xr, float xsq,
                                                 const float* ct,
                                                 const float* csq, int ks,
                                                 int d, int jj_lo, int jj_hi,
                                                 int j0, float& bv, int& bj) {
  if (VEC) {
    int jj = jj_lo;
    for (; jj + 4 < jj_hi; jj += 8) {
      cc_group<8, true>(xr, xsq, ct, csq, ks, d, jj, jj_hi, j0, bv, bj);
    }
    if (jj < jj_hi) {
      cc_group<4, true>(xr, xsq, ct, csq, ks, d, jj, jj_hi, j0, bv, bj);
    }
  } else {
    for (int jj = jj_lo; jj < jj_hi; ++jj) {
      cc_group<1, false>(xr, xsq, ct, csq, ks, d, jj, jj_hi, j0, bv, bj);
    }
  }
}

// The staging loops below are bound by the latency of global memory, so a
// thread issues B loads before it stores any of them.  B costs 2 registers
// a load: the tile kernels take 4 (more would cut their blocks per SM),
// the fused kernel, one block per SM, takes 8.

// Whole block: copy `rows` rows of d floats (contiguous at src) to dst at
// stride xs.  Consecutive threads read consecutive words.
template <int B>
__device__ __forceinline__ void cc_stage_rows(const float* __restrict__ src,
                                              int rows, int d, int xs,
                                              float* __restrict__ dst) {
  const int total = rows * d;
  const int step_r = blockDim.x / d;
  const int step_f = blockDim.x - step_r * d;
  int r = threadIdx.x / d;
  int f = threadIdx.x - r * d;
  for (int i0 = threadIdx.x; i0 < total; i0 += B * blockDim.x) {
    float v[B];
    int o[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int i = i0 + u * blockDim.x;
      o[u] = i < total ? r * xs + f : -1;
      if (i < total) v[u] = src[i];
      r += step_r;
      f += step_f;
      if (f >= d) {
        f -= d;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (o[u] >= 0) dst[o[u]] = v[u];
    }
  }
}

// Whole block: slots [j0, j0 + n) of `count` lanes' centroids (lane l's
// slot j at cen[l * lane_stride + j * d]) transposed: feature f of slot
// j0 + j of lane l to ct[l * lane_words + f * ks + j].  Consecutive
// threads read consecutive words.  Slots n.. of a chunk's last group of
// 4 are left as they are: they are read but never compared.  The caller
// syncs after.
template <int B>
__device__ __forceinline__ void cc_stage_centroids(
    const float* __restrict__ cen, size_t lane_stride, int count,
    int lane_words, int j0, int n, int d, int ks, float* __restrict__ ct) {
  const int total = count * n * d;
  const int step_r = blockDim.x / d;
  const int step_f = blockDim.x - step_r * d;
  int j = threadIdx.x / d;
  int f = threadIdx.x - j * d;
  int l = j / n;
  j -= l * n;
  const float* src = cen + (size_t)j0 * d;
  for (int i0 = threadIdx.x; i0 < total; i0 += B * blockDim.x) {
    float v[B];
    int o[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int i = i0 + u * blockDim.x;
      o[u] = i < total ? l * lane_words + f * ks + j : -1;
      if (i < total) v[u] = src[l * lane_stride + (size_t)j * d + f];
      j += step_r;
      f += step_f;
      if (f >= d) {
        f -= d;
        ++j;
      }
      if (j >= n) {
        l += j / n;
        j -= (j / n) * n;
      }
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (o[u] >= 0) ct[o[u]] = v[u];
    }
  }
}

// The norm of staged slot j (f ascending): the values of cl, read back from
// shared memory, which is quicker than a chain of d global loads.
__device__ __forceinline__ float cc_staged_norm(const float* __restrict__ ct,
                                                int j, int d, int ks) {
  float s = 0.0f;
#pragma unroll 4
  for (int f = 0; f < d; ++f) {
    const float v = ct[f * ks + j];
    s = __fadd_rn(s, __fmul_rn(v, v));
  }
  return s;
}

// Where the upper half of n slots starts: half, rounded up to a multiple of
// 4 on the VEC path (its groups start 16-byte aligned).
__device__ __forceinline__ int cc_half_split(int n, bool vec) {
  const int half = (n + 1) / 2;
  return min(n, vec ? (half + 3) & ~3 : half);
}

// Block of 2 * CC_TILE threads, two per row: the nearest of slots [0, k) of
// the lane's (k_max, d) centroids cl for each of `rows` rows staged in xt
// at stride xs (the caller has staged them, or synced since it last wrote
// any shared memory this reads).  Slots are staged cg at a time into ct
// (d, ks), their norms into csq.  Thread h * CC_TILE + r takes the lower
// (h = 0) or upper (h = 1) half of every chunk for row r, so each warp runs
// one half and no warp diverges on the halves' unequal group counts.  The
// halves meet in shared memory (mv, mj: CC_TILE words each, free from the
// first sync here to the last; they may alias ct and xt) and merge lowest
// slot on ties, which is what one scan over all slots in ascending order
// gives.  xsq is the thread's row norm: computed here when new_rows (rows
// staged since the last call), else the caller's from that call.  Thread
// r < rows (h = 0) returns row r's slot and *best its distance; the other
// threads return garbage.
template <bool VEC>
__device__ __forceinline__ int cc_tile_nearest(const float* __restrict__ cl,
                                               int d, int k, int xs, int ks,
                                               int cg, int rows,
                                               float* __restrict__ ct,
                                               float* __restrict__ csq,
                                               const float* __restrict__ xt,
                                               float* mv, int* mj,
                                               bool new_rows, float& xsq,
                                               float* best) {
  const int r = threadIdx.x % CC_TILE;
  const int h = threadIdx.x / CC_TILE;
  const bool live = r < rows;
  const float* xr = xt + r * xs;
  float bv = INFINITY;
  int bj = 0;
  for (int j0 = 0; j0 < k; j0 += cg) {
    const int n = min(cg, k - j0);
    if (j0 > 0) __syncthreads();  // every thread is done with the last chunk
    cc_stage_centroids<4>(cl, 0, 1, 0, j0, n, d, ks, ct);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      csq[j] = cc_staged_norm(ct, j, d, ks);
    }
    if (j0 == 0 && new_rows && live) xsq = cc_sq_norm(xr, d);
    __syncthreads();
    if (live) {
      const int split = cc_half_split(n, VEC);
      cc_nearest_slots<VEC>(xr, xsq, ct, csq, ks, d, h ? split : 0,
                            h ? n : split, j0, bv, bj);
    }
  }
  __syncthreads();  // mv, mj may alias what the loop read
  if (h == 1) {
    mv[r] = bv;
    mj[r] = bj;
  }
  __syncthreads();
  if (h == 0) {
    const float ov = mv[r];
    const int oj = mj[r];
    if (ov < bv || (ov == bv && oj < bj)) {
      bv = ov;
      bj = oj;
    }
  }
  *best = bv;
  return bj;
}
