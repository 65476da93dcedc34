// Shared by every kernel library of the port: each library is loaded with
// ctypes on its own, so each exports its own error-string entry.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define CC_EXPORT extern "C" __attribute__((visibility("default")))

CC_EXPORT const char* cc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The nearest-centroid arithmetic of the Lloyd step (lloyd.cu), the final
// assignment and the fused assign+pack step (fused_block.cu).  All three
// call these, so a row's label is the same wherever it is computed.  Every
// product and sum is rounded on its own (__fmul_rn / __fadd_rn: nvcc may not
// contract them into FMAs) and d is summed in ascending order, which the
// plain PyTorch version (ops/fused_block.row_sqdist_plain) repeats op for op.

// sum_f v[f]^2, f ascending.
__device__ __forceinline__ float cc_sq_norm(const float* v, int d) {
  float s = 0.0f;
  for (int f = 0; f < d; ++f) s = __fadd_rn(s, __fmul_rn(v[f], v[f]));
  return s;
}

// max((|x|^2 - 2 x.c) + |c|^2, 0), x.c summed with f ascending.
__device__ __forceinline__ float cc_sq_dist(const float* x, float xsq,
                                            const float* c, float csq,
                                            int d) {
  float cross = 0.0f;
  for (int f = 0; f < d; ++f) cross = __fadd_rn(cross, __fmul_rn(x[f], c[f]));
  const float v = __fadd_rn(__fsub_rn(xsq, __fmul_rn(2.0f, cross)), csq);
  return fmaxf(v, 0.0f);
}

// The nearest of slots 0..k-1 of the (k_max, d) centroids c with norms csq:
// the lowest slot on ties (strict '<' over ascending slots); slots >= k are
// +inf and never chosen.  *best gets the distance.
__device__ __forceinline__ int cc_nearest(const float* x, float xsq,
                                          const float* c, const float* csq,
                                          int d, int k, float* best) {
  float bv = INFINITY;
  int bj = 0;
  for (int j = 0; j < k; ++j) {
    const float v = cc_sq_dist(x, xsq, c + j * d, csq[j], d);
    if (v < bv) {
      bv = v;
      bj = j;
    }
  }
  *best = bv;
  return bj;
}
