// k-means++ candidate draws: one launch per seeding step.
//
// Replaces no Pallas kernel.  The JAX package's greedy seeding
// (consensus_clustering_tpu/models/kmeans.py:55 `_kmeanspp_init`) is a
// `jax.lax.fori_loop` (:114) that XLA compiles into the sweep's device
// program; the port ran each of its steps from the host, and each step's
// draws as ~350 int64 PyTorch launches (rng.fold_in, the D^2 logits,
// rng.categorical).  This library does those draws in two entries, which
// share one threefry2x32 (rng.threefry2x32 in uint32 registers):
//
//   cc_kmeanspp_prologue, once per seeding call, one thread per lane:
//     (key0, key_rest) = split(keys); first = randint(key0, (), 0, n)
//     (rng.split, rng.randint).
//   cc_kmeanspp_draw, once per step j, per lane:
//     kj       = fold_in(key_rest, j);
//     logit[i] = d2[i] > 0 ? log(max(d2[i], 1e-30)) : -inf;
//     bits     = a ^ b of threefry2x32(kj, hi, lo), (hi, lo) the words of
//                the counter t * n + i (hi = 0: the wrapper refuses
//                T * n >= 2^32);
//     u        = max(tiny, f * (1 - tiny) + tiny), f = float((bits >> 9) |
//                0x3F800000) - 1 (rng.uniform);
//     g        = -log(-log(u)) (rng.gumbel);
//     cand[t]  = argmax_i (g + logit[i]), the lowest i on ties
//                (torch.argmax), for each trial t < T.
//
// The bits are the plain version's (ops/kmeanspp.draw_candidates_plain,
// which is the composition above in PyTorch ops): IEEE logf, the same
// function torch.log runs on the card (no __logf, no fast math), and every
// product and sum rounded on its own (__fmul_rn / __fadd_rn) where PyTorch
// runs separate kernels, so nvcc contracts nothing into an FMA.
//
// What bounds it on the H100: integer operations.  A hash is ~80 int32
// instructions (20 rounds of add, funnel shift and xor, 5 key injections),
// then two logf and a compare; the D^2 row is 4 n bytes a lane, read once
// for all T trials.  The design:
//   1. kmeanspp_draw_kernel, grid (lanes, nblk) of 256 threads: a block
//      strides over the lane's points, each thread loads one D^2 value at a
//      time and carries all the trials of a pass (up to CC_PP_TRIALS) for
//      its point, keeping each trial's running maximum in registers (a
//      strict '>' over ascending points keeps the lowest index);
//   2. each (value, index) pair becomes one 64-bit key, the value's bits
//      mapped to an order-preserving uint32 above the complement of the
//      index, so the maximum key is the largest value at its lowest index
//      and any order of reduction gives it: warp shuffles, then one key per
//      (block, trial) in a scratch buffer the wrapper allocates;
//   3. kmeanspp_pick_kernel, a second launch, one thread per (lane, trial):
//      the maximum over the lane's blocks, decoded to the int64 index.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

#define CC_PP_THREADS 256
// Trials a pass of the draw kernel carries in registers; more take passes.
#define CC_PP_TRIALS 8
#define CC_PICK_THREADS 256

// threefry2x32 (20 rounds), as rng.threefry2x32 computes it in int64 words.
__device__ __forceinline__ void cc_threefry2x32(uint32_t k0, uint32_t k1,
                                                uint32_t x0, uint32_t x1,
                                                uint32_t* out0,
                                                uint32_t* out1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t a = x0 + k0;
  uint32_t b = x1 + k1;
#define CC_TF_ROUND(r) \
  a += b;              \
  b = __funnelshift_l(b, b, r) ^ a;
#define CC_TF_ROUNDS_EVEN \
  CC_TF_ROUND(13) CC_TF_ROUND(15) CC_TF_ROUND(26) CC_TF_ROUND(6)
#define CC_TF_ROUNDS_ODD \
  CC_TF_ROUND(17) CC_TF_ROUND(29) CC_TF_ROUND(16) CC_TF_ROUND(24)
  CC_TF_ROUNDS_EVEN
  a += k1;
  b += k2 + 1u;
  CC_TF_ROUNDS_ODD
  a += k2;
  b += k0 + 2u;
  CC_TF_ROUNDS_EVEN
  a += k0;
  b += k1 + 3u;
  CC_TF_ROUNDS_ODD
  a += k1;
  b += k2 + 4u;
  CC_TF_ROUNDS_EVEN
  a += k2;
  b += k0 + 5u;
#undef CC_TF_ROUNDS_ODD
#undef CC_TF_ROUNDS_EVEN
#undef CC_TF_ROUND
  *out0 = a;
  *out1 = b;
}

// The key of (value v, index i): larger for a larger value, and for equal
// values larger for the lower index.  -0 ranks as +0, as a comparison
// does; the values here are finite or -inf, never NaN.
__device__ __forceinline__ unsigned long long cc_draw_key(float v,
                                                          uint32_t i) {
  if (v == 0.0f) v = 0.0f;
  uint32_t u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | (~i);
}

// Pass over trials [t0, t0 + CC_PP_TRIALS) of every lane: one key per
// (lane, block, trial) into part (lanes, nblk, trials).  A key of 0 (below
// every pair's) stands for a block without points.
__global__ void __launch_bounds__(CC_PP_THREADS)
    kmeanspp_draw_kernel(const long long* __restrict__ keys, uint32_t j,
                         const float* __restrict__ d2, int n, int trials,
                         int t0, unsigned long long* __restrict__ part) {
  const int lane = blockIdx.x;
  const int nblk = gridDim.y;
  uint32_t k0, k1;
  cc_threefry2x32(static_cast<uint32_t>(keys[2 * (size_t)lane]),
                  static_cast<uint32_t>(keys[2 * (size_t)lane + 1]), 0u, j,
                  &k0, &k1);
  const float tiny = 1.17549435e-38f;  // FLT_MIN, jax's finfo(f32).tiny
  const float scale = __fsub_rn(1.0f, tiny);
  float best[CC_PP_TRIALS];
  int best_i[CC_PP_TRIALS];
#pragma unroll
  for (int q = 0; q < CC_PP_TRIALS; ++q) {
    best[q] = -INFINITY;
    best_i[q] = -1;
  }
  const float* row = d2 + (size_t)lane * n;
  for (int i = blockIdx.y * CC_PP_THREADS + threadIdx.x; i < n;
       i += nblk * CC_PP_THREADS) {
    const float d = row[i];
    const float logit = d > 0.0f ? logf(fmaxf(d, 1e-30f)) : -INFINITY;
#pragma unroll
    for (int q = 0; q < CC_PP_TRIALS; ++q) {
      const int t = t0 + q;
      if (t < trials) {
        uint32_t a, b;
        cc_threefry2x32(k0, k1, 0u,
                        static_cast<uint32_t>(t) * static_cast<uint32_t>(n) +
                            static_cast<uint32_t>(i),
                        &a, &b);
        const float f = __fsub_rn(
            __uint_as_float(((a ^ b) >> 9) | 0x3F800000u), 1.0f);
        const float u = fmaxf(tiny, __fadd_rn(__fmul_rn(f, scale), tiny));
        const float g = -logf(-logf(u));
        const float v = __fadd_rn(g, logit);
        if (best_i[q] < 0 || v > best[q]) {
          best[q] = v;
          best_i[q] = i;
        }
      }
    }
  }
  __shared__ unsigned long long red[CC_PP_TRIALS][CC_PP_THREADS / 32];
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int q = 0; q < CC_PP_TRIALS; ++q) {
    unsigned long long key =
        best_i[q] < 0 ? 0ull
                      : cc_draw_key(best[q], static_cast<uint32_t>(best_i[q]));
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, off);
      key = other > key ? other : key;
    }
    if (threadIdx.x % 32 == 0) red[q][warp] = key;
  }
  __syncthreads();
  const int q = threadIdx.x;
  if (q < CC_PP_TRIALS && t0 + q < trials) {
    unsigned long long key = 0;
    for (int w = 0; w < CC_PP_THREADS / 32; ++w) {
      key = red[q][w] > key ? red[q][w] : key;
    }
    part[((size_t)lane * nblk + blockIdx.y) * trials + t0 + q] = key;
  }
}

// out (lanes, trials) int64: the index of each (lane, trial)'s largest key
// over its nblk blocks.
__global__ void kmeanspp_pick_kernel(const unsigned long long* __restrict__ part,
                                     size_t lanes, int nblk, int trials,
                                     long long* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * CC_PICK_THREADS + threadIdx.x;
  if (e >= lanes * trials) return;
  const size_t lane = e / trials;
  const int t = static_cast<int>(e - lane * trials);
  const unsigned long long* p = part + lane * nblk * trials + t;
  unsigned long long key = 0;
  for (int b = 0; b < nblk; ++b) {
    const unsigned long long k = p[(size_t)b * trials];
    key = k > key ? k : key;
  }
  out[e] = static_cast<long long>(~static_cast<uint32_t>(key));
}

__global__ void kmeanspp_prologue_kernel(const long long* __restrict__ keys,
                                         int lanes, uint32_t n,
                                         long long* __restrict__ key_rest,
                                         long long* __restrict__ first) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const uint32_t k0 = static_cast<uint32_t>(keys[2 * (size_t)l]);
  const uint32_t k1 = static_cast<uint32_t>(keys[2 * (size_t)l + 1]);
  // split(keys): counters 0 (key0) and 1 (key_rest).
  uint32_t a0, b0, a1, b1;
  cc_threefry2x32(k0, k1, 0u, 0u, &a0, &b0);
  cc_threefry2x32(k0, k1, 0u, 1u, &a1, &b1);
  key_rest[2 * (size_t)l] = a1;
  key_rest[2 * (size_t)l + 1] = b1;
  // randint(key0, (), 0, n): split(key0), one 32-bit draw from each half.
  uint32_t ha, hb, la, lb, x, y;
  cc_threefry2x32(a0, b0, 0u, 0u, &ha, &hb);
  cc_threefry2x32(a0, b0, 0u, 1u, &la, &lb);
  cc_threefry2x32(ha, hb, 0u, 0u, &x, &y);
  const uint32_t higher = x ^ y;
  cc_threefry2x32(la, lb, 0u, 0u, &x, &y);
  const uint32_t lower = x ^ y;
  uint32_t mult = 65536u % n;
  mult = (mult * mult) % n;
  first[l] = ((higher % n) * mult + lower % n) % n;
}

CC_EXPORT int cc_kmeanspp_prologue(const long long* keys, int lanes, int n,
                                   long long* key_rest, long long* first,
                                   void* stream) {
  if (lanes < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (lanes + 127) / 128;
  kmeanspp_prologue_kernel<<<blocks, 128, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      keys, lanes, static_cast<uint32_t>(n), key_rest, first);
  return static_cast<int>(cudaGetLastError());
}

CC_EXPORT int cc_kmeanspp_draw(const long long* keys, int j, const float* d2,
                               int lanes, int n, int trials, int nblk,
                               unsigned long long* part, long long* out,
                               void* stream) {
  if (lanes < 1 || n < 1 || trials < 1 || nblk < 1 || nblk > 65535 ||
      static_cast<unsigned long long>(trials) * n >= (1ull << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(lanes, nblk);
  for (int t0 = 0; t0 < trials; t0 += CC_PP_TRIALS) {
    kmeanspp_draw_kernel<<<grid, CC_PP_THREADS, 0, s>>>(
        keys, static_cast<uint32_t>(j), d2, n, trials, t0, part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t outs = static_cast<size_t>(lanes) * trials;
  const unsigned blocks =
      static_cast<unsigned>((outs + CC_PICK_THREADS - 1) / CC_PICK_THREADS);
  kmeanspp_pick_kernel<<<blocks, CC_PICK_THREADS, 0, s>>>(
      part, static_cast<size_t>(lanes), nblk, trials, out);
  return static_cast<int>(cudaGetLastError());
}
