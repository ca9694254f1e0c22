// Philox4x32-10 (Salmon et al., SC'11) and K5's sorted draws, shared by the
// standalone K5 (sorted_uniform.cu), the training instantiations of K4 and
// K4c (resample.cu), which draw their u in a prologue, and the theta
// sampler's batch kernel (theta_sampler.cu).
//
// K5's law: per ray, n + 1 Exp(1) draws e_j, their cumulative sum c, and
// u = c[:-1] / c[-1].  Draw j of a ray is word j % 4 of the Philox block at
// counter (j / 4, ray, ray >> 32, kSortedStream) under key (seed, step),
// mapped to -log((bits + 0.5) * 2^-32) in float64 and rounded to float32,
// so e_j depends on (seed, step, ray, j) alone; the plain version
// (ops/philox.py, int64 torch arithmetic) draws the same bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_scan.cuh"

namespace egonerf {

// counter word 3 of K5's draws: its stream
constexpr uint32_t kSortedStream = 0x4B35u;

struct U4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ U4 philox4x32_10(U4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = U4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// Exp(1) of one 32-bit word: -log((bits + 0.5) * 2^-32) in float64
__device__ __forceinline__ float exp_of_bits(uint32_t bits) {
  const double u = ((double)bits + 0.5) * 2.3283064365386963e-10;  // 2^-32
  return (float)(-log(u));
}

// K5's sorted draws of one ray, by one warp: the n quotients c[j] / c[n]
// into dst[0 .. n-1] (lane-strided stores; dst may be row itself).  row
// holds n + 1 floats of this warp's shared memory.  Lane L computes the
// Philox blocks g = L, L + 32, ... and stores all four of a block's
// exponentials (a float4 where row is 16-byte aligned), ceil((n + 1) / 4)
// blocks a ray; the cumulative sum is K5's: contiguous chunks of
// ceil((n + 1) / 32) a lane summed with __fadd_rn, a warp exclusive scan of
// the chunk sums, and __fdiv_rn by the total.  Ends with __syncwarp.  Not
// inlined: its four float64 logs a block, inlined into K4c, made ptxas
// spill at K4c's register target; called once a warp, the call is cheap.
__device__ __noinline__ void warp_sorted_draw(float* row, int n, long long ray, uint32_t k0,
                                               uint32_t k1, float* dst) {
  const int lane = threadIdx.x & 31;
  const int m = n + 1;
  const bool vec = (reinterpret_cast<unsigned long long>(row) & 15) == 0;
  for (int g = lane; 4 * g < m; g += 32) {
    const U4 o = philox4x32_10(U4{(uint32_t)g, (uint32_t)ray,
                                  (uint32_t)((unsigned long long)ray >> 32), kSortedStream},
                               k0, k1);
    const int j = 4 * g;
    if (j + 3 < m) {
      const float4 e = make_float4(exp_of_bits(o.x), exp_of_bits(o.y), exp_of_bits(o.z),
                                   exp_of_bits(o.w));
      if (vec) {
        *reinterpret_cast<float4*>(row + j) = e;
      } else {
        row[j] = e.x;
        row[j + 1] = e.y;
        row[j + 2] = e.z;
        row[j + 3] = e.w;
      }
    } else {
      // the last, partial block: only its draws' logs (the lane that takes
      // it has the warp's longest chain)
      row[j] = exp_of_bits(o.x);
      if (j + 1 < m) row[j + 1] = exp_of_bits(o.y);
      if (j + 2 < m) row[j + 2] = exp_of_bits(o.z);
    }
  }
  __syncwarp();
  const int per = (m + 31) / 32;
  const int a = min(lane * per, m), b = min(a + per, m);
  float local = 0.0f;
  for (int j = a; j < b; ++j) local = __fadd_rn(local, row[j]);
  float run = warp_exclusive_sum(local);
  for (int j = a; j < b; ++j) {
    run = __fadd_rn(run, row[j]);
    row[j] = run;
  }
  __syncwarp();
  const float total = row[m - 1];
  for (int j = lane; j < n; j += 32) dst[j] = __fdiv_rn(row[j], total);
  __syncwarp();
}

}  // namespace egonerf
