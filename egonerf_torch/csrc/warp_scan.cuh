// Warp-wide scans and reductions over one float per lane, for kernels that
// give each lane a contiguous chunk of a ray's samples.
#pragma once

#include <cuda_runtime.h>

namespace egonerf {

constexpr unsigned kFullMask = 0xffffffffu;

// Product of the lanes below this one (1 on lane 0); *total gets the
// product over all 32 lanes.
__device__ __forceinline__ float warp_exclusive_prod(float v, float* total) {
  const int lane = threadIdx.x & 31;
  float incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl = __fmul_rn(incl, o);
  }
  *total = __shfl_sync(kFullMask, incl, 31);
  const float excl = __shfl_up_sync(kFullMask, incl, 1);
  return lane == 0 ? 1.0f : excl;
}

// Sum of the lanes below this one (0 on lane 0).
__device__ __forceinline__ float warp_exclusive_sum(float v) {
  const int lane = threadIdx.x & 31;
  float incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, o);
  }
  const float excl = __shfl_up_sync(kFullMask, incl, 1);
  return lane == 0 ? 0.0f : excl;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// feature2density: 0 = softplus(f + shift) written as JAX writes it,
// max(x, 0) + log1p(exp(-|x|)); 1 = relu(f).
__device__ __forceinline__ float density_act(float f, float shift, int act) {
  if (act == 0) {
    const float x = __fadd_rn(f, shift);
    return __fadd_rn(fmaxf(x, 0.0f), log1pf(expf(-fabsf(x))));
  }
  return fmaxf(f, 0.0f);
}

// d feature2density / d f: sigmoid(f + shift) for softplus, [f > 0] for relu.
__device__ __forceinline__ float density_act_grad(float f, float shift, int act) {
  if (act == 0) return 1.0f / (1.0f + expf(-__fadd_rn(f, shift)));
  return f > 0.0f ? 1.0f : 0.0f;
}

// raw2alpha's alpha = 1 - exp(-sigma * (dist * scale)).
__device__ __forceinline__ float alpha_of(float feat, float dist, float shift, float scale,
                                          int act) {
  const float sigma = density_act(feat, shift, act);
  return __fsub_rn(1.0f, expf(-__fmul_rn(sigma, __fmul_rn(dist, scale))));
}

// raw2alpha's transmittance factor (1 - alpha) + 1e-10.
__device__ __forceinline__ float trans_factor(float alpha) {
  return __fadd_rn(__fsub_rn(1.0f, alpha), 1e-10f);
}

}  // namespace egonerf
