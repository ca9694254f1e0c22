// K5: sorted U(0, 1) draws per ray from a counter-based generator.
//
// Replaces egonerf_tpu/ops/merge.py sorted_uniform (the training draws
// that sample_pdf feeds to the inverse CDF): per ray, n + 1 Exp(1) draws
// e_j, their cumulative sum c, and u = c[:-1] / c[-1], which is sorted by
// construction and has the joint law of n sorted iid uniforms.
//
// The TPU drew its bits from jax.random; here Philox4x32-10 (Salmon et al.,
// SC'11) runs in the kernel, keyed by (seed, step) with the counter
// (j / 4, ray, 0, kSortedStream), and word j % 4 of the output block is the
// 32-bit draw of index j.  e_j = -log((bits + 0.5) * 2^-32) in float64,
// rounded to float32, so the plain version (ops/merge.py, int64 torch
// arithmetic) draws the same e bit for bit and differs from the kernel
// only in the order of the float32 cumulative sum.
//
// Bound on the card: the (R, n) float32 output is the only device-memory
// traffic (2.1 MB at 4096 x 128, 0.6 us) and a draw's operations (a
// quarter of a Philox block, its float64 log, the sum and the division,
// ~140) take 1.1 us, so operations, both far under the launch.  Design: one warp per ray, the draw of csrc/philox.cuh
// (warp_sorted_draw: one Philox block gives four draws, a lane computes
// whole blocks; each lane sums a contiguous chunk, a warp scan gives the
// chunk offsets), the quotients written lane-strided (coalesced).  The
// training paths run the same draw as a prologue of K4 and K4c
// (resample.cu), so the training step launches no K5; this launch serves
// callers that pass u.  Measured before the design (tools/draw_ab.py
// --ablate, H100 80GB HBM3, 700 W): of the lane-strided version's 8.2 us,
// 2.4 were the launch, 2.0 Philox (a whole block computed for each draw),
// 1.5 the float64 logs and 0.8 the scan; this one takes 7.2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using namespace egonerf;

constexpr int kWarpsPerBlock = 4;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sorted_uniform_kernel(long long R, int n, uint32_t k0, uint32_t k1, long long ray0,
                      float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (ray >= R) return;
  // each warp's row 16-byte aligned: the draws store float4s
  float* row = reinterpret_cast<float*>(smem4) + warp * ((n + 4) & ~3);
  warp_sorted_draw(row, n, ray0 + ray, k0, k1, out + ray * n);
}

}  // namespace

extern "C" int sorted_uniform_fwd(long long R, int n, unsigned int k0, unsigned int k1,
                                  long long ray0, float* out, void* stream) {
  const size_t smem = sizeof(float) * kWarpsPerBlock * ((n + 4) & ~3);
  if (n < 1 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sorted_uniform_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(R, n, k0, k1, ray0, out);
  return (int)cudaGetLastError();
}
