// K5: sorted U(0, 1) draws per ray from a counter-based generator.
//
// Replaces egonerf_tpu/ops/merge.py sorted_uniform (the training draws
// that sample_pdf feeds to the inverse CDF): per ray, n + 1 Exp(1) draws
// e_j, their cumulative sum c, and u = c[:-1] / c[-1], which is sorted by
// construction and has the joint law of n sorted iid uniforms.
//
// The TPU drew its bits from jax.random; here Philox4x32-10 (Salmon et al.,
// SC'11) runs in the kernel, keyed by (seed, step) with the counter
// (j / 4, ray, 0, kStream), and word j % 4 of the output block is the
// 32-bit draw of index j.  e_j = -log((bits + 0.5) * 2^-32) in float64,
// rounded to float32, so the plain version (ops/merge.py, int64 torch
// arithmetic) draws the same e bit for bit and differs from the kernel
// only in the order of the float32 cumulative sum.
//
// Bound on the card: operations are negligible (10 Philox rounds per
// draw); the (R, n) float32 output is the only device-memory traffic, so
// bytes.  Design: one warp per ray; the draws go to shared memory
// lane-strided, each lane sums a contiguous chunk, a warp scan gives the
// chunk offsets, and the quotients are written lane-strided (coalesced).
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_scan.cuh"

namespace {

using namespace egonerf;

constexpr int kWarpsPerBlock = 4;
constexpr uint32_t kStream = 0x4B35u;  // counter word 3: this generator's stream

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

__device__ __forceinline__ float exp_draw(long long ray, int j, uint32_t k0, uint32_t k1) {
  const U4 o = philox4x32_10(U4{(uint32_t)(j >> 2), (uint32_t)ray,
                                (uint32_t)((unsigned long long)ray >> 32), kStream},
                             k0, k1);
  const int w = j & 3;
  const uint32_t bits = w == 0 ? o.x : (w == 1 ? o.y : (w == 2 ? o.z : o.w));
  const double u = ((double)bits + 0.5) * 2.3283064365386963e-10;  // 2^-32
  return (float)(-log(u));
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sorted_uniform_kernel(long long R, int n, uint32_t k0, uint32_t k1, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (ray >= R) return;
  const int m = n + 1;
  float* c = smem + warp * m;
  for (int j = lane; j < m; j += 32) c[j] = exp_draw(ray, j, k0, k1);
  __syncwarp();
  const int per = (m + 31) / 32;
  const int a = min(lane * per, m), b = min(a + per, m);
  float local = 0.0f;
  for (int j = a; j < b; ++j) local = __fadd_rn(local, c[j]);
  float run = warp_exclusive_sum(local);
  for (int j = a; j < b; ++j) {
    run = __fadd_rn(run, c[j]);
    c[j] = run;
  }
  __syncwarp();
  const float total = c[m - 1];
  out += ray * n;
  for (int j = lane; j < n; j += 32) out[j] = __fdiv_rn(c[j], total);
}

}  // namespace

extern "C" int sorted_uniform_fwd(long long R, int n, unsigned int k0, unsigned int k1,
                                  float* out, void* stream) {
  const size_t smem = sizeof(float) * kWarpsPerBlock * (n + 1);
  if (n < 1 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sorted_uniform_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(R, n, k0, k1, out);
  return (int)cudaGetLastError();
}
