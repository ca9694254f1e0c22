// K8: the environment-map lookup; K8b: its gradient in the table.
//
// Replaces envmap_radiance (egonerf_tpu/models/envmap.py:20-43): the view
// direction to canonical (u, v) = ((z + 1) / 2, (atan2(y, x) + pi) / 2pi)
// of the unit direction, mapped to [-1, 1]; sample_plane
// (egonerf_tpu/ops/grid_sample.py:23-87), a bilinear gather-based lookup of
// the channel-last (2h, h, 3) table with x = u over W = h and y = v over
// H = 2h, align_corners and zero padding, shaped for the TPU; and a
// sigmoid.  JAX differentiates the gathers into scatter-adds (jnp.take's
// transpose); K8b is that gradient: d raw = d_env * (s * (1 - s)) and, per
// corner, d raw * its weight added into a zeroed table with atomics.
//
// The lookup itself (the canonical map, the corners, the weighted sum and
// its sigmoid) is csrc/envmap.cuh, which the composite's envmap
// instantiation K6e shares: its radiance is K8's to the bit.
//
// Bound on the card: bytes.  Forward, per ray 12 bytes of direction, four
// 12-byte texels and 12 bytes out (~0.3 MB per 4096-ray batch, under a
// microsecond); backward, the zeroed (2h, h, 3) gradient (24 MB at
// h = 1000, ~7 us at 3.35 TB/s) dominates, which the wrapper allocates.
// Design: one thread per ray; the texels of a ray are 12-byte rows read
// through L1/L2; atomics spread over the table (rays of a batch rarely
// share a texel).
#include <cuda_runtime.h>

#include "envmap.cuh"

namespace {

using namespace egonerf;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
envmap_kernel(const float* __restrict__ dirs, long long d_stride,
              const float* __restrict__ table, int h, int R, float inv_2pi,
              float* __restrict__ out) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= R) return;
  const Corners c = corners_of(dirs + (long long)ray * d_stride, h, inv_2pi);
  float tex[12];
  load_texels(table, c, tex);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) out[3 * ray + ch] = envmap_channel(tex, c, ch);
}

__global__ void __launch_bounds__(kThreads)
envmap_bwd_kernel(const float* __restrict__ dirs, long long d_stride,
                  const float* __restrict__ env, const float* __restrict__ d_env, int h, int R,
                  float inv_2pi, float* __restrict__ d_table) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= R) return;
  const Corners c = corners_of(dirs + (long long)ray * d_stride, h, inv_2pi);
  float g[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float s = env[3 * ray + ch];
    g[ch] = __fmul_rn(d_env[3 * ray + ch], __fmul_rn(s, __fsub_rn(1.0f, s)));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (c.w[k] == 0.0f) continue;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) atomicAdd(d_table + 3 * c.idx[k] + ch, __fmul_rn(g[ch], c.w[k]));
  }
}

}  // namespace

extern "C" int envmap_fwd(const float* dirs, long long d_stride, const float* table, int h, int R,
                          float inv_2pi, float* out, void* stream) {
  const int blocks = (R + kThreads - 1) / kThreads;
  envmap_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dirs, d_stride, table, h, R, inv_2pi, out);
  return (int)cudaGetLastError();
}

extern "C" int envmap_bwd(const float* dirs, long long d_stride, const float* env,
                          const float* d_env, int h, int R, float inv_2pi, float* d_table,
                          void* stream) {
  const int blocks = (R + kThreads - 1) / kThreads;
  envmap_bwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dirs, d_stride, env, d_env, h, R, inv_2pi, d_table);
  return (int)cudaGetLastError();
}
