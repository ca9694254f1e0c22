// K6: volume-rendering composite, forward.
//
// Replaces egonerf_tpu/ops/volrend.py raw2alpha + feature2density
// (models/egonerf.py:99-104) + the composite of EgoNeRF.forward
// (models/egonerf.py:466-493), without the envmap branch.
//
// Per ray of S samples: sigma = feature2density(feat); alpha =
// 1 - exp(-sigma * dist * scale); T the exclusive prefix product of
// (1 - alpha + 1e-10); weights = alpha * T; acc = sum(weights);
// rgb = clip(sum(weights * rgb), 0, 1); depth = sum(weights * z) +
// (1 - acc) * ray_dz; bg = the product over the whole ray.
//
// Bound on the card: bytes (6 x S floats read per ray, ~25 MB per
// 4096 x 256 chunk, ~7.5 us at 3.35 TB/s).  Design: one warp per ray, each
// lane a contiguous chunk of samples; the transmittance is a local product
// then a warp scan of the chunk products; the five sums are warp shuffle
// reductions.  Nothing but the per-ray results is written.
#include <cuda_runtime.h>

#include "warp_scan.cuh"

namespace {

using namespace egonerf;

constexpr int kWarpsPerBlock = 4;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
composite_kernel(const float* __restrict__ feat, const float* __restrict__ dists,
                 const float* __restrict__ z, const float* __restrict__ rgb,
                 const float* __restrict__ ray_dz, int R, int S, float shift, float scale,
                 int act, float* __restrict__ rgb_out, float* __restrict__ depth_out,
                 float* __restrict__ acc_out, float* __restrict__ bg_out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * kWarpsPerBlock + warp;
  float* al = smem + warp * S;
  if (ray >= R) return;
  feat += ray * S;
  dists += ray * S;
  z += ray * S;
  rgb += ray * S * 3;

  const int per = (S + 31) / 32;
  const int a = min(lane * per, S), b = min(a + per, S);
  float prod = 1.0f;
  for (int j = a; j < b; ++j) {
    const float alpha = alpha_of(feat[j], dists[j], shift, scale, act);
    al[j] = alpha;
    prod = __fmul_rn(prod, trans_factor(alpha));
  }
  float total;
  float t = warp_exclusive_prod(prod, &total);
  float acc = 0.0f, r = 0.0f, g = 0.0f, bl = 0.0f, depth = 0.0f;
  for (int j = a; j < b; ++j) {
    const float alpha = al[j];
    const float wj = __fmul_rn(alpha, t);
    t = __fmul_rn(t, trans_factor(alpha));
    acc += wj;
    r += wj * rgb[3 * j];
    g += wj * rgb[3 * j + 1];
    bl += wj * rgb[3 * j + 2];
    depth += wj * z[j];
  }
  acc = warp_sum(acc);
  r = warp_sum(r);
  g = warp_sum(g);
  bl = warp_sum(bl);
  depth = warp_sum(depth);
  if (lane == 0) {
    rgb_out[ray * 3] = fminf(fmaxf(r, 0.0f), 1.0f);
    rgb_out[ray * 3 + 1] = fminf(fmaxf(g, 0.0f), 1.0f);
    rgb_out[ray * 3 + 2] = fminf(fmaxf(bl, 0.0f), 1.0f);
    depth_out[ray] = depth + (1.0f - acc) * ray_dz[ray];
    acc_out[ray] = acc;
    bg_out[ray] = total;
  }
}

}  // namespace

extern "C" int composite_fwd(const float* feat, const float* dists, const float* z,
                             const float* rgb, const float* ray_dz, int R, int S, float shift,
                             float scale, int act, float* rgb_out, float* depth_out,
                             float* acc_out, float* bg_out, void* stream) {
  const size_t smem = sizeof(float) * kWarpsPerBlock * S;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  composite_kernel<<<blocks, kWarpsPerBlock * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      feat, dists, z, rgb, ray_dz, R, S, shift, scale, act, rgb_out, depth_out, acc_out,
      bg_out);
  return (int)cudaGetLastError();
}
