// K7: the chart and normalization prologue of every field lookup.
//
// Replaces the yin-yang chart and its normalization as the JAX forward
// runs them on every sample: xyz = o + d z; from_cartesian
// (egonerf_tpu/coords/yinyang.py:47-66) and normalize_coord
// (coords/yinyang.py:68-76) with normalize_r, either the interval_th
// lookup on the radial grid (coords/expgrid.py:89-113, whose masked
// min/max bracketing replaces searchsorted to spare the TPU its gathers)
// or the closed-form exponential cells (coords/expgrid.py:116-130).  The
// arithmetic of one sample is chart.cuh's, which K4's fused epilogue
// (resample.cu) shares: the fine chart of the EgoNeRF forward runs there,
// and this kernel keeps the coarse chart and every other caller.
//
// K7s (chart_sphere_fwd) is the same kernel instantiated for the single
// sphere of generic_sphere (egonerf_tpu/coords/spherical.py:48-53,
// 119-126): the yin frame for every point, flag 0, the TensoRF models'
// (R * S, 4) [r, theta, phi, 0] coords.
//
// Bound on the card: bytes (a 4096 x 128 coarse chunk writes 8.4 MB of
// float4 coords, ~2.5 us at 3.35 TB/s; ~170 float32 operations per sample
// for two acos, two atan2 and the rest is ~1.3 us at 67 TFLOP/s).
// Design: a warp a ray, its lanes over the ray's samples, one float4
// store each (coalesced, 512 bytes a warp); the ray's origin and direction
// read once a warp; a persistent grid of at most 8 blocks an SM, each
// staging the radial grid in shared memory once and walking its rays, so
// no thread divides a 64-bit index.
#include <cuda_runtime.h>

#include "chart.cuh"

namespace {

using namespace egonerf;

constexpr int kWarps = 8;
constexpr int kBlocksPerSm = 8;

template <bool kSphere>
__global__ void __launch_bounds__(kWarps * 32)
chart_kernel(const float* __restrict__ o, long long o_stride, const float* __restrict__ d,
             long long d_stride, const float* __restrict__ z, long long z_stride, int R, int S,
             ChartArgs a, const float* __restrict__ grid_g, float4* __restrict__ out) {
  extern __shared__ float grid[];
  chart_stage_grid(a, grid_g, grid);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int ray = blockIdx.x * kWarps + (threadIdx.x >> 5); ray < R;
       ray += gridDim.x * kWarps) {
    const ChartRay cr = chart_ray(o + (long long)ray * o_stride, d + (long long)ray * d_stride,
                                  lane);
    const float* zr = z + (long long)ray * z_stride;
    float4* po = out + (long long)ray * S;
    for (int s = lane; s < S; s += 32)
      po[s] = chart_point<kSphere>(cr.ox, cr.oy, cr.oz, cr.dx, cr.dy, cr.dz, zr[s], a, grid);
  }
}

template <bool kSphere>
int launch(const float* o, long long o_stride, const float* d, long long d_stride,
           const float* z, long long z_stride, int R, int S, const ChartArgs& a,
           const float* grid, float* out, void* stream) {
  if (a.mode == 0 && (a.n_grid < 2 || a.n_grid > kMaxChartGrid)) return (int)cudaErrorInvalidValue;
  if (R <= 0 || S <= 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long need = ((long long)R + kWarps - 1) / kWarps;
  const unsigned blocks = (unsigned)(need < (long long)sms * kBlocksPerSm
                                         ? need : (long long)sms * kBlocksPerSm);
  const size_t smem = a.mode == 0 ? sizeof(float) * a.n_grid : 0;
  chart_kernel<kSphere><<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      o, o_stride, d, d_stride, z, z_stride, R, S, a, grid, reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// K7: the yin-yang chart
extern "C" int chart_fwd(const float* o, long long o_stride, const float* d, long long d_stride,
                         const float* z, long long z_stride, int R, int S, float cx, float cy,
                         float cz, float near_t, float near_p, float inv_r, float inv_t,
                         float inv_p, int mode, const float* grid, int n_grid, float inv_nr,
                         float r0, float inv_r0, float ratio, float inv_log_ratio, float* out,
                         void* stream) {
  const ChartArgs a{cx, cy, cz, near_t, near_p, inv_r, inv_t, inv_p, mode, n_grid, inv_nr,
                    r0, inv_r0, ratio, inv_log_ratio};
  return launch<false>(o, o_stride, d, d_stride, z, z_stride, R, S, a, grid, out, stream);
}

// K7s: generic_sphere's single sphere, the same arguments
extern "C" int chart_sphere_fwd(const float* o, long long o_stride, const float* d,
                                long long d_stride, const float* z, long long z_stride, int R,
                                int S, float cx, float cy, float cz, float near_t, float near_p,
                                float inv_r, float inv_t, float inv_p, int mode,
                                const float* grid, int n_grid, float inv_nr, float r0,
                                float inv_r0, float ratio, float inv_log_ratio, float* out,
                                void* stream) {
  const ChartArgs a{cx, cy, cz, near_t, near_p, inv_r, inv_t, inv_p, mode, n_grid, inv_nr,
                    r0, inv_r0, ratio, inv_log_ratio};
  return launch<true>(o, o_stride, d, d_stride, z, z_stride, R, S, a, grid, out, stream);
}
