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
// Bound on the card: bytes (a 4096 x 128 coarse chunk writes 8.4 MB of
// float4 coords, ~2.5 us at 3.35 TB/s; ~170 float32 operations per sample
// for two acos, two atan2 and the rest is ~1.3 us at 67 TFLOP/s).
// Design: a warp a ray, its lanes over the ray's samples, one float4
// store each (coalesced, 512 bytes a warp); the ray's origin and direction
// read once a warp; a persistent grid of at most 8 blocks an SM, each
// staging the radial grid in shared memory once and walking its rays, so
// no thread divides a 64-bit index.
//
// K7s (chart_sphere_fwd): generic_sphere's single sphere
// (egonerf_tpu/coords/spherical.py:48-53, 119-126 with
// coords/expgrid.py:89-113) and, given the aabb, the TensoRF samplers'
// in-box mask (egonerf_tpu/models/tensorf.py:61-77) of the same points:
// per sample [r, theta = acos(dz / r), phi = atan2(dy, dx), 0] and
// all(lo <= o + d z <= hi), the point rounded as torch forms it (d z, then
// + o) before the centre is subtracted.  Bound: bytes (a 4096 x 256 chunk
// reads 4.2 MB of depths and writes 16.8 MB of coords and 1 MB of mask,
// 22 MB, ~6.6 us at 3.35 TB/s).  Its first form, K7 with the yin test
// forced true, was held back by its binary search and its library acosf
// and atan2f, not by its bytes: on an H100 80GB HBM3 at 700 W, 0.0140 ms
// as it was, 0.0097 without the search, 0.0124 without its store
// (tools/chart_ab.py --ablate).  Design:
// the radial cell takes no search.  The radius's bucket (trunc(r / w), a
// multiply) gives a first index from a table the wrapper builds once per
// grid (ops/chart.py::radial_buckets), at or below searchsorted(grid, r,
// right=True) for every float32 radius; the table states the longest walk
// from there (1 on the configs' grids), and the kernel takes one
// predicated compare up the staged grid for a walk of 1 (a NaN after the
// last entry stops it), a loop for a longer one.  The radius and the cell's lerp keep the plain
// version's IEEE arithmetic, so the radial column is its bit for bit; the
// angles take branch-free polynomials within 2e-7 rad (sphere_acos,
// sphere_atan2) of the same dz / r and (dy, dx).  A warp takes
// kSphereSamples x 32 samples of a ray and loads their depths before any
// arithmetic, so one warp keeps eight loads and eight independent chains
// in flight, over a grid sized by the occupancy the registers allow.
#include <cuda_runtime.h>

#include "chart.cuh"

namespace {

using namespace egonerf;

constexpr int kWarps = 8;
constexpr int kBlocksPerSm = 8;
// K7s: samples a lane takes in one tile
constexpr int kSphereSamples = 8;

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
      po[s] = chart_point(cr.ox, cr.oy, cr.oz, cr.dx, cr.dy, cr.dz, zr[s], a, grid);
  }
}

// K7s's radial lookup: the staged grid (n_grid entries and a NaN), the
// bucket table's first indices and its buckets per unit radius
struct SphereLookup {
  const float* grid;
  const int* start;
  int n_bucket;
  float inv_w;
};

// normalize_r in [0, 1] of the radius r on generic_sphere's chart.  kWalk
// -1: radial modes 1 and 2 (no grid); 0: the grid lookup with a walk of
// any length, a loop; 1: a walk of at most one step, one predicated
// compare (the NaN after the last entry stops it there).
template <int kWalk>
__device__ __forceinline__ float sphere_normalize_r(float r, const ChartArgs& a,
                                                    const SphereLookup& l) {
  if constexpr (kWalk < 0) {
    return chart_normalize_r(r, a, l.grid);
  } else {
    // the bucket: trunc(r * inv_w), a NaN 0 (the conversion's), inf and
    // anything past the table its last
    const int b = min(__float2int_rz(__fmul_rn(r, l.inv_w)), l.n_bucket - 1);
    int hi = l.start[b];
    if constexpr (kWalk == 0) {
      while (l.grid[hi] <= r) ++hi;
    } else {
#pragma unroll
      for (int k = 0; k < kWalk; ++k) hi += l.grid[hi] <= r ? 1 : 0;
    }
    return chart_cell_lerp(r, hi, a, l.grid);
  }
}

constexpr float kPi = 3.14159265358979f, kHalfPi = 1.57079632679490f;

__device__ __forceinline__ float approx_sqrt(float x) {
  float y;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float approx_rcp(float x) {
  float y;
  asm("rcp.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acos(q) of q in [-1, 1], branch-free, within 2e-7 rad of the exact
// angle of the same q: asin(x) = x + x^3 P(x^2) on [0, 0.5] (a minimax
// fit, 1.5e-9 rad), at x = |q| (acos = pi/2 - asin) or, past |q| = 0.5, at
// x = sqrt((1 - |q|) / 2) (acos = 2 asin; 1 - |q| is exact there); then
// mirrored for q < 0.  Only the q the plain version forms (an IEEE
// division) keeps theta within K7_TOL at the poles, where acos is steep.
__device__ __forceinline__ float sphere_acos(float q) {
  const float a = fabsf(q);
  const bool far = a > 0.5f;
  const float x2 = far ? (1.0f - a) * 0.5f : a * a;
  const float x = far ? approx_sqrt(x2) : a;
  float p = fmaf(x2, 0.043763176f, 0.023142193f);
  p = fmaf(x2, p, 0.04570781f);
  p = fmaf(x2, p, 0.07493077f);
  p = fmaf(x2, p, 0.16666822f);
  const float s = fmaf(x * x2, p, x);
  const float ra = far ? 2.0f * s : kHalfPi - s;
  return q < 0.0f ? kPi - ra : ra;
}

// atan2(y, x), branch-free, within 2e-7 rad: atan(t) = t + t^3 P(t^2) on
// [0, 1] (a minimax fit, 5e-8 rad) at t = min(|x|, |y|) / max(|x|, |y|),
// then the octant; the signs of zero as IEEE atan2 (and torch) take them:
// atan2(+-0, x) is +-pi where x is negative or -0, and +-0 otherwise.  A
// pair of tiny magnitudes is scaled by 2^100 first (exactly), so the
// approximate reciprocal of the larger stays finite.
__device__ __forceinline__ float sphere_atan2(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float scale = fmaxf(ax, ay) < 1e-30f ? 0x1p100f : 1.0f;
  const float mx = fmaxf(ax, ay) * scale, mn = fminf(ax, ay) * scale;
  const float t = mx > 0.0f ? mn * approx_rcp(mx) : 0.0f;
  const float t2 = t * t;
  float p = fmaf(t2, -0.0043551517f, 0.023039216f);
  p = fmaf(t2, p, -0.05777227f);
  p = fmaf(t2, p, 0.0979414f);
  p = fmaf(t2, p, -0.13976547f);
  p = fmaf(t2, p, 0.19962698f);
  p = fmaf(t2, p, -0.3333166f);
  float r = fmaf(t * t2, p, t);
  r = ay > ax ? kHalfPi - r : r;
  r = signbit(x) ? kPi - r : r;
  return copysignf(r, y);
}

template <int kWalk>
__global__ void __launch_bounds__(kWarps * 32)
chart_sphere_kernel(const float* __restrict__ o, long long o_stride,
                    const float* __restrict__ d, long long d_stride,
                    const float* __restrict__ z, long long z_stride, int R, int S, ChartArgs a,
                    const float* __restrict__ grid_g, const int* __restrict__ start_g,
                    int n_bucket, float inv_w, const float* __restrict__ box,
                    float4* __restrict__ out, unsigned char* __restrict__ mask) {
  extern __shared__ float smem[];
  const SphereLookup l{smem, reinterpret_cast<const int*>(smem + a.n_grid + 1), n_bucket, inv_w};
  if (kWalk >= 0) {
    int* start = reinterpret_cast<int*>(smem + a.n_grid + 1);
    for (int i = threadIdx.x; i < a.n_grid; i += blockDim.x) smem[i] = grid_g[i];
    for (int i = threadIdx.x; i < n_bucket; i += blockDim.x) start[i] = start_g[i];
    if (threadIdx.x == 0) smem[a.n_grid] = __int_as_float(0x7fffffff);
  }
  __syncthreads();
  float lo[3] = {0.0f, 0.0f, 0.0f}, hi[3] = {0.0f, 0.0f, 0.0f};
  if (mask != nullptr)
    for (int i = 0; i < 3; ++i) lo[i] = __ldg(box + i), hi[i] = __ldg(box + 3 + i);
  const int lane = threadIdx.x & 31;
  constexpr int kTile = kSphereSamples * 32;
  const int tiles = (S + kTile - 1) / kTile;
  const int tasks = R * tiles;
  for (int t = blockIdx.x * kWarps + (threadIdx.x >> 5); t < tasks; t += gridDim.x * kWarps) {
    const int ray = t / tiles;
    const int s0 = (t - ray * tiles) * kTile + lane;
    const ChartRay cr = chart_ray(o + (long long)ray * o_stride, d + (long long)ray * d_stride,
                                  lane);
    const float* zr = z + (long long)ray * z_stride;
    float zz[kSphereSamples];
#pragma unroll
    for (int k = 0; k < kSphereSamples; ++k)
      zz[k] = s0 + 32 * k < S ? __ldg(zr + s0 + 32 * k) : 0.0f;
    const long long row = (long long)ray * S;
#pragma unroll
    for (int k = 0; k < kSphereSamples; ++k) {
      const int s = s0 + 32 * k;
      if (s >= S) break;
      const float px = __fadd_rn(cr.ox, __fmul_rn(cr.dx, zz[k]));
      const float py = __fadd_rn(cr.oy, __fmul_rn(cr.dy, zz[k]));
      const float pz = __fadd_rn(cr.oz, __fmul_rn(cr.dz, zz[k]));
      const float dx = __fsub_rn(px, a.cx), dy = __fsub_rn(py, a.cy), dz = __fsub_rn(pz, a.cz);
      const float r = __fsqrt_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
      float4 c;
      c.x = chart_to_unit(sphere_normalize_r<kWalk>(r, a, l));
      c.y = chart_to_unit(__fmul_rn(__fsub_rn(sphere_acos(chart_q(dz, r)), a.near_t), a.inv_t));
      c.z = chart_to_unit(__fmul_rn(__fsub_rn(sphere_atan2(dy, dx), a.near_p), a.inv_p));
      c.w = 0.0f;
      out[row + s] = c;
      if (mask != nullptr)
        mask[row + s] = lo[0] <= px && px <= hi[0] && lo[1] <= py && py <= hi[1] &&
                        lo[2] <= pz && pz <= hi[2];
    }
  }
}

int grid_size(const void* fn, long long warps_needed, size_t smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kWarps * 32, smem);
  if (err != cudaSuccess) return (int)err;
  const long long need = (warps_needed + kWarps - 1) / kWarps;
  const long long most = (long long)sms * (per_sm > 0 ? min(per_sm, kBlocksPerSm) : 1);
  *blocks = (int)(need < most ? need : most);
  return (int)cudaSuccess;
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
  chart_kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      o, o_stride, d, d_stride, z, z_stride, R, S, a, grid, reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

// K7s: generic_sphere's chart, K7's chart arguments, then the bucket
// table (mode 0) and its walk bound, the aabb (6 floats on the card, lo
// then hi) and the mask (both null for coords alone)
extern "C" int chart_sphere_fwd(const float* o, long long o_stride, const float* d,
                                long long d_stride, const float* z, long long z_stride, int R,
                                int S, float cx, float cy, float cz, float near_t, float near_p,
                                float inv_r, float inv_t, float inv_p, int mode,
                                const float* grid, int n_grid, float inv_nr, float r0,
                                float inv_r0, float ratio, float inv_log_ratio,
                                const int* start, int n_bucket, float inv_w, int walk,
                                const float* box, float* out, unsigned char* mask,
                                void* stream) {
  const ChartArgs a{cx, cy, cz, near_t, near_p, inv_r, inv_t, inv_p, mode, n_grid, inv_nr,
                    r0, inv_r0, ratio, inv_log_ratio};
  if (a.mode == 0 && (a.n_grid < 2 || a.n_grid > kMaxChartGrid || n_bucket < 1 ||
                      n_bucket > kMaxChartGrid || walk < 0))
    return (int)cudaErrorInvalidValue;
  if ((mask == nullptr) != (box == nullptr)) return (int)cudaErrorInvalidValue;
  if (R <= 0 || S <= 0) return (int)cudaSuccess;
  constexpr int kTile = kSphereSamples * 32;
  const long long tasks = (long long)R * ((S + kTile - 1) / kTile);
  if (tasks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = a.mode == 0 ? sizeof(float) * (a.n_grid + 1 + n_bucket) : 0;
  auto kern = a.mode != 0 ? chart_sphere_kernel<-1>
              : walk <= 1 ? chart_sphere_kernel<1> : chart_sphere_kernel<0>;
  int blocks = 0;
  const int err = grid_size(reinterpret_cast<const void*>(kern), tasks, smem, &blocks);
  if (err) return err;
  kern<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      o, o_stride, d, d_stride, z, z_stride, R, S, a, grid, start, n_bucket, inv_w, box,
      reinterpret_cast<float4*>(out), mask);
  return (int)cudaGetLastError();
}
