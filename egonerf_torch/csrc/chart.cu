// K7: the chart and normalization prologue of every field lookup.
//
// Replaces the yin-yang chart and its normalization as the JAX forward
// runs them on every sample: xyz = o + d z; from_cartesian
// (egonerf_tpu/coords/yinyang.py:47-66) and normalize_coord
// (coords/yinyang.py:68-76) with normalize_r, either the interval_th
// lookup on the radial grid (coords/expgrid.py:89-113, whose masked
// min/max bracketing replaces searchsorted to spare the TPU its gathers)
// or the closed-form exponential cells (coords/expgrid.py:116-130).
//
// Per sample, in the order of the plain version (egonerf_torch/ops/chart.py),
// every step rounded on its own (__f*_rn, so nvcc contracts nothing into
// an FMA): diff = (o + d z) - center; r = sqrt((dx dx + dy dy) + dz dz);
// the yin angles acos(dz / r), atan2(dy, dx), yin when both lie in their
// closed ranges [pi/4, 3pi/4] x [-3pi/4, 3pi/4]; else the yang angles
// acos(dy / r), atan2(dz, -dx) and the flag 1.  Then each of r, theta, phi
// maps to [-1, 1].  The radial lookup is searchsorted(grid, r, right) by a
// binary search over the grid kept in shared memory; where torch divides a
// tensor by a Python number on the card it multiplies by the float32
// reciprocal, and the kernel takes the same reciprocals from the wrapper.
//
// Bound on the card: bytes (a 4096 x 256 chunk writes 16.8 MB of float4
// coords, ~5 us at 3.35 TB/s; ~170 float32 operations per sample for two
// acos, two atan2 and the rest is ~2.6 us at 67 TFLOP/s).  Design: one
// thread per sample, one float4 store each; the ray's origin and
// direction come through L1; the radial grid (<= 4096 entries) is staged
// in shared memory once per block.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 4096;

// Python's pi / 4 and 3 pi / 4 in double, then rounded to float32, as
// torch compares a float32 tensor with a Python number
constexpr double kPi = 3.141592653589793;
constexpr float kLo = (float)(kPi / 4.0);
constexpr float kHi = (float)(3.0 * kPi / 4.0);
constexpr float kPhiLo = (float)(-3.0 * kPi / 4.0);
constexpr float kPhiHi = (float)(3.0 * kPi / 4.0);

struct ChartArgs {
  float cx, cy, cz;        // chart centre
  float near_t, near_p;    // theta and phi lower bounds
  float inv_r, inv_t, inv_p;  // 1 / (far - near) per axis
  int mode;                // 0 radial grid lookup, 1 closed-form exp, 2 linear
  int n_grid;              // entries of the radial grid (mode 0)
  float inv_nr;            // float32(1 / n_r)
  float r0, inv_r0;        // exp cells: r0 and float32(1 / r0)
  float ratio, inv_log_ratio;
};

// acos(num / r) with r = 0 -> acos(0), ratio clamped to [-1, 1]
__device__ __forceinline__ float safe_acos(float num, float r) {
  float q = r > 0.0f ? __fdiv_rn(num, fmaxf(r, 1e-12f)) : 0.0f;
  q = fminf(fmaxf(q, -1.0f), 1.0f);
  return acosf(q);
}

// normalize_r in [0, 1] of the radius r
__device__ __forceinline__ float normalize_r(float r, const ChartArgs& a, const float* grid) {
  if (a.mode == 0) {
    // hi = searchsorted(grid, r, right=True) clamped to [1, n_r]
    int lo_i = 0, hi_i = a.n_grid;  // first index with grid[i] > r in [lo_i, hi_i]
    while (lo_i < hi_i) {
      const int mid = (lo_i + hi_i) >> 1;
      if (grid[mid] <= r) lo_i = mid + 1; else hi_i = mid;
    }
    const int n_r = a.n_grid - 1;
    const int hi = min(max(lo_i, 1), n_r);
    const int lo = hi - 1;
    const float g_lo = grid[lo], g_hi = grid[hi];
    const float t = __fdiv_rn(__fsub_rn(r, g_lo), __fsub_rn(g_hi, g_lo));
    return __fmul_rn(__fadd_rn((float)lo, t), a.inv_nr);
  }
  if (a.mode == 1) {
    const float safe_r = fmaxf(r, 1e-12f);
    const float kq = __fmul_rn(logf(__fmul_rn(safe_r, a.inv_r0)), a.inv_log_ratio);
    const float kf = (float)(int)kq;  // truncation, as .to(torch.int32)
    const bool below = r < a.r0;
    const float r_in = below ? 0.0f : __fmul_rn(a.r0, powf(a.ratio, kf));
    const float r_out = below ? a.r0 : __fmul_rn(a.r0, powf(a.ratio, __fadd_rn(kf, 1.0f)));
    const float t = __fdiv_rn(__fsub_rn(r, r_in), __fsub_rn(r_out, r_in));
    const float norm = below ? __fmul_rn(r, a.inv_r0) : __fadd_rn(__fadd_rn(1.0f, kf), t);
    return __fmul_rn(norm, a.inv_nr);
  }
  return __fmul_rn(r, a.inv_r);
}

__device__ __forceinline__ float to_unit(float x) {
  return __fsub_rn(__fmul_rn(x, 2.0f), 1.0f);
}

__global__ void __launch_bounds__(kThreads)
chart_kernel(const float* __restrict__ o, long long o_stride, const float* __restrict__ d,
             long long d_stride, const float* __restrict__ z, long long z_stride, int S,
             long long n, ChartArgs a, const float* __restrict__ grid_g,
             float4* __restrict__ out) {
  __shared__ float grid[kMaxGrid];
  if (a.mode == 0) {
    for (int i = threadIdx.x; i < a.n_grid; i += blockDim.x) grid[i] = grid_g[i];
    __syncthreads();
  }
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long ray = i / S;
  const int s = (int)(i - ray * S);
  const float* po = o + ray * o_stride;
  const float* pd = d + ray * d_stride;
  const float zz = z[ray * z_stride + s];
  const float dx = __fsub_rn(__fadd_rn(po[0], __fmul_rn(pd[0], zz)), a.cx);
  const float dy = __fsub_rn(__fadd_rn(po[1], __fmul_rn(pd[1], zz)), a.cy);
  const float dz = __fsub_rn(__fadd_rn(po[2], __fmul_rn(pd[2], zz)), a.cz);
  const float r = __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));

  const float theta_n = safe_acos(dz, r);
  const float phi_n = atan2f(dy, dx);
  const bool yin = kLo <= theta_n && theta_n <= kHi && kPhiLo <= phi_n && phi_n <= kPhiHi;
  const float theta = yin ? theta_n : safe_acos(dy, r);
  const float phi = yin ? phi_n : atan2f(dz, -dx);

  float4 c;
  c.x = to_unit(normalize_r(r, a, grid));
  c.y = to_unit(__fmul_rn(__fsub_rn(theta, a.near_t), a.inv_t));
  c.z = to_unit(__fmul_rn(__fsub_rn(phi, a.near_p), a.inv_p));
  c.w = yin ? 0.0f : 1.0f;
  out[i] = c;
}

}  // namespace

extern "C" int chart_fwd(const float* o, long long o_stride, const float* d, long long d_stride,
                         const float* z, long long z_stride, int R, int S, float cx, float cy,
                         float cz, float near_t, float near_p, float inv_r, float inv_t,
                         float inv_p, int mode, const float* grid, int n_grid, float inv_nr,
                         float r0, float inv_r0, float ratio, float inv_log_ratio, float* out,
                         void* stream) {
  if (mode == 0 && (n_grid < 2 || n_grid > kMaxGrid)) return (int)cudaErrorInvalidValue;
  const ChartArgs a{cx, cy, cz, near_t, near_p, inv_r, inv_t, inv_p, mode, n_grid, inv_nr,
                    r0, inv_r0, ratio, inv_log_ratio};
  const long long n = (long long)R * S;
  const long long blocks = (n + kThreads - 1) / kThreads;
  chart_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      o, o_stride, d, d_stride, z, z_stride, S, n, a, grid, reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}
