// The yin-yang chart and its normalization of one sample, shared by the
// standalone chart kernel K7 (chart.cu) and K4's fused epilogue
// (resample.cu), so that both write the same coords bit for bit; K7s
// (chart.cu), generic_sphere's single sphere, takes its pieces.
//
// In the order of the plain version (egonerf_torch/ops/chart.py), every
// step rounded on its own (__f*_rn, so nvcc contracts nothing into an
// FMA): diff = (o + d z) - center; r = sqrt((dx dx + dy dy) + dz dz); the
// yin angles acos(dz / r), atan2(dy, dx), yin when both lie in their
// closed ranges [pi/4, 3pi/4] x [-3pi/4, 3pi/4]; else the yang angles
// acos(dy / r), atan2(dz, -dx) and the flag 1.  Away from the boundaries
// the test reads dz / r and dx + |dy| instead of the yin angles, so a
// sample takes one acos and one atan2.  Then each of r, theta, phi
// maps to [-1, 1].  K7's and K4's radial lookup is searchsorted(grid, r,
// right) by a binary search over the grid the caller keeps in shared
// memory (K7s finds the same cell from a bucket table, chart.cu); where
// torch divides a tensor by a Python number on the card it multiplies by
// the float32 reciprocal, and the kernels take the same reciprocals from
// the wrappers.
#pragma once

#include <cuda_runtime.h>

namespace egonerf {

// radial grid entries a block stages in shared memory
constexpr int kMaxChartGrid = 4096;

// Python's pi / 4 and 3 pi / 4 in double, then rounded to float32, as
// torch compares a float32 tensor with a Python number
constexpr double kChartPi = 3.141592653589793;
constexpr float kChartLo = (float)(kChartPi / 4.0);
constexpr float kChartHi = (float)(3.0 * kChartPi / 4.0);
constexpr float kChartPhiLo = (float)(-3.0 * kChartPi / 4.0);
constexpr float kChartPhiHi = (float)(3.0 * kChartPi / 4.0);

struct ChartArgs {
  float cx, cy, cz;           // chart centre
  float near_t, near_p;       // theta and phi lower bounds
  float inv_r, inv_t, inv_p;  // 1 / (far - near) per axis
  int mode;                   // 0 radial grid lookup, 1 closed-form exp, 2 linear
  int n_grid;                 // entries of the radial grid (mode 0)
  float inv_nr;               // float32(1 / n_r)
  float r0, inv_r0;           // exp cells: r0 and float32(1 / r0)
  float ratio, inv_log_ratio;
};

// num / r clamped to [-1, 1], 0 at r = 0: the argument of acos
__device__ __forceinline__ float chart_q(float num, float r) {
  const float q = r > 0.0f ? __fdiv_rn(num, fmaxf(r, 1e-12f)) : 0.0f;
  return fminf(fmaxf(q, -1.0f), 1.0f);
}

// |dz / r| below kChartQIn puts theta_n 1.4e-5 rad or more inside
// [pi/4, 3pi/4], above kChartQOut as far outside; (dx + |dy|) beyond
// kChartPhiMargin (|dx| + |dy|) puts phi_n 1e-5 rad or more inside or
// outside [-3pi/4, 3pi/4].  acosf and atan2f err by a few ulps (< 1e-6
// rad), so there the yin test needs neither.
constexpr float kChartQIn = 0.70709678f;
constexpr float kChartQOut = 0.70711678f;
constexpr float kChartPhiMargin = 1e-5f;

// normalize_r_lookup of the radius r in the cell of hi = searchsorted(grid,
// r, right=True), clamped here to [1, n_r]
__device__ __forceinline__ float chart_cell_lerp(float r, int hi, const ChartArgs& a,
                                                 const float* grid) {
  const int n_r = a.n_grid - 1;
  hi = min(max(hi, 1), n_r);
  const int lo = hi - 1;
  const float g_lo = grid[lo], g_hi = grid[hi];
  const float t = __fdiv_rn(__fsub_rn(r, g_lo), __fsub_rn(g_hi, g_lo));
  return __fmul_rn(__fadd_rn((float)lo, t), a.inv_nr);
}

// normalize_r in [0, 1] of the radius r
__device__ __forceinline__ float chart_normalize_r(float r, const ChartArgs& a,
                                                   const float* grid) {
  if (a.mode == 0) {
    int lo_i = 0, hi_i = a.n_grid;  // first index with grid[i] > r in [lo_i, hi_i]
    while (lo_i < hi_i) {
      const int mid = (lo_i + hi_i) >> 1;
      if (grid[mid] <= r) lo_i = mid + 1; else hi_i = mid;
    }
    return chart_cell_lerp(r, lo_i, a, grid);
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

__device__ __forceinline__ float chart_to_unit(float x) {
  return __fsub_rn(__fmul_rn(x, 2.0f), 1.0f);
}

// The normalized [r, theta, phi, flag] of the point o + d z.
__device__ __forceinline__ float4 chart_point(float ox, float oy, float oz, float ddx,
                                              float ddy, float ddz, float zz,
                                              const ChartArgs& a, const float* grid) {
  const float dx = __fsub_rn(__fadd_rn(ox, __fmul_rn(ddx, zz)), a.cx);
  const float dy = __fsub_rn(__fadd_rn(oy, __fmul_rn(ddy, zz)), a.cy);
  const float dz = __fsub_rn(__fadd_rn(oz, __fmul_rn(ddz, zz)), a.cz);
  const float r = __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));

  // the yin test: from dz / r and dx + |dy| away from the chart boundaries,
  // else from the yin angles themselves; then one acos and one atan2 of
  // the chosen frame (the same calls on the same arguments as the angles
  // the test would have taken)
  const float qz = chart_q(dz, r);
  const float aq = fabsf(qz), span = __fadd_rn(fabsf(dx), fabsf(dy));
  const float side = __fadd_rn(dx, fabsf(dy));
  bool yin;
  if (aq > kChartQOut) {
    yin = false;
  } else if (aq < kChartQIn && side > __fmul_rn(kChartPhiMargin, span)) {
    yin = true;
  } else if (aq < kChartQIn && side < -__fmul_rn(kChartPhiMargin, span)) {
    yin = false;
  } else {
    const float theta_n = acosf(qz), phi_n = atan2f(dy, dx);
    yin = kChartLo <= theta_n && theta_n <= kChartHi && kChartPhiLo <= phi_n &&
          phi_n <= kChartPhiHi;
  }
  const float theta = acosf(yin ? qz : chart_q(dy, r));
  const float phi = atan2f(yin ? dy : dz, yin ? dx : -dx);

  float4 c;
  c.x = chart_to_unit(chart_normalize_r(r, a, grid));
  c.y = chart_to_unit(__fmul_rn(__fsub_rn(theta, a.near_t), a.inv_t));
  c.z = chart_to_unit(__fmul_rn(__fsub_rn(phi, a.near_p), a.inv_p));
  c.w = yin ? 0.0f : 1.0f;
  return c;
}

// The ray's origin and direction, read once by lanes 0-5 of the warp and
// handed to every lane.
struct ChartRay {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ ChartRay chart_ray(const float* o, const float* d, int lane) {
  const float v = lane < 3 ? o[lane] : lane < 6 ? d[lane - 3] : 0.0f;
  ChartRay ray;
  ray.ox = __shfl_sync(0xffffffffu, v, 0);
  ray.oy = __shfl_sync(0xffffffffu, v, 1);
  ray.oz = __shfl_sync(0xffffffffu, v, 2);
  ray.dx = __shfl_sync(0xffffffffu, v, 3);
  ray.dy = __shfl_sync(0xffffffffu, v, 4);
  ray.dz = __shfl_sync(0xffffffffu, v, 5);
  return ray;
}

// The radial grid into shared memory, by every thread of the block; the
// caller syncs the block before the first lookup.
__device__ __forceinline__ void chart_stage_grid(const ChartArgs& a, const float* grid_g,
                                                 float* grid_s) {
  if (a.mode == 0)
    for (int i = threadIdx.x; i < a.n_grid; i += blockDim.x) grid_s[i] = grid_g[i];
}

}  // namespace egonerf
