// The environment map's lookup, shared by K8 and K8b (csrc/envmap.cu) and
// by the composite's envmap instantiation K6e (csrc/composite.cu): the view
// direction to canonical (u, v) = ((z + 1) / 2, (atan2(y, x) + pi) / 2pi)
// of the unit direction, mapped to [-1, 1]; the four corners of a bilinear
// lookup of the channel-last (2h, h, 3) table with x = u over W = h and
// y = v over H = 2h, align_corners and zero padding; and the weighted sum
// of their texels with its sigmoid.
//
// Every step is rounded on its own (__f*_rn), in the order of the plain
// version (egonerf_torch/ops/envmap.py), so nvcc contracts nothing into an
// FMA: the corners, weights and radiance of every includer and of the plain
// version are the same bits.  A corner off the table (v = 1 at atan2 = pi:
// the seam is zero padding, not a wrap; u = 1 at z = 1) has weight 0 and
// reads or writes the clipped index, as the JAX gather does.
#pragma once

#include <cuda_runtime.h>

namespace egonerf {

// Python's pi, as the plain version adds it
constexpr float kEnvPi = (float)3.141592653589793;

struct Corners {
  int idx[4];    // flat texel index (y * W + x), clipped to the table
  float w[4];    // bilinear weight, 0 where the corner is off the table
};

// _corner of grid_sample.py: [-1, 1] -> pixel space with align_corners
__device__ __forceinline__ void corner(float coord, int size, int* i0, int* i1, float* t,
                                       bool* v0, bool* v1) {
  const float p = __fmul_rn(__fmul_rn(__fadd_rn(coord, 1.0f), 0.5f), (float)(size - 1));
  const float f = floorf(p);
  *t = __fsub_rn(p, f);
  const int a = (int)f;
  *v0 = a >= 0 && a <= size - 1;
  *v1 = a + 1 >= 0 && a + 1 <= size - 1;
  *i0 = min(max(a, 0), size - 1);
  *i1 = min(max(a + 1, 0), size - 1);
}

__device__ __forceinline__ Corners corners_of(const float* dir, int h, float inv_2pi) {
  const float x = dir[0], y = dir[1], z = dir[2];
  const float norm =
      __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)));
  const float xn = __fdiv_rn(x, norm), yn = __fdiv_rn(y, norm), zn = __fdiv_rn(z, norm);
  const float u = __fmul_rn(__fadd_rn(zn, 1.0f), 0.5f);
  const float v = __fmul_rn(__fadd_rn(atan2f(yn, xn), kEnvPi), inv_2pi);
  const float gx = __fsub_rn(__fmul_rn(u, 2.0f), 1.0f);
  const float gy = __fsub_rn(__fmul_rn(v, 2.0f), 1.0f);
  const int W = h, H = 2 * h;
  int x0, x1, y0, y1;
  float tx, ty;
  bool vx0, vx1, vy0, vy1;
  corner(gx, W, &x0, &x1, &tx, &vx0, &vx1);
  corner(gy, H, &y0, &y1, &ty, &vy0, &vy1);
  const float ax = __fsub_rn(1.0f, tx), ay = __fsub_rn(1.0f, ty);
  Corners c;
  c.idx[0] = y0 * W + x0;
  c.idx[1] = y0 * W + x1;
  c.idx[2] = y1 * W + x0;
  c.idx[3] = y1 * W + x1;
  c.w[0] = (vy0 && vx0) ? __fmul_rn(ay, ax) : 0.0f;
  c.w[1] = (vy0 && vx1) ? __fmul_rn(ay, tx) : 0.0f;
  c.w[2] = (vy1 && vx0) ? __fmul_rn(ty, ax) : 0.0f;
  c.w[3] = (vy1 && vx1) ? __fmul_rn(ty, tx) : 0.0f;
  return c;
}

// The 12 texel values of a ray's four corners, corner-major: tex[3 k + ch].
// Issued together, so that a caller can load them early and use them late.
__device__ __forceinline__ void load_texels(const float* __restrict__ table, const Corners& c,
                                            float* tex) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) tex[3 * k + ch] = __ldg(table + 3 * c.idx[k] + ch);
  }
}

// Channel ch of the radiance: the corners' weighted sum in corner order,
// then the sigmoid.
__device__ __forceinline__ float envmap_channel(const float* tex, const Corners& c, int ch) {
  float acc = __fmul_rn(tex[ch], c.w[0]);
  acc = __fadd_rn(acc, __fmul_rn(tex[3 + ch], c.w[1]));
  acc = __fadd_rn(acc, __fmul_rn(tex[6 + ch], c.w[2]));
  acc = __fadd_rn(acc, __fmul_rn(tex[9 + ch], c.w[3]));
  return 1.0f / (1.0f + expf(-acc));
}

}  // namespace egonerf
