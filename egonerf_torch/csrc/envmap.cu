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
// Every step is rounded on its own (__f*_rn), in the order of the plain
// version (egonerf_torch/ops/envmap.py), so nvcc contracts nothing into an
// FMA: the corners and weights of the kernel and of the plain version are
// the same bits.  A corner off the table (v = 1 at atan2 = pi: the seam is
// zero padding, not a wrap; u = 1 at z = 1) has weight 0 and reads or
// writes the clipped index, as the JAX gather does.
//
// Bound on the card: bytes.  Forward, per ray 12 bytes of direction, four
// 12-byte texels and 12 bytes out (~0.3 MB per 4096-ray batch, under a
// microsecond); backward, the zeroed (2h, h, 3) gradient (24 MB at
// h = 1000, ~7 us at 3.35 TB/s) dominates, which the wrapper allocates.
// Design: one thread per ray; the texels of a ray are 12-byte rows read
// through L1/L2; atomics spread over the table (rays of a batch rarely
// share a texel).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr double kPi = 3.141592653589793;
// Python's pi and float32(1 / float32(2 pi)), as the plain version uses them
constexpr float kPiF = (float)kPi;

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
  const float v = __fmul_rn(__fadd_rn(atan2f(yn, xn), kPiF), inv_2pi);
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

__global__ void __launch_bounds__(kThreads)
envmap_kernel(const float* __restrict__ dirs, long long d_stride,
              const float* __restrict__ table, int h, int R, float inv_2pi,
              float* __restrict__ out) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= R) return;
  const Corners c = corners_of(dirs + (long long)ray * d_stride, h, inv_2pi);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = __fmul_rn(table[3 * c.idx[0] + ch], c.w[0]);
    acc = __fadd_rn(acc, __fmul_rn(table[3 * c.idx[1] + ch], c.w[1]));
    acc = __fadd_rn(acc, __fmul_rn(table[3 * c.idx[2] + ch], c.w[2]));
    acc = __fadd_rn(acc, __fmul_rn(table[3 * c.idx[3] + ch], c.w[3]));
    out[3 * ray + ch] = 1.0f / (1.0f + expf(-acc));
  }
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
