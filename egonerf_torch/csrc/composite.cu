// K6: volume-rendering composite, forward; K6b: its backward.
//
// Replaces egonerf_tpu/ops/volrend.py raw2alpha + feature2density
// (models/egonerf.py:99-104) + the composite of EgoNeRF.forward
// (models/egonerf.py:466-493), with its envmap branch, and of
// TensorBase.forward (models/tensorf.py:226-258) with its two sample gates.
// JAX
// differentiates that composite with autodiff; the port's forward is a
// kernel that autograd cannot see through, so its backward is one too.
//
// Per ray of S samples: sigma = feature2density(feat); alpha =
// 1 - exp(-sigma * dist * scale); T the exclusive prefix product of
// (1 - alpha + 1e-10); weights = alpha * T; acc = sum(weights);
// bg = T_S, the product over the whole ray; with the envmap radiance env
// of the ray (JAX's "background is a last sample of alpha 1",
// models/egonerf.py:481-486) bg_map = T_S env, and rgb = clip(sum(weights *
// rgb) + bg_map, 0, 1), the clip after the blend; depth = sum(weights * z)
// + (1 - acc) * ray_dz.
//
// TensoRF's gates: with a valid mask (in the box and inside the alpha
// mask) sigma = where(valid, feature2density(feat), 0); with a threshold,
// rgb_j counts only where w_j > thres (ray_march_weight_thres; -inf, the
// default, passes every weight).  The gates are a template parameter: the
// ungated instantiation (EgoNeRF's) is the code, registers and time it was
// before the gates came in.  The gate decision must be the same bit in
// K6 and K6b, or K6b gives rgb a gradient the forward dropped: K6b
// recomputes each weight as K6 does, alpha_j times the exclusive
// transmittance from the same lane chunks, warp scan and __fmul_rn products
// (no saved mask), and the plain versions take the kernels' order
// (ops/volrend.py::_warp_transmittance).
//
// Backward of rgb only (depth is under stop_gradient in JAX, z and dists
// carry no gradient): with g the clip-masked d rgb (JAX's clip passes 1
// inside (0, 1) and 1/2 at exactly 0 or 1, taken on the blended sum) and
// q_j = rgb_j . g,
//   d rgb_j  = w_j g
//   R_j      = alpha_j q_j + (1 - alpha_j + 1e-10) R_{j+1},  R_S = env . g
//   d alpha_j = T_j (q_j - R_{j+1})
//   d feat_j = d alpha_j exp(-sigma_j d_j s) d_j s sigma'(feat_j)
//   d env    = T_S g.
// R_S is 0 without the envmap.  The reverse recurrence never divides by
// 1 - alpha + 1e-10, which reaches 1e-10 where alpha rounds to 1.  A sample
// the rgb gate drops has q_j = 0 and d rgb_j = 0; d feat_j = 0 where valid
// is false.
//
// Bound on the card: bytes (forward 6 x S floats read per ray, ~25 MB per
// 4096 x 256 chunk, ~7.5 us at 3.35 TB/s; backward 5 x S read and 4 x S
// written, ~38 MB).  Design: one warp per ray, each lane a contiguous chunk
// of samples; the transmittance is a local product then a warp scan of the
// chunk products; the sums are warp shuffle reductions.  The backward
// recomputes the forward scan (alpha and T in shared memory, and the
// unclipped sum for the clip mask), so the forward saves nothing; the
// reverse recurrence is affine per chunk, R_a = A + B R_b, and a suffix
// scan of the (A, B) maps across the lanes gives each chunk its R_b.
#include <cuda_runtime.h>

#include "warp_scan.cuh"

namespace {

using namespace egonerf;

constexpr int kWarpsPerBlock = 4;

// alpha of sample j: sigma = 0 where the valid mask (if any) is false.
__device__ __forceinline__ float gated_alpha(const float* feat, const float* dists,
                                             const unsigned char* valid, int j, float shift,
                                             float scale, int act) {
  const float sigma = (valid != nullptr && !valid[j]) ? 0.0f : density_act(feat[j], shift, act);
  return __fsub_rn(1.0f, expf(-__fmul_rn(sigma, __fmul_rn(dists[j], scale))));
}

template <bool kGates>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
composite_kernel(const float* __restrict__ feat, const float* __restrict__ dists,
                 const float* __restrict__ z, const float* __restrict__ rgb,
                 const float* __restrict__ ray_dz, const float* __restrict__ env,
                 const unsigned char* __restrict__ valid, int R, int S, float shift, float scale,
                 int act, float thres, float* __restrict__ rgb_out,
                 float* __restrict__ depth_out, float* __restrict__ acc_out,
                 float* __restrict__ bg_out, float* __restrict__ bg_map) {
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
  if (kGates && valid != nullptr) valid += ray * S;

  const int per = (S + 31) / 32;
  const int a = min(lane * per, S), b = min(a + per, S);
  float prod = 1.0f;
  for (int j = a; j < b; ++j) {
    const float alpha = kGates ? gated_alpha(feat, dists, valid, j, shift, scale, act)
                               : alpha_of(feat[j], dists[j], shift, scale, act);
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
    if (!kGates || wj > thres) {
      r += wj * rgb[3 * j];
      g += wj * rgb[3 * j + 1];
      bl += wj * rgb[3 * j + 2];
    }
    depth += wj * z[j];
  }
  acc = warp_sum(acc);
  r = warp_sum(r);
  g = warp_sum(g);
  bl = warp_sum(bl);
  depth = warp_sum(depth);
  if (lane == 0) {
    if (env != nullptr) {
      // the background: a last sample of alpha 1 behind transmittance T_S
      const float b0 = __fmul_rn(total, env[ray * 3]);
      const float b1 = __fmul_rn(total, env[ray * 3 + 1]);
      const float b2 = __fmul_rn(total, env[ray * 3 + 2]);
      bg_map[ray * 3] = b0;
      bg_map[ray * 3 + 1] = b1;
      bg_map[ray * 3 + 2] = b2;
      r = __fadd_rn(r, b0);
      g = __fadd_rn(g, b1);
      bl = __fadd_rn(bl, b2);
    }
    rgb_out[ray * 3] = fminf(fmaxf(r, 0.0f), 1.0f);
    rgb_out[ray * 3 + 1] = fminf(fmaxf(g, 0.0f), 1.0f);
    rgb_out[ray * 3 + 2] = fminf(fmaxf(bl, 0.0f), 1.0f);
    depth_out[ray] = depth + (1.0f - acc) * ray_dz[ray];
    acc_out[ray] = acc;
    bg_out[ray] = total;
  }
}

// d clip(x, 0, 1) / dx as JAX's jnp.clip (max then min) gives it.
__device__ __forceinline__ float clip_grad(float x) {
  if (x > 0.0f && x < 1.0f) return 1.0f;
  return (x == 0.0f || x == 1.0f) ? 0.5f : 0.0f;
}

template <bool kGates>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
composite_bwd_kernel(const float* __restrict__ feat, const float* __restrict__ dists,
                     const float* __restrict__ rgb, const float* __restrict__ g_rgb,
                     const float* __restrict__ env, const unsigned char* __restrict__ valid,
                     int R, int S, float shift, float scale, int act, float thres,
                     float* __restrict__ d_feat, float* __restrict__ d_rgb,
                     float* __restrict__ d_env) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * kWarpsPerBlock + warp;
  float* al = smem + warp * 2 * S;
  float* tr = al + S;
  if (ray >= R) return;
  feat += ray * S;
  dists += ray * S;
  rgb += ray * S * 3;
  d_feat += ray * S;
  d_rgb += ray * S * 3;
  if (kGates && valid != nullptr) valid += ray * S;

  // the forward scan: alpha, the exclusive transmittance, the unclipped sum
  const int per = (S + 31) / 32;
  const int a = min(lane * per, S), b = min(a + per, S);
  float prod = 1.0f;
  for (int j = a; j < b; ++j) {
    const float alpha = kGates ? gated_alpha(feat, dists, valid, j, shift, scale, act)
                               : alpha_of(feat[j], dists[j], shift, scale, act);
    al[j] = alpha;
    prod = __fmul_rn(prod, trans_factor(alpha));
  }
  float total;
  float t = warp_exclusive_prod(prod, &total);
  float r = 0.0f, g = 0.0f, bl = 0.0f;
  for (int j = a; j < b; ++j) {
    const float alpha = al[j];
    tr[j] = t;
    const float wj = __fmul_rn(alpha, t);
    t = __fmul_rn(t, trans_factor(alpha));
    if (!kGates || wj > thres) {
      r += wj * rgb[3 * j];
      g += wj * rgb[3 * j + 1];
      bl += wj * rgb[3 * j + 2];
    }
  }
  r = warp_sum(r);
  g = warp_sum(g);
  bl = warp_sum(bl);
  float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f;
  if (env != nullptr) {
    e0 = env[ray * 3];
    e1 = env[ray * 3 + 1];
    e2 = env[ray * 3 + 2];
    r = __fadd_rn(r, __fmul_rn(total, e0));
    g = __fadd_rn(g, __fmul_rn(total, e1));
    bl = __fadd_rn(bl, __fmul_rn(total, e2));
  }
  const float gr = g_rgb[ray * 3] * clip_grad(r);
  const float gg = g_rgb[ray * 3 + 1] * clip_grad(g);
  const float gb = g_rgb[ray * 3 + 2] * clip_grad(bl);
  // R after the last sample: the background's q (0 without the envmap)
  const float r_end = e0 * gr + e1 * gg + e2 * gb;
  if (env != nullptr && lane == 0) {
    d_env[ray * 3] = total * gr;
    d_env[ray * 3 + 1] = total * gg;
    d_env[ray * 3 + 2] = total * gb;
  }

  // this chunk's affine map R_a = A + B R_b, then a suffix scan over lanes
  float A = 0.0f, B = 1.0f;
  // the gate of sample j: K6's weight, the same product of the same bits
  auto kept = [&](int j) { return !kGates || __fmul_rn(al[j], tr[j]) > thres; };
  for (int j = b - 1; j >= a; --j) {
    const float q = kept(j) ? rgb[3 * j] * gr + rgb[3 * j + 1] * gg + rgb[3 * j + 2] * gb : 0.0f;
    const float f = trans_factor(al[j]);
    A = al[j] * q + f * A;
    B = f * B;
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float Ao = __shfl_down_sync(kFullMask, A, off);
    const float Bo = __shfl_down_sync(kFullMask, B, off);
    if (lane + off < 32) {
      A = A + B * Ao;
      B = B * Bo;
    }
  }
  // R after this chunk: the next lanes' composed map applied to r_end
  const float An = __shfl_down_sync(kFullMask, A, 1);
  const float Bn = __shfl_down_sync(kFullMask, B, 1);
  float Rn = lane == 31 ? r_end : An + Bn * r_end;

  for (int j = b - 1; j >= a; --j) {
    const float alpha = al[j], T = tr[j];
    const bool keep = kept(j);
    const float c0 = rgb[3 * j], c1 = rgb[3 * j + 1], c2 = rgb[3 * j + 2];
    const float q = keep ? c0 * gr + c1 * gg + c2 * gb : 0.0f;
    const float d_alpha = T * (q - Rn);
    Rn = alpha * q + trans_factor(alpha) * Rn;
    if (kGates && valid != nullptr && !valid[j]) {
      d_feat[j] = 0.0f;
    } else {
      const float f = feat[j];
      const float D = __fmul_rn(dists[j], scale);
      const float e = expf(-__fmul_rn(density_act(f, shift, act), D));
      d_feat[j] = d_alpha * e * D * density_act_grad(f, shift, act);
    }
    const float wj = keep ? alpha * T : 0.0f;
    d_rgb[3 * j] = wj * gr;
    d_rgb[3 * j + 1] = wj * gg;
    d_rgb[3 * j + 2] = wj * gb;
  }
}

// The gated instantiation where a valid mask or a threshold above -inf
// (which every weight passes) is given.
bool gated(const unsigned char* valid, float thres) { return valid != nullptr || thres > -1e30f; }

}  // namespace

extern "C" int composite_bwd(const float* feat, const float* dists, const float* rgb,
                             const float* g_rgb, const float* env, const unsigned char* valid,
                             int R, int S, float shift, float scale, int act, float thres,
                             float* d_feat, float* d_rgb, float* d_env, void* stream) {
  const size_t smem = sizeof(float) * kWarpsPerBlock * 2 * S;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gated(valid, thres)) {
    composite_bwd_kernel<true><<<blocks, kWarpsPerBlock * 32, smem, st>>>(
        feat, dists, rgb, g_rgb, env, valid, R, S, shift, scale, act, thres, d_feat, d_rgb, d_env);
  } else {
    composite_bwd_kernel<false><<<blocks, kWarpsPerBlock * 32, smem, st>>>(
        feat, dists, rgb, g_rgb, env, valid, R, S, shift, scale, act, thres, d_feat, d_rgb, d_env);
  }
  return (int)cudaGetLastError();
}

extern "C" int composite_fwd(const float* feat, const float* dists, const float* z,
                             const float* rgb, const float* ray_dz, const float* env,
                             const unsigned char* valid, int R, int S, float shift, float scale,
                             int act, float thres, float* rgb_out,
                             float* depth_out, float* acc_out, float* bg_out, float* bg_map,
                             void* stream) {
  const size_t smem = sizeof(float) * kWarpsPerBlock * S;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gated(valid, thres)) {
    composite_kernel<true><<<blocks, kWarpsPerBlock * 32, smem, st>>>(
        feat, dists, z, rgb, ray_dz, env, valid, R, S, shift, scale, act, thres, rgb_out,
        depth_out, acc_out, bg_out, bg_map);
  } else {
    composite_kernel<false><<<blocks, kWarpsPerBlock * 32, smem, st>>>(
        feat, dists, z, rgb, ray_dz, env, valid, R, S, shift, scale, act, thres, rgb_out,
        depth_out, acc_out, bg_out, bg_map);
  }
  return (int)cudaGetLastError();
}
