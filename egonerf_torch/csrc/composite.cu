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
// Training with the entropy loss (ray_entropy, egonerf_tpu/ops/volrend.py:27)
// asks for each sample's alpha too: K6's training instantiation (kAlpha, in
// every form: plain, gated, with a given env and K6e) writes alpha (R, S)
// beside its other outputs, from the shared array it already keeps, one
// coalesced row a warp after the scan; K6b's (kDAlpha) takes its cotangent
// d_alpha (R, S) and adds it into d alpha_j before the chain to d feat_j.
// Both are template parameters, so the default instantiations are the code
// they were; d feat_j stays 0 where valid is false.
//
// K6e, the envmap instantiation of K6, takes each ray's view direction and
// the (2h, h, 3) table in place of env and computes env with K8's code
// (csrc/envmap.cuh), so it is K8's to the bit; it writes env beside bg_map
// (K8b reads it in the step).  Its twelve texel loads are issued when the
// warp starts and used after the sample loop, so their latency hides behind
// it.  The rest of K6 (the blend, the clip, every output) is unchanged.
//
// Bound on the card: bytes (forward 6 x S floats read per ray, ~25 MB per
// 4096 x 256 chunk, ~7.5 us at 3.35 TB/s; backward 5 x S read and 4 x S
// written, ~38 MB).  Design: one warp per ray, each lane a contiguous chunk
// of samples; the transmittance is a local product then a warp scan of the
// chunk products; the sums are warp shuffle reductions.  The backward
// recomputes the forward scan (alpha and T, and the unclipped sum for the
// clip mask), so the forward saves nothing; the reverse recurrence is affine
// per chunk, R_a = A + B R_b, and a suffix scan of the (A, B) maps across
// the lanes gives each chunk its R_b.
//
// K6b stages a ray's rows in shared memory first: feat, dists * scale and
// rgb (as three planes) with coalesced 16-byte loads; each lane keeps its
// chunk's valid bits in a register.  Every pass reads them there: the scan
// stores exp(-sigma D) (alpha is 1 minus it, the bits K6 takes, and d feat
// needs it again), T, and q_j in place of the red plane; the last pass
// writes d feat over feat and d rgb over the planes, and the rows go out as
// coalesced 16-byte stores.  A lane walks its own chunk, so the arrays are
// swizzled (word i at i ^ ((i / 32) % 32)): the 32 lanes' words of one step
// of their chunks sit in 32 banks for chunks of 1, 2, 4, 8 or 16 samples.
// The arithmetic and its order are those of the unstaged form (every pass
// reading global memory), each product and sum written as an intrinsic in
// the contraction nvcc gave that form, so staging changed no output bit.
// Warps a block: the most resident warps for the ray's shared bytes, by
// the occupancy calculator in the entry (bwd_layout), above 48 KB by the
// dynamic opt-in.
#include <cuda_runtime.h>

#include <cstdint>

#include "envmap.cuh"
#include "warp_scan.cuh"

namespace {

using namespace egonerf;

constexpr int kWarpsPerBlock = 4;
// K6b: at most 8 warps a block, 64 registers a thread, so 32 warps an SM
constexpr int kBwdMaxWarps = 8;

// alpha of sample j: sigma = 0 where the valid mask (if any) is false.
__device__ __forceinline__ float gated_alpha(const float* feat, const float* dists,
                                             const unsigned char* valid, int j, float shift,
                                             float scale, int act) {
  const float sigma = (valid != nullptr && !valid[j]) ? 0.0f : density_act(feat[j], shift, act);
  return __fsub_rn(1.0f, expf(-__fmul_rn(sigma, __fmul_rn(dists[j], scale))));
}

// K6e's envmap: the rays' view directions (a row stride, the (R, 6) rays'
// columns 3:6), the (2h, h, 3) table, float32(1 / 2pi) and env's output.
struct Envmap {
  const float* dirs;
  long long d_stride;
  const float* table;
  int h;
  float inv_2pi;
  float* env_out;
};

template <bool kGates, bool kEnvmap, bool kAlpha>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
composite_kernel(const float* __restrict__ feat, const float* __restrict__ dists,
                 const float* __restrict__ z, const float* __restrict__ rgb,
                 const float* __restrict__ ray_dz, const float* __restrict__ env,
                 const unsigned char* __restrict__ valid, Envmap em, int R, int S, float shift,
                 float scale, int act, float thres, float* __restrict__ rgb_out,
                 float* __restrict__ depth_out, float* __restrict__ acc_out,
                 float* __restrict__ bg_out, float* __restrict__ bg_map,
                 float* __restrict__ alpha_out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * kWarpsPerBlock + warp;
  float* al = smem + warp * S;
  if (ray >= R) return;
  // K6e: the lookup's texels, in flight while the samples are summed
  Corners corners;
  float tex[12];
  if constexpr (kEnvmap) {
    corners = corners_of(em.dirs + ray * em.d_stride, em.h, em.inv_2pi);
    load_texels(em.table, corners, tex);
  }
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
  if constexpr (kAlpha) {
    // the lanes' chunks of al out as one row, lane-strided (coalesced)
    __syncwarp();
    float* ao = alpha_out + ray * S;
    for (int i = lane; i < S; i += 32) ao[i] = al[i];
  }
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
    float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f;
    if constexpr (kEnvmap) {
      e0 = envmap_channel(tex, corners, 0);
      e1 = envmap_channel(tex, corners, 1);
      e2 = envmap_channel(tex, corners, 2);
      em.env_out[ray * 3] = e0;
      em.env_out[ray * 3 + 1] = e1;
      em.env_out[ray * 3 + 2] = e2;
    } else if (env != nullptr) {
      e0 = env[ray * 3];
      e1 = env[ray * 3 + 1];
      e2 = env[ray * 3 + 2];
    }
    if (kEnvmap || env != nullptr) {
      // the background: a last sample of alpha 1 behind transmittance T_S
      const float b0 = __fmul_rn(total, e0);
      const float b1 = __fmul_rn(total, e1);
      const float b2 = __fmul_rn(total, e2);
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

// q = c . g in a fixed contraction, fma(c2, g2, fma(c0, g0, c1 g1)), the one
// nvcc gave the unstaged form.  The backward's products and sums are all
// written as intrinsics in that form's contraction (which differed between
// two passes for the same expression), so no compiler choice moves a bit.
__device__ __forceinline__ float rgb_dot(float c0, float c1, float c2, float g0, float g1,
                                         float g2) {
  return __fmaf_rn(c2, g2, __fmaf_rn(c0, g0, __fmul_rn(c1, g1)));
}

// Word i of a staged array: swizzled within its row of 32 words.
__device__ __forceinline__ int sw(int i) { return i ^ ((i >> 5) & 31); }

// K6b's shared bytes a warp: seven float arrays of 32 per words (feat,
// D = dists * scale, exp(-sigma D), T, three rgb planes).
__host__ __device__ constexpr int bwd_warp_bytes(int S) { return 7 * 4 * 32 * ((S + 31) / 32); }

// x, or with kScale x * scale rounded as raw2alpha rounds dists * scale.
template <bool kScale>
__device__ __forceinline__ float scaled(float x, float scale) {
  return kScale ? __fmul_rn(x, scale) : x;
}

// A row of n floats into a swizzled array (with kScale, each times
// ``scale``); 16-byte loads where the row allows them.
template <bool kScale>
__device__ __forceinline__ void stage_row(const float* __restrict__ src, int n, float scale,
                                          float* dst, int lane) {
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = 4 * lane; i < n; i += 128) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + i));
      dst[sw(i)] = scaled<kScale>(v.x, scale);
      dst[sw(i + 1)] = scaled<kScale>(v.y, scale);
      dst[sw(i + 2)] = scaled<kScale>(v.z, scale);
      dst[sw(i + 3)] = scaled<kScale>(v.w, scale);
    }
  } else {
    for (int i = lane; i < n; i += 32) dst[sw(i)] = scaled<kScale>(__ldg(src + i), scale);
  }
}

// A row of S rgb triples into three swizzled planes P apart.
__device__ __forceinline__ void stage_rgb(const float* __restrict__ src, int S, float* dst,
                                          int P, int lane) {
  const int n = 3 * S;
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = 4 * lane; i < n; i += 128) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + i));
      const float x[4] = {v.x, v.y, v.z, v.w};
      int j = i / 3, ch = i - 3 * j;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dst[ch * P + sw(j)] = x[q];
        if (++ch == 3) ch = 0, ++j;
      }
    }
  } else {
    for (int i = lane; i < n; i += 32) {
      const int j = i / 3;
      dst[(i - 3 * j) * P + sw(j)] = __ldg(src + i);
    }
  }
}

// A swizzled array out as a row of n floats.
__device__ __forceinline__ void store_row(const float* src, int n, float* __restrict__ dst,
                                          int lane) {
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int i = 4 * lane; i < n; i += 128)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(src[sw(i)], src[sw(i + 1)], src[sw(i + 2)], src[sw(i + 3)]);
  } else {
    for (int i = lane; i < n; i += 32) dst[i] = src[sw(i)];
  }
}

// Three swizzled planes P apart out as a row of S triples.
__device__ __forceinline__ void store_rgb(const float* src, int S, int P,
                                          float* __restrict__ dst, int lane) {
  const int n = 3 * S;
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int i = 4 * lane; i < n; i += 128) {
      float x[4];
      int j = i / 3, ch = i - 3 * j;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x[q] = src[ch * P + sw(j)];
        if (++ch == 3) ch = 0, ++j;
      }
      *reinterpret_cast<float4*>(dst + i) = make_float4(x[0], x[1], x[2], x[3]);
    }
  } else {
    for (int i = lane; i < n; i += 32) {
      const int j = i / 3;
      dst[i] = src[(i - 3 * j) * P + sw(j)];
    }
  }
}

template <bool kGates, bool kDAlpha>
__global__ void __launch_bounds__(kBwdMaxWarps * 32, 4)
composite_bwd_kernel(const float* __restrict__ feat, const float* __restrict__ dists,
                     const float* __restrict__ rgb, const float* __restrict__ g_rgb,
                     const float* __restrict__ env, const unsigned char* __restrict__ valid,
                     const float* __restrict__ g_alpha, int R, int S, float shift, float scale,
                     int act, float thres, float* __restrict__ d_feat,
                     float* __restrict__ d_rgb, float* __restrict__ d_env) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (ray >= R) return;
  const int per = (S + 31) / 32;
  const int P = 32 * per;
  float* f = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + warp * bwd_warp_bytes(S));
  float* D = f + P;
  float* ex = D + P;
  float* tr = ex + P;
  float* c0 = tr + P;  // rgb planes; q in the first after the third pass
  float* c1 = c0 + P;
  float* c2 = c1 + P;
  const bool has_valid = kGates && valid != nullptr;

  // the ray's rows, staged once; each lane keeps its chunk's valid bits
  // (at most 48) in a register
  const int a = min(lane * per, S), b = min(a + per, S);
  stage_row<false>(feat + ray * S, S, scale, f, lane);
  stage_row<true>(dists + ray * S, S, scale, D, lane);
  stage_rgb(rgb + ray * S * 3, S, c0, P, lane);
  unsigned long long vbits = ~0ull;
  if (has_valid) {
    vbits = 0;
    for (int j = a; j < b; ++j) vbits |= (unsigned long long)(valid[ray * S + j] != 0) << (j - a);
  }
  __syncwarp();

  // the forward scan: exp(-sigma D), the exclusive transmittance, the
  // unclipped sum
  float prod = 1.0f;
  for (int j = a; j < b; ++j) {
    const int p = sw(j);
    const bool ok = (vbits >> (j - a)) & 1;
    const float sigma = ok ? density_act(f[p], shift, act) : 0.0f;
    const float e = expf(-__fmul_rn(sigma, D[p]));
    ex[p] = e;
    prod = __fmul_rn(prod, trans_factor(__fsub_rn(1.0f, e)));
  }
  float total;
  float t = warp_exclusive_prod(prod, &total);
  float r = 0.0f, g = 0.0f, bl = 0.0f;
  for (int j = a; j < b; ++j) {
    const int p = sw(j);
    const float alpha = __fsub_rn(1.0f, ex[p]);
    tr[p] = t;
    const float wj = __fmul_rn(alpha, t);
    t = __fmul_rn(t, trans_factor(alpha));
    if (!kGates || wj > thres) {
      r = __fmaf_rn(wj, c0[p], r);
      g = __fmaf_rn(wj, c1[p], g);
      bl = __fmaf_rn(wj, c2[p], bl);
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
  const float r_end = rgb_dot(e0, e1, e2, gr, gg, gb);
  if (env != nullptr && lane == 0) {
    d_env[ray * 3] = __fmul_rn(total, gr);
    d_env[ray * 3 + 1] = __fmul_rn(total, gg);
    d_env[ray * 3 + 2] = __fmul_rn(total, gb);
  }

  // this chunk's affine map R_a = A + B R_b, then a suffix scan over lanes;
  // the gate of sample j is K6's weight, the same product of the same bits
  float A = 0.0f, B = 1.0f;
  for (int j = b - 1; j >= a; --j) {
    const int p = sw(j);
    const float alpha = __fsub_rn(1.0f, ex[p]);
    const bool kept = !kGates || __fmul_rn(alpha, tr[p]) > thres;
    const float q = kept ? rgb_dot(c0[p], c1[p], c2[p], gr, gg, gb) : 0.0f;
    c0[p] = q;
    const float fa = trans_factor(alpha);
    A = __fmaf_rn(alpha, q, __fmul_rn(A, fa));
    B = __fmul_rn(B, fa);
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float Ao = __shfl_down_sync(kFullMask, A, off);
    const float Bo = __shfl_down_sync(kFullMask, B, off);
    if (lane + off < 32) {
      A = __fmaf_rn(B, Ao, A);
      B = __fmul_rn(B, Bo);
    }
  }
  // R after this chunk: the next lanes' composed map applied to r_end
  const float An = __shfl_down_sync(kFullMask, A, 1);
  const float Bn = __shfl_down_sync(kFullMask, B, 1);
  float Rn = lane == 31 ? r_end : __fmaf_rn(Bn, r_end, An);

  for (int j = b - 1; j >= a; --j) {
    const int p = sw(j);
    const float e = ex[p], T = tr[p];
    const float alpha = __fsub_rn(1.0f, e);
    const bool keep = !kGates || __fmul_rn(alpha, T) > thres;
    const float q = c0[p];
    float d_alpha = __fmul_rn(T, __fsub_rn(q, Rn));
    // the entropy's cotangent of alpha_j (the lane's chunk, cached in L1)
    if constexpr (kDAlpha) d_alpha = __fadd_rn(d_alpha, __ldg(g_alpha + ray * S + j));
    Rn = __fmaf_rn(Rn, trans_factor(alpha), __fmul_rn(alpha, q));
    if (!((vbits >> (j - a)) & 1)) {
      f[p] = 0.0f;
    } else {
      f[p] = __fmul_rn(__fmul_rn(__fmul_rn(d_alpha, e), D[p]),
                       density_act_grad(f[p], shift, act));
    }
    const float wj = keep ? __fmul_rn(alpha, T) : 0.0f;
    c0[p] = __fmul_rn(wj, gr);
    c1[p] = __fmul_rn(wj, gg);
    c2[p] = __fmul_rn(wj, gb);
  }
  __syncwarp();
  store_row(f, S, d_feat + ray * S, lane);
  store_rgb(c0, S, P, d_rgb + ray * S * 3, lane);
}

// The gated instantiation where a valid mask or a threshold above -inf
// (which every weight passes) is given.
bool gated(const unsigned char* valid, float thres) { return valid != nullptr || thres > -1e30f; }

// K6b's warps a block for rays of S samples on the current device: of 1
// to kBwdMaxWarps, the count that keeps the most warps resident on an SM
// by the occupancy calculator (the kernel's registers, the block's shared
// bytes), the smaller on a tie; at S = 256, 8 warps and 56 KB, four blocks
// an SM, where 4-warp blocks leave 28 warps.  The kernel's dynamic shared
// limit is first lifted to the device's opt-in maximum: the attribute is
// the device's, so it is set on every call.
template <bool kGates, bool kDAlpha>
cudaError_t bwd_layout(int S, int* warps) {
  int dev = 0, optin = 0, best = 0;
  *warps = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(composite_bwd_kernel<kGates, kDAlpha>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  for (int w = 1; err == cudaSuccess && w <= kBwdMaxWarps && w * bwd_warp_bytes(S) <= optin;
       ++w) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks,
                                                        composite_bwd_kernel<kGates, kDAlpha>,
                                                        w * 32, (size_t)w * bwd_warp_bytes(S));
    if (err == cudaSuccess && w * blocks > best) {
      best = w * blocks;
      *warps = w;
    }
  }
  if (err == cudaSuccess && best == 0) err = cudaErrorInvalidConfiguration;
  return err;
}

template <bool kGates, bool kDAlpha>
int launch_bwd(const float* feat, const float* dists, const float* rgb, const float* g_rgb,
               const float* env, const unsigned char* valid, const float* g_alpha, int R, int S,
               float shift, float scale, int act, float thres, float* d_feat, float* d_rgb,
               float* d_env, cudaStream_t st) {
  int warps = 0;
  const cudaError_t err = bwd_layout<kGates, kDAlpha>(S, &warps);
  if (err != cudaSuccess) return (int)err;
  composite_bwd_kernel<kGates, kDAlpha><<<(R + warps - 1) / warps, warps * 32,
                                          (size_t)warps * bwd_warp_bytes(S), st>>>(
      feat, dists, rgb, g_rgb, env, valid, g_alpha, R, S, shift, scale, act, thres, d_feat,
      d_rgb, d_env);
  return (int)cudaGetLastError();
}

// K6b in the gated or ungated instantiation, with d_alpha (g_alpha) or
// without.
int composite_bwd_any(const float* feat, const float* dists, const float* rgb,
                      const float* g_rgb, const float* env, const unsigned char* valid,
                      const float* g_alpha, int R, int S, float shift, float scale, int act,
                      float thres, float* d_feat, float* d_rgb, float* d_env, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool gate = gated(valid, thres);
  if (g_alpha != nullptr) {
    return gate ? launch_bwd<true, true>(feat, dists, rgb, g_rgb, env, valid, g_alpha, R, S,
                                         shift, scale, act, thres, d_feat, d_rgb, d_env, st)
                : launch_bwd<false, true>(feat, dists, rgb, g_rgb, env, valid, g_alpha, R, S,
                                          shift, scale, act, thres, d_feat, d_rgb, d_env, st);
  }
  return gate ? launch_bwd<true, false>(feat, dists, rgb, g_rgb, env, valid, nullptr, R, S,
                                        shift, scale, act, thres, d_feat, d_rgb, d_env, st)
              : launch_bwd<false, false>(feat, dists, rgb, g_rgb, env, valid, nullptr, R, S,
                                         shift, scale, act, thres, d_feat, d_rgb, d_env, st);
}

template <bool kAlpha>
int launch_fwd(const float* feat, const float* dists, const float* z, const float* rgb,
               const float* ray_dz, const float* env, const unsigned char* valid,
               const Envmap& em, int R, int S, float shift, float scale, int act, float thres,
               float* rgb_out, float* depth_out, float* acc_out, float* bg_out, float* bg_map,
               float* alpha_out, cudaStream_t st) {
  const size_t smem = sizeof(float) * kWarpsPerBlock * S;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (em.table != nullptr) {
    if (gated(valid, thres)) return (int)cudaErrorInvalidValue;
    composite_kernel<false, true, kAlpha><<<blocks, kWarpsPerBlock * 32, smem, st>>>(
        feat, dists, z, rgb, ray_dz, nullptr, nullptr, em, R, S, shift, scale, act, thres,
        rgb_out, depth_out, acc_out, bg_out, bg_map, alpha_out);
  } else if (gated(valid, thres)) {
    composite_kernel<true, false, kAlpha><<<blocks, kWarpsPerBlock * 32, smem, st>>>(
        feat, dists, z, rgb, ray_dz, env, valid, em, R, S, shift, scale, act, thres, rgb_out,
        depth_out, acc_out, bg_out, bg_map, alpha_out);
  } else {
    composite_kernel<false, false, kAlpha><<<blocks, kWarpsPerBlock * 32, smem, st>>>(
        feat, dists, z, rgb, ray_dz, env, valid, em, R, S, shift, scale, act, thres, rgb_out,
        depth_out, acc_out, bg_out, bg_map, alpha_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The warps a block that composite_bwd launches with for rays of S
// samples on the current device (``gated``: its gated instantiation), and
// the block's dynamic shared bytes.
extern "C" int composite_bwd_geometry(int S, int gated, int* warps, int* smem_bytes) {
  const cudaError_t err = gated ? bwd_layout<true, false>(S, warps)
                                : bwd_layout<false, false>(S, warps);
  *smem_bytes = *warps * bwd_warp_bytes(S);
  return (int)err;
}

// The same for composite_bwd_alpha.
extern "C" int composite_bwd_alpha_geometry(int S, int gated, int* warps, int* smem_bytes) {
  const cudaError_t err = gated ? bwd_layout<true, true>(S, warps)
                                : bwd_layout<false, true>(S, warps);
  *smem_bytes = *warps * bwd_warp_bytes(S);
  return (int)err;
}

extern "C" int composite_bwd(const float* feat, const float* dists, const float* rgb,
                             const float* g_rgb, const float* env, const unsigned char* valid,
                             int R, int S, float shift, float scale, int act, float thres,
                             float* d_feat, float* d_rgb, float* d_env, void* stream) {
  return composite_bwd_any(feat, dists, rgb, g_rgb, env, valid, nullptr, R, S, shift, scale,
                           act, thres, d_feat, d_rgb, d_env, stream);
}

// K6b's training instantiation: composite_bwd with the alphas' cotangent
// g_alpha (R, S).
extern "C" int composite_bwd_alpha(const float* feat, const float* dists, const float* rgb,
                                   const float* g_rgb, const float* env,
                                   const unsigned char* valid, const float* g_alpha, int R,
                                   int S, float shift, float scale, int act, float thres,
                                   float* d_feat, float* d_rgb, float* d_env, void* stream) {
  if (g_alpha == nullptr) return (int)cudaErrorInvalidValue;
  return composite_bwd_any(feat, dists, rgb, g_rgb, env, valid, g_alpha, R, S, shift, scale,
                           act, thres, d_feat, d_rgb, d_env, stream);
}

// With ``table`` (K6e) the envmap comes from ``dirs`` and the table, and
// ``env`` is not read; the gates are not taken with it.
extern "C" int composite_fwd(const float* feat, const float* dists, const float* z,
                             const float* rgb, const float* ray_dz, const float* env,
                             const unsigned char* valid, const float* dirs, long long d_stride,
                             const float* table, int h, float inv_2pi, float* env_out, int R,
                             int S, float shift, float scale, int act, float thres,
                             float* rgb_out, float* depth_out, float* acc_out, float* bg_out,
                             float* bg_map, void* stream) {
  const Envmap em{dirs, d_stride, table, h, inv_2pi, env_out};
  return launch_fwd<false>(feat, dists, z, rgb, ray_dz, env, valid, em, R, S, shift, scale, act,
                           thres, rgb_out, depth_out, acc_out, bg_out, bg_map, nullptr,
                           static_cast<cudaStream_t>(stream));
}

// K6's training instantiation (every form): composite_fwd that also writes
// each sample's alpha to alpha_out (R, S).
extern "C" int composite_fwd_alpha(const float* feat, const float* dists, const float* z,
                                   const float* rgb, const float* ray_dz, const float* env,
                                   const unsigned char* valid, const float* dirs,
                                   long long d_stride, const float* table, int h, float inv_2pi,
                                   float* env_out, int R, int S, float shift, float scale,
                                   int act, float thres, float* rgb_out, float* depth_out,
                                   float* acc_out, float* bg_out, float* bg_map,
                                   float* alpha_out, void* stream) {
  if (alpha_out == nullptr) return (int)cudaErrorInvalidValue;
  const Envmap em{dirs, d_stride, table, h, inv_2pi, env_out};
  return launch_fwd<true>(feat, dists, z, rgb, ray_dz, env, valid, em, R, S, shift, scale, act,
                          thres, rgb_out, depth_out, acc_out, bg_out, bg_map, alpha_out,
                          static_cast<cudaStream_t>(stream));
}
