// K4: coarse weights, inverse-CDF resampling, merge and dists, fused per ray.
//
// Replaces egonerf_tpu/ops/pdf.py sample_pdf + ops/merge.py merge_sorted +
// the coarse raw2alpha (ops/volrend.py:11-24, called at
// models/egonerf.py:392-393) + the dists diff (models/egonerf.py:410-411).
//
// Per ray: alpha and weights of the S coarse samples from feature2density;
// pdf over the interior weights [1:-1] (+1e-5) and its cdf with a leading 0;
// F inverse-CDF draws at u over the S-1 coarse midpoints, bracketed in
// searchsorted(cdf, u, right) form with the u >= cdf[-1] clamp and the
// denom < 1e-5 -> 1 guard; the merge with the sorted coarse depths; the
// dists with the last one repeated.
//
// Bound on the card: bytes (3 x S floats in and 2 x (S+F) floats out per
// ray, ~15 MB per 4096-ray chunk, a few microseconds at 3.35 TB/s), though
// at one 4096-ray chunk the launch is too small to fill the card.
// Design: one warp per ray with all intermediates in shared memory. Each
// lane owns a contiguous chunk of samples; the transmittance product and
// the cdf are warp scans over the lanes' chunk totals; the draws are binary
// searches; the merge places every element at its rank in the union
// (stable, coarse before fine on ties), which equals sorting the
// concatenation whatever the order of the draws.  The TPU's masked min/max
// bracketing and bitonic network answered gather costs and are not kept.
#include <cuda_runtime.h>

#include "warp_scan.cuh"

namespace {

using namespace egonerf;

constexpr int kWarpsPerBlock = 4;

__host__ __device__ inline int floats_per_warp(int s, int f, int t) {
  return s + 2 * (s - 1) + s + f + t;  // weights, cdf, bins, coarse z, fine z, out
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
resample_kernel(const float* __restrict__ feat, const float* __restrict__ z,
                const float* __restrict__ dists, const float* __restrict__ u,
                long long u_stride, int R, int S, int F, int merge, float shift,
                float scale, int act, float* __restrict__ z_out, float* __restrict__ d_out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * kWarpsPerBlock + warp;
  const int T = merge ? S + F : F;
  float* w = smem + warp * floats_per_warp(S, F, T);
  float* cdf = w + S;         // S - 1
  float* bins = cdf + S - 1;  // S - 1
  float* zc = bins + S - 1;   // S
  float* zf = zc + S;         // F
  float* zo = zf + F;         // T
  if (ray >= R) return;
  feat += ray * S;
  z += ray * S;
  dists += ray * S;
  u += ray * u_stride;

  for (int j = lane; j < S; j += 32) zc[j] = z[j];

  // weights = alpha * exclusive transmittance
  {
    const int per = (S + 31) / 32;
    const int a = min(lane * per, S), b = min(a + per, S);
    float prod = 1.0f;
    for (int j = a; j < b; ++j) {
      const float al = alpha_of(feat[j], dists[j], shift, scale, act);
      w[j] = al;
      prod = __fmul_rn(prod, trans_factor(al));
    }
    float total;
    float t = warp_exclusive_prod(prod, &total);
    for (int j = a; j < b; ++j) {
      const float al = w[j];
      w[j] = __fmul_rn(al, t);
      t = __fmul_rn(t, trans_factor(al));
    }
  }
  __syncwarp();

  // pdf over w[1 .. S-2] + 1e-5 and its cdf, cdf[0] = 0
  const int B = S - 1;
  {
    const int M = S - 2;
    const int per = (M + 31) / 32;
    const int a = min(lane * per, M), b = min(a + per, M);
    float part = 0.0f;
    for (int k = a; k < b; ++k) part += __fadd_rn(w[k + 1], 1e-5f);
    const float sum = warp_sum(part);
    float local = 0.0f;
    for (int k = a; k < b; ++k) local = __fadd_rn(local, __fdiv_rn(__fadd_rn(w[k + 1], 1e-5f), sum));
    float c = warp_exclusive_sum(local);
    for (int k = a; k < b; ++k) {
      c = __fadd_rn(c, __fdiv_rn(__fadd_rn(w[k + 1], 1e-5f), sum));
      cdf[k + 1] = c;
    }
    if (lane == 0) cdf[0] = 0.0f;
    for (int k = lane; k < B; k += 32) bins[k] = __fmul_rn(0.5f, __fadd_rn(zc[k + 1], zc[k]));
  }
  __syncwarp();

  // inverse CDF: inds = #(cdf <= u), below = inds - 1, above = inds (or below)
  for (int k = lane; k < F; k += 32) {
    const float uk = u[k];
    int lo = 0, hi = B;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] <= uk) lo = mid + 1; else hi = mid;
    }
    const int below = max(lo - 1, 0);
    const int above = lo < B ? lo : below;
    const float c_lo = cdf[below], c_hi = cdf[above];
    const float b_lo = bins[below], b_hi = bins[above];
    float denom = __fsub_rn(c_hi, c_lo);
    if (denom < 1e-5f) denom = 1.0f;
    const float t = __fdiv_rn(__fsub_rn(uk, c_lo), denom);
    zf[k] = __fadd_rn(b_lo, __fmul_rn(t, __fsub_rn(b_hi, b_lo)));
  }
  __syncwarp();

  // merge: every element goes to its rank in the union
  const float* src = zf;
  if (merge) {
    for (int i = lane; i < S; i += 32) {
      const float v = zc[i];
      int n_less = 0;
      for (int k = 0; k < F; ++k) n_less += zf[k] < v;
      zo[i + n_less] = v;
    }
    for (int j = lane; j < F; j += 32) {
      const float v = zf[j];
      int rank = 0;
      for (int k = 0; k < S; ++k) rank += zc[k] <= v;
      for (int k = 0; k < F; ++k) rank += zf[k] < v || (zf[k] == v && k < j);
      zo[rank] = v;
    }
    src = zo;
    __syncwarp();
  }

  for (int p = lane; p < T; p += 32) {
    z_out[ray * T + p] = src[p];
    const int q = p < T - 1 ? p : T - 2;
    d_out[ray * T + p] = __fsub_rn(src[q + 1], src[q]);
  }
}

}  // namespace

extern "C" int resample_fwd(const float* feat, const float* z, const float* dists,
                            const float* u, long long u_stride, int R, int S, int F,
                            int merge, float shift, float scale, int act, float* z_out,
                            float* d_out, void* stream) {
  const int T = merge ? S + F : F;
  const size_t smem = sizeof(float) * kWarpsPerBlock * floats_per_warp(S, F, T);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  resample_kernel<<<blocks, kWarpsPerBlock * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      feat, z, dists, u, u_stride, R, S, F, merge, shift, scale, act, z_out, d_out);
  return (int)cudaGetLastError();
}
