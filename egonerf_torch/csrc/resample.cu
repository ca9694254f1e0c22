// K4: coarse weights, inverse-CDF resampling, merge and dists, fused per
// ray; with the chart epilogue, also the fine samples' normalized coords.
//
// Replaces egonerf_tpu/ops/pdf.py sample_pdf + ops/merge.py merge_sorted +
// the coarse raw2alpha (ops/volrend.py:11-24, called at
// models/egonerf.py:392-393) + the dists diff (models/egonerf.py:410-411),
// and, in resample_chart_fwd, the fine chart that follows them
// (from_cartesian + normalize_coord, models/egonerf.py:396-406), which
// the standalone chart kernel K7 (chart.cu) computes the same way from
// chart.cuh.  resample_weights_fwd also writes the coarse weights, which
// the empty-space cull scores the merged samples by (models/egonerf.py:
// 393, 440-443), and runs no chart: under the cull the chart is taken of
// the kept depths only.  The chart epilogue and the weights' store are
// template parameters, so each instantiation carries only its own code.
//
// Per ray: alpha and weights of the S coarse samples from feature2density;
// pdf over the interior weights [1:-1] (+1e-5) and its cdf with a leading 0;
// F inverse-CDF draws at u over the S-1 coarse midpoints, bracketed in
// searchsorted(cdf, u, right) form with the u >= cdf[-1] clamp and the
// denom < 1e-5 -> 1 guard; the merge with the sorted coarse depths; the
// dists with the last one repeated; with the epilogue, the [r, theta, phi,
// flag] of o + d z for every merged depth.
//
// Bound on the card: bytes (3 x S floats in and 2 x (S+F) floats out per
// ray, ~15 MB per 4096-ray chunk; the epilogue adds 16 bytes a merged
// sample, ~17 MB; the weights' store S floats a ray, 2 MB), a few
// microseconds at 3.35 TB/s; a 4096-ray chunk is
// one wave of one warp a ray, so what is left is each warp's chain of
// dependent shared-memory steps.  Design: one warp per ray, intermediates
// in shared memory.  The weights, the transmittance scan, the pdf total
// and the cdf scan keep the order of the plain version
// (egonerf_torch/ops/pdf.py, volrend._warp_weights): each lane owns a
// contiguous chunk of samples, and the products and sums across lanes are
// the scans and the butterfly of warp_scan.cuh; each pdf element is
// divided once.  Each lane owns a contiguous run of draws: one binary
// search for the first, then a step along the cdf for the next (a search
// of the rest when the step is not enough), since u is sorted.  The merge
// is a merge path: each lane owns a run of output positions, finds by one
// binary search how many coarse depths precede its first, and merges its
// run (coarse before fine on ties, which equals sorting the concatenation).
// Eval's u = linspace(0, 1, F) is formed in registers as
// ops/pdf.py::linspace01 forms it.
//
// Why the fine draws are non-decreasing, which the merge path needs:
// the cdf is a running sum of positive terms rounded to nearest, so it is
// non-decreasing, and sorted u give non-decreasing brackets.  Inside one
// bracket z = b_lo + t (b_hi - b_lo) is a chain of rounded monotone
// operations of u.  Across brackets, a draw of bracket k has t <= 1 (u <
// c_hi gives rn(u - c_lo) <= rn(c_hi - c_lo) = denom; under the denom <
// 1e-5 guard t = rn(u - c_lo) < 1e-5), and a draw of a later bracket is
// at least that bracket's b_lo >= b_{k+1}.  So order holds where rn(b_k +
// rn(b_{k+1} - b_k)) <= b_{k+1}: always when b_k >= b_{k+1} / 2 (Sterbenz:
// the difference is exact and the sum is b_{k+1}), but when b_k <
// b_{k+1} / 2 the difference rounds and the sum may pass b_{k+1} by one
// ulp at t = 1, which a u within an ulp below cdf[k+1] reaches (midpoints
// that more than double from one bin to the next: a ray that starts at
// depth 0, or large gaps between coarse depths).  u >= cdf[-1] takes
// below = above = B - 1 and gives z = b_{B-1} exactly (t times 0), the
// last edge, under the same condition.  Unsorted u (the wrapper does not
// require sorted ones) break it too.  So one warp vote a ray checks it,
// and a ray whose draws are not in order takes the full-rank walk: every
// element counts the elements of the union that precede it.
#include <cuda_runtime.h>

#include "chart.cuh"
#include "warp_scan.cuh"

namespace {

using namespace egonerf;

constexpr int kWarpsPerBlock = 4;
// shared memory a block may opt into on sm_90
constexpr size_t kMaxSmem = 232448;

__host__ __device__ inline int floats_per_warp(int s, int f, int t) {
  return s + (s - 1) + s + f + t;  // weights, pdf / cdf, coarse z, fine z, merged z
}

// first index in [lo, hi) whose value exceeds v, or hi (searchsorted right)
__device__ __forceinline__ int upper_bound(const float* x, int lo, int hi, float v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (x[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// bin edge k: the midpoint of coarse depths k and k + 1
__device__ __forceinline__ float bin_edge(const float* zc, int k) {
  return __fmul_rn(0.5f, __fadd_rn(zc[k + 1], zc[k]));
}

template <bool kChart, bool kWeights>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
resample_kernel(const float* __restrict__ feat, const float* __restrict__ z,
                const float* __restrict__ dists, const float* __restrict__ u,
                long long u_stride, float u_step, int R, int S, int F, int merge, float shift,
                float scale, int act, float* __restrict__ z_out, float* __restrict__ d_out,
                const float* __restrict__ o, long long o_stride, const float* __restrict__ dv,
                long long dv_stride, ChartArgs ca, const float* __restrict__ grid_g,
                float4* __restrict__ c_out, float* __restrict__ w_out) {
  extern __shared__ float smem[];
  const int n_grid = kChart && ca.mode == 0 ? ca.n_grid : 0;
  if constexpr (kChart) {
    chart_stage_grid(ca, grid_g, smem);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * kWarpsPerBlock + warp;
  const int T = merge ? S + F : F;
  float* w = smem + n_grid + warp * floats_per_warp(S, F, T);
  float* cdf = w + S;       // S - 1: the pdf, then its cdf
  float* zc = cdf + S - 1;  // S
  float* zf = zc + S;       // F
  float* zo = zf + F;       // T
  if (ray >= R) return;
  feat += ray * S;
  z += ray * S;
  dists += ray * S;

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
  if constexpr (kWeights) {
    for (int j = lane; j < S; j += 32) w_out[ray * S + j] = w[j];
  }

  // pdf over w[1 .. S-2] + 1e-5, each element divided once, and its cdf,
  // cdf[0] = 0
  const int B = S - 1;
  {
    const int M = S - 2;
    const int per = (M + 31) / 32;
    const int a = min(lane * per, M), b = min(a + per, M);
    float part = 0.0f;
    for (int k = a; k < b; ++k) part += __fadd_rn(w[k + 1], 1e-5f);
    const float sum = warp_sum(part);
    float local = 0.0f;
    for (int k = a; k < b; ++k) {
      const float p = __fdiv_rn(__fadd_rn(w[k + 1], 1e-5f), sum);
      cdf[k + 1] = p;
      local = __fadd_rn(local, p);
    }
    float c = warp_exclusive_sum(local);
    for (int k = a; k < b; ++k) {
      c = __fadd_rn(c, cdf[k + 1]);
      cdf[k + 1] = c;
    }
    if (lane == 0) cdf[0] = 0.0f;
  }
  __syncwarp();

  // inverse CDF over this lane's run of draws: pos = #(cdf <= u), below =
  // pos - 1, above = pos (or below)
  const int per_f = (F + 31) / 32;
  const int k0 = min(lane * per_f, F), k1 = min(k0 + per_f, F);
  {
    int pos = 0;
    for (int k = k0; k < k1; ++k) {
      const float uk = u != nullptr ? u[ray * u_stride + k]
                       : k < F - 1  ? __fmul_rn((float)k, u_step)
                       : F > 1      ? 1.0f
                                    : 0.0f;
      if (k == k0) {
        pos = upper_bound(cdf, 0, B, uk);
      } else if (pos > 0 && cdf[pos - 1] > uk) {
        pos = upper_bound(cdf, 0, pos - 1, uk);
      } else if (pos < B && cdf[pos] <= uk) {
        ++pos;
        if (pos < B && cdf[pos] <= uk) pos = upper_bound(cdf, pos + 1, B, uk);
      }
      const int below = max(pos - 1, 0);
      const int above = pos < B ? pos : below;
      const float c_lo = cdf[below], c_hi = cdf[above];
      const float b_lo = bin_edge(zc, below), b_hi = bin_edge(zc, above);
      float denom = __fsub_rn(c_hi, c_lo);
      if (denom < 1e-5f) denom = 1.0f;
      const float t = __fdiv_rn(__fsub_rn(uk, c_lo), denom);
      zf[k] = __fadd_rn(b_lo, __fmul_rn(t, __fsub_rn(b_hi, b_lo)));
    }
  }
  __syncwarp();

  const float* src = zf;
  if (merge) {
    bool ordered = true;
    for (int k = max(k0, 1); k < k1; ++k) ordered &= zf[k - 1] <= zf[k];
    if (__all_sync(kFullMask, ordered)) {
      // merge path: i coarse and p0 - i fine depths precede output p0
      const int per = (T + 31) / 32;
      const int p0 = min(lane * per, T), p1 = min(p0 + per, T);
      int lo = max(0, p0 - F), hi = min(p0, S);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (zc[mid] <= zf[p0 - 1 - mid]) lo = mid + 1; else hi = mid;
      }
      int i = lo, j = p0 - lo;
      for (int p = p0; p < p1; ++p) {
        const bool take_coarse = j >= F || (i < S && zc[i] <= zf[j]);
        zo[p] = take_coarse ? zc[i++] : zf[j++];
      }
    } else {
      // the full-rank walk: every element goes to its rank in the union
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
    }
    src = zo;
    __syncwarp();
  }

  ChartRay cr{};
  if constexpr (kChart) cr = chart_ray(o + ray * o_stride, dv + ray * dv_stride, lane);
  for (int p = lane; p < T; p += 32) {
    const float zp = src[p];
    z_out[ray * T + p] = zp;
    const int q = p < T - 1 ? p : T - 2;
    d_out[ray * T + p] = __fsub_rn(src[q + 1], src[q]);
    if constexpr (kChart)
      c_out[ray * T + p] = chart_point(cr.ox, cr.oy, cr.oz, cr.dx, cr.dy, cr.dz, zp, ca, smem);
  }
}

template <bool kChart, bool kWeights>
int launch(const float* feat, const float* z, const float* dists, const float* u,
           long long u_stride, float u_step, int R, int S, int F, int merge, float shift,
           float scale, int act, float* z_out, float* d_out, const float* o, long long o_stride,
           const float* dv, long long dv_stride, const ChartArgs& ca, const float* grid,
           float* coords, float* weights, void* stream) {
  const int T = merge ? S + F : F;
  const int n_grid = kChart && ca.mode == 0 ? ca.n_grid : 0;
  if (kChart && ca.mode == 0 && (n_grid < 2 || n_grid > kMaxChartGrid))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (n_grid + (size_t)kWarpsPerBlock * floats_per_warp(S, F, T));
  if (S < 3 || F < 1 || T < 2 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaSuccess;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resample_kernel<kChart, kWeights>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  resample_kernel<kChart, kWeights><<<blocks, kWarpsPerBlock * 32, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
      feat, z, dists, u, u_stride, u_step, R, S, F, merge, shift, scale, act, z_out, d_out, o,
      o_stride, dv, dv_stride, ca, grid, reinterpret_cast<float4*>(coords), weights);
  return (int)cudaGetLastError();
}

}  // namespace

// u null: eval's linspace(0, 1, F), from u_step = float32(1 / (F - 1)).
extern "C" int resample_fwd(const float* feat, const float* z, const float* dists,
                            const float* u, long long u_stride, float u_step, int R, int S,
                            int F, int merge, float shift, float scale, int act, float* z_out,
                            float* d_out, void* stream) {
  return launch<false, false>(feat, z, dists, u, u_stride, u_step, R, S, F, merge, shift, scale,
                              act, z_out, d_out, nullptr, 0, nullptr, 0, ChartArgs{}, nullptr,
                              nullptr, nullptr, stream);
}

// resample_fwd, and the coarse weights (R, S) into weights.
extern "C" int resample_weights_fwd(const float* feat, const float* z, const float* dists,
                                    const float* u, long long u_stride, float u_step, int R,
                                    int S, int F, int merge, float shift, float scale, int act,
                                    float* z_out, float* d_out, float* weights, void* stream) {
  return launch<false, true>(feat, z, dists, u, u_stride, u_step, R, S, F, merge, shift, scale,
                             act, z_out, d_out, nullptr, 0, nullptr, 0, ChartArgs{}, nullptr,
                             nullptr, weights, stream);
}

// resample_fwd, then the chart of every merged depth into coords (R * T, 4).
extern "C" int resample_chart_fwd(const float* feat, const float* z, const float* dists,
                                  const float* u, long long u_stride, float u_step, int R,
                                  int S, int F, int merge, float shift, float scale, int act,
                                  float* z_out, float* d_out, const float* o,
                                  long long o_stride, const float* d, long long d_stride,
                                  float cx, float cy, float cz, float near_t, float near_p,
                                  float inv_r, float inv_t, float inv_p, int mode,
                                  const float* grid, int n_grid, float inv_nr, float r0,
                                  float inv_r0, float ratio, float inv_log_ratio, float* coords,
                                  void* stream) {
  const ChartArgs ca{cx, cy, cz, near_t, near_p, inv_r, inv_t, inv_p, mode, n_grid, inv_nr,
                     r0, inv_r0, ratio, inv_log_ratio};
  return launch<true, false>(feat, z, dists, u, u_stride, u_step, R, S, F, merge, shift, scale,
                             act, z_out, d_out, o, o_stride, d, d_stride, ca, grid, coords,
                             nullptr, stream);
}
