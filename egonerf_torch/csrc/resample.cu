// K4: coarse weights, inverse-CDF resampling, merge and dists, fused per
// ray; with the chart epilogue, also the fine samples' normalized coords.
//
// Replaces egonerf_tpu/ops/pdf.py sample_pdf + ops/merge.py merge_sorted +
// the coarse raw2alpha (ops/volrend.py:11-24, called at
// models/egonerf.py:392-393) + the dists diff (models/egonerf.py:410-411),
// and, in resample_chart_fwd, the fine chart that follows them
// (from_cartesian + normalize_coord, models/egonerf.py:396-406), which
// the standalone chart kernel K7 (chart.cu) computes the same way from
// chart.cuh.  resample_weights_fwd also writes the coarse weights (the
// cull's oracle scorer takes its depths) and runs no chart: under the cull
// the chart is taken of the kept depths only.  The chart epilogue and the
// weights' store are template parameters, so each instantiation carries
// only its own code.  resample_score_fwd (K4c, its own kernel below) is the
// empty-space cull's coarse pass: K4's weights, draws, merge and dists,
// with the cull score of every merged sample (egonerf_tpu/ops/cull.py
// coarse_importance, :30-54, called at models/egonerf.py:445) in its
// epilogue in place of K12's second launch.  resample_chart_draw_fwd and
// resample_score_draw_fwd are the training instantiations (template
// parameter kDraw): u is not read but drawn, K5's sorted uniforms for
// (seed, step) (egonerf_tpu/ops/merge.py sorted_uniform, :25-36), by each
// warp into its shared memory before the coarse weights (csrc/philox.cuh,
// the code K5 runs, so the draws are K5's bit for bit), which removes K5's
// launch and its (R, F) round trip through device memory.  Measured: K4
// with the draw 0.0317 ms against K5 + K4's 0.0359, K4c 0.0165 against
// 0.0197 (tools/draw_ab.py, H100 80GB HBM3, 700 W).
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
#include "philox.cuh"

namespace {

using namespace egonerf;

constexpr int kWarpsPerBlock = 4;
// shared memory a block may opt into on sm_90
constexpr size_t kMaxSmem = 232448;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline int floats_per_warp(int s, int f, int t) {
  return s + (s - 1) + s + f + t;  // weights, pdf / cdf, coarse z, fine z, merged z
}

// the training instantiation's shared memory a warp: K5's draws (f + 1
// floats) first, then floats_per_warp, each warp's row 16-byte aligned
__host__ __device__ inline int draw_floats_per_warp(int s, int f, int t) {
  return round4(f + 1) + round4(floats_per_warp(s, f, t));
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

// kDraw: u is not read but drawn, K5's draws of (ray, key (key0, key1)) from
// csrc/philox.cuh into the warp's shared memory before the coarse weights
template <bool kChart, bool kWeights, bool kDraw>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
resample_kernel(const float* __restrict__ feat, const float* __restrict__ z,
                const float* __restrict__ dists, const float* __restrict__ u,
                long long u_stride, float u_step, uint32_t key0, uint32_t key1, long long ray0,
                int R, int S, int F, int merge, float shift, float scale, int act, float* __restrict__ z_out,
                float* __restrict__ d_out, const float* __restrict__ o, long long o_stride,
                const float* __restrict__ dv, long long dv_stride, ChartArgs ca,
                const float* __restrict__ grid_g, float4* __restrict__ c_out,
                float* __restrict__ w_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_grid = kChart && ca.mode == 0 ? ca.n_grid : 0;
  if constexpr (kChart) {
    chart_stage_grid(ca, grid_g, smem);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * kWarpsPerBlock + warp;
  const int T = merge ? S + F : F;
  float* ud = smem + (kDraw ? round4(n_grid) + warp * draw_floats_per_warp(S, F, T) : 0);
  float* w = kDraw ? ud + round4(F + 1) : smem + n_grid + warp * floats_per_warp(S, F, T);
  float* cdf = w + S;       // S - 1: the pdf, then its cdf
  float* zc = cdf + S - 1;  // S
  float* zf = zc + S;       // F
  float* zo = zf + F;       // T
  if (ray >= R) return;
  if constexpr (kDraw) warp_sorted_draw(ud, F, ray0 + ray, key0, key1, ud);
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
      const float uk = kDraw          ? ud[k]
                       : u != nullptr ? u[ray * u_stride + k]
                       : k < F - 1    ? __fmul_rn((float)k, u_step)
                       : F > 1        ? 1.0f
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

template <bool kChart, bool kWeights, bool kDraw = false>
int launch(const float* feat, const float* z, const float* dists, const float* u,
           long long u_stride, float u_step, int R, int S, int F, int merge, float shift,
           float scale, int act, float* z_out, float* d_out, const float* o, long long o_stride,
           const float* dv, long long dv_stride, const ChartArgs& ca, const float* grid,
           float* coords, float* weights, void* stream, uint32_t k0 = 0, uint32_t k1 = 0,
           long long ray0 = 0) {
  const int T = merge ? S + F : F;
  const int n_grid = kChart && ca.mode == 0 ? ca.n_grid : 0;
  if (kChart && ca.mode == 0 && (n_grid < 2 || n_grid > kMaxChartGrid))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (kDraw ? round4(n_grid) + (size_t)kWarpsPerBlock *
                                                   draw_floats_per_warp(S, F, T)
                             : n_grid + (size_t)kWarpsPerBlock * floats_per_warp(S, F, T));
  if (S < 3 || F < 1 || T < 2 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaSuccess;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resample_kernel<kChart, kWeights, kDraw>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  resample_kernel<kChart, kWeights, kDraw><<<blocks, kWarpsPerBlock * 32, smem,
                                             static_cast<cudaStream_t>(stream)>>>(
      feat, z, dists, u, u_stride, u_step, k0, k1, ray0, R, S, F, merge, shift, scale, act,
      z_out, d_out, o, o_stride, dv, dv_stride, ca, grid, reinterpret_cast<float4*>(coords),
      weights);
  return (int)cudaGetLastError();
}


// -- K4c: the cull's coarse pass, K4's weights, draws, merge and dists with
// K12's score in the epilogue -----------------------------------------------
//
// The same arithmetic in the same order as resample_kernel (so z and dists
// equal K4's bit for bit, and the weights K4's), and the score of merged
// sample z: the coarse weights dilated by one interval, max(w_c, w_{c+1},
// w_{c-1}) with the edges repeated, at c = #(coarse_z <= z) - 1, 0 below
// coarse_z[0] (K12's function, csrc/cull.cu), with no search of its own: a
// draw lies at or above its bin's lower edge, itself at or above
// zc[below], so its c starts at below (and moves up past coarse depths
// within an ulp of it, or repeated); a coarse depth's c is the last index
// of the coarse depths equal to it (an interval [z, z) is empty).  Only
// the full-rank walk searches.
//
// Bound on the card: bytes (feat, z, dists read once, 3 x S floats a ray;
// z, dists and the score written once, 3 x T floats: 18.9 MB a 4096-ray
// production chunk, 5.6 us at 3.35 TB/s).  Measured before the design
// (tools/cull_kernel_ab.py --ablate, H100 80GB HBM3, 700 W): resample_kernel's
// weights instantiation spent its 15.2 us on the launch (2.6), the draws'
// searches (2.5), the merge (2.7) and instruction chains over its lane
// runs in shared memory; padding those runs against bank conflicts made it
// slower; K12 spent 3.2 of its 8.0 us on its search.  So the design cuts
// instructions and the chains between them.  One warp a ray, as K4; a
// lane's runs of coarse samples, pdf terms and draws (at most PS and PF a
// lane) live in registers, loaded and stored as float4s where the runs
// are multiples of 4; the weights, their dilation and the pdf and cdf are
// computed there, neighbours across lanes by shuffles; each draw's
// searchsorted is a search by halving steps of compile-time length over
// the cdf padded with +inf, the lane's draws side by side.  No merge walk:
// every depth goes to its place in the union at once, a draw j at j + c +
// 1, a coarse depth i at i + the draws of the intervals below i (the last
// draw of each interval marks that count; a max scan over the coarse runs
// fills the intervals without draws); the outputs, staged in shared memory,
// go out as whole rows of float4s.  The weights never leave the kernel.
// Measured: 0.0112 ms on the production chunk against 0.0232 for K4's
// weights instantiation and K12 (tools/cull_kernel_ab.py, H100 80GB HBM3, 700 W).

// the highest power of two <= n (n >= 1)
__host__ __device__ inline int top_step(int n) {
#ifdef __CUDA_ARCH__
  return 1 << (31 - __clz(n));
#else
  int t = 1;
  while (2 * t <= n) t *= 2;
  return t;
#endif
}

// a warp's shared memory in K4c, each array 16-byte aligned: coarse z, the
// dilated weights, the cdf (placed so that cdf + 1 is aligned: the pdf runs
// start at cdf[1]; padded with +inf to 2 top_step(S - 1) - 1 entries, the
// most a search by halving steps reaches), the fine z, and the merged z
// and scores (the merged z also the scratch of the weights where the pdf
// runs are not the weights' runs), the count of fine depths below each
// coarse one (ints), and in the training instantiation K5's draws (f + 1)
struct ScoreLayout {
  int wd, cdf, zf, zo, so, nb, ud, floats;
  __host__ __device__ ScoreLayout(int s, int f, int t, bool draw = false)
      : wd(round4(s)), cdf(2 * round4(s) + 3), zf(2 * round4(s) + round4(2 * top_step(s - 1) + 2)),
        zo(zf + round4(f)), so(zo + round4(s > t ? s : t)), nb(so + round4(t)),
        ud(nb + round4(s)), floats(ud + (draw ? round4(f + 1) : 0)) {}
};

// the first n <= N floats at src into v (the rest 0); vec: src 16-byte
// aligned, so whole float4s load at once
template <int N>
__device__ __forceinline__ void load_run(const float* src, int n, bool vec, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    if (vec && i + 3 < n) {
      const float4 q = *reinterpret_cast<const float4*>(src + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) v[i + r] = i + r < n ? src[i + r] : 0.0f;
    }
  }
}

// the first n <= N of v to dst; vec: dst 16-byte aligned
template <int N>
__device__ __forceinline__ void store_run(float* dst, const float (&v)[N], int n, bool vec) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    if (vec && i + 3 < n) {
      *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (i + r < n) dst[i + r] = v[i + r];
    }
  }
}

// the last of the first n (>= 1) entries of v
template <int N>
__device__ __forceinline__ float last_of(const float (&v)[N], int n) {
  float x = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (i == n - 1) x = v[i];
  return x;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// K12's score of depth v: the dilated weight of the coarse interval
// holding it, c = #(zc <= v) - 1, found by one search; 0 below zc[0]
__device__ __forceinline__ float searched_score(const float* zc, const float* wd, int S,
                                                float v) {
  const int c = upper_bound(zc, 0, S, v);
  return c > 0 ? wd[c - 1] : 0.0f;
}

// PS, PF: the most coarse samples and draws a lane holds in registers,
// ceil(S / 32) <= PS and ceil(F / 32) <= PF; kDraw: u drawn as in K4's
// training instantiation
template <int PS, int PF, bool kDraw>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
resample_score_kernel(const float* __restrict__ feat, const float* __restrict__ z,
                      const float* __restrict__ dists, const float* __restrict__ u,
                      long long u_stride, float u_step, uint32_t key0, uint32_t key1,
                      long long ray0, int R, int S, int F, int merge, float shift, float scale,
                      int act,
                      float* __restrict__ z_out, float* __restrict__ d_out,
                      float* __restrict__ s_out) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * kWarpsPerBlock + warp;
  const int T = merge ? S + F : F;
  const ScoreLayout L(S, F, T, kDraw);
  float* zc = reinterpret_cast<float*>(smem4) + warp * L.floats;
  float* wd = zc + L.wd;
  float* cdf = zc + L.cdf;
  float* zf = zc + L.zf;
  float* zo = zc + L.zo;
  float* so = zc + L.so;
  int* nb = reinterpret_cast<int*>(zc + L.nb);
  float* ud = zc + L.ud;
  if (ray >= R) return;
  if constexpr (kDraw) warp_sorted_draw(ud, F, ray0 + ray, key0, key1, ud);

  // this lane's run of coarse samples, [a, a + n): feat, dists and z in
  // registers, whole float4s where the runs are multiples of 4
  const int per = (S + 31) >> 5;
  const int a = min(lane * per, S), n = min(per, S - a);
  const bool vec_s = (per & 3) == 0 && (S & 3) == 0;
  const bool vec_in = vec_s && aligned16(feat) && aligned16(z) && aligned16(dists);
  float cz[PS], w[PS];
  {
    float cf[PS], cd[PS];
    load_run(feat + ray * S + a, n, vec_in, cf);
    load_run(dists + ray * S + a, n, vec_in, cd);
    load_run(z + ray * S + a, n, vec_in, cz);
    store_run(zc + a, cz, n, vec_s);

    // weights = alpha * exclusive transmittance, in K4's order
    float prod = 1.0f;
#pragma unroll
    for (int i = 0; i < PS; ++i) {
      w[i] = 0.0f;
      if (i < n) {
        const float al = alpha_of(cf[i], cd[i], shift, scale, act);
        w[i] = al;
        prod = __fmul_rn(prod, trans_factor(al));
      }
    }
    float total;
    float t = warp_exclusive_prod(prod, &total);
#pragma unroll
    for (int i = 0; i < PS; ++i) {
      if (i < n) {
        const float al = w[i];
        w[i] = __fmul_rn(al, t);
        t = __fmul_rn(t, trans_factor(al));
      }
    }
  }

  // K12's dilation, max(w_c, w_{c+1}, w_{c-1}) with the edges repeated,
  // the neighbours across runs from the lanes beside this one
  const float w_prev = __shfl_up_sync(kFullMask, last_of(w, n), 1);
  const float w_next = __shfl_down_sync(kFullMask, w[0], 1);
  float wdv[PS];
#pragma unroll
  for (int i = 0; i < PS; ++i) {
    const float left = i > 0 ? w[i > 0 ? i - 1 : 0] : (a > 0 ? w_prev : w[0]);
    const float right = i + 1 < n ? w[i + 1 < PS ? i + 1 : i] : (a + n < S ? w_next : w[i]);
    wdv[i] = fmaxf(w[i], fmaxf(right, left));
  }
  store_run(wd + a, wdv, n, vec_s);

  // pdf over w[1 .. S-2] + 1e-5 in its own runs [am, am + nm), each element
  // divided once, and its cdf, cdf[0] = 0: K4's order.  Where the runs
  // match the weights' (S not 32k + 1 or 32k + 2) the terms are this
  // lane's weights and the next lane's first
  const int M = S - 2, per_m = (M + 31) >> 5;
  const int am = min(lane * per_m, M), nm = min(per_m, M - am);
  {
    float x[PS];
    if (per_m == per) {
#pragma unroll
      for (int i = 0; i < PS; ++i)
        x[i] = __fadd_rn(i + 1 < per ? w[i + 1 < PS ? i + 1 : i] : w_next, 1e-5f);
    } else {
      store_run(zo + a, w, n, false);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < PS; ++i) x[i] = i < nm ? __fadd_rn(zo[am + 1 + i], 1e-5f) : 0.0f;
    }
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < PS; ++i)
      if (i < nm) part += x[i];
    const float sum = warp_sum(part);
    float local = 0.0f;
#pragma unroll
    for (int i = 0; i < PS; ++i) {
      if (i < nm) {
        x[i] = __fdiv_rn(x[i], sum);
        local = __fadd_rn(local, x[i]);
      }
    }
    float c = warp_exclusive_sum(local);
#pragma unroll
    for (int i = 0; i < PS; ++i) {
      if (i < nm) {
        c = __fadd_rn(c, x[i]);
        x[i] = c;
      }
    }
    store_run(cdf + am + 1, x, nm, (per_m & 3) == 0);
    if (lane == 0) cdf[0] = 0.0f;
    for (int k = S - 1 + lane; k < 2 * top_step(S - 1) - 1; k += 32)
      cdf[k] = __int_as_float(0x7f800000);
  }
  __syncwarp();

  // this lane's run of draws [k0, k0 + nf): pos = #(cdf <= u), K4's
  // searchsorted(cdf, u, right) (the cdf never decreases; its +inf padding
  // is above every u), by halving steps taken for the whole run at once,
  // then K4's bracket arithmetic
  const int B = S - 1;
  const int per_f = (F + 31) >> 5;
  const int k0 = min(lane * per_f, F), nf = min(per_f, F - k0);
  float fz[PF];
  int ci[PF];
  {
    float uk[PF];
    int pos[PF];
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int k = k0 + i;
      uk[i] = i >= nf       ? 0.0f
              : kDraw        ? ud[k]
              : u != nullptr ? u[ray * u_stride + k]
              : k < F - 1    ? __fmul_rn((float)k, u_step)
              : F > 1        ? 1.0f
                             : 0.0f;
      pos[i] = 0;
    }
    // steps of compile-time length (immediate offsets), those above the
    // highest power of two <= B skipped
    constexpr int kTopLog = PS <= 4 ? 6 : 8;  // B < 32 PS
    const int top = top_step(B);
#pragma unroll
    for (int e = kTopLog; e >= 0; --e) {
      if ((1 << e) > top) continue;
#pragma unroll
      for (int i = 0; i < PF; ++i) {
        const int t = pos[i] + (1 << e);
        if (cdf[t - 1] <= uk[i]) pos[i] = t;
      }
    }
#pragma unroll
    for (int i = 0; i < PF; ++i) pos[i] = min(pos[i], B);  // u = +inf passes the padding
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int below = max(pos[i] - 1, 0);
      const int above = pos[i] < B ? pos[i] : below;
      const float c_lo = cdf[below], c_hi = cdf[above];
      const float z_lo = zc[below], z_next = zc[below + 1];
      const float b_lo = __fmul_rn(0.5f, __fadd_rn(z_next, z_lo)), b_hi = bin_edge(zc, above);
      float denom = __fsub_rn(c_hi, c_lo);
      if (denom < 1e-5f) denom = 1.0f;
      const float t = __fdiv_rn(__fsub_rn(uk[i], c_lo), denom);
      const float v = __fadd_rn(b_lo, __fmul_rn(t, __fsub_rn(b_hi, b_lo)));
      fz[i] = v;
      // its coarse interval, c = #(zc <= z) - 1 (K12's): z >= its bin's
      // lower edge >= zc[below], so c starts at below and moves up past
      // coarse depths within an ulp of z or repeated; any other draw takes
      // a search
      int c = below;
      if (!(z_lo <= v)) {
        c = upper_bound(zc, 0, S, v) - 1;
      } else if (z_next <= v) {
        ++c;
        while (c + 1 < S && zc[c + 1] <= v) ++c;
      }
      ci[i] = c;
    }
  }
  store_run(zf + k0, fz, nf, (per_f & 3) == 0);
  bool ordered = true;
  {
    const float f_prev = __shfl_up_sync(kFullMask, last_of(fz, nf), 1);
#pragma unroll
    for (int i = 0; i < PF; ++i)
      if (i < nf && k0 + i > 0) ordered &= (i > 0 ? fz[i > 0 ? i - 1 : 0] : f_prev) <= fz[i];
  }
  __syncwarp();

  // every output to its place in shared memory, with its score
  if (!merge) {
    // the draws are the outputs
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      if (i < nf) {
        zo[k0 + i] = fz[i];
        so[k0 + i] = ci[i] >= 0 ? wd[ci[i]] : 0.0f;
      }
    }
  } else if (__all_sync(kFullMask, ordered)) {
    // each depth to its place in the union, coarse before fine on ties: a
    // fine zf[j] has j fine and c + 1 coarse depths before it; a coarse
    // zc[i], i coarse ones and the fine ones of the intervals below i.  The
    // last fine depth j of each interval c marks nb[c + 1] = j + 1; a max
    // scan over the coarse runs fills the intervals without draws.  A
    // coarse depth's interval is the last of the coarse depths equal to it
    // (an interval [z, z) is empty)
    if ((S & 3) == 0) {
      for (int k = 4 * lane; k < S; k += 128)
        *reinterpret_cast<int4*>(nb + k) = make_int4(0, 0, 0, 0);
    } else {
      for (int k = lane; k < S; k += 32) nb[k] = 0;
    }
    const int ci_next = __shfl_down_sync(kFullMask, ci[0], 1);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      if (i < nf) {
        const int c = ci[i];
        const int p = k0 + i + c + 1;
        zo[p] = fz[i];
        so[p] = c >= 0 ? wd[c] : 0.0f;
        const int c_after = i + 1 < nf ? ci[i + 1 < PF ? i + 1 : i] : ci_next;
        if ((k0 + i + 1 == F || c_after != c) && c + 1 < S) nb[c + 1] = k0 + i + 1;
      }
    }
    __syncwarp();
    int cnt[PS];
    int m = 0;
#pragma unroll
    for (int i = 0; i < PS; ++i) {
      cnt[i] = i < n ? nb[a + i] : 0;
      m = max(m, cnt[i]);
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFullMask, m, off);
      if (lane >= off) m = max(m, o);
    }
    int before = __shfl_up_sync(kFullMask, m, 1);
    if (lane == 0) before = 0;
    const float z_after = __shfl_down_sync(kFullMask, cz[0], 1);
#pragma unroll
    for (int i = 0; i < PS; ++i) {
      if (i < n) {
        before = max(before, cnt[i]);
        const float v = cz[i];
        const float after = i + 1 < n ? cz[i + 1 < PS ? i + 1 : i] : z_after;
        float sc = wdv[i];
        if (a + i + 1 < S && after <= v) {
          int c = a + i + 1;
          while (c + 1 < S && zc[c + 1] <= v) ++c;
          sc = wd[c];
        }
        zo[a + i + before] = v;
        so[a + i + before] = sc;
      }
    }
  } else {
    // the full-rank walk, as K4; each element scored by a search
    for (int i = lane; i < S; i += 32) {
      const float v = zc[i];
      int n_less = 0;
      for (int k = 0; k < F; ++k) n_less += zf[k] < v;
      zo[i + n_less] = v;
      so[i + n_less] = searched_score(zc, wd, S, v);
    }
    for (int j = lane; j < F; j += 32) {
      const float v = zf[j];
      int rank = 0;
      for (int k = 0; k < S; ++k) rank += zc[k] <= v;
      for (int k = 0; k < F; ++k) rank += zf[k] < v || (zf[k] == v && k < j);
      zo[rank] = v;
      so[rank] = searched_score(zc, wd, S, v);
    }
  }
  __syncwarp();

  // z, dists (the gap to the next output, the last one repeated) and score
  // out as whole rows, float4s where T is a multiple of 4
  const long long row = ray * T;
  if ((T & 3) == 0 && aligned16(z_out) && aligned16(d_out) && aligned16(s_out)) {
    for (int p = 4 * lane; p < T; p += 128) {
      const float4 v = *reinterpret_cast<const float4*>(zo + p);
      const float4 sc = *reinterpret_cast<const float4*>(so + p);
      const float4 d = make_float4(__fsub_rn(v.y, v.x), __fsub_rn(v.z, v.y),
                                   __fsub_rn(v.w, v.z),
                                   p + 4 < T ? __fsub_rn(zo[p + 4], v.w) : __fsub_rn(v.w, v.z));
      *reinterpret_cast<float4*>(z_out + row + p) = v;
      *reinterpret_cast<float4*>(d_out + row + p) = d;
      *reinterpret_cast<float4*>(s_out + row + p) = sc;
    }
  } else {
    for (int p = lane; p < T; p += 32) {
      const float v = zo[p];
      z_out[row + p] = v;
      d_out[row + p] = p < T - 1 ? __fsub_rn(zo[p + 1], v) : __fsub_rn(v, zo[p - 1]);
      s_out[row + p] = so[p];
    }
  }
}

template <int PS, int PF, bool kDraw>
int launch_score(const float* feat, const float* z, const float* dists, const float* u,
                 long long u_stride, float u_step, uint32_t k0, uint32_t k1, long long ray0,
                 int R, int S, int F,
                 int merge, float shift, float scale, int act, float* z_out, float* d_out,
                 float* score, void* stream) {
  const int T = merge ? S + F : F;
  const size_t smem = sizeof(float) * kWarpsPerBlock * ScoreLayout(S, F, T, kDraw).floats;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resample_score_kernel<PS, PF, kDraw>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  resample_score_kernel<PS, PF, kDraw><<<blocks, kWarpsPerBlock * 32, smem,
                                         static_cast<cudaStream_t>(stream)>>>(
      feat, z, dists, u, u_stride, u_step, k0, k1, ray0, R, S, F, merge, shift, scale, act,
      z_out, d_out, score);
  return (int)cudaGetLastError();
}

template <bool kDraw>
int score_entry(const float* feat, const float* z, const float* dists, const float* u,
                long long u_stride, float u_step, uint32_t k0, uint32_t k1, long long ray0,
                int R, int S, int F,
                int merge, float shift, float scale, int act, float* z_out, float* d_out,
                float* score, void* stream) {
  const int T = merge ? S + F : F;
  const int most = S > T ? S : T;
  if (S < 3 || F < 1 || T < 2 || most > 32 * 16) return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaSuccess;
  return (S <= 32 * 4 && F <= 32 * 4 ? launch_score<4, 4, kDraw> : launch_score<16, 16, kDraw>)(
      feat, z, dists, u, u_stride, u_step, k0, k1, ray0, R, S, F, merge, shift, scale, act,
      z_out, d_out, score, stream);
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

// K4c: resample_fwd's z_vals and dists, and the cull score (R, T) of every
// merged depth, K12's function on K4's coarse weights, from one launch;
// up to 512 samples (S and T) a ray.
extern "C" int resample_score_fwd(const float* feat, const float* z, const float* dists,
                                  const float* u, long long u_stride, float u_step, int R,
                                  int S, int F, int merge, float shift, float scale, int act,
                                  float* z_out, float* d_out, float* score, void* stream) {
  return score_entry<false>(feat, z, dists, u, u_stride, u_step, 0, 0, 0, R, S, F, merge,
                            shift, scale, act, z_out, d_out, score, stream);
}

// The training instantiations: resample_chart_fwd and resample_score_fwd
// with u drawn in the kernel, K5's sorted draws under key (k0, k1) = (seed,
// step) (csrc/philox.cuh), bit for bit what sorted_uniform_fwd writes;
// ray i of the launch draws as ray ray0 + i (a data-parallel shard's rays
// draw as the global batch's, ray0 being its first).
extern "C" int resample_chart_draw_fwd(const float* feat, const float* z, const float* dists,
                                       unsigned int k0, unsigned int k1, long long ray0, int R,
                                       int S, int F,
                                       int merge, float shift, float scale, int act,
                                       float* z_out, float* d_out, const float* o,
                                       long long o_stride, const float* d, long long d_stride,
                                       float cx, float cy, float cz, float near_t, float near_p,
                                       float inv_r, float inv_t, float inv_p, int mode,
                                       const float* grid, int n_grid, float inv_nr, float r0,
                                       float inv_r0, float ratio, float inv_log_ratio,
                                       float* coords, void* stream) {
  const ChartArgs ca{cx, cy, cz, near_t, near_p, inv_r, inv_t, inv_p, mode, n_grid, inv_nr,
                     r0, inv_r0, ratio, inv_log_ratio};
  return launch<true, false, true>(feat, z, dists, nullptr, 0, 0.0f, R, S, F, merge, shift,
                                   scale, act, z_out, d_out, o, o_stride, d, d_stride, ca, grid,
                                   coords, nullptr, stream, k0, k1, ray0);
}

extern "C" int resample_score_draw_fwd(const float* feat, const float* z, const float* dists,
                                       unsigned int k0, unsigned int k1, long long ray0, int R,
                                       int S, int F, int merge, float shift, float scale,
                                       int act, float* z_out, float* d_out, float* score,
                                       void* stream) {
  return score_entry<true>(feat, z, dists, nullptr, 0, 0.0f, k0, k1, ray0, R, S, F, merge,
                           shift, scale, act, z_out, d_out, score, stream);
}
