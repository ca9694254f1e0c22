// K12: the empty-space cull's score of every merged sample; K13: the top-K
// compaction of the merged samples by that score.
//
// Replaces egonerf_tpu/ops/cull.py coarse_importance (:30-54), an (N, S, C)
// broadcast-compare reduction, and select_top_k (:103-125), lax.top_k with
// sort(idx) and a one-hot HIGHEST-precision matmul: both gather-free TPU
// shapes of a per-ray search and a per-ray compaction.
//
// K12, per ray: the coarse weights dilated by one interval, wd_c =
// max(w_c, w_{c+1}, w_{c-1}) with the edges repeated; each merged sample z
// scores wd_c of the coarse interval [coarse_z[c], coarse_z[c+1]) holding
// it, the last interval open to +inf, and 0 below coarse_z[0].  JAX sums
// wd over every interval with z >= lower & z < upper; the coarse depths are
// sorted (the sampler's depths never decrease), so the intervals are
// disjoint (a repeated depth gives an empty [z, z)) and at most one term
// survives: c = #(coarse_z <= z) - 1, found by one binary search, which is
// that test exactly (a NaN z finds no interval on both sides).
//
// K13, per ray: sample i has rank #{j : s_j > s_i, or s_j == s_i and j < i}
// (lax.top_k's order: ties to the lower index) and is kept when its rank is
// below K; the kept samples go out in index (depth) order with their z and
// their original dist.  No sort: the scores map to order-preserving 32-bit
// keys (-0 taken as +0, so float equality and key equality agree), a
// bitwise radix select over the warp finds T, the K-th largest key (32
// steps, each a count of the keys >= a candidate: one compare a key and a
// warp sum), and a sample is kept when its key is above T, or equal to T
// and fewer than K - #(key > T) equal keys precede it.  Each lane owns a
// contiguous run of samples, so the equal keys before it and its output
// slot are exclusive warp scans of the lanes' counts.
//
// Bound on the card: bytes (K12 reads z (S), coarse_z and the weights (2C)
// and writes the score (S) a ray, 4096 x 768 floats = 12.6 MB for a
// production chunk; K13 reads z, dists and the score (3S) and writes 2K, 15
// MB at K = 192), a few microseconds at 3.35 TB/s.  Design: one warp a ray
// (a 4096-ray chunk is one wave), nothing kept across rays; K12 stages
// coarse_z and the dilated weights in shared memory for the searches; K13
// keeps a lane's keys in registers (S <= 32 x kMaxRun).
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
// K12: the coarse depths and dilated weights of each warp's ray in shared
// memory, 2 x C floats a warp
constexpr int kMaxCoarse = 768;
// K13: keys a lane holds in registers
constexpr int kMaxRun = 16;

__device__ __forceinline__ int warp_sum(int v) { return __reduce_add_sync(kFullMask, v); }

// sum of v over the lanes below this one
__device__ __forceinline__ int warp_exclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += o;
  }
  return incl - v;
}

// an order-preserving key of a non-NaN float; -0 and +0 give one key
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cull_score_kernel(const float* __restrict__ z, const float* __restrict__ cz,
                  const float* __restrict__ cw, int R, int S, int C,
                  float* __restrict__ score) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (ray >= R) return;
  float* zc = smem + warp * 2 * C;
  float* wd = zc + C;
  cz += ray * C;
  cw += ray * C;
  for (int c = lane; c < C; c += 32) {
    zc[c] = cz[c];
    wd[c] = fmaxf(cw[c], fmaxf(cw[min(c + 1, C - 1)], cw[max(c - 1, 0)]));
  }
  __syncwarp();
  z += ray * S;
  score += ray * S;
  for (int j = lane; j < S; j += 32) {
    const float v = z[j];
    // #(coarse_z <= v)
    int lo = 0, hi = C;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (zc[mid] <= v) lo = mid + 1; else hi = mid;
    }
    score[j] = lo > 0 ? wd[lo - 1] : 0.0f;
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
top_k_kernel(const float* __restrict__ z, const float* __restrict__ d,
             const float* __restrict__ s, int R, int S, int K, float* __restrict__ z_out,
             float* __restrict__ d_out) {
  const int lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ray >= R) return;
  const int per = (S + 31) / 32;
  const int a = min(lane * per, S), n = min(a + per, S) - a;
  s += ray * S + a;
  unsigned key[kMaxRun];
#pragma unroll
  for (int t = 0; t < kMaxRun; ++t) key[t] = t < n ? order_key(s[t]) : 0u;

  // T: the largest key with #(key >= T) >= K, the K-th largest key
  unsigned T = 0u;
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned cand = T | (1u << bit);
    int cnt = 0;
#pragma unroll
    for (int t = 0; t < kMaxRun; ++t) cnt += t < n && key[t] >= cand;
    if (warp_sum(cnt) >= K) T = cand;
  }
  int gt = 0, eq = 0;
#pragma unroll
  for (int t = 0; t < kMaxRun; ++t) {
    gt += t < n && key[t] > T;
    eq += t < n && key[t] == T;
  }
  // the first K - #(key > T) keys equal to T, in index order, are kept
  const int room = K - warp_sum(gt);
  int eq_before = warp_exclusive_sum(eq);
  unsigned kept = 0u;
  int n_kept = 0;
#pragma unroll
  for (int t = 0; t < kMaxRun; ++t) {
    bool k = t < n && key[t] > T;
    if (t < n && key[t] == T) k = eq_before++ < room;
    kept |= (unsigned)k << t;
    n_kept += k;
  }
  int slot = warp_exclusive_sum(n_kept);
  z += ray * S + a;
  d += ray * S + a;
  z_out += ray * K;
  d_out += ray * K;
  for (int t = 0; t < n; ++t) {
    if (kept >> t & 1u) {
      z_out[slot] = z[t];
      d_out[slot] = d[t];
      ++slot;
    }
  }
}

}  // namespace

// score (R, S) of the merged depths z (R, S) from the coarse depths cz and
// weights cw (R, C); cz sorted per ray.
extern "C" int cull_score(const float* z, const float* cz, const float* cw, int R, int S,
                          int C, float* score, void* stream) {
  if (S < 1 || C < 1 || C > kMaxCoarse) return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * kWarpsPerBlock * 2 * C;
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cull_score_kernel<<<blocks, kWarpsPerBlock * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      z, cz, cw, R, S, C, score);
  return (int)cudaGetLastError();
}

// the K (1 <= K < S) highest-score samples of each ray in depth order:
// z_out, d_out (R, K) from z, d, s (R, S).
extern "C" int top_k(const float* z, const float* d, const float* s, int R, int S, int K,
                     float* z_out, float* d_out, void* stream) {
  if (S < 2 || S > 32 * kMaxRun || K < 1 || K >= S) return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaSuccess;
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  top_k_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      z, d, s, R, S, K, z_out, d_out);
  return (int)cudaGetLastError();
}
