// K12: the empty-space cull's score of every merged sample; K13: the top-K
// compaction of the merged samples by that score.  The cull's path takes
// the score from K4c (csrc/resample.cu: K12's function in K4's epilogue,
// from the same merge); K12 stays a standalone op.
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
// bitwise select over the warp finds T, the K-th largest key (a step a
// bit from the top, each a compare a key and a warp sum, stopping once
// exactly K keys are >= T), and a sample is kept when its key is above T,
// or equal to T and fewer than K - #(key > T) equal keys precede it.
// Sample 32 t + lane belongs to lane `lane` (t < ceil(S / 32)), so every
// load and store of a warp is one contiguous run; the equal keys before a
// sample and its output slot are ballot counts of the lanes below it plus
// running counts over t.
//
// Bound on the card: bytes (K12 reads z (S), coarse_z and the weights (2C)
// and writes the score (S) a ray, 4096 x 768 floats = 12.6 MB for a
// production chunk; K13 reads z, dists and the score (3S) and writes 2K, 15
// MB at K = 192), a few microseconds at 3.35 TB/s.  Design: one warp a ray
// (a 4096-ray chunk is one wave), nothing kept across rays; K12 stages
// coarse_z and the dilated weights in shared memory for the searches; K13
// loads a ray's scores, z and dists into registers at once (S <= 32 x
// kMaxRows; 64 registers at 256 samples, four blocks an SM) and writes the
// kept ones behind the selection.  Measured on the card
// (egonerf_torch/tools/cull_kernel_ab.py --ablate, H100 80GB HBM3, 700 W): the
// earlier K13, a lane's contiguous run of 8 samples (each load and store
// instruction touched eight lines) and the same select without its early
// stop, took 0.0234 ms at K = 192, its stores 6 of them and its select 3;
// a draft with 4 passes of 8-bit digits (a warp's 256-bin histogram in
// shared memory, a run of one digit in adjacent lanes added once) spent
// 5.9 us selecting, more than the 32 one-bit steps.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
// K12: the coarse depths and dilated weights of each warp's ray in shared
// memory, 2 x C floats a warp
constexpr int kMaxCoarse = 768;
// K13: rows of 32 samples a ray, a lane's keys, z and dists in registers
// (instantiated for 8 rows, the production 256 samples, and for 16)
constexpr int kMaxRows = 16;

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

// lanes below this one
__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

template <int ROWS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
top_k_kernel(const float* __restrict__ z, const float* __restrict__ d,
             const float* __restrict__ s, int R, int S, int K, float* __restrict__ z_out,
             float* __restrict__ d_out) {
  const int lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ray >= R) return;
  const int rows = (S + 31) / 32;
  const unsigned below = lanes_below();
  s += ray * S;
  z += ray * S;
  d += ray * S;
  // keys 0 past S (0 is no float's key: the scores are not NaN)
  unsigned key[ROWS];
  float zv[ROWS], dv[ROWS];
#pragma unroll
  for (int t = 0; t < ROWS; ++t) {
    const int i = 32 * t + lane;
    const bool in = t < rows && i < S;
    key[t] = in ? order_key(s[i]) : 0u;
    zv[t] = in ? z[i] : 0.0f;
    dv[t] = in ? d[i] : 0.0f;
  }

  // T, bit by bit from the top: the largest T with #(key >= T) >= K, the
  // K-th largest key, each step a compare a key and a warp sum; it stops
  // once exactly K keys are >= T (then they are the kept ones)
  unsigned T = 0u;
  int ge = S;  // #(key >= T), the same in every lane
  for (int bit = 31; bit >= 0 && ge != K; --bit) {
    const unsigned cand = T | (1u << bit);
    int cnt = 0;
#pragma unroll
    for (int t = 0; t < ROWS; ++t) cnt += key[t] >= cand;
    cnt = __reduce_add_sync(kFullMask, cnt);
    if (cnt >= K) {
      T = cand;
      ge = cnt;
    }
  }
  int gt = 0;
#pragma unroll
  for (int t = 0; t < ROWS; ++t) gt += key[t] > T;
  const int need = K - __reduce_add_sync(kFullMask, gt);

  // the first `need` keys equal to T, in index order, are kept with every
  // key above T: K in all; their slots in index order
  int eq_before = 0, slot = 0;
  z_out += ray * K;
  d_out += ray * K;
#pragma unroll
  for (int t = 0; t < ROWS; ++t) {
    if (t < rows) {
      const bool eq = key[t] == T;
      const unsigned eqs = __ballot_sync(kFullMask, eq);
      const bool keep = key[t] > T || (eq && eq_before + __popc(eqs & below) < need);
      const unsigned kept = __ballot_sync(kFullMask, keep);
      if (keep) {
        const int o = slot + __popc(kept & below);
        z_out[o] = zv[t];
        d_out[o] = dv[t];
      }
      eq_before += __popc(eqs);
      slot += __popc(kept);
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
  if (S < 2 || S > 32 * kMaxRows || K < 1 || K >= S) return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaSuccess;
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  auto kern = S <= 32 * 8 ? top_k_kernel<8> : top_k_kernel<kMaxRows>;
  kern<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(z, d, s, R, S, K,
                                                                               z_out, d_out);
  return (int)cudaGetLastError();
}
