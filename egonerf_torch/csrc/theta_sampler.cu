// K14: the theta-importance sampler's row draw and the flat ray id.
//
// Replaces: egonerf_tpu/data/samplers.py make_device_id_sampler, its
// ThetaImportanceSampler branch (:87-102):
//   row = min(searchsorted(cdf, u, side="left", method="compare_all"), h - 1)
//   id  = img * (w * h) + row * w + col
// compare_all is the TPU's gather-free form: a (batch, h) broadcast-compare
// summed over h.  Its count of cdf[i] < u is, on a non-decreasing cdf, the
// lower bound, which a binary search finds in ceil(log2 h) probes.
//
// Bound on the card: launch time.  A batch of 4,096 draws moves 115 KB
// (img and col int64, u float32 in; the int64 id out) and the cdf (960
// floats on the Ricoh raster), under 0.1 us at 3.35 TB/s.
// Design: one thread a draw.  Each block first stages the cdf in shared
// memory (kStaged; a cdf above 48 KB, 12,288 rows, is read through the
// read-only cache instead), then every thread runs a branch-free lower
// bound: the window [base, base + len] always holds the answer, each probe
// halves len and moves base by a select, not a branch, so the warp never
// diverges.  The grid is capped and strides over larger batches, so a
// block's staging is paid for by many draws.
//
// theta_batch_kernel (K14f) is the training path's sampler: it draws, picks
// and gathers a whole batch in one launch, where the step took five (the
// image and column draws, the uniforms, theta_ids and the gather of the
// resident ray buffer).  Draw i of batch t takes one Philox4x32-10 block at
// counter (i, i >> 32, 0, kThetaStream) under key (seed, t) (csrc/philox.cuh;
// K5's draws use another stream word) and maps its words x, y, z to img =
// (x * img_len) >> 32, col = (y * w) >> 32 and u = (z >> 8) * 2^-24 (exact
// in float32); the row is theta_ids_kernel's lower bound and clamp, the id
// the same arithmetic; the id's F floats of the (N, F) buffer go to row i
// of the (B, F) output, F = 9 (rays | rgb) or 10 (| depth, under
// use_depth: JAX's trainer.py:479-481, 540-542), a template parameter.
// Bound: bytes, 4 x F floats read and written and the int64 id written a
// draw (0.3 MB at 4,096 draws), so the launch.
// Design: theta_ids_kernel's grid and staging; one thread a draw, and each
// warp copies its 32 rows' 32 F floats together, lane-strided over the
// warp's output rows (coalesced stores), each float's id taken from its
// draw's lane by a shuffle.  Measured: 5.1 us a 4,096-draw batch against
// the five launches' 17.9 (tools/draw_ab.py, H100 80GB HBM3, 700 W).
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using namespace egonerf;

// counter word 3 of the theta sampler's draws: its stream
constexpr uint32_t kThetaStream = 0x7E7Au;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 2048;
constexpr int kMaxStaged = 48 * 1024 / sizeof(float);

// the count of cdf[i] < x over cdf[0 .. h-1], non-decreasing, h >= 1
__device__ __forceinline__ int lower_bound(const float* cdf, int h, float x) {
  int base = 0, len = h;
  while (len > 1) {
    const int half = len >> 1;
    base = cdf[base + half] < x ? base + half : base;
    len -= half;
  }
  return base + (cdf[base] < x ? 1 : 0);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
theta_ids_kernel(const int64_t* __restrict__ img, const int64_t* __restrict__ col,
                 const float* __restrict__ u, long long n, const float* __restrict__ cdf, int h,
                 int w, int64_t* __restrict__ out) {
  extern __shared__ float staged[];
  const float* c = cdf;
  if (kStaged) {
    for (int i = threadIdx.x; i < h; i += kThreads) staged[i] = __ldg(cdf + i);
    __syncthreads();
    c = staged;
  }
  const long long plane = (long long)w * h;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const int row = min(lower_bound(c, h, __ldg(u + i)), h - 1);
    out[i] = __ldg(img + i) * plane + (long long)row * w + __ldg(col + i);
  }
}

// kRowFloats: rays (6) | rgb (3), and | depth (1) under use_depth
template <bool kStaged, int kRowFloats>
__global__ void __launch_bounds__(kThreads)
theta_batch_kernel(const float* __restrict__ buffer, const float* __restrict__ cdf, int h, int w,
                   long long img_len, long long n, uint32_t k0, uint32_t k1,
                   int64_t* __restrict__ ids, float* __restrict__ rows) {
  extern __shared__ float staged[];
  const float* c = cdf;
  if (kStaged) {
    for (int i = threadIdx.x; i < h; i += kThreads) staged[i] = __ldg(cdf + i);
    __syncthreads();
    c = staged;
  }
  const int lane = threadIdx.x & 31;
  const long long plane = (long long)w * h;
  // the loop runs over whole warps, so every lane takes the shuffles
  for (long long base = (long long)blockIdx.x * kThreads + (threadIdx.x & ~31); base < n;
       base += (long long)gridDim.x * kThreads) {
    const long long i = base + lane;
    long long id = 0;
    if (i < n) {
      const U4 o = philox4x32_10(
          U4{(uint32_t)i, (uint32_t)((unsigned long long)i >> 32), 0u, kThetaStream}, k0, k1);
      const long long img = (long long)(((unsigned long long)o.x * img_len) >> 32);
      const long long col = (long long)(((unsigned long long)o.y * (unsigned)w) >> 32);
      const float u = (float)(o.z >> 8) * 5.9604644775390625e-08f;  // 2^-24
      const int row = min(lower_bound(c, h, u), h - 1);
      id = img * plane + (long long)row * w + col;
      ids[i] = id;
    }
    const long long n_here = n - base < 32 ? n - base : 32;
    float* out = rows + base * kRowFloats;
#pragma unroll
    for (int k = 0; k < kRowFloats; ++k) {
      const int q = k * 32 + lane;  // float q of the warp's 32 x 9 output
      const int r = q / kRowFloats;
      const long long src = __shfl_sync(kFullMask, id, r);
      if (r < n_here) out[q] = __ldg(buffer + src * kRowFloats + (q - r * kRowFloats));
    }
  }
}

}  // namespace

extern "C" int theta_ids(const int64_t* img, const int64_t* col, const float* u, long long n,
                         const float* cdf, int h, int w, int64_t* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h <= kMaxStaged) {
    theta_ids_kernel<true><<<blocks, kThreads, h * sizeof(float), st>>>(img, col, u, n, cdf, h,
                                                                        w, out);
  } else {
    theta_ids_kernel<false><<<blocks, kThreads, 0, st>>>(img, col, u, n, cdf, h, w, out);
  }
  return (int)cudaGetLastError();
}

namespace {

template <int kRowFloats>
void launch_batch(unsigned blocks, cudaStream_t st, const float* buffer, const float* cdf, int h,
                  int w, long long img_len, long long n, unsigned int seed, unsigned int t,
                  int64_t* ids, float* rows) {
  if (h <= kMaxStaged) {
    theta_batch_kernel<true, kRowFloats><<<blocks, kThreads, h * sizeof(float), st>>>(
        buffer, cdf, h, w, img_len, n, seed, t, ids, rows);
  } else {
    theta_batch_kernel<false, kRowFloats><<<blocks, kThreads, 0, st>>>(
        buffer, cdf, h, w, img_len, n, seed, t, ids, rows);
  }
}

}  // namespace

// K14f: B draws of batch t under seed: the ids (B,) int64 and the rows
// (B, F) of the (img_len * h * w, F) float32 buffer, F = row_floats, 9 or
// 10.
extern "C" int theta_batch(const float* buffer, int row_floats, const float* cdf, int h, int w,
                           long long img_len, long long n, unsigned int seed, unsigned int t,
                           int64_t* ids, float* rows, void* stream) {
  if (row_floats != 9 && row_floats != 10) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  const long long want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (row_floats == 9) {
    launch_batch<9>(blocks, st, buffer, cdf, h, w, img_len, n, seed, t, ids, rows);
  } else {
    launch_batch<10>(blocks, st, buffer, cdf, h, w, img_len, n, seed, t, ids, rows);
  }
  return (int)cudaGetLastError();
}
