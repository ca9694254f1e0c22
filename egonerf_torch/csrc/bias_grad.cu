// K11: the bias gradient of a shader layer, db = sum over rows of dout.
//
// Replaces the backward of egonerf_tpu/models/shading.py::_bias_add
// (:62-83), which EGONERF_BIAS_DOT=1 puts on every shader layer: db =
// ones @ dout contracted with float32 accumulation, a column sum of the
// (M, C) float32 cotangent (C = 128 for l1 and l2, 3 for l3; M = 1,048,576
// rows at the production step).  Its forward is the plain x + b.
//
// Bound on the card: bytes, the 537 MB of a (M, 128) cotangent read once
// (0.16 ms at 3.35 TB/s); the adds are one a byte.  Design: a block sums a
// contiguous range of rows, which is one contiguous range of floats.  With
// C % 4 == 0 (l1, l2) its lanes read 16 bytes each, consecutive lanes on
// consecutive columns: lane t keeps the float32 sums of columns 4 (t % C/4)
// .. + 3 over every (256 / (C/4))-th row.  Otherwise its T = C floor(256 /
// C) lanes (C lanes, each taking the columns t, t + 256, ... when C > 256)
// read the range with consecutive lanes on consecutive floats, so lane t
// always lands on column t % C and keeps one sum.  The lanes of a column
// are then added in lane order and the block writes one partial row.  A
// second kernel adds the partials in block order: no atomics, the same bits
// every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// part[blockIdx.x] (C,) = the column sums of rows [b r, min((b + 1) r, M)).
// Dynamic shared memory: max(T, C) floats (T lanes, or T float4 lanes).
// With vec (C % 4 == 0, C <= 1024, dout 16-byte aligned) a lane reads 16
// bytes a row: columns 4 q .. 4 q + 3, q = t % (C / 4), every
// (256 / (C / 4))-th row.
__global__ void __launch_bounds__(kThreads)
bias_grad_part_kernel(const float* __restrict__ dout, long long m, int c,
                      long long rows_per_block, int vec, float* __restrict__ part) {
  extern __shared__ float lanes[];
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = min(m, r0 + rows_per_block);
  const float* base = dout + r0 * c;
  int per_step;  // rows one pass of the lanes covers
  if (vec) {
    const int quads = c / 4;
    per_step = kThreads / quads;
    const int t = threadIdx.x;
    if (t < per_step * quads) {
      const int q = t % quads;
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float4* src = reinterpret_cast<const float4*>(base) + q;
#pragma unroll 8
      for (long long r = t / quads; r < r1 - r0; r += per_step) {
        const float4 v = __ldg(src + r * quads);
        s.x = __fadd_rn(s.x, v.x), s.y = __fadd_rn(s.y, v.y);
        s.z = __fadd_rn(s.z, v.z), s.w = __fadd_rn(s.w, v.w);
      }
      // lane t holds columns 4q .. 4q + 3 of row group t / quads
      reinterpret_cast<float4*>(lanes)[t] = s;
    }
  } else {
    per_step = c <= kThreads ? kThreads / c : 1;
    const int span = per_step * c;  // T, or C when C > 256
    const long long size = (r1 - r0) * c;
    for (int t = threadIdx.x; t < span; t += kThreads) {
      float s = 0.0f;
#pragma unroll 8
      for (long long f = t; f < size; f += span) s = __fadd_rn(s, __ldg(base + f));
      lanes[t] = s;
    }
  }
  __syncthreads();
  // in both layouts lanes[g * c + col] is row group g's sum of column col
  for (int col = threadIdx.x; col < c; col += kThreads) {
    float s = 0.0f;
    for (int g = 0; g < per_step; ++g) s = __fadd_rn(s, lanes[g * c + col]);
    part[blockIdx.x * (long long)c + col] = s;
  }
}

// out[col] = sum over blocks b of part[b][col], b in increasing order
__global__ void __launch_bounds__(kThreads)
bias_grad_sum_kernel(const float* __restrict__ part, int blocks, int c, float* __restrict__ out) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= c) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s = __fadd_rn(s, __ldg(part + (long long)b * c + col));
  out[col] = s;
}

}  // namespace

// part: (ceil(M / rows_per_block), C) float32 scratch; vec: the 16-byte
// lanes (ops/bias.py decides: C % 4 == 0, C <= 1024, dout 16-byte aligned)
extern "C" int bias_grad(const float* dout, long long m, int c, long long rows_per_block, int vec,
                         float* part, float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((m + rows_per_block - 1) / rows_per_block);
  if (vec && (c % 4 != 0 || c > 4 * kThreads)) return (int)cudaErrorInvalidValue;
  const int span = vec ? kThreads / (c / 4) * c : c <= kThreads ? kThreads / c * c : c;
  const size_t smem = sizeof(float) * (size_t)span;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // ops/bias.py raises first
  bias_grad_part_kernel<<<blocks, kThreads, smem, st>>>(dout, m, c, rows_per_block, vec, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bias_grad_sum_kernel<<<(c + kThreads - 1) / kThreads, kThreads, 0, st>>>(part, (int)blocks, c,
                                                                          out);
  return (int)cudaGetLastError();
}
