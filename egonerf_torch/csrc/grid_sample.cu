// K16: the linear sample of stacked float32 lines.
//
// Replaces: egonerf_tpu/ops/grid_sample.py sample_line (:38-57) with its
// corner rule _corner (:23-35): for an (S, L, C) float32 stack, a coord in
// [-1, 1] and grid sel (grid 0 without sel, JAX's sel=None),
//   p = (coord + 1) * 0.5 * (L - 1), i0 = floor(p), t = p - i0, i1 = i0 + 1
//   out = line[sel, clip(i0)] * ((1 - t) * valid(i0))
//       + line[sel, clip(i1)] * (t * valid(i1))
// (align_corners, zero padding: a corner outside the grid weighs 0).  The
// float32 steps are JAX's one by one, with explicit _rn intrinsics so nvcc
// contracts nothing into an FMA.  ops/vm_lookup.py's sample_line, the plain
// version, reaches the same values through _axis_cells' clamped pair.
//
// Bound on the card: bytes, the (N, C) float32 output (64 MB at N = 2^20,
// C = 16) and the coords; the lines (33 KB at L = 516) sit in L1 and L2.
// Design: a sample takes a group of G lanes, G = the power of two >=
// C / 4, lane g the 4-channel chunks g, g + G, ...: one 16-byte load a row
// and one 16-byte streaming store a chunk in the vector instantiation
// (C % 4 == 0 and 16-byte aligned lines), one 4-byte load and store a
// channel in the scalar one.  The corner arithmetic is issued once a group.
// The vector width and the selector are template parameters.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4;

template <bool kVec, bool kSel>
__global__ void __launch_bounds__(kThreads)
line_sample_kernel(const float* __restrict__ coord, const int64_t* __restrict__ sel,
                   long long n, const float* __restrict__ lines, int L, int C, int log2_group,
                   float* __restrict__ out) {
  const int group = 1 << log2_group;
  const int g = threadIdx.x & (group - 1);
  const long long s =
      (((long long)blockIdx.x * kThreads) >> log2_group) + (threadIdx.x >> log2_group);
  if (s >= n) return;
  const float p = __fmul_rn(__fmul_rn(__fadd_rn(__ldg(coord + s), 1.0f), 0.5f), (float)(L - 1));
  const float i0f = floorf(p);
  const float t = __fsub_rn(p, i0f);
  const int i0 = (int)i0f;
  const int i1 = i0 + 1;
  const float w0 = (i0 >= 0 && i0 <= L - 1) ? __fsub_rn(1.0f, t) : 0.0f;
  const float w1 = (i1 >= 0 && i1 <= L - 1) ? t : 0.0f;
  const size_t base = kSel ? (size_t)__ldg(sel + s) * L : 0;
  const float* f0 = lines + (base + min(max(i0, 0), L - 1)) * C;
  const float* f1 = lines + (base + min(max(i1, 0), L - 1)) * C;
  float* orow = out + s * C;
  for (int c0 = g * kChunk; c0 < C; c0 += group * kChunk) {
    if (kVec) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(f0 + c0));
      const float4 b = __ldg(reinterpret_cast<const float4*>(f1 + c0));
      __stcs(reinterpret_cast<float4*>(orow + c0),
             make_float4(__fadd_rn(__fmul_rn(a.x, w0), __fmul_rn(b.x, w1)),
                         __fadd_rn(__fmul_rn(a.y, w0), __fmul_rn(b.y, w1)),
                         __fadd_rn(__fmul_rn(a.z, w0), __fmul_rn(b.z, w1)),
                         __fadd_rn(__fmul_rn(a.w, w0), __fmul_rn(b.w, w1))));
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (c0 + j < C) {
          __stcs(orow + c0 + j, __fadd_rn(__fmul_rn(__ldg(f0 + c0 + j), w0),
                                          __fmul_rn(__ldg(f1 + c0 + j), w1)));
        }
      }
    }
  }
}

template <bool kVec>
void launch(bool with_sel, unsigned blocks, cudaStream_t st, const float* coord,
            const int64_t* sel, long long n, const float* lines, int L, int C, int log2_group,
            float* out) {
  if (with_sel) {
    line_sample_kernel<kVec, true><<<blocks, kThreads, 0, st>>>(coord, sel, n, lines, L, C,
                                                                log2_group, out);
  } else {
    line_sample_kernel<kVec, false><<<blocks, kThreads, 0, st>>>(coord, sel, n, lines, L, C,
                                                                 log2_group, out);
  }
}

}  // namespace

// dims {L, C, log2 of the lanes a sample takes, 1 for the vector
// instantiation} (ops/grid_sample.py::sample_line); sel may be null (grid 0)
extern "C" int line_sample(const float* coord, const int64_t* sel, long long n,
                           const float* lines, const int* dims, float* out, void* stream) {
  const int L = dims[0], C = dims[1], log2_group = dims[2];
  const long long per_block = kThreads >> log2_group;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dims[3]) {
    launch<true>(sel != nullptr, blocks, st, coord, sel, n, lines, L, C, log2_group, out);
  } else {
    launch<false>(sel != nullptr, blocks, st, coord, sel, n, lines, L, C, log2_group, out);
  }
  return (int)cudaGetLastError();
}
