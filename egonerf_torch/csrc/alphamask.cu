// K9: the alpha-mask lookup, the trilinear occupancy of a baked binary volume.
//
// Replaces egonerf_tpu/models/alphamask.py _PackedTrilinear.sample
// (models/alphamask.py:50-68), which computes ops/grid_sample.py
// sample_volume (:90-117) with align_corners=True and zeros padding: the
// TensoRF forward's sample gate (models/tensorf.py:226-228), the bake's
// second pass (:126-128) and EgoNeRF's yin-yang mask.
//
// Per sample: coords (x, y, z[, flag]) in [-1, 1]; x indexes W, y H, z D of
// the (S, D, H, W) volume, the flag the grid of a stack of two (a single
// grid ignores it).  The cells follow _axis_cells (ops/vm_lookup.py:
// 317-336): clamped indices, weight t on corner 0 one cell below -1,
// out-of-range corners weigh 0.  Out = sum over the 8 corners of
// ((wz wy) wx) v, added in the order (z, y, x) = 000, 001, 010, ..., 111;
// the plain version (ops/alphamask.py::alpha_fwd_plain) adds in the same
// order, so the two agree to the bit.
//
// Bound on the card: bytes.  One sample reads its 12 or 16 bytes of coords
// and writes 4; the volume is one byte per cell (2 MB at 128^3, read
// through the 50 MB L2).  JAX packs each x-line's 2x2 (z, y) neighbourhood
// into int8 rows so that one gather plus a two-hot reduce replaces eight
// 4-byte gathers on the TPU; on the card a byte load is a byte load, so
// the design is one thread per sample and eight byte loads from L2, and
// the packing is not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Cell {
  int i0;
  float w0, w1;
};

// _axis_cells, as in csrc/vm_lookup.cu.
__device__ __forceinline__ Cell axis_cell(float coord, int size) {
  const float p = __fmul_rn(__fmul_rn(__fadd_rn(coord, 1.0f), 0.5f), (float)(size - 1));
  const float i0f = floorf(p);
  const float t = __fsub_rn(p, i0f);
  const int i0 = (int)i0f;
  const bool v0 = i0 >= 0 && i0 <= size - 1;
  const bool v1 = i0 + 1 >= 0 && i0 + 1 <= size - 1;
  Cell c;
  c.w0 = (i0 == -1) ? t : (v0 ? __fsub_rn(1.0f, t) : 0.0f);
  c.w1 = (v1 && i0 >= 0) ? t : 0.0f;
  c.i0 = min(max(i0, 0), size - 1);
  return c;
}

__global__ void __launch_bounds__(kThreads)
alphamask_kernel(const float* __restrict__ coords, long long n, int stride,
                 const uint8_t* __restrict__ vol, int S, int D, int H, int W,
                 float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* q = coords + i * stride;
  const int sel = (S > 1 && q[3] != 0.0f) ? 1 : 0;
  const Cell cx = axis_cell(q[0], W);
  const Cell cy = axis_cell(q[1], H);
  const Cell cz = axis_cell(q[2], D);
  const int xs[2] = {cx.i0, min(cx.i0 + 1, W - 1)};
  const int ys[2] = {cy.i0, min(cy.i0 + 1, H - 1)};
  const int zs[2] = {cz.i0, min(cz.i0 + 1, D - 1)};
  const float wx[2] = {cx.w0, cx.w1};
  const float wy[2] = {cy.w0, cy.w1};
  const float wz[2] = {cz.w0, cz.w1};
  const uint8_t* V = vol + (size_t)sel * D * H * W;
  float acc = 0.0f;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const uint8_t* row = V + ((size_t)zs[a] * H + ys[b]) * W;
      const float wzy = __fmul_rn(wz[a], wy[b]);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(wzy, wx[c]), (float)row[xs[c]]));
      }
    }
  }
  out[i] = acc;
}

}  // namespace

extern "C" int alphamask_fwd(const float* coords, long long n, int stride, const uint8_t* vol,
                             int S, int D, int H, int W, float* out, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  alphamask_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      coords, n, stride, vol, S, D, H, W, out);
  return (int)cudaGetLastError();
}
