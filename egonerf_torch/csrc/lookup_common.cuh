// Device helpers shared by the VM lookups (vm_lookup.cu: K1, K2, K3, K15)
// and the CP line product (cp_lookup.cu: K17, K17b): JAX's _axis_cells
// corner rule, the bf16 rounding, and the walking merge of K2 and K17b.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Cell {
  int i0;
  float w0, w1;
};

// _axis_cells: [-1, 1] coord -> clamped cell0 and the weights of the clamped
// pair (cell0, cell0 + 1), align_corners=True, zeros padding.
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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// w * v, rounded to bf16 under kRound and `round` (line mode 2's corner
// cotangent); without kRound the plain product.
template <bool kRound>
__device__ __forceinline__ float corner_term(float w, float v, bool round) {
  const float t = __fmul_rn(w, v);
  return (kRound && round) ? bf16_round(t) : t;
}

// One slot of a walking group: while the row repeats, add w * v to the
// pending sum; on another row hand the sum to flush(row, sum) and start
// anew.  row < 0: nothing pending.  A zero weight adds nothing.  With
// kRound and `round`, each w * v is rounded to bf16 before it is added.
template <int kCh, bool kRound = false, typename Flush>
__device__ __forceinline__ void merge(int& row, float acc[kCh], int next, float w,
                                      const float v[kCh], Flush flush, bool round = false) {
  if (w == 0.0f) return;
  if (next != row) {
    if (row >= 0) flush(row, acc);
    row = next;
#pragma unroll
    for (int j = 0; j < kCh; ++j) acc[j] = corner_term<kRound>(w, v[j], round);
  } else {
#pragma unroll
    for (int j = 0; j < kCh; ++j) acc[j] = __fadd_rn(acc[j], corner_term<kRound>(w, v[j], round));
  }
}

}  // namespace
