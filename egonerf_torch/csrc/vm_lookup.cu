// K1 (fine field), K3 (coarse density) and K2 (the fine field's backward):
// fused VM-grid lookups.
//
// Replaces:
//   K1  egonerf_tpu/ops/vm_lookup.py  sample_plane_packed_fastgrad (_plane_fwd)
//       + sample_line_hat (_hat_fwd / _hat_matrix), composed by
//       EgoNeRF._fused_products + compute_field (models/egonerf.py:207-247)
//   K3  sample_plane_packed + sample_line_packed (_line_fwd), composed by
//       EgoNeRF.compute_density_feature (models/egonerf.py:249-270)
//   K2  the custom VJPs of K1's lookups: _plane_bwd_bf16 and _hat_bwd
//       (ops/vm_lookup.py:482,611), and _plane_bwd / _line_bwd (:456,519)
//       under compute_dtype="float32" or off the hat gate.  The corner
//       packing, _scatter_chunked, _unpack_plane_grads and
//       _corner_cotangents are TPU layout answers and are not copied.
//
// For i in 0..2 each sample reads 4 corners of plane_i and 2 rows of line_i
// (bf16 tables; with a stack of two grids, EgoNeRF's yin and yang, the {0,1}
// chart flag selects one; a stack of one, TensoRF's single grid, ignores the
// flag as JAX's sel=None lookups do), multiplies
// plane and line per channel, reduces the density channels to
// sum_i relu(sum_c) and (K1) writes the appearance channels.
//
// Bound on the card: bytes.  At the production chunk K1 writes
// N x 145 float32 (608 MB for N = 1,048,576) against ~2.6 GFLOP, so the
// output stream is the floor; the tables (49 MB of bf16) fit in the 50 MB L2.
// Design: one warp per sample, lanes over channels, so each table row
// (C bf16) is one coalesced read and each output row one coalesced write;
// the density sum is a warp shuffle reduction.  No corner packing and no
// one-hot/hat matmuls: those answer TPU gather costs.
//
// Arithmetic follows the JAX forward operation for operation (explicit _rn
// intrinsics keep nvcc from contracting into FMAs): corner weights of
// _axis_cells, ((c00 + c01) + c10) + c11 for the plane, w0*r0 + w1*r1 for
// the line, and for K1's hat path the tent max(0, 1 - |pos - j|) at
// pos = p + sel*L rounded to bf16 (not _axis_cells' t: adding sel*L in
// float32 moves the low bits before the rounding).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

struct Tables {
  const __nv_bfloat16* plane[3];
  const __nv_bfloat16* line[3];
  int h[3], w[3], l[3], c[3], cd[3], hat[3], app_off[3];
};

struct Grads {
  float* plane[3];
  float* line[3];
};

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

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// kTwoGrids: a stack of two grids selected by the flag; a single grid is
// its own instantiation (the flag never read), so that EgoNeRF's keeps the
// registers and the time it had before single grids came in.
template <bool kApp, bool kTwoGrids>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
vm_lookup_kernel(const float* __restrict__ coords, long long n, Tables tb,
                 float* __restrict__ density, float* __restrict__ app, int n_app) {
  const int lane = threadIdx.x & 31;
  const long long s = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= n) return;
  const float* q = coords + 4 * s;
  const float xyz[3] = {q[0], q[1], q[2]};
  const int sel = (kTwoGrids && q[3] != 0.0f) ? 1 : 0;  // the flag is exactly 0 or 1
  float dsum = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    // MAT_MODE = ((0, 1), (0, 2), (1, 2)), VEC_MODE = (2, 1, 0)
    const int m0 = i == 2 ? 1 : 0;
    const int m1 = i == 0 ? 1 : 2;
    const int vm = 2 - i;
    const int H = tb.h[i], W = tb.w[i], L = tb.l[i], C = tb.c[i], CD = tb.cd[i];

    const Cell cx = axis_cell(xyz[m0], W);
    const Cell cy = axis_cell(xyz[m1], H);
    const int x1 = min(cx.i0 + 1, W - 1);
    const int y1 = min(cy.i0 + 1, H - 1);
    const float w00 = __fmul_rn(cy.w0, cx.w0), w01 = __fmul_rn(cy.w0, cx.w1);
    const float w10 = __fmul_rn(cy.w1, cx.w0), w11 = __fmul_rn(cy.w1, cx.w1);
    const __nv_bfloat16* P = tb.plane[i] + (size_t)sel * H * W * C;
    const __nv_bfloat16* r00 = P + ((size_t)cy.i0 * W + cx.i0) * C;
    const __nv_bfloat16* r01 = P + ((size_t)cy.i0 * W + x1) * C;
    const __nv_bfloat16* r10 = P + ((size_t)y1 * W + cx.i0) * C;
    const __nv_bfloat16* r11 = P + ((size_t)y1 * W + x1) * C;

    int j0, j1;
    float lw0, lw1;
    if (tb.hat[i]) {
      const float p = __fmul_rn(__fmul_rn(__fadd_rn(xyz[vm], 1.0f), 0.5f), (float)(L - 1));
      const float pos = __fadd_rn(p, (float)(sel * L));
      const float jf = floorf(pos);
      const int ja = (int)jf - sel * L;  // own-chart row of the lower tent
      lw0 = bf16_round(fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(pos, jf)))));
      lw1 = bf16_round(fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(pos, __fadd_rn(jf, 1.0f))))));
      if (ja < 0 || ja > L - 1) lw0 = 0.0f;
      if (ja + 1 < 0 || ja + 1 > L - 1) lw1 = 0.0f;
      j0 = min(max(ja, 0), L - 1);
      j1 = min(max(ja + 1, 0), L - 1);
    } else {
      const Cell cz = axis_cell(xyz[vm], L);
      j0 = cz.i0;
      j1 = min(cz.i0 + 1, L - 1);
      lw0 = cz.w0;
      lw1 = cz.w1;
    }
    const __nv_bfloat16* Lrow0 = tb.line[i] + ((size_t)sel * L + j0) * C;
    const __nv_bfloat16* Lrow1 = tb.line[i] + ((size_t)sel * L + j1) * C;

    float part = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float pv = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(w00, ld(r00 + c)),
                                                     __fmul_rn(w01, ld(r01 + c))),
                                           __fmul_rn(w10, ld(r10 + c))),
                                 __fmul_rn(w11, ld(r11 + c)));
      const float lv = __fadd_rn(__fmul_rn(lw0, ld(Lrow0 + c)), __fmul_rn(lw1, ld(Lrow1 + c)));
      const float prod = __fmul_rn(pv, lv);
      if (c < CD) {
        part += prod;
      } else if (kApp) {
        app[s * n_app + tb.app_off[i] + (c - CD)] = prod;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    dsum += fmaxf(part, 0.0f);
  }
  if (lane == 0) density[s] = dsum;
}

// K2.  Per sample and decomposition it recomputes K1's corner and line
// weights and the plane and line values (from the bf16 tables: saving the
// N x 384 per-channel values would cost 1.5 GB per production step), the
// pre-relu density partial with the same warp reduction as K1 (so the relu
// mask is K1's to the bit), and then
//   dprod_c = d_dens [partial > 0]  (c < n_density), d_app[c - n_density]
//   dp = dprod l,  dl = dprod p
//   plane cell of corner k  += w_k dp          (float32)
//   line row j              += lw_j bf16(dl)   (hat path, bf16 tents as K1)
//                           += lw_j dl          (float32 _axis_cells weights)
// The planes accumulate in float32, unrounded.  JAX's fastgrad backward
// scatter-adds in bf16, rounding at every add in an order the TPU
// chooses, so no bit-level reference exists; float32 is the semantics of
// its _plane_bwd.  The hat path rounds dl to bf16 and sums in float32, as
// _hat_bwd's bf16 x bf16 -> float32 matmul does.
//
// Bound on the card: bytes, d_app (N x 144 float32, 604 MB at the
// production step) plus the float32 gradient tables (98 MB of planes).
// Design: one warp per sample, lanes over channels as in K1; every
// contribution is an atomicAdd (RED) in float32.  Contention: the line
// tables have at most ~1,000 stacked rows and take ~2M hits per step, and
// samples of one ray share their theta/phi rows; a per-block shared-memory
// pre-sum of the line rows is the next step (not done here).
template <bool kTwoGrids>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
vm_field_bwd_kernel(const float* __restrict__ coords, long long n, Tables tb,
                    const float* __restrict__ d_dens, const float* __restrict__ d_app,
                    int n_app, Grads gr) {
  const int lane = threadIdx.x & 31;
  const long long s = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= n) return;
  const float* q = coords + 4 * s;
  const float xyz[3] = {q[0], q[1], q[2]};
  const int sel = (kTwoGrids && q[3] != 0.0f) ? 1 : 0;
  const float dd_s = d_dens[s];
  const float* da = d_app + s * n_app;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int m0 = i == 2 ? 1 : 0;
    const int m1 = i == 0 ? 1 : 2;
    const int vm = 2 - i;
    const int H = tb.h[i], W = tb.w[i], L = tb.l[i], C = tb.c[i], CD = tb.cd[i];

    const Cell cx = axis_cell(xyz[m0], W);
    const Cell cy = axis_cell(xyz[m1], H);
    const int x1 = min(cx.i0 + 1, W - 1);
    const int y1 = min(cy.i0 + 1, H - 1);
    const float w00 = __fmul_rn(cy.w0, cx.w0), w01 = __fmul_rn(cy.w0, cx.w1);
    const float w10 = __fmul_rn(cy.w1, cx.w0), w11 = __fmul_rn(cy.w1, cx.w1);
    const size_t base = (size_t)sel * H * W;
    const size_t o00 = (base + (size_t)cy.i0 * W + cx.i0) * C;
    const size_t o01 = (base + (size_t)cy.i0 * W + x1) * C;
    const size_t o10 = (base + (size_t)y1 * W + cx.i0) * C;
    const size_t o11 = (base + (size_t)y1 * W + x1) * C;
    const __nv_bfloat16* P = tb.plane[i];

    int j0, j1;
    float lw0, lw1;
    const bool hat = tb.hat[i];
    if (hat) {
      const float p = __fmul_rn(__fmul_rn(__fadd_rn(xyz[vm], 1.0f), 0.5f), (float)(L - 1));
      const float pos = __fadd_rn(p, (float)(sel * L));
      const float jf = floorf(pos);
      const int ja = (int)jf - sel * L;
      lw0 = bf16_round(fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(pos, jf)))));
      lw1 = bf16_round(fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(pos, __fadd_rn(jf, 1.0f))))));
      if (ja < 0 || ja > L - 1) lw0 = 0.0f;
      if (ja + 1 < 0 || ja + 1 > L - 1) lw1 = 0.0f;
      j0 = min(max(ja, 0), L - 1);
      j1 = min(max(ja + 1, 0), L - 1);
    } else {
      const Cell cz = axis_cell(xyz[vm], L);
      j0 = cz.i0;
      j1 = min(cz.i0 + 1, L - 1);
      lw0 = cz.w0;
      lw1 = cz.w1;
    }
    const size_t l0 = ((size_t)sel * L + j0) * C;
    const size_t l1 = ((size_t)sel * L + j1) * C;
    const __nv_bfloat16* Ln = tb.line[i];

    // the pre-relu density partial, as K1 sums it
    float part = 0.0f;
    for (int c = lane; c < CD; c += 32) {
      const float pv = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(w00, ld(P + o00 + c)),
                                                     __fmul_rn(w01, ld(P + o01 + c))),
                                           __fmul_rn(w10, ld(P + o10 + c))),
                                 __fmul_rn(w11, ld(P + o11 + c)));
      const float lv = __fadd_rn(__fmul_rn(lw0, ld(Ln + l0 + c)), __fmul_rn(lw1, ld(Ln + l1 + c)));
      part += __fmul_rn(pv, lv);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    const float dd = part > 0.0f ? dd_s : 0.0f;

    float* gP = gr.plane[i];
    float* gL = gr.line[i];
    for (int c = lane; c < C; c += 32) {
      const float dprod = c < CD ? dd : da[tb.app_off[i] + (c - CD)];
      if (dprod == 0.0f) continue;
      const float pv = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(w00, ld(P + o00 + c)),
                                                     __fmul_rn(w01, ld(P + o01 + c))),
                                           __fmul_rn(w10, ld(P + o10 + c))),
                                 __fmul_rn(w11, ld(P + o11 + c)));
      const float lv = __fadd_rn(__fmul_rn(lw0, ld(Ln + l0 + c)), __fmul_rn(lw1, ld(Ln + l1 + c)));
      const float dp = __fmul_rn(dprod, lv);
      const float dl = __fmul_rn(dprod, pv);
      if (w00 != 0.0f) atomicAdd(gP + o00 + c, __fmul_rn(w00, dp));
      if (w01 != 0.0f) atomicAdd(gP + o01 + c, __fmul_rn(w01, dp));
      if (w10 != 0.0f) atomicAdd(gP + o10 + c, __fmul_rn(w10, dp));
      if (w11 != 0.0f) atomicAdd(gP + o11 + c, __fmul_rn(w11, dp));
      const float dlr = hat ? bf16_round(dl) : dl;
      if (lw0 != 0.0f) atomicAdd(gL + l0 + c, __fmul_rn(lw0, dlr));
      if (lw1 != 0.0f) atomicAdd(gL + l1 + c, __fmul_rn(lw1, dlr));
    }
  }
}

// dims: per decomposition i, {H, W, L, C, n_density, hat}, then the stack size
Tables make_tables(const void* const* planes, const void* const* lines, const int* dims) {
  Tables tb;
  int off = 0;
  for (int i = 0; i < 3; ++i) {
    tb.plane[i] = static_cast<const __nv_bfloat16*>(planes[i]);
    tb.line[i] = static_cast<const __nv_bfloat16*>(lines[i]);
    tb.h[i] = dims[6 * i + 0];
    tb.w[i] = dims[6 * i + 1];
    tb.l[i] = dims[6 * i + 2];
    tb.c[i] = dims[6 * i + 3];
    tb.cd[i] = dims[6 * i + 4];
    tb.hat[i] = dims[6 * i + 5];
    tb.app_off[i] = off;
    off += tb.c[i] - tb.cd[i];
  }
  return tb;
}

template <bool kApp>
int launch(const float* coords, long long n, const void* const* planes,
           const void* const* lines, const int* dims, float* density, float* app,
           int n_app, void* stream) {
  const Tables tb = make_tables(planes, lines, dims);
  const unsigned blocks = (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dims[18] > 1) {
    vm_lookup_kernel<kApp, true><<<blocks, kWarpsPerBlock * 32, 0, st>>>(coords, n, tb, density,
                                                                        app, n_app);
  } else {
    vm_lookup_kernel<kApp, false><<<blocks, kWarpsPerBlock * 32, 0, st>>>(coords, n, tb,
                                                                         density, app, n_app);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vm_field_fwd(const float* coords, long long n, const void* const* planes,
                            const void* const* lines, const int* dims, float* density,
                            float* app, int n_app, void* stream) {
  return launch<true>(coords, n, planes, lines, dims, density, app, n_app, stream);
}

extern "C" int vm_field_bwd(const float* coords, long long n, const void* const* planes,
                            const void* const* lines, const int* dims, const float* d_dens,
                            const float* d_app, int n_app, void* const* gplanes,
                            void* const* glines, void* stream) {
  const Tables tb = make_tables(planes, lines, dims);
  Grads gr;
  for (int i = 0; i < 3; ++i) {
    gr.plane[i] = static_cast<float*>(gplanes[i]);
    gr.line[i] = static_cast<float*>(glines[i]);
  }
  const unsigned blocks = (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dims[18] > 1) {
    vm_field_bwd_kernel<true><<<blocks, kWarpsPerBlock * 32, 0, st>>>(coords, n, tb, d_dens,
                                                                     d_app, n_app, gr);
  } else {
    vm_field_bwd_kernel<false><<<blocks, kWarpsPerBlock * 32, 0, st>>>(coords, n, tb, d_dens,
                                                                      d_app, n_app, gr);
  }
  return (int)cudaGetLastError();
}

extern "C" int vm_density_fwd(const float* coords, long long n, const void* const* planes,
                              const void* const* lines, const int* dims, float* density,
                              float* app, int n_app, void* stream) {
  return launch<false>(coords, n, planes, lines, dims, density, app, n_app, stream);
}
