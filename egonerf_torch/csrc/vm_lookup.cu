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
// K1 and K3 (vm_lookup_kernel).  Bound on the card: K1 by bytes, its
// appearance stream of N x n_app float32 (604 MB at the production chunk,
// N = 1,048,576, n_app = 144; 0.18 ms at 3.35 TB/s); K3 by its instruction
// count (it writes 4 bytes a sample and its half-resolution tables sit in
// L2).  The work is gathers and per-channel products (~2.6 GFLOP a
// production chunk, 0.04 ms at the float32 rate): no matrix product, so the
// tensor cores do not apply.
// Design: a sample takes a group of G lanes, G = the power of two >= C / 8
// (K1's C = 64: 8 lanes, 4 samples a warp; K3's C = 16: 2 lanes, 16 samples
// a warp), and lane g of the group owns the 8-channel chunks g, g + G, ...
// of each table row.  So each row slice is one 16-byte load of 8 bf16
// values (the vector instantiation, C % 8 == 0 and 16-byte aligned tables;
// any other width takes the scalar instantiation, the same code with one
// 2-byte load a channel), each sample's coordinates one float4 load, and the
// cell and weight arithmetic is issued once per group of lanes instead of
// by all 32.  Consecutive samples of a ray share a warp and a block, and so
// their angle rows in L1.  K1's appearance products go to a shared-memory
// tile of the block's rows ([samples x n_app], one contiguous range of the
// output), which one thread writes with a single bulk asynchronous copy
// (cp.async.bulk, the TMA engine): whole lines, no partial sectors.  On an
// H100 80GB HBM3 at 700 W this measured 0.4319 ms a production chunk
// against 0.4470 for 16-byte streaming stores from the lanes (st.global.cs,
// evict-first) and 0.4636 for the copy without the 4-blocks-an-SM launch
// bound, which holds the kernel to 64 registers without spills (the
// streaming stores spill under it).  A cold L2 costs it under 1%, so the
// output stream does not push the tables (49 MB at the production grid)
// out of the 50 MB L2 enough to matter; an L2 access-policy window was not
// tried, since one window covers one allocation and the tables are six.
// The single grid, the appearance output and the vector load are template
// parameters: a run-time flag costs registers.
//
// The density sum's order, which K2 and ops/vm_lookup.py::_warp_order_sum
// repeat so that the relu mask is the same bit everywhere: channel c < CD
// lies in chunk c / 8 and chunk q belongs to lane q mod G; each lane adds
// its channels in increasing c, from 0.0f; then a butterfly over the
// group, xor offsets G/2, ..., 1.  K2 takes the same chunks over a whole
// warp (lane q mod 32): the lanes past the last density chunk hold exact
// zeros, so the wider butterfly adds the same values in the same tree.
//
// Arithmetic follows the JAX forward operation for operation (explicit _rn
// intrinsics keep nvcc from contracting into FMAs): corner weights of
// _axis_cells, ((c00 + c01) + c10) + c11 for the plane, w0*r0 + w1*r1 for
// the line, and for K1's hat path the tent max(0, 1 - |pos - j|) at
// pos = p + sel*L rounded to bf16 (not _axis_cells' t: adding sel*L in
// float32 moves the low bits before the rounding).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // K1/K3 block
constexpr int kWarpsPerBlock = 8;  // K2: one warp per sample
constexpr int kChunk = 8;          // channels of one lane: 16 bytes of bf16
// K1's vector instantiation: 4 blocks an SM in its launch bound (64
// registers, no spills), and its appearance tile within the static limit
constexpr int kBulkBlocksPerSM = 4;
constexpr size_t kMaxTileBytes = 48 * 1024;

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

// The four plane corners and two line rows of decomposition i at one
// sample: element offsets of the rows and their weights.
struct Lookup {
  size_t p00, p01, p10, p11, l0, l1;
  float w00, w01, w10, w11, lw0, lw1;
};

__device__ __forceinline__ Lookup lookup(const Tables& tb, int i, const float xyz[3], int sel) {
  // MAT_MODE = ((0, 1), (0, 2), (1, 2)), VEC_MODE = (2, 1, 0)
  const int m0 = i == 2 ? 1 : 0;
  const int m1 = i == 0 ? 1 : 2;
  const int vm = 2 - i;
  const int H = tb.h[i], W = tb.w[i], L = tb.l[i], C = tb.c[i];
  const Cell cx = axis_cell(xyz[m0], W);
  const Cell cy = axis_cell(xyz[m1], H);
  const int x1 = min(cx.i0 + 1, W - 1);
  const int y1 = min(cy.i0 + 1, H - 1);
  Lookup k;
  k.w00 = __fmul_rn(cy.w0, cx.w0);
  k.w01 = __fmul_rn(cy.w0, cx.w1);
  k.w10 = __fmul_rn(cy.w1, cx.w0);
  k.w11 = __fmul_rn(cy.w1, cx.w1);
  const size_t base = (size_t)sel * H * W;
  k.p00 = (base + (size_t)cy.i0 * W + cx.i0) * C;
  k.p01 = (base + (size_t)cy.i0 * W + x1) * C;
  k.p10 = (base + (size_t)y1 * W + cx.i0) * C;
  k.p11 = (base + (size_t)y1 * W + x1) * C;
  int j0, j1;
  if (tb.hat[i]) {
    const float p = __fmul_rn(__fmul_rn(__fadd_rn(xyz[vm], 1.0f), 0.5f), (float)(L - 1));
    const float pos = __fadd_rn(p, (float)(sel * L));
    const float jf = floorf(pos);
    const int ja = (int)jf - sel * L;  // own-chart row of the lower tent
    k.lw0 = bf16_round(fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(pos, jf)))));
    k.lw1 = bf16_round(fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(pos, __fadd_rn(jf, 1.0f))))));
    if (ja < 0 || ja > L - 1) k.lw0 = 0.0f;
    if (ja + 1 < 0 || ja + 1 > L - 1) k.lw1 = 0.0f;
    j0 = min(max(ja, 0), L - 1);
    j1 = min(max(ja + 1, 0), L - 1);
  } else {
    const Cell cz = axis_cell(xyz[vm], L);
    j0 = cz.i0;
    j1 = min(cz.i0 + 1, L - 1);
    k.lw0 = cz.w0;
    k.lw1 = cz.w1;
  }
  k.l0 = ((size_t)sel * L + j0) * C;
  k.l1 = ((size_t)sel * L + j1) * C;
  return k;
}

// Channels c0 .. c0+7 of a bf16 row as float32: one 16-byte load (kVec:
// C % 8 == 0, the row 16-byte aligned) or one 2-byte load per channel below
// C and zeros past it.
template <bool kVec>
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ row, int c0, int C,
                                      float f[kChunk]) {
  if (kVec) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + c0));
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // little-endian: channel c0 + 2k in the low half
      f[2 * k] = __uint_as_float(u[k] << 16);
      f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) f[j] = c0 + j < C ? ld(row + c0 + j) : 0.0f;
  }
}

// plane * line for channels c0 .. c0+7 (zeros past C)
template <bool kVec>
__device__ __forceinline__ void products(const __nv_bfloat16* __restrict__ P,
                                         const __nv_bfloat16* __restrict__ Ln, const Lookup& k,
                                         int c0, int C, float prod[kChunk]) {
  float a[kChunk], b[kChunk], c[kChunk], d[kChunk], e[kChunk], f[kChunk];
  load8<kVec>(P + k.p00, c0, C, a);
  load8<kVec>(P + k.p01, c0, C, b);
  load8<kVec>(P + k.p10, c0, C, c);
  load8<kVec>(P + k.p11, c0, C, d);
  load8<kVec>(Ln + k.l0, c0, C, e);
  load8<kVec>(Ln + k.l1, c0, C, f);
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const float pv = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(k.w00, a[j]), __fmul_rn(k.w01, b[j])),
                                         __fmul_rn(k.w10, c[j])),
                               __fmul_rn(k.w11, d[j]));
    const float lv = __fadd_rn(__fmul_rn(k.lw0, e[j]), __fmul_rn(k.lw1, f[j]));
    prod[j] = __fmul_rn(pv, lv);
  }
}

// The plane and line values of channel c (K2: one channel a lane)
__device__ __forceinline__ void plane_line(const __nv_bfloat16* __restrict__ P,
                                           const __nv_bfloat16* __restrict__ Ln, const Lookup& k,
                                           int c, float& pv, float& lv) {
  pv = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(k.w00, ld(P + k.p00 + c)),
                                     __fmul_rn(k.w01, ld(P + k.p01 + c))),
                           __fmul_rn(k.w10, ld(P + k.p10 + c))),
                 __fmul_rn(k.w11, ld(P + k.p11 + c)));
  lv = __fadd_rn(__fmul_rn(k.lw0, ld(Ln + k.l0 + c)), __fmul_rn(k.lw1, ld(Ln + k.l1 + c)));
}

// K1 (kApp) and K3.  Block: kThreads lanes, 2^log2_group lanes a sample.
// K1's vector instantiation stages the block's appearance rows, one
// contiguous [samples x n_app] range of the output, in shared memory and
// writes them with one bulk asynchronous copy (the layout guarantees
// n_app % 4 == 0 and a tile of at most 48 KB); the scalar one writes
// streaming 4-byte stores.
template <bool kApp, bool kTwoGrids, bool kVec>
__global__ void __launch_bounds__(kThreads, kApp && kVec ? kBulkBlocksPerSM : 1)
vm_lookup_kernel(const float* __restrict__ coords, long long n, Tables tb, int log2_group,
                 float* __restrict__ density, float* __restrict__ app, int n_app) {
  constexpr bool kBulk = kApp && kVec;
  extern __shared__ float4 tile4[];
  float* tile = reinterpret_cast<float*>(tile4);
  const int group = 1 << log2_group;
  const int g = threadIdx.x & (group - 1);
  const long long s_first = ((long long)blockIdx.x * kThreads) >> log2_group;
  const long long s_all = s_first + (threadIdx.x >> log2_group);
  const bool live = s_all < n;
  // past the end a group recomputes the last sample and writes nothing, so
  // that every lane of the warp reaches the shuffles
  const long long s = live ? s_all : n - 1;
  float4 q;
  if (kVec) {
    q = __ldg(reinterpret_cast<const float4*>(coords) + s);
  } else {
    q = make_float4(coords[4 * s], coords[4 * s + 1], coords[4 * s + 2], coords[4 * s + 3]);
  }
  const float xyz[3] = {q.x, q.y, q.z};
  const int sel = (kTwoGrids && q.w != 0.0f) ? 1 : 0;  // the flag is exactly 0 or 1
  float* arow = kBulk ? tile + (threadIdx.x >> log2_group) * n_app : app + s * n_app;
  float dsum = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const Lookup k = lookup(tb, i, xyz, sel);
    const int C = tb.c[i], CD = tb.cd[i];
    float part = 0.0f;
    for (int c0 = g * kChunk; c0 < C; c0 += group * kChunk) {
      float prod[kChunk];
      products<kVec>(tb.plane[i], tb.line[i], k, c0, C, prod);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (c0 + j < CD) part = __fadd_rn(part, prod[j]);
      }
      if (kApp && live) {
        const int col = tb.app_off[i] + c0 - CD;  // appearance column of channel c0
        if (kBulk && c0 >= CD && (col & 3) == 0) {
          float4* dst = reinterpret_cast<float4*>(arow + col);
          dst[0] = make_float4(prod[0], prod[1], prod[2], prod[3]);
          dst[1] = make_float4(prod[4], prod[5], prod[6], prod[7]);
        } else {
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            if (c0 + j >= CD && c0 + j < C) {
              if (kBulk) {
                arow[col + j] = prod[j];
              } else {
                __stcs(arow + col + j, prod[j]);
              }
            }
          }
        }
      }
    }
    for (int off = group >> 1; off > 0; off >>= 1) {
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
    }
    dsum = __fadd_rn(dsum, fmaxf(part, 0.0f));
  }
  if (live && g == 0) density[s] = dsum;
  if (kBulk && n_app > 0) {
    // the tile's generic-proxy writes, then one thread hands it to the
    // bulk copy and keeps the block (and its shared memory) alive until the
    // copy has read it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long rows = min((long long)(kThreads >> log2_group), n - s_first);
      const unsigned bytes = (unsigned)(rows * n_app * sizeof(float));
      const uint32_t src = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                   :: "l"(reinterpret_cast<uint64_t>(app + s_first * n_app)), "r"(src),
                      "r"(bytes)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// K2.  Per sample and decomposition it recomputes K1's corner and line
// weights and the plane and line values (from the bf16 tables: saving the
// N x 384 per-channel values would cost 1.5 GB per production step), the
// pre-relu density partial in K1's order (the chunks of 8 channels over the
// warp's lanes, see the head of this file; so the relu mask is K1's to the
// bit), and then
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
// Design: one warp per sample, lanes over channels; every
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
    const int C = tb.c[i], CD = tb.cd[i];
    const Lookup k = lookup(tb, i, xyz, sel);
    const __nv_bfloat16* P = tb.plane[i];
    const __nv_bfloat16* Ln = tb.line[i];

    // the pre-relu density partial in K1's order: lane l reads channel
    // 32m + l as the scatter below does, and chunk q's owner, lane q mod 32,
    // chains its 8 channels by shuffles (chunks 4m .. 4m+3 of block m)
    float part = 0.0f;
    for (int m = 0; 32 * m < CD; ++m) {
      const int c = 32 * m + lane;
      float prod = 0.0f;
      if (c < CD) {
        float pv, lv;
        plane_line(P, Ln, k, c, pv, lv);
        prod = __fmul_rn(pv, lv);
      }
      const int own = (lane - 4 * m) & 31;  // this lane's chunk in the block, if < 4
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int src = (own & 3) * kChunk + j;
        const float v = __shfl_sync(0xffffffffu, prod, src);
        if (own < 4 && 32 * m + src < CD) part = __fadd_rn(part, v);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
    }
    const float dd = part > 0.0f ? dd_s : 0.0f;

    float* gP = gr.plane[i];
    float* gL = gr.line[i];
    const bool hat = tb.hat[i];
    for (int c = lane; c < C; c += 32) {
      const float dprod = c < CD ? dd : da[tb.app_off[i] + (c - CD)];
      if (dprod == 0.0f) continue;
      float pv, lv;
      plane_line(P, Ln, k, c, pv, lv);
      const float dp = __fmul_rn(dprod, lv);
      const float dl = __fmul_rn(dprod, pv);
      if (k.w00 != 0.0f) atomicAdd(gP + k.p00 + c, __fmul_rn(k.w00, dp));
      if (k.w01 != 0.0f) atomicAdd(gP + k.p01 + c, __fmul_rn(k.w01, dp));
      if (k.w10 != 0.0f) atomicAdd(gP + k.p10 + c, __fmul_rn(k.w10, dp));
      if (k.w11 != 0.0f) atomicAdd(gP + k.p11 + c, __fmul_rn(k.w11, dp));
      const float dlr = hat ? bf16_round(dl) : dl;
      if (k.lw0 != 0.0f) atomicAdd(gL + k.l0 + c, __fmul_rn(k.lw0, dlr));
      if (k.lw1 != 0.0f) atomicAdd(gL + k.l1 + c, __fmul_rn(k.lw1, dlr));
    }
  }
}

// dims: per decomposition i, {H, W, L, C, n_density, hat}; then the stack
// size, log2 of the lanes a sample takes in K1/K3, and 1 for their vector
// instantiation (ops/vm_lookup.py::lookup_layout)
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

template <bool kApp, bool kTwoGrids, bool kVec>
void launch_one(unsigned blocks, size_t smem, cudaStream_t st, const float* coords, long long n,
                const Tables& tb, int log2_group, float* density, float* app, int n_app) {
  vm_lookup_kernel<kApp, kTwoGrids, kVec><<<blocks, kThreads, smem, st>>>(
      coords, n, tb, log2_group, density, app, n_app);
}

template <bool kApp>
int launch(const float* coords, long long n, const void* const* planes,
           const void* const* lines, const int* dims, float* density, float* app,
           int n_app, void* stream) {
  const Tables tb = make_tables(planes, lines, dims);
  const int log2_group = dims[19];
  const long long per_block = kThreads >> log2_group;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool two = dims[18] > 1, vec = dims[20] != 0;
  const size_t smem = kApp && vec ? (size_t)per_block * n_app * sizeof(float) : 0;
  if (smem > kMaxTileBytes || (kApp && vec && (n_app & 3) != 0)) {
    return (int)cudaErrorInvalidValue;  // ops/vm_lookup.py::lookup_layout takes the scalar one
  }
  if (two && vec) {
    launch_one<kApp, true, true>(blocks, smem, st, coords, n, tb, log2_group, density, app,
                                 n_app);
  } else if (two) {
    launch_one<kApp, true, false>(blocks, 0, st, coords, n, tb, log2_group, density, app, n_app);
  } else if (vec) {
    launch_one<kApp, false, true>(blocks, smem, st, coords, n, tb, log2_group, density, app,
                                  n_app);
  } else {
    launch_one<kApp, false, false>(blocks, 0, st, coords, n, tb, log2_group, density, app,
                                   n_app);
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
