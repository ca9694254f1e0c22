// K1 (fine field), K3 (coarse density) and K2 (the fine field's backward):
// fused VM-grid lookups.
//
// Replaces:
//   K1  egonerf_tpu/ops/vm_lookup.py  sample_plane_packed_fastgrad (_plane_fwd)
//       + sample_line_hat (_hat_fwd / _hat_matrix), composed by
//       EgoNeRF._fused_products + compute_field (models/egonerf.py:207-247)
//   K3  sample_plane_packed + sample_line_packed (_line_fwd), composed by
//       EgoNeRF.compute_density_feature (models/egonerf.py:249-270)
//   K15 sample_plane_packed_nograd, sample_line_packed_nograd (:636,645):
//       one table's bilinear or linear lookup, (N, C) features
//   K2  the custom VJPs of K1's lookups: _plane_bwd_bf16 and _hat_bwd
//       (ops/vm_lookup.py:482,611), and _plane_bwd / _line_bwd (:456,519)
//       under compute_dtype="float32" or off the hat gate, and
//       _line_bwd_onehot (:544, sample_line_packed_fastgrad's backward)
//       under EGONERF_LINE_HAT=0.  The corner
//       packing, _scatter_chunked, _unpack_plane_grads and
//       _corner_cotangents are TPU layout answers and are not copied.
//   K3 with its relu mask, and K2 with no appearance channels in line
//       mode 0: sample_plane_packed + sample_line_packed with their float32
//       VJPs _plane_bwd / _line_bwd (:435-463, 503-528), the sparsity
//       loss's density (EgoNeRF.compute_density_feature,
//       TensorVMSplit.compute_density_feature_only).
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
// TensorVM (egonerf_tpu/models/tensorf.py:422-431, _density_relu = False)
// sums each decomposition's partial raw, with no relu: K1's and K3's
// instantiations with kRelu = false (the *_norelu entry points, single grid
// only) add the partial itself, in JAX's order 0 + d_0 + d_1 + d_2, and
// write no mask; K2's pass the density cotangent at scale 1 and read none.
// The default instantiations (kRelu = true) are the code they were.
//
// The density sum's order, which ops/vm_lookup.py::_warp_order_sum repeats
// for K3's plain version: channel c < CD lies in chunk c / 8 and chunk q
// belongs to lane q mod G; each lane adds its channels in increasing c, from
// 0.0f; then a butterfly over the group, xor offsets G/2, ..., 1.  K1's
// training instantiation, and K3's (the sparsity loss's density, whose
// backward is K2 with no appearance channels), also write, from the same
// sums, one byte a sample (the relu mask): two bits for decomposition i at bit 2i, 2 where the
// partial is > 0, 1 where it is == 0, 0 where it is < 0.  K2 scales the
// density cotangent by half the state (1, 0.5 or 0: jnp.maximum's gradient,
// which splits a tie), so it repeats no sum and needs no order.
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

#include "lookup_common.cuh"

namespace {

constexpr int kThreads = 256;      // K1/K3 block
constexpr int kChunk = 8;          // K1/K3: channels of one lane, 16 bytes of bf16
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

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The four plane corners and two line rows of decomposition i at one
// sample: element offsets of the rows and their weights.
// Off: size_t in K1/K3, int in K2 (whose wrapper holds every table below
// 2^31 elements), where the registers it saves keep the walk from spilling.
template <typename Off>
struct LookupT {
  Off p00, p01, p10, p11, l0, l1;
  float w00, w01, w10, w11, lw0, lw1;
};
using Lookup = LookupT<size_t>;

template <typename Off = size_t>
__device__ __forceinline__ LookupT<Off> lookup(const Tables& tb, int i, const float xyz[3],
                                               int sel) {
  // MAT_MODE = ((0, 1), (0, 2), (1, 2)), VEC_MODE = (2, 1, 0)
  const int m0 = i == 2 ? 1 : 0;
  const int m1 = i == 0 ? 1 : 2;
  const int vm = 2 - i;
  const int H = tb.h[i], W = tb.w[i], L = tb.l[i], C = tb.c[i];
  const Cell cx = axis_cell(xyz[m0], W);
  const Cell cy = axis_cell(xyz[m1], H);
  const int x1 = min(cx.i0 + 1, W - 1);
  const int y1 = min(cy.i0 + 1, H - 1);
  LookupT<Off> k;
  k.w00 = __fmul_rn(cy.w0, cx.w0);
  k.w01 = __fmul_rn(cy.w0, cx.w1);
  k.w10 = __fmul_rn(cy.w1, cx.w0);
  k.w11 = __fmul_rn(cy.w1, cx.w1);
  const Off base = (Off)sel * H * W;
  k.p00 = (base + (Off)cy.i0 * W + cx.i0) * C;
  k.p01 = (base + (Off)cy.i0 * W + x1) * C;
  k.p10 = (base + (Off)y1 * W + cx.i0) * C;
  k.p11 = (base + (Off)y1 * W + x1) * C;
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
  k.l0 = ((Off)sel * L + j0) * C;
  k.l1 = ((Off)sel * L + j1) * C;
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

// K1 (kApp) and K3.  Block: kThreads lanes, 2^log2_group lanes a sample.
// K1's vector instantiation stages the block's appearance rows, one
// contiguous [samples x n_app] range of the output, in shared memory and
// writes them with one bulk asynchronous copy (the layout guarantees
// n_app % 4 == 0 and a tile of at most 48 KB); the scalar one writes
// streaming 4-byte stores.  kMask (K1 and K3 in training) also writes the
// relu mask, one byte a sample; the eval instantiations have no trace of it.
template <bool kApp, bool kTwoGrids, bool kVec, bool kMask, bool kRelu = true>
__global__ void __launch_bounds__(kThreads, kApp && kVec ? kBulkBlocksPerSM : 1)
vm_lookup_kernel(const float* __restrict__ coords, long long n, Tables tb, int log2_group,
                 float* __restrict__ density, float* __restrict__ app, int n_app,
                 uint8_t* __restrict__ mask) {
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
  unsigned relu_bits = 0;
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
    dsum = __fadd_rn(dsum, kRelu ? fmaxf(part, 0.0f) : part);
    if (kMask) relu_bits |= (part > 0.0f ? 2u : part == 0.0f ? 1u : 0u) << (2 * i);
  }
  if (live && g == 0) {
    density[s] = dsum;
    if (kMask) mask[s] = (uint8_t)relu_bits;
  }
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
// N x 384 per-channel values would cost 1.5 GB per production step), reads
// the relu state K1 wrote (the mask; no partial is summed again), and then
//   dprod_c = d_dens * state / 2  (c < n_density),  d_app[c - n_density]
//   dp = dprod l,  dl = dprod p
//   plane cell of corner k  += w_k dp          (float32)
//   line row j              += lw_j bf16(dl)   (hat path, bf16 tents as K1)
//                           += lw_j dl          (float32 _axis_cells weights)
//                           += bf16(lw_j dl)    (the same weights, line mode 2)
// The planes accumulate in float32, unrounded.  JAX's fastgrad backward
// scatter-adds in bf16, rounding at every add in an order the TPU
// chooses, so no bit-level reference exists; float32 is the semantics of
// its _plane_bwd.  The hat path rounds dl to bf16 and sums in float32, as
// _hat_bwd's bf16 x bf16 -> float32 matmul does.  Line mode 2
// (EGONERF_LINE_HAT=0, sample_line_packed_fastgrad) rounds each corner's
// cotangent lw_j dl to bf16 and sums those in float32, as
// _line_bwd_onehot's bf16 corner matrix contracted against the one-hot
// matrix with float32 accumulation does.
//
// Bound on the card: bytes, d_app (N x 144 float32, 604 MB at the
// production step) plus the float32 gradient tables (98 MB of planes).
// On an H100 80GB HBM3 at 700 W the one-warp-a-sample kernel this replaces
// took 2.54 ms a production step and 2.23 ms with every RED removed: the
// work around the atomics (32 lanes a sample computing its cells, 2-byte
// loads, the partial summed again for the mask) cost far more than they.
// Design:
// * a sample takes a group of G lanes; in the vector instantiation lane g
//   owns the 4 consecutive channels 4g .. 4g+3 of every row (G = the power
//   of two >= C / 4): one 8-byte load a row, one 16-byte d_app load and
//   one 16-byte RED (an atomicAdd on a float4, REDG.E.ADD.F32x4) a cell.
//   It needs C % 4 == 0, n_density % 4 == 0 and aligned tables; any other
//   width takes the scalar instantiation, the same code with one channel a
//   lane (G >= C), whose 4-byte REDs the group's lanes issue to
//   consecutive addresses;
// * each group walks one contiguous run of samples (a ray's samples are
//   consecutive), one decomposition at a time, and for each of its six
//   slots (4 plane corners, 2 line rows) keeps the pending (row, sum) in
//   registers: it adds while the row repeats and issues the RED only when
//   the row changes or the run ends.  So the grid is persistent: each group
//   takes one run of ceil(N / groups) samples;
// * every RED goes to global memory.  Lines summed in shared memory per
//   block and flushed at its end were measured and removed: a float
//   atomicAdd there is a compare-and-swap loop (ATOMS.CAST.SPIN), its bytes
//   come out of L1, and each block flushes every row, so on every recorded
//   step one shared line lost 12-14% against none (the smoke config's
//   three lines, TensoRF at 128^3, 161^3 and 256^3, EgoNeRF's radial line);
//   it won only on random samples with no runs to merge;
// * a sample whose cotangents are all zero on a lane's channels (the gated
//   TensoRF samples) is skipped.
// The single grid, the vector width and line mode 2's rounding (kLineBf16;
// the decompositions that take it are bits of line_bf16) are template
// parameters: the default instantiations hold no trace of mode 2.  The
// vector instantiation takes 768 lanes a block (80 registers; under 1024
// lanes' 64-register cap it spills), the scalar one 1024.  Measured (H100
// 80GB HBM3, 700 W, the recorded production step): 1.148 ms against the
// old kernel's 2.545.  Merging carried the most (a 768-lane build took
// 2.11 ms without it, 1.59 with it); issuing no RED at all saved only 0.14
// ms more, so what is left is the walk itself (the lookups and the 604 MB
// of d_app).
template <bool kVec>
struct BwdShape {
  static constexpr int kChannels = kVec ? 4 : 1;  // a lane's channels
  static constexpr int kThreads = kVec ? 768 : 1024;
};

// A lane's channels c0 .. c0 + kCh - 1 of a bf16 row as float32: one 8-byte
// load (kVec), or one 2-byte load below C and zero past it.
template <bool kVec, int kCh = BwdShape<kVec>::kChannels>
__device__ __forceinline__ void load_lane(const __nv_bfloat16* __restrict__ row, int c0, int C,
                                          float f[kCh]) {
  if constexpr (kVec) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + c0));
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xffff0000u);
  } else {
    f[0] = c0 < C ? ld(row + c0) : 0.0f;
  }
}

// Add a lane's pending sums to channels c0 .. of a float32 gradient row:
// one 16-byte RED (kVec) or one 4-byte RED below C.
template <bool kVec, int kCh = BwdShape<kVec>::kChannels>
__device__ __forceinline__ void red_global(float* row, int c0, int C, const float v[kCh]) {
  if constexpr (kVec) {
    atomicAdd(reinterpret_cast<float4*>(row + c0), make_float4(v[0], v[1], v[2], v[3]));
  } else if (c0 < C) {
    atomicAdd(row + c0, v[0]);
  }
}

// One sample's inputs for a lane of K2: its coords and the cotangents of
// its channels of decomposition i (the density ones scaled by half the
// relu state the mask holds at bits 2i, 2i+1).
template <int kCh>
struct Sample {
  float4 q;
  float dprod[kCh];
};

template <bool kVec, bool kRelu = true, int kCh = BwdShape<kVec>::kChannels>
__device__ __forceinline__ Sample<kCh> load_sample(int s, int i, int c0, int C, int CD,
                                                   const float* __restrict__ coords,
                                                   const float* __restrict__ d_dens,
                                                   const float* __restrict__ d_app,
                                                   const uint8_t* __restrict__ mask, int n_app,
                                                   int app0) {
  Sample<kCh> in;
  if (kVec) {
    in.q = __ldg(reinterpret_cast<const float4*>(coords) + s);
  } else {
    const float* c4 = coords + 4 * (size_t)s;
    in.q = make_float4(c4[0], c4[1], c4[2], c4[3]);
  }
  const float* da = d_app + (size_t)s * n_app + app0;  // channel c >= CD at da[c]
  if constexpr (kVec) {
    if (c0 >= CD) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(da + c0));
      in.dprod[0] = v.x, in.dprod[1] = v.y, in.dprod[2] = v.z, in.dprod[3] = v.w;
      return in;
    }
  }
  const float dd =
      kRelu ? __fmul_rn(d_dens[s], 0.5f * (float)((mask[s] >> (2 * i)) & 3)) : d_dens[s];
#pragma unroll
  for (int j = 0; j < kCh; ++j) {
    const int c = c0 + j;
    in.dprod[j] = c < CD ? dd : (c < C ? da[c] : 0.0f);
  }
  return in;
}

// run: the samples of one group's run.  Rows are element offsets
// (row * C) in int: the wrapper holds every table below 2^31 elements.
template <bool kTwoGrids, bool kVec, bool kLineBf16, bool kRelu = true>
__global__ void __launch_bounds__(BwdShape<kVec>::kThreads, 1)
vm_field_bwd_kernel(const float* __restrict__ coords, int n, Tables tb,
                    const float* __restrict__ d_dens, const float* __restrict__ d_app,
                    const uint8_t* __restrict__ mask, int n_app, Grads gr, int log2_group,
                    int run, unsigned line_bf16) {
  constexpr int kCh = BwdShape<kVec>::kChannels;
  constexpr int kBlock = BwdShape<kVec>::kThreads;
  const int group = 1 << log2_group;
  const int g = threadIdx.x & (group - 1);
  const int walker = (int)(((long long)blockIdx.x * kBlock + threadIdx.x) >> log2_group);
  const int s_begin = (int)min((long long)walker * run, (long long)n);
  const int s_end = min(n - s_begin, run) + s_begin;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int C = tb.c[i], CD = tb.cd[i];
    const bool hat = tb.hat[i];
    const bool round_line = kLineBf16 && ((line_bf16 >> i) & 1u);
    const __nv_bfloat16* P = tb.plane[i];
    const __nv_bfloat16* Ln = tb.line[i];
    float* gP = gr.plane[i];
    float* gL = gr.line[i];
    const int app0 = tb.app_off[i] - CD;  // d_app column of channel c >= CD
    for (int c0 = g * kCh; c0 < C; c0 += group * kCh) {
      int row[6] = {-1, -1, -1, -1, -1, -1};
      float acc[6][kCh];
      auto to_plane = [&](int at, const float* v) { red_global<kVec>(gP + at, c0, C, v); };
      auto to_line = [&](int at, const float* v) { red_global<kVec>(gL + at, c0, C, v); };
      for (int s = s_begin; s < s_end; ++s) {
        const Sample<kCh> cur =
            load_sample<kVec, kRelu>(s, i, c0, C, CD, coords, d_dens, d_app, mask, n_app, app0);
        float dprod[kCh];
        bool any = false;
#pragma unroll
        for (int j = 0; j < kCh; ++j) {
          dprod[j] = cur.dprod[j];
          any |= dprod[j] != 0.0f;
        }
        if (!any) continue;
        const float xyz[3] = {cur.q.x, cur.q.y, cur.q.z};
        const int sel = (kTwoGrids && cur.q.w != 0.0f) ? 1 : 0;
        const LookupT<int> k = lookup<int>(tb, i, xyz, sel);
        float lv[kCh], pv[kCh], a[kCh], b[kCh];
        load_lane<kVec>(Ln + k.l0, c0, C, a);
        load_lane<kVec>(Ln + k.l1, c0, C, b);
#pragma unroll
        for (int j = 0; j < kCh; ++j) {
          lv[j] = __fadd_rn(__fmul_rn(k.lw0, a[j]), __fmul_rn(k.lw1, b[j]));
        }
        load_lane<kVec>(P + k.p00, c0, C, a);
        load_lane<kVec>(P + k.p01, c0, C, b);
#pragma unroll
        for (int j = 0; j < kCh; ++j) {
          pv[j] = __fadd_rn(__fmul_rn(k.w00, a[j]), __fmul_rn(k.w01, b[j]));
        }
        load_lane<kVec>(P + k.p10, c0, C, a);
        load_lane<kVec>(P + k.p11, c0, C, b);
        float dp[kCh], dl[kCh];
#pragma unroll
        for (int j = 0; j < kCh; ++j) {
          pv[j] = __fadd_rn(__fadd_rn(pv[j], __fmul_rn(k.w10, a[j])), __fmul_rn(k.w11, b[j]));
          dp[j] = __fmul_rn(dprod[j], lv[j]);
          dl[j] = __fmul_rn(dprod[j], pv[j]);
          if (hat) dl[j] = bf16_round(dl[j]);
        }
        merge<kCh>(row[0], acc[0], k.p00, k.w00, dp, to_plane);
        merge<kCh>(row[1], acc[1], k.p01, k.w01, dp, to_plane);
        merge<kCh>(row[2], acc[2], k.p10, k.w10, dp, to_plane);
        merge<kCh>(row[3], acc[3], k.p11, k.w11, dp, to_plane);
        merge<kCh, kLineBf16>(row[4], acc[4], k.l0, k.lw0, dl, to_line, round_line);
        merge<kCh, kLineBf16>(row[5], acc[5], k.l1, k.lw1, dl, to_line, round_line);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (row[t] >= 0) to_plane(row[t], acc[t]);
      }
#pragma unroll
      for (int t = 4; t < 6; ++t) {
        if (row[t] >= 0) to_line(row[t], acc[t]);
      }
    }
  }
}

// dims: per decomposition i, {H, W, L, C, n_density, line mode (0 linear,
// 1 hat, 2 linear with bf16 corner cotangents in K2)}; then the stack
// size, log2 of the lanes a sample takes in K1/K3 and 1 for their vector
// instantiation (ops/vm_lookup.py::lookup_layout); then K2's: log2 of its
// lanes a sample and 1 for its vector instantiation
// (ops/vm_lookup.py::bwd_layout)
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
    tb.hat[i] = dims[6 * i + 5] == 1;
    tb.app_off[i] = off;
    off += tb.c[i] - tb.cd[i];
  }
  return tb;
}

template <bool kApp, bool kTwoGrids, bool kVec, bool kMask, bool kRelu = true>
void launch_one(unsigned blocks, size_t smem, cudaStream_t st, const float* coords, long long n,
                const Tables& tb, int log2_group, float* density, float* app, int n_app,
                uint8_t* mask) {
  vm_lookup_kernel<kApp, kTwoGrids, kVec, kMask, kRelu><<<blocks, kThreads, smem, st>>>(
      coords, n, tb, log2_group, density, app, n_app, mask);
}

template <bool kApp, bool kMask>
void launch_grid(bool two, bool vec, unsigned blocks, size_t smem, cudaStream_t st,
                 const float* coords, long long n, const Tables& tb, int log2_group,
                 float* density, float* app, int n_app, uint8_t* mask) {
  if (two && vec) {
    launch_one<kApp, true, true, kMask>(blocks, smem, st, coords, n, tb, log2_group, density,
                                        app, n_app, mask);
  } else if (two) {
    launch_one<kApp, true, false, kMask>(blocks, 0, st, coords, n, tb, log2_group, density, app,
                                         n_app, mask);
  } else if (vec) {
    launch_one<kApp, false, true, kMask>(blocks, smem, st, coords, n, tb, log2_group, density,
                                         app, n_app, mask);
  } else {
    launch_one<kApp, false, false, kMask>(blocks, 0, st, coords, n, tb, log2_group, density,
                                          app, n_app, mask);
  }
}

template <bool kApp, bool kRelu = true>
int launch(const float* coords, long long n, const void* const* planes,
           const void* const* lines, const int* dims, float* density, float* app,
           int n_app, uint8_t* mask, void* stream) {
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
  if constexpr (!kRelu) {
    // TensorVM's raw sums: a single grid, no mask
    if (two || mask != nullptr) return (int)cudaErrorInvalidValue;
    if (vec) {
      launch_one<kApp, false, true, false, false>(blocks, smem, st, coords, n, tb, log2_group,
                                                  density, app, n_app, nullptr);
    } else {
      launch_one<kApp, false, false, false, false>(blocks, 0, st, coords, n, tb, log2_group,
                                                   density, app, n_app, nullptr);
    }
  } else if (mask != nullptr) {
    launch_grid<kApp, true>(two, vec, blocks, smem, st, coords, n, tb, log2_group, density, app,
                            n_app, mask);
  } else {
    launch_grid<kApp, false>(two, vec, blocks, smem, st, coords, n, tb, log2_group, density,
                             app, n_app, nullptr);
  }
  return (int)cudaGetLastError();
}

template <bool kTwoGrids, bool kVec, bool kLineBf16, bool kRelu = true>
void launch_bwd(unsigned blocks, cudaStream_t st, const float* coords, int n, const Tables& tb,
                const float* d_dens, const float* d_app, const uint8_t* mask, int n_app,
                const Grads& gr, int log2_group, int run, unsigned line_bf16) {
  vm_field_bwd_kernel<kTwoGrids, kVec, kLineBf16, kRelu>
      <<<blocks, BwdShape<kVec>::kThreads, 0, st>>>(coords, n, tb, d_dens, d_app, mask, n_app,
                                                    gr, log2_group, run, line_bf16);
}

template <bool kLineBf16>
void launch_bwd_grid(bool two, bool vec, unsigned blocks, cudaStream_t st, const float* coords,
                     int n, const Tables& tb, const float* d_dens, const float* d_app,
                     const uint8_t* mask, int n_app, const Grads& gr, int log2_group, int run,
                     unsigned line_bf16) {
  if (two && vec) {
    launch_bwd<true, true, kLineBf16>(blocks, st, coords, n, tb, d_dens, d_app, mask, n_app, gr,
                                      log2_group, run, line_bf16);
  } else if (two) {
    launch_bwd<true, false, kLineBf16>(blocks, st, coords, n, tb, d_dens, d_app, mask, n_app, gr,
                                       log2_group, run, line_bf16);
  } else if (vec) {
    launch_bwd<false, true, kLineBf16>(blocks, st, coords, n, tb, d_dens, d_app, mask, n_app, gr,
                                       log2_group, run, line_bf16);
  } else {
    launch_bwd<false, false, kLineBf16>(blocks, st, coords, n, tb, d_dens, d_app, mask, n_app,
                                        gr, log2_group, run, line_bf16);
  }
}


// K15 (vm_sample_kernel): one table's lookup with no gradient, the
// counterpart of sample_plane_packed_nograd / sample_line_packed_nograd on
// the port's layout: a bf16 (S, H, W, C) plane or (S, L, C) line read at
// (x, y) or at x, on grid sel (grid 0 without sel, as JAX's sel=None), each
// channel written to an (N, C) float32 row.  It shares K3's corner code
// (axis_cell, load8) and K3's sums, ((c00 + c01) + c10) + c11 for a plane
// and w0*r0 + w1*r1 for a line, so it equals ops/vm_lookup.py's
// sample_plane / sample_line bit for bit.  A sample takes a group of G
// lanes, G = the power of two >= C / 8, lane g the 8-channel chunks g,
// g + G, ...: one 16-byte load a corner and two 16-byte stores a chunk in
// the vector instantiation (C % 8 == 0, a 16-byte aligned table), one
// 2-byte load and one store a channel in the scalar one.  Bound on the
// card: bytes, the (N, C) float32 output (64 MB at N = 2^20, C = 16); the
// tables sit in L2.  Plane or line, the vector load and the selector are
// template parameters of its own kernel: K1-K3 hold no trace of it.
template <bool kPlane, bool kVec, bool kSel>
__global__ void __launch_bounds__(kThreads)
vm_sample_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const int64_t* __restrict__ sel, long long n,
                 const __nv_bfloat16* __restrict__ table, int H, int W, int C, int log2_group,
                 float* __restrict__ out) {
  const int group = 1 << log2_group;
  const int g = threadIdx.x & (group - 1);
  const long long s =
      (((long long)blockIdx.x * kThreads) >> log2_group) + (threadIdx.x >> log2_group);
  if (s >= n) return;
  const size_t grid = kSel ? (size_t)__ldg(sel + s) : 0;
  size_t r00, r01, r10 = 0, r11 = 0;
  float w00, w01, w10 = 0.0f, w11 = 0.0f;
  if (kPlane) {
    const Cell cx = axis_cell(__ldg(x + s), W);
    const Cell cy = axis_cell(__ldg(y + s), H);
    const int x1 = min(cx.i0 + 1, W - 1);
    const int y1 = min(cy.i0 + 1, H - 1);
    w00 = __fmul_rn(cy.w0, cx.w0);
    w01 = __fmul_rn(cy.w0, cx.w1);
    w10 = __fmul_rn(cy.w1, cx.w0);
    w11 = __fmul_rn(cy.w1, cx.w1);
    const size_t base = grid * H * W;
    r00 = (base + (size_t)cy.i0 * W + cx.i0) * C;
    r01 = (base + (size_t)cy.i0 * W + x1) * C;
    r10 = (base + (size_t)y1 * W + cx.i0) * C;
    r11 = (base + (size_t)y1 * W + x1) * C;
  } else {
    const Cell cz = axis_cell(__ldg(x + s), H);
    w00 = cz.w0;
    w01 = cz.w1;
    r00 = (grid * H + cz.i0) * C;
    r01 = (grid * H + min(cz.i0 + 1, H - 1)) * C;
  }
  float* orow = out + s * C;
  for (int c0 = g * kChunk; c0 < C; c0 += group * kChunk) {
    float a[kChunk], b[kChunk], c[kChunk], d[kChunk], v[kChunk];
    load8<kVec>(table + r00, c0, C, a);
    load8<kVec>(table + r01, c0, C, b);
    if (kPlane) {
      load8<kVec>(table + r10, c0, C, c);
      load8<kVec>(table + r11, c0, C, d);
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      v[j] = kPlane ? __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(w00, a[j]), __fmul_rn(w01, b[j])),
                                          __fmul_rn(w10, c[j])),
                                __fmul_rn(w11, d[j]))
                    : __fadd_rn(__fmul_rn(w00, a[j]), __fmul_rn(w01, b[j]));
    }
    if (kVec) {
      float4* dst = reinterpret_cast<float4*>(orow + c0);
      __stcs(dst, make_float4(v[0], v[1], v[2], v[3]));
      __stcs(dst + 1, make_float4(v[4], v[5], v[6], v[7]));
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (c0 + j < C) __stcs(orow + c0 + j, v[j]);
      }
    }
  }
}

template <bool kPlane, bool kVec>
void launch_sample(bool with_sel, unsigned blocks, cudaStream_t st, const float* x,
                   const float* y, const int64_t* sel, long long n,
                   const __nv_bfloat16* table, int H, int W, int C, int log2_group, float* out) {
  if (with_sel) {
    vm_sample_kernel<kPlane, kVec, true><<<blocks, kThreads, 0, st>>>(x, y, sel, n, table, H, W,
                                                                      C, log2_group, out);
  } else {
    vm_sample_kernel<kPlane, kVec, false><<<blocks, kThreads, 0, st>>>(x, y, sel, n, table, H,
                                                                       W, C, log2_group, out);
  }
}

// K2's entry: the persistent grid and the instantiation of these tables
template <bool kRelu>
int field_bwd(const float* coords, long long n, const void* const* planes,
              const void* const* lines, const int* dims, const float* d_dens,
              const float* d_app, const uint8_t* mask, int n_app, void* const* gplanes,
              void* const* glines, void* stream) {
  const Tables tb = make_tables(planes, lines, dims);
  Grads gr;
  for (int i = 0; i < 3; ++i) {
    gr.plane[i] = static_cast<float*>(gplanes[i]);
    gr.line[i] = static_cast<float*>(glines[i]);
  }
  const int log2_group = dims[21];
  const bool two = dims[18] > 1, vec = dims[22] != 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // the persistent grid: one block an SM, every group one run of samples
  const long long per_block =
      (vec ? BwdShape<true>::kThreads : BwdShape<false>::kThreads) >> log2_group;
  const long long run = (n + sms * per_block - 1) / (sms * per_block);
  const long long walkers = (n + run - 1) / run;
  const unsigned blocks = (unsigned)((walkers + per_block - 1) / per_block);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ni = (int)n, r = (int)run;
  unsigned line_bf16 = 0;  // the decompositions in line mode 2
  for (int i = 0; i < 3; ++i) line_bf16 |= (dims[6 * i + 5] == 2 ? 1u : 0u) << i;
  if constexpr (!kRelu) {
    // TensorVM's raw sums: a single grid, line modes 0 and 1
    if (two || line_bf16) return (int)cudaErrorInvalidValue;
    if (vec) {
      launch_bwd<false, true, false, false>(blocks, st, coords, ni, tb, d_dens, d_app, nullptr,
                                            n_app, gr, log2_group, r, 0u);
    } else {
      launch_bwd<false, false, false, false>(blocks, st, coords, ni, tb, d_dens, d_app, nullptr,
                                             n_app, gr, log2_group, r, 0u);
    }
  } else if (line_bf16) {
    launch_bwd_grid<true>(two, vec, blocks, st, coords, ni, tb, d_dens, d_app, mask, n_app, gr,
                          log2_group, r, line_bf16);
  } else {
    launch_bwd_grid<false>(two, vec, blocks, st, coords, ni, tb, d_dens, d_app, mask, n_app, gr,
                           log2_group, r, 0u);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vm_field_fwd(const float* coords, long long n, const void* const* planes,
                            const void* const* lines, const int* dims, float* density,
                            float* app, int n_app, uint8_t* mask, void* stream) {
  return launch<true>(coords, n, planes, lines, dims, density, app, n_app, mask, stream);
}

extern "C" int vm_field_bwd(const float* coords, long long n, const void* const* planes,
                            const void* const* lines, const int* dims, const float* d_dens,
                            const float* d_app, const uint8_t* mask, int n_app,
                            void* const* gplanes, void* const* glines, void* stream) {
  return field_bwd<true>(coords, n, planes, lines, dims, d_dens, d_app, mask, n_app, gplanes,
                         glines, stream);
}

// TensorVM's K2: the density cotangent at scale 1 on every decomposition;
// `mask` is not read (it may be null).
extern "C" int vm_field_bwd_norelu(const float* coords, long long n, const void* const* planes,
                                   const void* const* lines, const int* dims,
                                   const float* d_dens, const float* d_app,
                                   const uint8_t* mask, int n_app, void* const* gplanes,
                                   void* const* glines, void* stream) {
  return field_bwd<false>(coords, n, planes, lines, dims, d_dens, d_app, nullptr, n_app,
                          gplanes, glines, stream);
}

// TensorVM's K1: raw partial sums, no mask (mask must be null).
extern "C" int vm_field_fwd_norelu(const float* coords, long long n, const void* const* planes,
                                   const void* const* lines, const int* dims, float* density,
                                   float* app, int n_app, uint8_t* mask, void* stream) {
  return launch<true, false>(coords, n, planes, lines, dims, density, app, n_app, mask, stream);
}

// TensorVM's K3: raw partial sums (the bake and the sparsity loss's density).
extern "C" int vm_density_fwd_norelu(const float* coords, long long n, const void* const* planes,
                                     const void* const* lines, const int* dims, float* density,
                                     void* stream) {
  return launch<false, false>(coords, n, planes, lines, dims, density, nullptr, 0, nullptr,
                              stream);
}

extern "C" int vm_density_fwd(const float* coords, long long n, const void* const* planes,
                              const void* const* lines, const int* dims, float* density,
                              void* stream) {
  return launch<false>(coords, n, planes, lines, dims, density, nullptr, 0, nullptr, stream);
}

// K3's training instantiation (the sparsity loss's differentiable density):
// vm_density_fwd that also writes the relu mask, as K1's does.
extern "C" int vm_density_train_fwd(const float* coords, long long n, const void* const* planes,
                                    const void* const* lines, const int* dims, float* density,
                                    uint8_t* mask, void* stream) {
  if (mask == nullptr) return (int)cudaErrorInvalidValue;
  return launch<false>(coords, n, planes, lines, dims, density, nullptr, 0, mask, stream);
}

// K15: dims {H, W, C, log2 of the lanes a sample takes, 1 for the vector
// instantiation} (ops/vm_lookup.py::_sample_nograd); a line passes L as H,
// and y is unused.  sel may be null (grid 0).
extern "C" int vm_sample_nograd(int plane, const float* x, const float* y, const int64_t* sel,
                                long long n, const void* table, const int* dims, float* out,
                                void* stream) {
  const int H = dims[0], W = dims[1], C = dims[2], log2_group = dims[3];
  const bool vec = dims[4] != 0;
  const long long per_block = kThreads >> log2_group;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* tab = static_cast<const __nv_bfloat16*>(table);
  const bool with_sel = sel != nullptr;
  if (plane && vec) {
    launch_sample<true, true>(with_sel, blocks, st, x, y, sel, n, tab, H, W, C, log2_group, out);
  } else if (plane) {
    launch_sample<true, false>(with_sel, blocks, st, x, y, sel, n, tab, H, W, C, log2_group, out);
  } else if (vec) {
    launch_sample<false, true>(with_sel, blocks, st, x, y, sel, n, tab, H, W, C, log2_group, out);
  } else {
    launch_sample<false, false>(with_sel, blocks, st, x, y, sel, n, tab, H, W, C, log2_group,
                                out);
  }
  return (int)cudaGetLastError();
}
