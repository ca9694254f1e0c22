// K17 (the CP line product) and K17b (its backward): TensorCP's field.
//
// Replaces:
//   K17   TensorCP._line_products and the density sum of compute_field /
//         compute_density_feature_only (egonerf_tpu/models/tensorf.py:459-487)
//         over sample_line_hat (the bf16 hat forward, _hat_fwd,
//         egonerf_tpu/ops/vm_lookup.py:581-608) while its gate holds, else
//         sample_line_packed (_line_fwd, :503-518)
//   K17b  their custom VJPs through the product: _hat_bwd (:611-628), which
//         rounds the line's cotangent to bf16 and contracts it against the
//         bf16 hat in float32, and _line_bwd (:519-525), the float32 scatter
//
// For each of N samples and axis i = 0, 1, 2, the linear sample l_i of line i
// (L_i rows of C channels) at coordinate x_{VEC_MODE[i]} = x_{2-i}; then per
// channel prod = (l_0 * l_1) * l_2, JAX's order.  K17 writes the density,
// the sum of the first CD channels (no relu), and (kApp) the other C - CD
// channels as an (N, C - CD) row.  The line mode of axis i picks the weights:
// the hat (1): the tents max(0, 1 - |p - j|) rounded to bf16, rows outside
// the line weighing 0, as JAX's _hat_matrix with sel=None; linear (0):
// _axis_cells' float32 pair.  Tables are read as bf16 (JAX casts in
// pack_line / _hat_fwd): the eval form reads bf16 tables, the training form
// and the density-only form (C == CD: the bake, compute_alpha, the sparsity
// loss) float32 ones, each value rounded to bf16 as it is loaded (the
// gradient treats the cast as the identity, as JAX's custom VJPs do).
//
// K17b: per sample, channel and axis i, with dprod = d_dens (c < CD) or
// d_app[c - CD], dout_0 = (dprod l_2) l_1, dout_1 = (dprod l_2) l_0,
// dout_2 = dprod (l_0 l_1) (the autodiff of JAX's product, in its order),
// rounded to bf16 on a hat axis; then line_i[row_j] += w_j dout_i in float32.
// The line samples are recomputed from the float32 tables (three lines of
// 500 x 384 are 2.3 MB and stay in L2).
//
// Bound on the card: bytes.  K17 writes the (N, C - CD) float32 appearance
// products (1.2 GB at N = 1,048,576 and C - CD = 288, 0.36 ms at 3.35 TB/s);
// K17b reads as much of d_app.  The work is ~15 operations a channel and
// sample, no matrix product.
// Design (a simple kernel that is right first):
// * K17: a sample takes a group of G lanes, G = the power of two >= C / 4 (at
//   most 32); lane g owns the 4-channel chunks g, g + G, ... of each row: one
//   8-byte (bf16) or 16-byte (float32) load a row and one 16-byte streaming
//   store of appearance a chunk in the vector instantiation (C and CD
//   multiples of 4, aligned tables), one channel at a time in the scalar one.
//   The density sums go over the group by a butterfly.
// * K17b: K2's walk.  A persistent grid gives each group one contiguous run of
//   samples (a ray's samples are consecutive and step through neighbouring
//   rows); for each of its six slots (two rows an axis) the group keeps the
//   pending (row, sum) in registers, adds while the row repeats, and issues a
//   float32 atomicAdd (a 16-byte RED in the vector instantiation) only when
//   the row changes or the run ends.  Samples whose cotangents are zero on a
//   lane's channels (the gated ones) are skipped.  The REDs go to one of
//   `copies` copies of the gradient rows (block b to copy b % copies; 29
//   copies, 64 MB, at CP-384), and a second pass sums the copies in order.
//   So a row's terms sum in two levels: where every sample of a step hits a
//   few rows and no run repeats one (262,144 terms a row), one chain of
//   float32 atomics came 4e-4 of sum|terms| off the exact sum on an H100;
//   here a chain holds about 1 / copies of the terms.  (Sums of a block's
//   rows in shared memory were as exact but took 3.0 ms a step against
//   1.7: a float atomicAdd to shared memory is a CAS loop, where a RED to
//   global memory is one instruction.)
// The appearance output, the vector width and the table type are template
// parameters.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookup_common.cuh"

namespace {

constexpr int kThreads = 256;     // K17's block
constexpr int kBwdThreads = 512;  // K17b's block
constexpr int kCh = 4;            // a lane's channels in a chunk (vector)

struct Lines {
  const void* line[3];  // (L_i, C) rows: bf16, or float32 in the training form
  int l[3];
  int hat[3];
  int c, cd;
};

struct Rows {
  int j0, j1;
  float w0, w1;
};

// The two rows of a line sample and their weights (a single grid: JAX's
// sel=None, the hat's position p itself).
__device__ __forceinline__ Rows line_rows(float coord, int L, bool hat) {
  Rows r;
  if (hat) {
    const float p = __fmul_rn(__fmul_rn(__fadd_rn(coord, 1.0f), 0.5f), (float)(L - 1));
    const float jf = floorf(p);
    const int ja = (int)jf;
    r.w0 = bf16_round(fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(p, jf)))));
    r.w1 = bf16_round(fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(p, __fadd_rn(jf, 1.0f))))));
    if (ja < 0 || ja > L - 1) r.w0 = 0.0f;
    if (ja + 1 < 0 || ja + 1 > L - 1) r.w1 = 0.0f;
    r.j0 = min(max(ja, 0), L - 1);
    r.j1 = min(max(ja + 1, 0), L - 1);
  } else {
    const Cell c = axis_cell(coord, L);
    r.j0 = c.i0;
    r.j1 = min(c.i0 + 1, L - 1);
    r.w0 = c.w0;
    r.w1 = c.w1;
  }
  return r;
}

__device__ __forceinline__ float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float as_float(float v) { return bf16_round(v); }

// Channels c0 .. c0 + K - 1 of a row as float32 (bf16 values): one vector
// load (kVec, K = 4: 8 bytes of bf16 or 16 of float32), or one load a
// channel below C and zero past it.
template <bool kVec, int K, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int c0, int C, float f[K]) {
  if constexpr (kVec && sizeof(T) == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + c0));
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xffff0000u);
  } else if constexpr (kVec) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + c0));
    f[0] = as_float(v.x);
    f[1] = as_float(v.y);
    f[2] = as_float(v.z);
    f[3] = as_float(v.w);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) f[j] = c0 + j < C ? as_float(row[c0 + j]) : 0.0f;
  }
}

// The three line samples of a lane's K channels at one sample.
template <bool kVec, int K, typename T>
__device__ __forceinline__ void line_values(const Lines& ln, const Rows r[3], int c0,
                                            float l[3][K]) {
  const int C = ln.c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T* tab = static_cast<const T*>(ln.line[i]);
    float a[K], b[K];
    load_row<kVec, K>(tab + (size_t)r[i].j0 * C, c0, C, a);
    load_row<kVec, K>(tab + (size_t)r[i].j1 * C, c0, C, b);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      l[i][j] = __fadd_rn(__fmul_rn(r[i].w0, a[j]), __fmul_rn(r[i].w1, b[j]));
    }
  }
}

__device__ __forceinline__ float4 load_coords(const float* __restrict__ coords, long long s,
                                              bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(coords) + s);
  return make_float4(coords[4 * s], coords[4 * s + 1], coords[4 * s + 2], coords[4 * s + 3]);
}

// K17.  Block: kThreads lanes, 2^log2_group lanes a sample.
template <bool kApp, bool kVec, typename T>
__global__ void __launch_bounds__(kThreads)
cp_fwd_kernel(const float* __restrict__ coords, long long n, Lines ln, int log2_group,
              float* __restrict__ density, float* __restrict__ app) {
  const int group = 1 << log2_group;
  const int g = threadIdx.x & (group - 1);
  const long long s_all =
      (((long long)blockIdx.x * kThreads) >> log2_group) + (threadIdx.x >> log2_group);
  const bool live = s_all < n;
  // past the end a group recomputes the last sample and writes nothing, so
  // that every lane of the warp reaches the shuffles
  const long long s = live ? s_all : n - 1;
  const float4 q = load_coords(coords, s, kVec);
  const float xyz[3] = {q.x, q.y, q.z};
  Rows r[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) r[i] = line_rows(xyz[2 - i], ln.l[i], ln.hat[i] != 0);
  const int C = ln.c, CD = ln.cd, n_app = C - CD;
  float* arow = app + (s * n_app - CD);  // channel c >= CD at arow[c]
  float part = 0.0f;
  for (int c0 = g * kCh; c0 < C; c0 += group * kCh) {
    float l[3][kCh];
    line_values<kVec, kCh, T>(ln, r, c0, l);
    float prod[kCh];
#pragma unroll
    for (int j = 0; j < kCh; ++j) {
      prod[j] = __fmul_rn(__fmul_rn(l[0][j], l[1][j]), l[2][j]);
      if (c0 + j < CD) part = __fadd_rn(part, prod[j]);
    }
    if (kApp && live) {
      if (kVec && c0 >= CD) {
        __stcs(reinterpret_cast<float4*>(arow + c0),
               make_float4(prod[0], prod[1], prod[2], prod[3]));
      } else {
#pragma unroll
        for (int j = 0; j < kCh; ++j) {
          if (c0 + j >= CD && c0 + j < C) __stcs(arow + c0 + j, prod[j]);
        }
      }
    }
  }
  for (int off = group >> 1; off > 0; off >>= 1) {
    part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
  }
  if (live && g == 0) density[s] = part;
}

// Add a lane's pending sums to channels c0 .. of a float32 row: one
// 16-byte RED (kVec) or one 4-byte RED below C.
template <bool kVec>
__device__ __forceinline__ void red(float* row, int c0, int C, const float* v) {
  if constexpr (kVec) {
    atomicAdd(reinterpret_cast<float4*>(row + c0), make_float4(v[0], v[1], v[2], v[3]));
  } else if (c0 < C) {
    atomicAdd(row + c0, v[0]);
  }
}

// K17b's first pass.  run: the samples of one group's run; float32 tables;
// block b adds into copy b % copies of the three lines' gradient rows,
// stacked: (L_0 + L_1 + L_2, C) floats a copy.
template <bool kVec>
__global__ void __launch_bounds__(kBwdThreads, 1)
cp_bwd_kernel(const float* __restrict__ coords, int n, Lines ln,
              const float* __restrict__ d_dens, const float* __restrict__ d_app, float* work,
              int log2_group, int run, int copies) {
  constexpr int K = kVec ? kCh : 1;  // a lane's channels
  const int group = 1 << log2_group;
  const int g = threadIdx.x & (group - 1);
  const int walker = (int)(((long long)blockIdx.x * kBwdThreads + threadIdx.x) >> log2_group);
  const int s_begin = (int)min((long long)walker * run, (long long)n);
  const int s_end = min(n - s_begin, run) + s_begin;
  const int C = ln.c, CD = ln.cd, n_app = C - CD;
  float* const g0 =
      work + (size_t)(blockIdx.x % copies) * ((size_t)ln.l[0] + ln.l[1] + ln.l[2]) * C;
  float* const g1 = g0 + (size_t)ln.l[0] * C;
  float* const g2 = g1 + (size_t)ln.l[1] * C;
  for (int c0 = g * K; c0 < C; c0 += group * K) {
    int row[6] = {-1, -1, -1, -1, -1, -1};
    float acc[6][K];
    auto to0 = [&](int at, const float* v) { red<kVec>(g0 + at, c0, C, v); };
    auto to1 = [&](int at, const float* v) { red<kVec>(g1 + at, c0, C, v); };
    auto to2 = [&](int at, const float* v) { red<kVec>(g2 + at, c0, C, v); };
    for (int s = s_begin; s < s_end; ++s) {
      float dprod[K];
      const float* da = d_app + ((long long)s * n_app - CD);  // channel c >= CD at da[c]
      if (kVec && c0 >= CD) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(da + c0));
        dprod[0] = v.x, dprod[1] = v.y, dprod[2] = v.z, dprod[3] = v.w;
      } else {
        const float dd = d_dens[s];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int c = c0 + j;
          dprod[j] = c < CD ? dd : (c < C ? da[c] : 0.0f);
        }
      }
      bool any = false;
#pragma unroll
      for (int j = 0; j < K; ++j) any |= dprod[j] != 0.0f;
      if (!any) continue;
      const float4 q = load_coords(coords, s, kVec);
      const float xyz[3] = {q.x, q.y, q.z};
      Rows r[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) r[i] = line_rows(xyz[2 - i], ln.l[i], ln.hat[i] != 0);
      float l[3][K];
      line_values<kVec, K, float>(ln, r, c0, l);
      float dout[3][K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float d2 = __fmul_rn(dprod[j], l[2][j]);
        dout[0][j] = __fmul_rn(d2, l[1][j]);
        dout[1][j] = __fmul_rn(d2, l[0][j]);
        dout[2][j] = __fmul_rn(dprod[j], __fmul_rn(l[0][j], l[1][j]));
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (ln.hat[i]) {
#pragma unroll
          for (int j = 0; j < K; ++j) dout[i][j] = bf16_round(dout[i][j]);
        }
      }
      merge<K>(row[0], acc[0], r[0].j0 * C, r[0].w0, dout[0], to0);
      merge<K>(row[1], acc[1], r[0].j1 * C, r[0].w1, dout[0], to0);
      merge<K>(row[2], acc[2], r[1].j0 * C, r[1].w0, dout[1], to1);
      merge<K>(row[3], acc[3], r[1].j1 * C, r[1].w1, dout[1], to1);
      merge<K>(row[4], acc[4], r[2].j0 * C, r[2].w0, dout[2], to2);
      merge<K>(row[5], acc[5], r[2].j1 * C, r[2].w1, dout[2], to2);
    }
    if (row[0] >= 0) to0(row[0], acc[0]);
    if (row[1] >= 0) to0(row[1], acc[1]);
    if (row[2] >= 0) to1(row[2], acc[2]);
    if (row[3] >= 0) to1(row[3], acc[3]);
    if (row[4] >= 0) to2(row[4], acc[4]);
    if (row[5] >= 0) to2(row[5], acc[5]);
  }
}

// K17b's second pass: out[e] = the copies' element e summed in copy order,
// four elements a thread (size a multiple of 4) or one.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
cp_bwd_sum_kernel(const float* __restrict__ work, long long size, int copies,
                  float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if constexpr (kVec) {
    if (4 * i >= size) return;
    const float4* w = reinterpret_cast<const float4*>(work) + i;
    float4 a = __ldcs(w);
    for (int p = 1; p < copies; ++p) {
      const float4 b = __ldcs(w + (size_t)p * (size / 4));
      a = make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                      __fadd_rn(a.w, b.w));
    }
    reinterpret_cast<float4*>(out)[i] = a;
  } else {
    if (i >= size) return;
    float a = __ldcs(work + i);
    for (int p = 1; p < copies; ++p) a = __fadd_rn(a, __ldcs(work + (size_t)p * size + i));
    out[i] = a;
  }
}

// dims: {L_0, L_1, L_2, line mode 0..2 (0 linear, 1 hat), C, CD, log2 of the
// lanes a sample, 1 for the vector instantiation}
// (egonerf_torch/ops/cp.py::_dims)
Lines make_lines(const void* const* lines, const int* dims) {
  Lines ln;
  for (int i = 0; i < 3; ++i) {
    ln.line[i] = lines[i];
    ln.l[i] = dims[i];
    ln.hat[i] = dims[3 + i] == 1;
  }
  ln.c = dims[6];
  ln.cd = dims[7];
  return ln;
}

template <bool kApp, typename T>
void launch_fwd(bool vec, unsigned blocks, cudaStream_t st, const float* coords, long long n,
                const Lines& ln, int log2_group, float* density, float* app) {
  if (vec) {
    cp_fwd_kernel<kApp, true, T><<<blocks, kThreads, 0, st>>>(coords, n, ln, log2_group,
                                                              density, app);
  } else {
    cp_fwd_kernel<kApp, false, T><<<blocks, kThreads, 0, st>>>(coords, n, ln, log2_group,
                                                               density, app);
  }
}

}  // namespace

// K17.  f32_tables: the training form (float32 tables, rounded to bf16 as
// they are read); app may be null where C == CD (the density-only form).
extern "C" int cp_fwd(const float* coords, long long n, const void* const* lines,
                      const int* dims, float* density, float* app, int f32_tables,
                      void* stream) {
  const Lines ln = make_lines(lines, dims);
  const int log2_group = dims[8];
  const bool vec = dims[9] != 0;
  const long long per_block = kThreads >> log2_group;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool with_app = ln.c > ln.cd;
  if (with_app && app == nullptr) return (int)cudaErrorInvalidValue;
  if (!with_app && !f32_tables) return (int)cudaErrorInvalidValue;  // density-only: float32
  if (!with_app) {
    launch_fwd<false, float>(vec, blocks, st, coords, n, ln, log2_group, density, app);
  } else if (f32_tables) {
    launch_fwd<true, float>(vec, blocks, st, coords, n, ln, log2_group, density, app);
  } else {
    launch_fwd<true, __nv_bfloat16>(vec, blocks, st, coords, n, ln, log2_group, density, app);
  }
  return (int)cudaGetLastError();
}

// K17b on float32 tables.  dims[10..12]: the run of samples a group, the
// blocks, the copies (egonerf_torch/ops/cp.py::bwd_geometry); work:
// copies x (L_0 + L_1 + L_2) x C float32, zeroed by the caller; out: the
// three lines' gradient rows stacked, (L_0 + L_1 + L_2) x C float32.  d_app
// may be null where C == CD.
extern "C" int cp_bwd(const float* coords, long long n, const void* const* lines,
                      const int* dims, const float* d_dens, const float* d_app, float* work,
                      float* out, void* stream) {
  const Lines ln = make_lines(lines, dims);
  const int log2_group = dims[8];
  const bool vec = dims[9] != 0;
  const int run = dims[10], blocks = dims[11], copies = dims[12];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    cp_bwd_kernel<true><<<blocks, kBwdThreads, 0, st>>>(coords, (int)n, ln, d_dens, d_app, work,
                                                        log2_group, run, copies);
  } else {
    cp_bwd_kernel<false><<<blocks, kBwdThreads, 0, st>>>(coords, (int)n, ln, d_dens, d_app, work,
                                                         log2_group, run, copies);
  }
  const long long size = ((long long)ln.l[0] + ln.l[1] + ln.l[2]) * ln.c;
  if (size % 4 == 0) {
    const unsigned sum_blocks = (unsigned)((size / 4 + kThreads - 1) / kThreads);
    cp_bwd_sum_kernel<true><<<sum_blocks, kThreads, 0, st>>>(work, size, copies, out);
  } else {
    const unsigned sum_blocks = (unsigned)((size + kThreads - 1) / kThreads);
    cp_bwd_sum_kernel<false><<<sum_blocks, kThreads, 0, st>>>(work, size, copies, out);
  }
  return (int)cudaGetLastError();
}
