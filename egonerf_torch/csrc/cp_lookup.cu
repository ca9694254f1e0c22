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
// Design: the staged slices.  The three lines of 500 rows are small (1.15 MB
// in bf16 at C = 384) but a sample reads six of their rows, 4.8 GB a call if
// every read goes to L2.  So a block owns one channel slice of W channels
// (W = 4 << lw, a power of two of 16 or more; the plan, ops/cp.py::fwd_plan
// and bwd_plan, takes 32) and stages the slice's rows of all three lines
// once in shared memory as bf16 (1,500 rows x 64 bytes = 96 KB at CP-384;
// bf16 tables by cp.async, float32 ones rounded to bf16 as they are staged,
// the same rounding as as_float).  A persistent grid of (slice, part) blocks, blockIdx.x = part *
// slices + slice, so the blocks in flight walk the same samples; each block
// walks its part's samples once.
// * K17: a lane owns two 4-channel quads of the slice, W / 8 lanes a sample;
//   tiles of 128 samples: a tile's coords arrive by cp.async two tiles
//   ahead, the block computes each sample's three row pairs and weights
//   once into shared memory a tile ahead (one barrier a tile), and the
//   lanes read the rows from the staged slice and stream their quads of
//   the appearance row out (W = 32: 128 bytes a sample, 64 at a time).
//   Blocks of 512 threads, two an SM.  The density sum spans the first
//   ceil(CD / W) slices: each writes its partial sums, and a second pass
//   adds them in slice order (one density slice: written directly).
// * K17b: one block an SM; a lane owns one channel of the slice, and the W
//   lanes of a sample (a warp at W = 32) form a walker that walks one
//   contiguous run of its part's samples (a ray's samples are consecutive)
//   in chunks of 8, on its own after the block has staged the slice: no
//   barrier ties walkers whose chunks hold different amounts of work.  Its
//   branches are the warp's: a sample whose cotangents are zero on all its
//   channels (most of a masked step's) is skipped whole, and the windows
//   below move together.  Chunk k + 1's slice of d_app, coords and d_dens
//   arrive by cp.async into the walker's own shared memory while it walks
//   chunk k, so an iteration reads only shared memory.  Each lane
//   keeps, an axis, the pending sums of rows base and base + 1, a window
//   that slides with the ray: a ray's rows on the xyz chart are monotone,
//   so each row is flushed once while the ray stays on it, as a float32
//   atomicAdd (a RED, coalesced over the walker's channels) into one of
//   `copies` copies of the gradient rows (part p to copy p % copies, as
//   many as fit 32 MB, so they stay in the 50 MB L2), and a second pass
//   sums the copies in order.  A row's terms so sum in two levels: with
//   every sample on four points (262,144 terms a row, no window hit), one
//   chain of float32 atomics came 4e-4 of sum|terms| off the exact sum on an
//   H100; here a chain holds about 1 / copies of the terms.  (Sums in
//   shared memory by float atomicAdd, a CAS loop, took 3.0 ms a step
//   against 1.7.)
// * Lines too long for a 32-channel slice (over 3,344 rows in all for K17,
//   2,256 for K17b; narrower slices measured slower than this) take the
//   unstaged form, the first design: a group of lanes a sample reads its
//   rows from L2 (K17), and K17b's walk adds a slot-keyed window into
//   copies of the gradient.
// The appearance output, the vector instantiation (C and CD multiples of 4,
// 16-byte aligned tensors: vector loads, cp.async and stores; the scalar
// one reads and writes a channel at a time) and the table type are template
// parameters; shared memory is read by quads in both.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookup_common.cuh"

namespace {

constexpr int kThreads = 256;        // the unstaged K17's block
constexpr int kFwdThreads = 512;     // K17's block
constexpr int kBwdThreads = 1024;    // K17b's block
constexpr int kUnstagedBwdThreads = 512;  // the unstaged K17b's block
constexpr int kCh = 4;               // a lane's channels: a quad (a chunk, unstaged)
constexpr int kTile = 128;           // K17: samples a tile
constexpr int kSteps = 8;            // K17b: a walker's samples a chunk
constexpr int kBufs = 2;             // K17b: a walker's chunks in flight or ready

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

// ---------------------------------------------------------------------------
// the staged slices
// ---------------------------------------------------------------------------
// A staged slice: the rows of the three lines stacked (L_0 + L_1 + L_2
// rows), W bf16 channels a row, its end rounded up to 16 bytes.  K17's
// lanes read quads (4 channels, 8 bytes) of a row, K17b's a channel.
__device__ __forceinline__ long long tab_bytes(int rows, int w) {
  return ((long long)rows * w * 2 + 15) / 16 * 16;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 4, 8 or 16 bytes from device to shared memory; src_bytes = 0
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage channels c0 .. c0 + W - 1 (W = 4 << lw) of every row of the three
// lines into tab as bf16, zeros past C: bf16 tables of the vector
// instantiation by 8-byte cp.async (one group, committed here), the others
// loaded and rounded to bf16 as they are read (as_float).
template <bool kVec, typename T>
__device__ void stage_slice(const Lines& ln, int c0, int lw, __nv_bfloat16* tab) {
  const int quads = (ln.l[0] + ln.l[1] + ln.l[2]) << lw;
  for (int e = threadIdx.x; e < quads; e += blockDim.x) {
    int r = e >> lw;
    const int c = c0 + kCh * (e & ((1 << lw) - 1));
    const void* line = ln.line[0];  // selected, not indexed: ln stays in registers
    if (r >= ln.l[0]) {
      r -= ln.l[0];
      line = ln.line[1];
      if (r >= ln.l[1]) r -= ln.l[1], line = ln.line[2];
    }
    const T* row = static_cast<const T*>(line) + (size_t)r * ln.c;
    uint2* dst = reinterpret_cast<uint2*>(tab) + e;
    if constexpr (kVec && sizeof(T) == 2) {
      cp_async8(dst, c < ln.c ? row + c : row, c < ln.c ? 8 : 0);
    } else {
      float f[kCh] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (!kVec || c < ln.c) load_row<kVec, kCh, T>(row, c, ln.c, f);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
      *dst = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                        *reinterpret_cast<const unsigned*>(&hi));
    }
  }
  cp_async_commit();
}

// A sample's coords into shared memory: one 16-byte cp.async (vec) or
// four loads; s < 0 writes zeros.
__device__ __forceinline__ void copy_coords(const float* __restrict__ coords, long long s,
                                            bool vec, float4* dst) {
  if (vec) {
    cp_async16(dst, coords + 4 * max(s, 0LL), s >= 0 ? 16 : 0);
  } else {
    *dst = s >= 0 ? load_coords(coords, s, false) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// A sample's three axes, each as an int4: its two rows' places in the
// staged slice, ((base_i + j) << shift), and their weights: 48 bytes.
__device__ __forceinline__ void write_rows(const float4 q, const Lines& ln, const int base[3],
                                           int shift, int4* out) {
  const float xyz[3] = {q.x, q.y, q.z};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const Rows r = line_rows(xyz[2 - i], ln.l[i], ln.hat[i] != 0);
    out[i] = make_int4((base[i] + r.j0) << shift, (base[i] + r.j1) << shift,
                       __float_as_int(r.w0), __float_as_int(r.w1));
  }
}

// A staged quad as float32.
__device__ __forceinline__ void unpack_quad(const uint2 v, float f[kCh]) {
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

// Quad `at` (a row's place plus the quad) of the staged slice, interpolated:
// w0 * row0 + w1 * row1 as one fma over the second product.  On the hat the
// weights are bf16, so w0 * row0 is exact and this is line_values'
// arithmetic bit for bit; float32 weights round once less.
__device__ __forceinline__ void staged_lerp(const uint2* tab, const int4 r, int at,
                                            float l[kCh]) {
  float a[kCh], b[kCh];
  unpack_quad(tab[r.x + at], a);
  unpack_quad(tab[r.y + at], b);
  const float w0 = __int_as_float(r.z), w1 = __int_as_float(r.w);
#pragma unroll
  for (int j = 0; j < kCh; ++j) l[j] = fmaf(w0, a[j], __fmul_rn(w1, b[j]));
}

// K17.  Block (slice, part) = (blockIdx.x % slices, blockIdx.x / slices):
// slice channels slice * W .. + W - 1 (W = 4 << lw), samples part *
// per_part .. + per_part - 1, in tiles of kTile.  A lane owns two quads of
// the slice, q and q + G (G = W / 8 lanes a sample), so that a sample's
// lanes store 64 contiguous bytes at a time.  A tile's coords arrive by
// cp.async two tiles ahead and its rows and weights are computed one tile
// ahead, so the walk never waits on device memory; one barrier a tile.
// Density: written directly where one slice holds every density channel
// (dens_slices == 1), else partial[slice * n + s].
template <bool kApp, bool kVec, typename T>
__global__ void __launch_bounds__(kFwdThreads, 2)
cp_fwd_kernel(const float* __restrict__ coords, long long n, Lines ln, int lw, int slices,
              long long per_part, int dens_slices, float* __restrict__ density,
              float* __restrict__ partial, float* __restrict__ app) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = ln.l[0] + ln.l[1] + ln.l[2];
  const uint2* tab = reinterpret_cast<const uint2*>(smem);
  int4* idx = reinterpret_cast<int4*>(smem + tab_bytes(rows, 4 << lw));  // 2 tiles x 3
  float4* crd = reinterpret_cast<float4*>(idx + 2 * 3 * kTile);           // 3 tiles
  const int slice = blockIdx.x % slices;
  const long long s0 = (long long)(blockIdx.x / slices) * per_part;
  const long long s1 = min(n, s0 + per_part);
  if (s0 >= s1) return;
  const int c0 = slice * (4 << lw);
  const int lq = lw - 1, G = 1 << lq;  // lanes a sample
  const int q = threadIdx.x & (G - 1);
  const int C = ln.c, CD = ln.cd, n_app = C - CD;
  const int cq[2] = {c0 + kCh * q, c0 + kCh * (q + G)};  // the lane's first channels
  const bool dens = c0 < CD;  // the slice holds density channels
  const int base[3] = {0, ln.l[0], ln.l[0] + ln.l[1]};
  const long long tiles = (s1 - s0 + kTile - 1) / kTile;
  // tile t's coords into slot t % 3 (past s1 the last sample's)
  auto fetch = [&](long long t) {
    if (threadIdx.x < kTile) {
      copy_coords(coords, min(s0 + t * kTile + threadIdx.x, s1 - 1), kVec,
                  crd + (t % 3) * kTile + threadIdx.x);
    }
  };
  // tile t's rows and weights into buffer t & 1
  auto fill = [&](long long t) {
    if (threadIdx.x < kTile) {
      write_rows(crd[(t % 3) * kTile + threadIdx.x], ln, base, lw,
                 idx + ((t & 1) * kTile + threadIdx.x) * 3);
    }
  };
  fetch(0);
  if (tiles > 1) fetch(1);
  stage_slice<kVec, T>(ln, c0, lw, reinterpret_cast<__nv_bfloat16*>(smem));  // commits
  cp_async_wait<0>();
  __syncthreads();
  fill(0);
  for (long long t = 0; t < tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    if (t + 2 < tiles) fetch(t + 2);
    cp_async_commit();
    if (t + 1 < tiles) fill(t + 1);
    const int4* tile = idx + (t & 1) * kTile * 3;
    // every lane of a warp takes the same trip count (the shuffles below)
    for (int i = threadIdx.x >> lq; i < kTile; i += kFwdThreads >> lq) {
      const long long s = s0 + t * kTile + i;
      const bool live = s < s1;
      const int4 r[3] = {tile[3 * i], tile[3 * i + 1], tile[3 * i + 2]};
      float part = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = cq[h];
        float l[3][kCh], prod[kCh];
#pragma unroll
        for (int a = 0; a < 3; ++a) staged_lerp(tab, r[a], q + h * G, l[a]);
#pragma unroll
        for (int j = 0; j < kCh; ++j) {
          prod[j] = __fmul_rn(__fmul_rn(l[0][j], l[1][j]), l[2][j]);
          if (c + j < CD) part = __fadd_rn(part, prod[j]);
        }
        if (kApp && live) {
          float* arow = app + (s * n_app - CD);  // channel c >= CD at arow[c]
          if (kVec) {
            if (c >= CD && c < C) {
              __stcs(reinterpret_cast<float4*>(arow + c),
                     make_float4(prod[0], prod[1], prod[2], prod[3]));
            }
          } else {
#pragma unroll
            for (int j = 0; j < kCh; ++j) {
              if (c + j >= CD && c + j < C) __stcs(arow + c + j, prod[j]);
            }
          }
        }
      }
      if (dens) {
        for (int off = G >> 1; off > 0; off >>= 1) {
          part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
        }
        if (live && q == 0) {
          if (dens_slices == 1) {
            density[s] = part;
          } else {
            partial[(long long)slice * n + s] = part;
          }
        }
      }
    }
  }
}

// K17's second pass where the density spans slices: the partial sums of
// each sample added in slice order.
__global__ void __launch_bounds__(kThreads)
cp_dens_sum_kernel(const float* __restrict__ partial, long long n, int k,
                   float* __restrict__ density) {
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (s >= n) return;
  float a = partial[s];
  for (int p = 1; p < k; ++p) a = __fadd_rn(a, partial[(long long)p * n + s]);
  density[s] = a;
}

// A lane's pending sums on one axis: rows base and base + 1 (a sample's two
// rows are j0 and j0 + 1, or one row with the other weight 0), so the
// window slides with a ray that walks the line.  flush() adds a sum into
// the lane's channel of row `row` of the axis's gradient rows g.
struct Window {
  int base;
  float acc0, acc1;
};

__device__ __forceinline__ void flush(float* g, int row, int rows, int c, int C, float v) {
  if (row >= 0 && row < rows && c < C && v != 0.0f) atomicAdd(g + (size_t)row * C + c, v);
}

// Adds the sample's terms w0 * d to row jb, w1 * d to row jb + 1, after
// sliding the window there; the branches depend on the walker's sample
// only, so a warp of one walker takes them together.
__device__ __forceinline__ void slide(Window& win, int jb, float w0, float w1, float d, float* g,
                                      int rows, int c, int C) {
  const int sh = jb - win.base;
  if (sh != 0) {
    if (sh == 1) {
      flush(g, win.base, rows, c, C, win.acc0);
      win.acc0 = win.acc1;
      win.acc1 = 0.0f;
    } else if (sh == -1) {
      flush(g, win.base + 1, rows, c, C, win.acc1);
      win.acc1 = win.acc0;
      win.acc0 = 0.0f;
    } else {
      flush(g, win.base, rows, c, C, win.acc0);
      flush(g, win.base + 1, rows, c, C, win.acc1);
      win.acc0 = win.acc1 = 0.0f;
    }
    win.base = jb;
  }
  win.acc0 = fmaf(w0, d, win.acc0);
  win.acc1 = fmaf(w1, d, win.acc1);
}

// K17b's first pass.  Block (slice, part) as K17's; float32 tables staged
// as bf16.  A lane owns one channel of the slice, c0 + (lane mod W), so a
// walker is W lanes (a warp at W = 32); the 1024 / W walkers of a block
// walk runs s0 + w * run .. of the part
// in chunks of kSteps samples, each on its own after the staging barrier:
// a walker's chunks k + 1 .. k + kBufs - 1 (its rows of d_app, coords and
// d_dens) arrive by cp.async into the walker's own shared memory while it
// walks chunk k; it
// ORs its lanes' nonzero samples of the chunk, computes the rows and
// weights of a chunk with any (kSteps lanes at once) and walks only those
// samples.  Part p adds into copy p % copies of the stacked gradient rows
// ((L_0 + L_1 + L_2, C) floats a copy).
template <bool kVec>
__global__ void __launch_bounds__(kBwdThreads, 1)
cp_bwd_kernel(const float* __restrict__ coords, int n, Lines ln, const float* __restrict__ d_dens,
              const float* __restrict__ d_app, float* work, int lw, int slices, int per_part,
              int copies) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = 4 << lw, lg = lw + 2, rows = ln.l[0] + ln.l[1] + ln.l[2];
  const int walkers = kBwdThreads >> lg;
  const int slice = blockIdx.x % slices, part = blockIdx.x / slices;
  const long long s0 = (long long)part * per_part;
  const int s1 = (int)min((long long)n, s0 + per_part);
  if (s0 >= s1) return;
  const int c0 = slice * W;
  const int C = ln.c, CD = ln.cd, n_app = C - CD;
  const bool has_dens = c0 < CD, has_app = n_app > 0 && c0 + W > CD;
  const int w = threadIdx.x >> lg, lane_c = threadIdx.x & (W - 1), c = c0 + lane_c;
  const unsigned gmask = (W == 32 ? 0xffffffffu : (1u << W) - 1) << ((threadIdx.x & 31) & ~(W - 1));
  const int run = (s1 - (int)s0 + walkers - 1) / walkers;
  const int r0 = (int)s0 + w * run, r1 = min(r0 + run, s1);
  const int chunks = max(0, (r1 - r0 + kSteps - 1) / kSteps);
  const int base[3] = {0, ln.l[0], ln.l[0] + ln.l[1]};
  float* const g = work + (size_t)(part % copies) * rows * C;
  float* const gl[3] = {g, g + (size_t)base[1] * C, g + (size_t)base[2] * C};
  // the walker's own region: kBufs chunks of d_app (kSteps x W floats
  // each), coords and d_dens, and one chunk's rows and weights
  const unsigned short* tab = reinterpret_cast<const unsigned short*>(smem);
  float* da = reinterpret_cast<float*>(smem + tab_bytes(rows, W)) +
              (size_t)w * kSteps * (kBufs * (W + 4 + 1) + 12);
  float4* crd = reinterpret_cast<float4*>(da + kBufs * kSteps * W);
  float* dd = reinterpret_cast<float*>(crd + kBufs * kSteps);
  int4* idx = reinterpret_cast<int4*>(dd + kBufs * kSteps);
  // chunk k into buffer k % kBufs, zeros past the run or C; one cp.async
  // group
  auto fetch = [&](int k) {
    const int b = (k % kBufs) * kSteps;
    for (int e2 = lane_c; has_app && k < chunks && e2 < (kSteps << lw); e2 += W) {
      const int e = e2 >> lw, qq = e2 & ((1 << lw) - 1), cc = c0 + kCh * qq;
      const int s = r0 + k * kSteps + e;
      float* dst = da + (size_t)(b + e) * W + kCh * qq;
      const float* src = d_app + ((long long)min(s, s1 - 1) * n_app - CD);  // channel >= CD at c
      if (kVec) {
        const bool ok = s < r1 && cc >= CD && cc < C;
        cp_async16(dst, ok ? src + cc : d_app, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < kCh; ++j) {
          dst[j] = (s < r1 && cc + j >= CD && cc + j < C) ? src[cc + j] : 0.0f;
        }
      }
    }
    for (int e = lane_c; k < chunks && e < kSteps; e += W) {
      const int s = r0 + k * kSteps + e;
      copy_coords(coords, s < r1 ? s : -1, kVec, crd + b + e);
      if (has_dens) {
        if (kVec) {
          cp_async4(dd + b + e, d_dens + min(s, s1 - 1), s < r1 ? 4 : 0);
        } else {
          dd[b + e] = s < r1 ? d_dens[s] : 0.0f;
        }
      }
    }
    cp_async_commit();
  };
  Window win[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) win[i] = Window{-2, 0.0f, 0.0f};
  stage_slice<kVec, float>(ln, c0, lw, reinterpret_cast<__nv_bfloat16*>(smem));  // commits
  for (int k = 0; k < kBufs - 1; ++k) fetch(k);
  cp_async_wait<kBufs - 1>();  // the slice
  __syncthreads();
  for (int k = 0; k < chunks; ++k) {
    fetch(k + kBufs - 1);  // into the buffer chunk k - 1 held
    cp_async_wait<kBufs - 1>();
    __syncwarp(gmask);  // the walker's copies of chunk k have landed
    const int b = (k % kBufs) * kSteps;
    auto dprod_of = [&](int t) {
      return c < CD ? dd[b + t] : (c < C ? da[(size_t)(b + t) * W + lane_c] : 0.0f);
    };
    unsigned live = 0;  // the lane's nonzero samples, then the walker's
#pragma unroll
    for (int t = 0; t < kSteps; ++t) live |= dprod_of(t) != 0.0f ? 1u << t : 0u;
    live = __reduce_or_sync(gmask, live);
    if (live) {
      for (int e = lane_c; e < kSteps; e += W) write_rows(crd[b + e], ln, base, lg, idx + e * 3);
      __syncwarp(gmask);
    }
    while (live) {
      const int t = __ffs(live) - 1;
      live &= live - 1;
      const float dprod = dprod_of(t);
      const int4 r[3] = {idx[3 * t], idx[3 * t + 1], idx[3 * t + 2]};
      float l[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float a = __uint_as_float((unsigned)tab[r[i].x + lane_c] << 16);
        const float b2 = __uint_as_float((unsigned)tab[r[i].y + lane_c] << 16);
        l[i] = __fadd_rn(__fmul_rn(__int_as_float(r[i].z), a),
                         __fmul_rn(__int_as_float(r[i].w), b2));
      }
      const float d2 = __fmul_rn(dprod, l[2]);
      float dout[3] = {__fmul_rn(d2, l[1]), __fmul_rn(d2, l[0]),
                       __fmul_rn(dprod, __fmul_rn(l[0], l[1]))};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (ln.hat[i]) dout[i] = bf16_round(dout[i]);
        // rows j0 and j0 + 1, or one row twice with one weight 0: the other
        // row of the pair then takes the 0
        const float w0 = __int_as_float(r[i].z), w1 = __int_as_float(r[i].w);
        const int j0 = (r[i].x >> lg) - base[i];
        const int jb = (r[i].x == r[i].y && w0 == 0.0f) ? j0 - 1 : j0;
        slide(win[i], jb, w0, w1, dout[i], gl[i], ln.l[i], c, C);
      }
    }
    __syncwarp(gmask);  // done with buffer b and the rows before they are refilled
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    flush(gl[i], win[i].base, ln.l[i], c, C, win[i].acc0);
    flush(gl[i], win[i].base + 1, ln.l[i], c, C, win[i].acc1);
  }
}

// K17's unstaged form (lines past the staging limit).  Block: kThreads
// lanes, 2^log2_group lanes a sample, each reading its rows from L2.
template <bool kApp, bool kVec, typename T>
__global__ void __launch_bounds__(kThreads)
cp_fwd_unstaged_kernel(const float* __restrict__ coords, long long n, Lines ln, int log2_group,
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

// K17b's unstaged form, first pass.  run: the samples of one group's run;
// float32 tables; block b adds into copy b % copies of the three lines'
// gradient rows, stacked: (L_0 + L_1 + L_2, C) floats a copy.
template <bool kVec>
__global__ void __launch_bounds__(kUnstagedBwdThreads, 1)
cp_bwd_unstaged_kernel(const float* __restrict__ coords, int n, Lines ln,
                       const float* __restrict__ d_dens, const float* __restrict__ d_app,
                       float* work, int log2_group, int run, int copies) {
  constexpr int K = kVec ? kCh : 1;  // a lane's channels
  const int group = 1 << log2_group;
  const int g = threadIdx.x & (group - 1);
  const int walker =
      (int)(((long long)blockIdx.x * kUnstagedBwdThreads + threadIdx.x) >> log2_group);
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

// K17b's second pass (both forms): out[e] = the copies' element e summed in copy order,
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
// unstaged form's lanes a sample, 1 for the vector instantiation}, then the
// plan (egonerf_torch/ops/cp.py::_dims)
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
cudaError_t launch_fwd(bool vec, unsigned blocks, int smem, cudaStream_t st, const float* coords,
                       long long n, const Lines& ln, int lw, int slices, long long per_part,
                       int dens_slices, float* density, float* partial, float* app) {
  auto k = cp_fwd_kernel<kApp, true, T>;
  if (!vec) k = cp_fwd_kernel<kApp, false, T>;
  const cudaError_t err =
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k<<<blocks, kFwdThreads, smem, st>>>(coords, n, ln, lw, slices, per_part, dens_slices,
                                       density, partial, app);
  return cudaSuccess;
}

template <bool kApp, typename T>
void launch_fwd_unstaged(bool vec, unsigned blocks, cudaStream_t st, const float* coords,
                         long long n, const Lines& ln, int log2_group, float* density,
                         float* app) {
  auto k = cp_fwd_unstaged_kernel<kApp, true, T>;
  if (!vec) k = cp_fwd_unstaged_kernel<kApp, false, T>;
  k<<<blocks, kThreads, 0, st>>>(coords, n, ln, log2_group, density, app);
}

// the second pass of K17b: the copies summed in order into out
void launch_bwd_sum(const Lines& ln, const float* work, int copies, float* out,
                    cudaStream_t st) {
  const long long size = ((long long)ln.l[0] + ln.l[1] + ln.l[2]) * ln.c;
  if (size % 4 == 0) {
    const unsigned blocks = (unsigned)((size / 4 + kThreads - 1) / kThreads);
    cp_bwd_sum_kernel<true><<<blocks, kThreads, 0, st>>>(work, size, copies, out);
  } else {
    const unsigned blocks = (unsigned)((size + kThreads - 1) / kThreads);
    cp_bwd_sum_kernel<false><<<blocks, kThreads, 0, st>>>(work, size, copies, out);
  }
}

}  // namespace

// K17.  f32_tables: the training form (float32 tables, rounded to bf16 as
// they are staged); app may be null where C == CD (the density-only form).
// dims[10..15]: log2(W / 4), the slices, the samples a part, the density
// slices, the dynamic shared bytes, the blocks (ops/cp.py::fwd_plan);
// partial: density slices x n float32 where the density spans slices.
extern "C" int cp_fwd(const float* coords, long long n, const void* const* lines,
                      const int* dims, float* density, float* partial, float* app,
                      int f32_tables, void* stream) {
  const Lines ln = make_lines(lines, dims);
  const bool vec = dims[9] != 0;
  const int lw = dims[10], slices = dims[11], dens_slices = dims[13], smem = dims[14];
  const long long per_part = dims[12];
  const unsigned blocks = (unsigned)dims[15];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool with_app = ln.c > ln.cd;
  if (with_app && app == nullptr) return (int)cudaErrorInvalidValue;
  if (!with_app && !f32_tables) return (int)cudaErrorInvalidValue;  // density-only: float32
  if (dens_slices > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (!with_app) {
    err = launch_fwd<false, float>(vec, blocks, smem, st, coords, n, ln, lw, slices, per_part,
                                   dens_slices, density, partial, app);
  } else if (f32_tables) {
    err = launch_fwd<true, float>(vec, blocks, smem, st, coords, n, ln, lw, slices, per_part,
                                  dens_slices, density, partial, app);
  } else {
    err = launch_fwd<true, __nv_bfloat16>(vec, blocks, smem, st, coords, n, ln, lw, slices,
                                          per_part, dens_slices, density, partial, app);
  }
  if (err != cudaSuccess) return (int)err;
  if (dens_slices > 1) {
    const unsigned sum_blocks = (unsigned)((n + kThreads - 1) / kThreads);
    cp_dens_sum_kernel<<<sum_blocks, kThreads, 0, st>>>(partial, n, dens_slices, density);
  }
  return (int)cudaGetLastError();
}

// K17's unstaged form (lines past the staging limit): dims[8] the log2 of
// the lanes a sample (ops/cp.py::cp_layout).
extern "C" int cp_fwd_unstaged(const float* coords, long long n, const void* const* lines,
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
  if (!with_app && !f32_tables) return (int)cudaErrorInvalidValue;
  if (!with_app) {
    launch_fwd_unstaged<false, float>(vec, blocks, st, coords, n, ln, log2_group, density, app);
  } else if (f32_tables) {
    launch_fwd_unstaged<true, float>(vec, blocks, st, coords, n, ln, log2_group, density, app);
  } else {
    launch_fwd_unstaged<true, __nv_bfloat16>(vec, blocks, st, coords, n, ln, log2_group,
                                             density, app);
  }
  return (int)cudaGetLastError();
}

// K17b on float32 tables.  dims[10..15]: log2(W / 4), the slices, the
// samples a part, the copies, the dynamic shared bytes, the blocks
// (ops/cp.py::bwd_plan); work: copies x (L_0 + L_1 + L_2) x C float32,
// zeroed by the caller; out: the three lines' gradient rows stacked, (L_0 +
// L_1 + L_2) x C float32.  d_app may be null where C == CD.
extern "C" int cp_bwd(const float* coords, long long n, const void* const* lines,
                      const int* dims, const float* d_dens, const float* d_app, float* work,
                      float* out, void* stream) {
  const Lines ln = make_lines(lines, dims);
  const bool vec = dims[9] != 0;
  const int lw = dims[10], slices = dims[11], per_part = dims[12], copies = dims[13];
  const int smem = dims[14];
  const unsigned blocks = (unsigned)dims[15];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto k = cp_bwd_kernel<true>;
  if (!vec) k = cp_bwd_kernel<false>;
  const cudaError_t err =
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k<<<blocks, kBwdThreads, smem, st>>>(coords, (int)n, ln, d_dens, d_app, work, lw, slices,
                                       per_part, copies);
  launch_bwd_sum(ln, work, copies, out, st);
  return (int)cudaGetLastError();
}

// K17b's unstaged form.  dims[10..12]: the run of samples a group, the
// blocks, the copies (ops/cp.py::bwd_geometry); work and out as cp_bwd's.
extern "C" int cp_bwd_unstaged(const float* coords, long long n, const void* const* lines,
                               const int* dims, const float* d_dens, const float* d_app,
                               float* work, float* out, void* stream) {
  const Lines ln = make_lines(lines, dims);
  const int log2_group = dims[8];
  const bool vec = dims[9] != 0;
  const int run = dims[10], blocks = dims[11], copies = dims[12];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto k = cp_bwd_unstaged_kernel<true>;
  if (!vec) k = cp_bwd_unstaged_kernel<false>;
  k<<<blocks, kUnstagedBwdThreads, 0, st>>>(coords, (int)n, ln, d_dens, d_app, work, log2_group,
                                            run, copies);
  launch_bwd_sum(ln, work, copies, out, st);
  return (int)cudaGetLastError();
}
