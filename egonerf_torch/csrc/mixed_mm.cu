// K10: the mixed-precision matrix product, bf16 operands and float32
// accumulation, in the three layouts of its forward and backward.
//
// Replaces egonerf_tpu/ops/mm.py::mixed_matmul (:31-57), which
// EGONERF_MIXED_MM=1 puts under EgoNeRF's shader layers
// (models/shading.py:98-143) and its per-chart basis products
// (models/egonerf.py:243-245):
//   forward  c  = bf16(a) @ bf16(b)            (M, K) @ (K, N)
//   backward da = bf16(dout) @ bf16(b)^T       (M, N) @ (N, K)
//            db = bf16(a)^T @ bf16(dout)       (K, M) @ (M, N)
// Each operand element is rounded to bf16 once (round to nearest even, as
// astype(bfloat16)); the products of two bf16 values are exact in float32
// and every sum is float32, so this and the plain version
// (ops/mm.py::mixed_mm_plain) differ only in the order of the float32 sums.
//
// Bound on the card: bytes.  At the production chunk (M = 1,048,576 rows)
// the forward of l1 reads 629 MB of float32 operand and writes 537 MB
// (0.35 ms at 3.35 TB/s) for 40 GFLOP (0.04 ms at 989 TFLOP/s in bf16,
// 0.6 ms at 67 TFLOP/s in float32); every other layer and layout is thinner
// still.  So the kernels read the float32 operands once and round them to
// bf16 in registers while staging them in shared memory (no cast pass),
// and write float32 straight from the accumulators.
//
// Forward (mm_fwd_kernel<TN>): the CUDA cores, in k order.  Each output is
// acc = fma(bf16(a_k), bf16(b_k), acc) from 0 over k = 0, 1, ..., the
// float32 sum of exact products taken left to right, which the plain
// version repeats bit for bit.  The tensor cores add their 16 products and
// the accumulator in an order of their own (aligned to the largest exponent
// and truncated; no simple model matched them on data spread over a few
// binades, H100 80GB HBM3), and under MIXED_MM every product's output is
// rounded to bf16 again as the next product's operand: where the two sums
// differ in a last bit, that rounding lands a bf16 ulp apart and the
// difference grows through the MLP.  With the forward on the tensor cores
// the shader's rgb differed from the plain version's by up to 5.1e-4 a
// sample and the render by 1.5e-5 (700 W; chip_smoke phase 7b allows
// 1e-5).  A block holds b's block of 16 TN columns for the whole depth in
// shared memory (float32 of the bf16 values, loaded once: a persistent grid
// over row tiles) and stages a's rows 32 of depth at a time, the next chunk
// prefetched into registers; a thread owns TM rows x TN columns.
//
// da (mm_rows_kernel<NT>, b^T as its (N, K) operand): the tensor cores
// (mma.sync m16n8k16, bf16 x bf16 -> float32), fed from shared memory by
// 32-bit loads that a padded row stride keeps free of bank conflicts; the
// gradient is not rounded to bf16 again on its way to the loss.  A block
// holds b^T's columns n0 .. n0 + 8 NT - 1 for the whole depth in shared
// memory, loaded once, and walks row tiles of 128 rows (persistent); each
// of its 8 warps owns 16 rows and NT tiles of 8 columns.  The depth goes in
// chunks of 32: the next chunk's 16 values a thread are loaded into
// registers (row-major, 32 consecutive floats a warp) before the tensor
// cores take the current one.  K and N
// are zero-padded to the chunk and to 8 (K = 128, 54, 3; N = 150, 144,
// 135, 128, ...): tiles past N are skipped, rows past M are neither read
// nor written.
//
// Reduce layout (db): mm_db_kernel<TPW>.  The reduction runs over the M
// rows, so each block sums a contiguous range of rows into a partial
// (K, N) tile held in its warps' accumulators (the m16 x n8 tiles of K x N,
// up to TPW a warp, more tiles in further block groups that run beside it),
// staging 32 rows of a and dout a time as they lie and taking the
// transposed fragments with ldmatrix .trans; a second kernel adds the
// partials in block order, so the result does not depend on scheduling.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kRows = 128;      // rows layout: a block's row tile, 16 rows a warp
constexpr int kDepth = 32;      // reduce layout: rows of one staged chunk, two k16 steps
constexpr int kPad = 8;         // bf16 padding of a shared row (see row_stride)

// A shared row of 32q (+ 8) bf16 is 16q + 4 words: the 8 rows x 4 words of
// one fragment load land on 32 distinct banks whether q is odd or even.
__host__ __device__ constexpr int row_stride(int depth) { return depth + kPad; }

__device__ __forceinline__ float bf16_value(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The m16 x k16 fragment of a row-major bf16 tile in shared memory whose
// row r0 + g (g = lane / 4) starts at `row`, columns k0 .. k0 + 15: lane
// (g, t) holds columns 2t, 2t + 1 and 2t + 8, 2t + 9 of rows g and g + 8.
__device__ __forceinline__ void frag_a(uint32_t f[4], const __nv_bfloat16* row, int ld, int k0,
                                       int t) {
  f[0] = lds32(row + k0 + 2 * t);
  f[1] = lds32(row + 8 * ld + k0 + 2 * t);
  f[2] = lds32(row + k0 + 2 * t + 8);
  f[3] = lds32(row + 8 * ld + k0 + 2 * t + 8);
}

// The k16 x n8 fragment of an operand stored n-major (column n0 + g's k
// values contiguous from `col`): lane (g, t) holds k = 2t, 2t + 1 and
// 2t + 8, 2t + 9 of column g.
__device__ __forceinline__ void frag_b(uint32_t f[2], const __nv_bfloat16* col, int k0, int t) {
  f[0] = lds32(col + k0 + 2 * t);
  f[1] = lds32(col + k0 + 2 * t + 8);
}

// ---------------------------------------------------------------------------
// rows layout: c (M, N) = bf16(a) (M, K) @ bf16(b) (K, N); a row-major
// contiguous, b at element strides (sbk, sbn), c row-major contiguous.
// grid: (persistent blocks, column blocks of 8 NT); dynamic shared memory:
// b's block of columns (8 NT x row_stride(kpad)) and one a chunk.
// ---------------------------------------------------------------------------
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
mm_rows_kernel(const float* __restrict__ a, long long m, int k, const float* __restrict__ b,
               long long sbk, long long sbn, int n, float* __restrict__ c) {
  constexpr int kChunk = 32;  // a depth of 64 spilled with 16 column tiles
  constexpr int kChunkLd = row_stride(kChunk);
  constexpr int kPer = kRows / 8;  // values a thread stages a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int kpad = (k + kChunk - 1) / kChunk * kChunk;
  const int ldb = row_stride(kpad);
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem);        // [8 NT][ldb]
  __nv_bfloat16* as = bs + 8 * NT * ldb;                              // [kRows][kChunkLd]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * 8 * NT;

  // b's columns of this block, the whole depth, once
  for (int f = threadIdx.x; f < 8 * NT * kpad; f += kThreads) {
    const int nn = f / kpad, kk = f - nn * kpad;
    float v = 0.0f;
    if (kk < k && n0 + nn < n) v = __ldg(b + kk * sbk + (long long)(n0 + nn) * sbn);
    bs[nn * ldb + kk] = __float2bfloat16_rn(v);
  }

  const long long tiles = (m + kRows - 1) / kRows;
  const int chunks = kpad / kChunk;
  // a thread's values of a chunk: columns lane + 32 q, rows warp + 8 i
  float pa[kPer];
  auto load = [&](long long tile, int chunk) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int kk = chunk * kChunk + lane + 32 * (e / (kRows / 8));
      const long long r = tile * kRows + warp + 8 * (e % (kRows / 8));
      pa[e] = (r < m && kk < k) ? __ldg(a + r * k + kk) : 0.0f;
    }
  };
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  long long tile = blockIdx.x;
  int chunk = 0;
  if (tile < tiles) load(tile, 0);
  while (tile < tiles) {
    __syncthreads();  // the last chunk's fragments are read (and b is staged)
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      as[(warp + 8 * (e % (kRows / 8))) * kChunkLd + lane + 32 * (e / (kRows / 8))] =
          __float2bfloat16_rn(pa[e]);
    }
    __syncthreads();
    long long next_tile = tile;
    int next_chunk = chunk + 1;
    if (next_chunk == chunks) {
      next_chunk = 0;
      next_tile += gridDim.x;
    }
    if (next_tile < tiles) load(next_tile, next_chunk);  // in flight during the products
    const __nv_bfloat16* arow = as + (warp * 16 + g) * kChunkLd;
#pragma unroll
    for (int ks = 0; ks < kChunk; ks += 16) {
      uint32_t fa[4];
      frag_a(fa, arow, kChunkLd, ks, t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (n0 + 8 * j < n) {  // the same for the whole warp
          uint32_t fb[2];
          frag_b(fb, bs + (8 * j + g) * ldb, chunk * kChunk + ks, t);
          mma_bf16(acc[j], fa, fb);
        }
      }
    }
    if (chunk == chunks - 1) {
      // rows g and g + 8 of the warp's 16, columns 2t, 2t + 1 of each tile
      const long long r0 = tile * kRows + warp * 16 + g;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long r = r0 + 8 * h;
          if (r < m && col < n) {
            float* dst = c + r * n + col;
            if (((r * n + col) & 1) == 0 && col + 1 < n) {  // an aligned pair
              *reinterpret_cast<float2*>(dst) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
            } else {
              dst[0] = acc[j][2 * h];
              if (col + 1 < n) dst[1] = acc[j][2 * h + 1];
            }
          }
        }
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      }
    }
    tile = next_tile;
    chunk = next_chunk;
  }
}

// ---------------------------------------------------------------------------
// forward: c (M, N) = bf16(a) (M, K) @ bf16(b) (K, N), each output summed
// in k order with fma from 0; a row-major contiguous, b at element strides
// (sbk, sbn), c row-major contiguous.  A thread owns TM rows x TN columns,
// a block 16 TM rows x 16 TN columns.  grid: (persistent blocks, column
// blocks of 16 TN); dynamic shared memory: b's block [kpad][16 TN] and one
// a chunk transposed [32][16 TM + 4], float32.  A warp holds 4 column
// groups x 8 row groups, so that its k-step reads 4 distinct stretches of
// b's row and 8 of a's column, 16 bytes a load (with 16 column groups a
// warp the loads of b's row kept the shared memory busier than the fmas).
// ---------------------------------------------------------------------------
template <int TN, int TM>
__global__ void __launch_bounds__(kThreads, TN >= 8 ? 1 : 2)
mm_fwd_kernel(const float* __restrict__ a, long long m, int k, const float* __restrict__ b,
              long long sbk, long long sbn, int n, float* __restrict__ c) {
  constexpr int kCols = 16 * TN, kRowsOf = TM, kTile = 16 * TM;
  constexpr int kALd = kTile + 4;  // a chunk's column: 16-byte aligned, 4 banks a step
  extern __shared__ __align__(16) float fsmem[];
  const int kpad = (k + kDepth - 1) / kDepth * kDepth;
  float* bs = fsmem;                // [kpad][kCols]
  float* as = bs + kpad * kCols;    // [kDepth][kALd]: as[kk][row]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = (warp & 3) * 4 + (lane & 3), ty = (warp >> 2) * 8 + (lane >> 2);
  const int n0 = blockIdx.y * kCols;

  for (int f = threadIdx.x; f < kpad * kCols; f += kThreads) {
    const int kk = f / kCols, nn = f - kk * kCols;
    bs[f] = (kk < k && n0 + nn < n) ? bf16_value(__ldg(b + kk * sbk + (long long)(n0 + nn) * sbn))
                                    : 0.0f;
  }
  const long long tiles = (m + kTile - 1) / kTile;
  const int chunks = kpad / kDepth;
  // a thread's 2 TM values of a chunk: column `lane`, rows warp + 8 i
  float pa[kTile / 8];
  auto load = [&](long long tile, int chunk) {
    const int kk = chunk * kDepth + lane;
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      const long long r = tile * kTile + warp + 8 * i;
      pa[i] = (r < m && kk < k) ? __ldg(a + r * k + kk) : 0.0f;
    }
  };
  float acc[kRowsOf][TN];
#pragma unroll
  for (int i = 0; i < kRowsOf; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  }
  long long tile = blockIdx.x;
  int chunk = 0;
  if (tile < tiles) load(tile, 0);
  while (tile < tiles) {
    __syncthreads();  // the last chunk is read (and b is staged)
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) as[lane * kALd + warp + 8 * i] = bf16_value(pa[i]);
    __syncthreads();
    long long next_tile = tile;
    int next_chunk = chunk + 1;
    if (next_chunk == chunks) {
      next_chunk = 0;
      next_tile += gridDim.x;
    }
    if (next_tile < tiles) load(next_tile, next_chunk);  // in flight during the products
    const float* brow = bs + chunk * kDepth * kCols + tx * TN;
#pragma unroll 4
    for (int kk = 0; kk < kDepth; ++kk) {
      float av[kRowsOf], bv[TN];
#pragma unroll
      for (int q = 0; q < kRowsOf / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(as + kk * kALd + ty * kRowsOf + 4 * q);
        av[4 * q] = v.x, av[4 * q + 1] = v.y, av[4 * q + 2] = v.z, av[4 * q + 3] = v.w;
      }
      // b's row kk, the thread's TN columns: 16-byte loads where TN allows
      if constexpr (TN % 4 == 0) {
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(brow + kk * kCols + 4 * q);
          bv[4 * q] = v.x, bv[4 * q + 1] = v.y, bv[4 * q + 2] = v.z, bv[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = brow[kk * kCols + j];
      }
#pragma unroll
      for (int i = 0; i < kRowsOf; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
    }
    if (chunk == chunks - 1) {
#pragma unroll
      for (int i = 0; i < kRowsOf; ++i) {
        const long long r = tile * kTile + ty * kRowsOf + i;
        const int col0 = n0 + tx * TN;
        float* dst = c + r * n + col0;
        if (TN % 4 == 0 && r < m && col0 + TN <= n && ((r * n + col0) & 3) == 0) {
#pragma unroll
          for (int q = 0; q < TN / 4; ++q) {
            reinterpret_cast<float4*>(dst)[q] = make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                                                            acc[i][4 * q + 2], acc[i][4 * q + 3]);
          }
        } else if (r < m) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            if (col0 + j < n) dst[j] = acc[i][j];
          }
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
      }
    }
    tile = next_tile;
    chunk = next_chunk;
  }
}

// ---------------------------------------------------------------------------
// reduce layout: part[s] (K, N) = bf16(a)^T @ bf16(d) over rows
// [s rows_per_block, (s + 1) rows_per_block) of a (M, K) and d (M, N), both
// row-major contiguous.  The m16 x n8 tiles of K x N in row-major order;
// tile group blockIdx.x takes tiles [8 per_warp x, 8 per_warp (x + 1)) and
// warp w the per_warp (<= TPW) consecutive tiles from there.  32 rows of a
// and of d are staged a time as they lie (row-major bf16; lane c of a warp
// on column c, so the loads are coalesced and the stores conflict-free),
// and ldmatrix .trans hands the tensor cores a^T's and d's fragments from
// them.  Dynamic shared memory: 32 rows of ld_a and of ld_d bf16.
// ---------------------------------------------------------------------------
// a padded row of bf16 for ldmatrix: a whole number of 16-byte units, odd,
// so that the 8 rows of one 8x8 matrix fall on 8 distinct bank groups
__host__ __device__ constexpr int ldm_stride(int width) {
  return (width + 7) / 8 % 2 == 0 ? (width + 7) / 8 * 8 + 8 : (width + 7) / 8 * 8 + 16;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t f[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t f[2], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(f[0]), "=r"(f[1])
               : "r"(addr));
}

// rows [r0, r0 + rows) of a row-major (M, width) float32 matrix into
// rows 0 .. 31 of `dst` (row stride ld) as bf16; zeros past rows and width.
// A batch of 5 column passes (160 columns) issues all its 20 loads a
// thread before the first store, so they are in flight together.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ld, const float* src, long long r0,
                                           int rows, int width, int warp, int lane) {
  constexpr int kPass = 5, kRowsOf = kDepth / 8;
  const int padded = (width + 15) / 16 * 16;
  for (int c0 = 0; c0 < padded; c0 += 32 * kPass) {
    float v[kPass][kRowsOf];
#pragma unroll
    for (int p = 0; p < kPass; ++p) {
#pragma unroll
      for (int i = 0; i < kRowsOf; ++i) {
        const int c = c0 + 32 * p + lane, r = warp + 8 * i;
        v[p][i] = (r < rows && c < width) ? __ldg(src + (r0 + r) * width + c) : 0.0f;
      }
    }
#pragma unroll
    for (int p = 0; p < kPass; ++p) {
#pragma unroll
      for (int i = 0; i < kRowsOf; ++i) {
        const int c = c0 + 32 * p + lane;
        if (c < padded) dst[(warp + 8 * i) * ld + c] = __float2bfloat16_rn(v[p][i]);
      }
    }
  }
}

template <int TPW>
__global__ void __launch_bounds__(kThreads, 2)
mm_db_kernel(const float* __restrict__ a, const float* __restrict__ d, long long m, int k, int n,
             long long rows_per_block, int per_warp, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld_a = ldm_stride(k), ld_d = ldm_stride(n);
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);  // [32][ld_a]
  __nv_bfloat16* ds = as + kDepth * ld_a;                       // [32][ld_d]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_n = (n + 7) / 8, tiles = (k + 15) / 16 * tiles_n;
  const int first = (blockIdx.x * 8 + warp) * per_warp;
  const long long r_begin = blockIdx.y * rows_per_block;
  const long long r_end = min(m, r_begin + rows_per_block);
  // ldmatrix row addresses: lane l gives row l % 8 of 8x8 matrix l / 8
  const int mrow = lane & 7, mat = lane >> 3;

  float acc[TPW][4];
#pragma unroll
  for (int j = 0; j < TPW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (long long r0 = r_begin; r0 < r_end; r0 += kDepth) {
    const int rows = (int)min((long long)kDepth, r_end - r0);
    __syncthreads();
    stage_rows(as, ld_a, a, r0, rows, k, warp, lane);
    stage_rows(ds, ld_d, d, r0, rows, n, warp, lane);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kDepth; ks += 16) {
      int mi = first / tiles_n, ni = first - mi * tiles_n, loaded = -1;
      uint32_t fa[4];
#pragma unroll
      for (int j = 0; j < TPW; ++j) {
        if (j < per_warp && first + j < tiles) {
          if (mi != loaded) {
            // a^T's m16 x k16 fragment at (kk = 16 mi, r = ks): matrices
            // (kk, r), (kk + 8, r), (kk, r + 8), (kk + 8, r + 8)
            ldmatrix_x4_trans(fa, as + (ks + mrow + 8 * (mat >> 1)) * ld_a + 16 * mi +
                                      8 * (mat & 1));
            loaded = mi;
          }
          // d's k16 x n8 fragment at (r = ks, nn = 8 ni): matrices r, r + 8
          uint32_t fb[2];
          ldmatrix_x2_trans(fb, ds + (ks + mrow + 8 * (mat & 1)) * ld_d + 8 * ni);
          mma_bf16(acc[j], fa, fb);
        }
        if (++ni == tiles_n) {
          ni = 0;
          ++mi;
        }
      }
    }
  }
  float* out = part + blockIdx.y * (long long)k * n;
  int mi = first / tiles_n, ni = first - mi * tiles_n;
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    if (j < per_warp && first + j < tiles) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = mi * 16 + g + 8 * h, nn = ni * 8 + 2 * t;
        if (kk < k && nn < n) out[kk * n + nn] = acc[j][2 * h];
        if (kk < k && nn + 1 < n) out[kk * n + nn + 1] = acc[j][2 * h + 1];
      }
    }
    if (++ni == tiles_n) {
      ni = 0;
      ++mi;
    }
  }
}

// out[e] = sum over s of part[s][e], s in increasing order
__global__ void __launch_bounds__(kThreads)
mm_db_sum_kernel(const float* __restrict__ part, int splits, int size, float* __restrict__ out) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= size) return;
  float s = 0.0f;
  for (int i = 0; i < splits; ++i) s = __fadd_rn(s, __ldg(part + (long long)i * size + e));
  out[e] = s;
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

size_t rows_smem(int nt, int k) {
  const int depth = 32;
  const int kpad = (k + depth - 1) / depth * depth;
  return sizeof(__nv_bfloat16) *
         ((size_t)8 * nt * row_stride(kpad) + (size_t)kRows * row_stride(depth));
}

template <int NT>
int launch_rows(const float* a, long long m, int k, const float* b, long long sbk, long long sbn,
                int n, float* c, cudaStream_t st) {
  const size_t smem = rows_smem(NT, k);
  cudaError_t err = cudaFuncSetAttribute(mm_rows_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mm_rows_kernel<NT>, kThreads,
                                                        smem);
  }
  if (err == cudaSuccess) err = (cudaError_t)sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const unsigned col_blocks = (unsigned)((n + 8 * NT - 1) / (8 * NT));
  const long long tiles = (m + kRows - 1) / kRows;
  const long long room = (long long)per_sm * sms / col_blocks;
  const unsigned persistent = (unsigned)max(1LL, min(tiles, room));
  mm_rows_kernel<NT><<<dim3(persistent, col_blocks), kThreads, smem, st>>>(a, m, k, b, sbk, sbn,
                                                                          n, c);
  return (int)cudaGetLastError();
}

template <int TPW>
void launch_db(dim3 grid, size_t smem, cudaStream_t st, const float* a, const float* d,
               long long m, int k, int n, long long rows_per_block, int per_warp, float* part) {
  mm_db_kernel<TPW><<<grid, kThreads, smem, st>>>(a, d, m, k, n, rows_per_block, per_warp, part);
}

// the forward's columns a thread owns: 16 TN columns a block (16 for l3's
// 3, 64 for the basis's 54, 128 for the shader's layers), more columns in
// further column blocks
int fwd_cols(int n) { return n <= 16 ? 1 : n <= 64 ? 4 : 8; }

// a thread's rows (a multiple of 4: 16-byte loads of a's column)
constexpr int fwd_rows(int tn) { return 8; }

size_t fwd_smem(int tn, int k) {
  const int kpad = (k + kDepth - 1) / kDepth * kDepth;
  return sizeof(float) * ((size_t)kpad * 16 * tn + (size_t)kDepth * (16 * fwd_rows(tn) + 4));
}

template <int TN>
int launch_fwd(const float* a, long long m, int k, const float* b, long long sbk, long long sbn,
               int n, float* c, cudaStream_t st) {
  constexpr int TM = fwd_rows(TN);
  const size_t smem = fwd_smem(TN, k);
  cudaError_t err = cudaFuncSetAttribute(mm_fwd_kernel<TN, TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mm_fwd_kernel<TN, TM>, kThreads,
                                                        smem);
  }
  if (err == cudaSuccess) err = (cudaError_t)sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const unsigned col_blocks = (unsigned)((n + 16 * TN - 1) / (16 * TN));
  const long long tiles = (m + 16 * TM - 1) / (16 * TM);
  const long long room = (long long)per_sm * sms / col_blocks;
  const unsigned persistent = (unsigned)max(1LL, min(tiles, room));
  mm_fwd_kernel<TN, TM><<<dim3(persistent, col_blocks), kThreads, smem, st>>>(a, m, k, b, sbk, sbn,
                                                                             n, c);
  return (int)cudaGetLastError();
}

// da's columns a block holds: 160 (all of l1's 150, x_fea's 135, the
// basis's 144) or 128, more columns in further column blocks
int rows_tiles(int n) { return n > 128 && n <= 160 ? 20 : 16; }

}  // namespace

extern "C" int mixed_mm_rows(const float* a, long long m, int k, const float* b, long long sbk,
                             long long sbn, int n, float* c, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows_tiles(n)) {
    case 20:
      return launch_rows<20>(a, m, k, b, sbk, sbn, n, c, st);
    default:
      return launch_rows<16>(a, m, k, b, sbk, sbn, n, c, st);
  }
}

extern "C" int mixed_mm_fwd(const float* a, long long m, int k, const float* b, long long sbk,
                            long long sbn, int n, float* c, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fwd_cols(n)) {
    case 1:
      return launch_fwd<1>(a, m, k, b, sbk, sbn, n, c, st);
    case 4:
      return launch_fwd<4>(a, m, k, b, sbk, sbn, n, c, st);
    default:
      return launch_fwd<8>(a, m, k, b, sbk, sbn, n, c, st);
  }
}

// part: (splits, K, N) float32 scratch, splits = ceil(M / rows_per_block)
extern "C" int mixed_mm_db(const float* a, const float* d, long long m, int k, int n,
                           long long rows_per_block, float* part, float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (k + 15) / 16 * ((n + 7) / 8);
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)kDepth * (ldm_stride(k) + ldm_stride(n));
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // ops/mm.py raises first
  const unsigned splits = (unsigned)((m + rows_per_block - 1) / rows_per_block);
  if (splits > 65535) return (int)cudaErrorInvalidValue;
  // tile groups of at most 8 x 16 tiles, the tiles spread evenly over them
  const int groups = (tiles + 127) / 128;
  const int per_warp = (tiles + 8 * groups - 1) / (8 * groups);
  const dim3 grid(groups, splits);  // a row range's groups run side by side
  if (per_warp <= 4) {
    launch_db<4>(grid, smem, st, a, d, m, k, n, rows_per_block, per_warp, part);
  } else if (per_warp <= 8) {
    launch_db<8>(grid, smem, st, a, d, m, k, n, rows_per_block, per_warp, part);
  } else if (per_warp <= 12) {
    launch_db<12>(grid, smem, st, a, d, m, k, n, rows_per_block, per_warp, part);
  } else {
    launch_db<16>(grid, smem, st, a, d, m, k, n, rows_per_block, per_warp, part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int size = k * n;
  mm_db_sum_kernel<<<(size + kThreads - 1) / kThreads, kThreads, 0, st>>>(part, (int)splits, size,
                                                                          out);
  return (int)cudaGetLastError();
}
