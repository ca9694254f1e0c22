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
// Bound on the card.  At the production chunk (M = 1,048,576 rows) l1's
// layouts each move about 1.17 GB of float32 operand and result (0.35 ms at
// 3.35 TB/s) for 40 GFLOP: 0.04 ms at 989 TFLOP/s in bf16, but 0.6 ms as
// float32 fmas on the CUDA cores (132 SMs x 128 lanes at 1.98 GHz).  So da
// and db, on the tensor cores, are bound by bytes: they read the float32
// operands once and round them to bf16 on the way to the tensor cores (no
// cast pass).  The forward sums on the CUDA cores (below), where l1's and
// l2's fmas take longer than their bytes: its floor is the fma time.
//
// Forward: the CUDA cores, in k order.  Each output is
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
// 1e-5).  Two kernels (ops/mm.py::fwd_layout picks one):
//  - wide (mm_fwd_kernel<CT, RG, CG, NT>, N > 16): a thread owns 16 rows x
//    8 columns (the shader's 128 columns, two blocks of 128 threads an SM)
//    or 8 x 4 (the basis's 54 in 64, four blocks), each k-step reading its
//    operands as float4s from shared memory; a's chunks 32 deep staged
//    through registers one chunk ahead (below).
//  - narrow (mm_fwd_narrow_kernel<NW, VEC>, N <= 16: l3's 3 columns): a
//    thread owns one row and all NW >= N columns, so no column is wasted
//    past 4 or 16, and streams its row from device memory.
// Drafts that lost on the card (H100 80GB HBM3): a's chunks copied by
// 4-byte cp.async and rounded in place (the copies could not keep up with
// the fmas); 16-byte cp.async pieces into a landing buffer transposed by a
// second pass, interleaved with the fmas or not (no faster than staging
// through registers); 8 x 8 a thread (the fmas at about half their rate,
// as in the earlier design); one block of 256 threads an SM at 16 x 8
// (its barriers idle the SM; two blocks of 128 hide each other's staging).
//
// da (mm_rows_kernel<S, KS>, b^T as its (N, K) operand): the tensor cores
// (mma.sync m16n8k16, bf16 x bf16 -> float32); the gradient is not rounded
// to bf16 again on its way to the loss.  Bound by bytes (l1: 537 MB of dout
// read, 629 MB of da written).  A persistent block an SM walks row tiles of
// 64 rows through a ring of S = 3 or 4 stages: a stage is a tile's rows of
// dout as they lie (float32), copied by 16-byte cp.async pieces, either as
// one contiguous range (K % 4 != 0; the last 1-3 floats of a tail tile by
// plain loads: ops/mm.py::bulk_copy) or row by row into rows padded to 8 or
// 24 words mod 32 (K % 4 == 0), where a fragment's float2 loads fall on
// distinct banks.  Each of the 8 warps (2 along M x 4 along N) owns 32 rows
// and up to 5 n8 tiles of a tile; it holds its tiles of b^T for the whole
// depth (K <= 160) as mma B fragments in registers, loaded once, and takes
// its A fragments from the stage as float2 pairs rounded to bf16 in
// registers (cvt.rn.bf16x2, round to nearest even), zero past K.  Its sums
// go to a staging tile (two, alternated) that holds the tile's rows of da
// as they lie in device memory: one contiguous, 16-byte aligned range
// (64 rows from a multiple of 64), which one thread hands to the bulk-copy
// engine (cp.async.bulk shared -> global) in the next iteration, so the
// stores of one tile run beside the products of the next and the loads in
// flight.  Iteration i waits for stage i (and for the bulk copy of tile
// i - 2 to have read its staging tile), puts stage i + S - 1 in flight,
// hands tile i - 1 to the bulk copy and takes tile i's products: one
// barrier a tile.  Rows past M are neither read nor written; N of any width
// (column blocks of 160, stored row by row).  Measured against the earlier
// design (egonerf_torch/tools/mm_ab.py --ablate, H100 80GB HBM3, 700 W):
// its stores, float2s straight from the fragments (a 600-byte row of l1
// puts a quad's 32 bytes across two sectors on every odd row), took 0.57
// of its 0.77 ms at l1.  Drafts that lost on the card: b^T in shared memory
// read by ldmatrix (every warp reads its columns again for each 32 rows:
// that traffic kept the products from hiding under the memory time), with
// the sums stored by the threads row by row; 16 warps of 16 rows; an
// unrolled k loop.
//
// Reduce layout (db): mm_db_kernel<S, WK>.  The reduction runs over the M
// rows, so each block sums a contiguous range of rows into a partial (K, N)
// tile and a second kernel (mm_db_sum_kernel) adds the partials in range
// order: the result does not depend on scheduling, the same bits every
// run.  One block holds a whole group of outputs (160 x 128 for l1, the
// hoist and the basis; 256 x 16 for l3's 3 columns), so every row of a and
// dout is read from device memory once, in the accumulators of 16 warps;
// about one block an SM.  A stage is 32 rows of a and of dout as they lie
// (float32; a row of 150 floats is 600 bytes, not a multiple of 16, but 32
// rows from a multiple of 4 rows are one 16-byte aligned range), copied by
// all threads in 16-byte cp.async pieces (the last 1-3 floats of a tail
// range by plain loads: ops/mm.py::bulk_copy) into a ring of S = 2-4
// stages; each stage is rounded to bf16 (round to nearest even) into one of
// two tiles laid out for ldmatrix .trans while the tensor cores (mma.sync)
// take the other: one barrier a stage.  The products are ~40 GFLOP at most,
// far under the tensor rate: the ring keeps the bytes in flight.  (A
// first draft fed the ring with 1-D bulk copies (cp.async.bulk, the TMA
// engine) from a producer warp to 8 consumer warps: 0.68 ms for l1, about
// 2.4 us a stage whatever its bytes; with cp.async and 8 warps 0.59, where
// the rounding and the tensor cores alone took longer than the copies: 16
// warps hide their latency, 0.47; egonerf_torch/tools/mm_ab.py.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps (the partial sums' kernel)

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

// ---------------------------------------------------------------------------
// asynchronous copies (cp.async): global -> shared without registers,
// completed by cp.async.wait_group for the issuing thread
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the issuing thread's groups but the newest N have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// forward, wide: c (M, N) = bf16(a) (M, K) @ bf16(b) (K, N), each output
// summed in k order with fma from 0; a row-major contiguous, b at element
// strides (sbk, sbn), c row-major contiguous.  The kWideThreads threads
// form CT = 16 columns x RT = 8 rows; a thread owns rows 4 RT g + 4 ty + i
// (g < RG, i < 4) and columns 4 CT h + 4 tx + j (h < CG, j < 4) of its
// block's tile of 4 RG RT rows x 4 CG CT columns, so that a warp's 8 row
// groups read 128 contiguous bytes of the transposed a chunk and its 4
// column groups 64 of b's row.  b's block of columns stays in shared memory for the whole depth
// (float32 of the bf16 values, loaded once: a persistent grid over row
// tiles).  a comes 32 deep a chunk: a thread loads its values of the next
// chunk into registers (32 consecutive floats a warp) before the fmas of
// this one and rounds them to bf16 into the transposed chunk [32][rows +
// 4] between two barriers; a second block on the SM runs its fmas across
// those barriers.  A full chunk's k loop has a constant trip count
// (unrolled by 8); the last one stops at K.
// ---------------------------------------------------------------------------
constexpr int kFwdDepth = 32;  // a chunk's depth

__host__ __device__ constexpr int round4(int k) { return (k + 3) & ~3; }

constexpr int kWideThreads = 128;  // two blocks an SM at 16 x 8 a thread, four at 8 x 4

template <int RG, int CG>
__global__ void __launch_bounds__(kWideThreads, 2)
mm_fwd_kernel(const float* __restrict__ a, long long m, int k, const float* __restrict__ b,
              long long sbk, long long sbn, int n, float* __restrict__ c) {
  constexpr int NT = kWideThreads, CT = 16, RT = NT / CT;
  constexpr int kTile = 4 * RG * RT, kCols = 4 * CG * CT;
  constexpr int kALd = kTile + 4;
  constexpr int kPer = kTile * kFwdDepth / NT;  // values a thread stages a chunk
  extern __shared__ __align__(16) float fsmem[];
  const int k4 = round4(k);
  float* bs = fsmem;             // [k4][kCols]
  float* as = bs + k4 * kCols;   // [kFwdDepth][kALd]: as[kk][row]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = (warp % (CT / 4)) * 4 + (lane & 3), ty = (warp / (CT / 4)) * 8 + (lane >> 2);
  const int n0 = blockIdx.y * kCols;

  for (int f = threadIdx.x; f < k4 * kCols; f += NT) {
    const int kk = f / kCols, nn = f - kk * kCols;
    bs[f] = (kk < k && n0 + nn < n) ? bf16_value(__ldg(b + kk * sbk + (long long)(n0 + nn) * sbn))
                                    : 0.0f;
  }
  const long long tiles = (m + kTile - 1) / kTile;
  const int chunks = (k4 + kFwdDepth - 1) / kFwdDepth;
  // a thread's values of a chunk: depth `lane`, rows warp + (NT / 32) i
  float pa[kPer];
  auto load = [&](long long tile, int chunk) {
    const int kk = chunk * kFwdDepth + lane;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const long long r = tile * kTile + warp + NT / 32 * i;
      pa[i] = (r < m && kk < k) ? __ldg(a + r * k + kk) : 0.0f;
    }
  };
  float acc[4 * RG][4 * CG];
#pragma unroll
  for (int i = 0; i < 4 * RG; ++i) {
#pragma unroll
    for (int j = 0; j < 4 * CG; ++j) acc[i][j] = 0.0f;
  }
  long long tile = blockIdx.x;
  int chunk = 0;
  if (tile < tiles) load(tile, 0);
  while (tile < tiles) {
    __syncthreads();  // the last chunk is read (and b is staged)
#pragma unroll
    for (int i = 0; i < kPer; ++i) as[lane * kALd + warp + NT / 32 * i] = bf16_value(pa[i]);
    __syncthreads();
    long long next_tile = tile;
    int next_chunk = chunk + 1;
    if (next_chunk == chunks) {
      next_chunk = 0;
      next_tile += gridDim.x;
    }
    if (next_tile < tiles) load(next_tile, next_chunk);  // in flight during the fmas
    const float* ab = as + ty * 4;
    const float* bb = bs + chunk * kFwdDepth * kCols + tx * 4;
    auto step = [&](int kk) {
      float av[4 * RG], bv[4 * CG];
#pragma unroll
      for (int g = 0; g < RG; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(ab + kk * kALd + 4 * RT * g);
        av[4 * g] = v.x, av[4 * g + 1] = v.y, av[4 * g + 2] = v.z, av[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < CG; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(bb + kk * kCols + 4 * CT * h);
        bv[4 * h] = v.x, bv[4 * h + 1] = v.y, bv[4 * h + 2] = v.z, bv[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 4 * RG; ++i) {
#pragma unroll
        for (int j = 0; j < 4 * CG; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
    };
    // a full chunk with a constant trip count, the last one to K
    const int depth = k - chunk * kFwdDepth;
    if (depth >= kFwdDepth) {
#pragma unroll 8
      for (int kk = 0; kk < kFwdDepth; ++kk) step(kk);
    } else {
#pragma unroll 4
      for (int kk = 0; kk < depth; ++kk) step(kk);
    }
    if (chunk == chunks - 1) {
#pragma unroll
      for (int i = 0; i < 4 * RG; ++i) {
        const long long r = tile * kTile + 4 * RT * (i / 4) + ty * 4 + (i % 4);
#pragma unroll
        for (int h = 0; h < CG; ++h) {
          const int col0 = n0 + 4 * CT * h + tx * 4;
          float* out = c + r * n + col0;
          if (r < m && col0 + 4 <= n && ((r * n + col0) & 3) == 0) {
            *reinterpret_cast<float4*>(out) = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                                          acc[i][4 * h + 2], acc[i][4 * h + 3]);
          } else if (r < m) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (col0 + j < n) out[j] = acc[i][4 * h + j];
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4 * CG; ++j) acc[i][j] = 0.0f;
      }
    }
    tile = next_tile;
    chunk = next_chunk;
  }
}

// ---------------------------------------------------------------------------
// forward, narrow (N <= NW <= 16): a thread owns one row of c and all its
// columns, summed in k order with fma from 0, reading its row of a from
// device memory 16 bytes at a time where K and a allow (VEC = 4; else one
// float): the 32 lines a warp's load touches are read whole over its next
// loads, from L1.  A persistent grid of kNarrowBlocks blocks an SM keeps
// 1,024 rows in flight: with 2,048 (8 blocks, the most that fit) the rows'
// lines evicted each other before their last use (slower than the earlier
// 16-column wide kernel on the card).  b's values [K][NW] are in shared memory, read as
// broadcast float4s.
// ---------------------------------------------------------------------------
constexpr int kNarrowThreads = 256, kNarrowBlocks = 4;

template <int NW, int VEC>
__global__ void __launch_bounds__(kNarrowThreads)
mm_fwd_narrow_kernel(const float* __restrict__ a, long long m, int k, const float* __restrict__ b,
                     long long sbk, long long sbn, int n, float* __restrict__ c) {
  extern __shared__ __align__(16) float fsmem[];
  float* bs = fsmem;  // [k][NW]
  for (int f = threadIdx.x; f < k * NW; f += kNarrowThreads) {
    const int kk = f / NW, nn = f - kk * NW;
    bs[f] = nn < n ? bf16_value(__ldg(b + kk * sbk + nn * sbn)) : 0.0f;
  }
  __syncthreads();
  for (long long r = (long long)blockIdx.x * kNarrowThreads + threadIdx.x; r < m;
       r += (long long)gridDim.x * kNarrowThreads) {
    const float* arow = a + r * k;
    float acc[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) acc[j] = 0.0f;
    auto step_k = [&](float av, int kk) {
#pragma unroll
      for (int q = 0; q < NW / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(bs + kk * NW + 4 * q);
        acc[4 * q] = __fmaf_rn(av, v.x, acc[4 * q]);
        acc[4 * q + 1] = __fmaf_rn(av, v.y, acc[4 * q + 1]);
        acc[4 * q + 2] = __fmaf_rn(av, v.z, acc[4 * q + 2]);
        acc[4 * q + 3] = __fmaf_rn(av, v.w, acc[4 * q + 3]);
      }
    };
    if (VEC == 4) {
#pragma unroll 4
      for (int kk = 0; kk < k; kk += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(arow + kk));
        step_k(bf16_value(v.x), kk);
        step_k(bf16_value(v.y), kk + 1);
        step_k(bf16_value(v.z), kk + 2);
        step_k(bf16_value(v.w), kk + 3);
      }
    } else {
#pragma unroll 8
      for (int kk = 0; kk < k; ++kk) step_k(bf16_value(__ldg(arow + kk)), kk);
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      if (j < n) c[r * n + j] = acc[j];
    }
  }
}

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

// ---------------------------------------------------------------------------
// reduce layout: part[s] (K, N) = bf16(a)^T @ bf16(d) over rows
// [s rows_per_block, (s + 1) rows_per_block) of a (M, K) and d (M, N), both
// row-major contiguous and 16-byte aligned, rows_per_block a multiple of
// kDbRows.  blockIdx.y is the block's group of outputs; its 16 warps
// stand WK along K by 16 / WK along N, each over MT x 2 m16n8 tiles: WK = 2,
// MT = 5 (groups of 160 x 128: l1, the hoist, the basis) or WK = 16,
// MT = 1 (256 x 16: l3's 3 columns, whose one n8 tile would otherwise
// leave the products to 2 warps).  A stage of the ring is kDbRows rows of
// a then of d as they lie (float32: one contiguous range each, copied in
// 16-byte pieces, the last (rows K) % 4 floats of a tail by plain loads);
// the bf16 tiles are kDbRows rows of ldm_stride(K) and of ldm_stride(N),
// zero past the stage's rows and past K and N (to 16).  Iteration i waits
// for stage i, puts stage i + S - 1 in flight, rounds stage i into tile
// i % 2 and feeds the tensor cores from tile (i - 1) % 2: one barrier a
// stage.  Dynamic shared memory (db_smem): the ring and two tiles.
// ---------------------------------------------------------------------------
constexpr int kDbRows = 32;           // rows a stage: two k16 steps
constexpr int kDbThreads = 512;       // 16 warps
constexpr int kDbNT = 2;              // n8 tiles a warp

// a group's outputs along K and N for WK warps along K
__host__ __device__ constexpr int db_mt(int wk) { return wk == 2 ? 5 : 1; }
__host__ __device__ constexpr int db_group_k(int wk) { return 16 * db_mt(wk) * wk; }
__host__ __device__ constexpr int db_group_n(int wk) { return 8 * kDbNT * (16 / wk); }

__host__ __device__ constexpr int round16(int w) { return (w + 15) / 16 * 16; }

// `floats` contiguous floats from src (16-byte aligned) to dst by the
// block's THREADS threads: 16-byte cp.async pieces, the last floats % 4 by
// plain loads
template <int THREADS>
__device__ __forceinline__ void copy_range(float* dst, const float* src, int floats) {
  const int pieces = floats / 4;
  for (int p = threadIdx.x; p < pieces; p += THREADS) cp_async16(dst + 4 * p, src + 4 * p);
  for (int e = 4 * pieces + threadIdx.x; e < floats; e += THREADS) dst[e] = __ldg(src + e);
}

// rows [0, kDbRows) of a stage's (rows, width) float32 block as bf16 into
// the tile `dst` (row stride ld): warp w takes rows w and w + 16, lane l
// the column pairs 2 l + 64 q; zeros past `rows` and past `width` (to 16)
__device__ __forceinline__ void round_rows(__nv_bfloat16* dst, int ld, const float* src, int rows,
                                           int width, int warp, int lane) {
  const int padded = round16(width);
  for (int col = 2 * lane; col < padded; col += 64) {
#pragma unroll
    for (int q = 0; q < kDbRows / 16; ++q) {
      const int r = warp + 16 * q;
      const float* row = src + r * width;
      float2 v = make_float2(0.0f, 0.0f);
      if (r < rows) {
        if ((width & 1) == 0) {
          if (col < width) v = *reinterpret_cast<const float2*>(row + col);
        } else {
          if (col < width) v.x = row[col];
          if (col + 1 < width) v.y = row[col + 1];
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(dst + r * ld + col) = __floats2bfloat162_rn(v.x, v.y);
    }
  }
}

template <int S, int WK>
__global__ void __launch_bounds__(kDbThreads, 1)
mm_db_kernel(const float* __restrict__ a, const float* __restrict__ d, long long m, int k, int n,
             long long rows_per_block, float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld_a = ldm_stride(k), ld_d = ldm_stride(n);
  const int stage_floats = kDbRows * (k + n);  // a multiple of 32: 128-byte aligned stages
  float* ring = reinterpret_cast<float*>(smem);
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(ring + S * stage_floats);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mrow = lane & 7, mat = lane >> 3;  // ldmatrix: lane l gives row l % 8 of matrix l / 8
  const long long r_begin = blockIdx.x * rows_per_block;
  const long long r_end = min(m, r_begin + rows_per_block);
  const int iters = (int)((r_end - r_begin + kDbRows - 1) / kDbRows);
  auto rows_of = [&](int i) {
    return (int)min((long long)kDbRows, r_end - r_begin - (long long)i * kDbRows);
  };
  // stage i's rows into slot i % S (an empty group past the last)
  auto issue = [&](int i) {
    if (i < iters) {
      const long long r0 = r_begin + (long long)i * kDbRows;
      float* dst = ring + (i % S) * stage_floats;
      copy_range<kDbThreads>(dst, a + r0 * k, rows_of(i) * k);
      copy_range<kDbThreads>(dst + kDbRows * k, d + r0 * n, rows_of(i) * n);
    }
    cp_async_commit();
  };
  constexpr int kDbMT = db_mt(WK), WN = 16 / WK;
  const int groups_n = (n + db_group_n(WK) - 1) / db_group_n(WK);
  const int mi0 = (blockIdx.y / groups_n) * (db_group_k(WK) / 16) + (warp / WN) * kDbMT;
  const int ni0 = (blockIdx.y % groups_n) * (db_group_n(WK) / 8) + (warp % WN) * kDbNT;
  const int mtiles = (k + 15) / 16, ntiles = (n + 7) / 8;
  float acc[kDbMT][kDbNT][4];
#pragma unroll
  for (int i = 0; i < kDbMT; ++i) {
#pragma unroll
    for (int j = 0; j < kDbNT; ++j) {
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
    }
  }
  auto products = [&](const __nv_bfloat16* ta, const __nv_bfloat16* td) {
#pragma unroll
    for (int ks = 0; ks < kDbRows; ks += 16) {
      // d's k16 x n8 fragments at (r = ks, nn = 8 ni), two tiles a load:
      // matrices (r, ni), (r + 8, ni), (r, ni + 1), (r + 8, ni + 1)
      uint32_t fb[kDbNT][2];
#pragma unroll
      for (int j = 0; j < kDbNT; j += 2) {
        if (ni0 + j < ntiles) {
          uint32_t f[4];
          ldmatrix_x4_trans(f, td + (ks + mrow + 8 * (mat & 1)) * ld_d + 8 * (ni0 + j) +
                                   8 * (mat >> 1));
          fb[j][0] = f[0], fb[j][1] = f[1], fb[j + 1][0] = f[2], fb[j + 1][1] = f[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < kDbMT; ++mi) {
        if (mi0 + mi < mtiles) {
          // a^T's m16 x k16 fragment at (kk = 16 (mi0 + mi), r = ks):
          // matrices (kk, r), (kk + 8, r), (kk, r + 8), (kk + 8, r + 8)
          uint32_t fa[4];
          ldmatrix_x4_trans(fa, ta + (ks + mrow + 8 * (mat >> 1)) * ld_a + 16 * (mi0 + mi) +
                                    8 * (mat & 1));
#pragma unroll
          for (int j = 0; j < kDbNT; ++j) {
            if (ni0 + j < ntiles) mma_bf16(acc[mi][j], fa, fb[j]);
          }
        }
      }
    }
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s);
  for (int i = 0; i <= iters; ++i) {
    cp_async_wait<S - 2>();
    // stage i is in place for every thread; iteration i - 1 has read its
    // slot and written its tile, and iteration i - 2's tile is read
    __syncthreads();
    issue(i + S - 1);  // into the slot of stage i - 1
    if (i < iters) {
      __nv_bfloat16* ta = tiles + (i & 1) * kDbRows * (ld_a + ld_d);
      const float* src = ring + (i % S) * stage_floats;
      round_rows(ta, ld_a, src, rows_of(i), k, warp, lane);
      round_rows(ta + kDbRows * ld_a, ld_d, src + kDbRows * k, rows_of(i), n, warp, lane);
    }
    if (i > 0) {
      const __nv_bfloat16* ta = tiles + ((i - 1) & 1) * kDbRows * (ld_a + ld_d);
      products(ta, ta + kDbRows * ld_a);
    }
  }
  float* out = part + blockIdx.x * (long long)k * n;
#pragma unroll
  for (int mi = 0; mi < kDbMT; ++mi) {
#pragma unroll
    for (int j = 0; j < kDbNT; ++j) {
      if (mi0 + mi < mtiles && ni0 + j < ntiles) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kk = (mi0 + mi) * 16 + g + 8 * h, nn = (ni0 + j) * 8 + 2 * t;
          if (kk < k && nn < n) out[kk * n + nn] = acc[mi][j][2 * h];
          if (kk < k && nn + 1 < n) out[kk * n + nn + 1] = acc[mi][j][2 * h + 1];
        }
      }
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

// ---------------------------------------------------------------------------
// rows layout (da): c (M, N) = bf16(a) (M, K) @ bf16(b) (K, N), K <= 160; a
// and c row-major contiguous and 16-byte aligned, b at element strides
// (sbk, sbn).  grid: (persistent blocks, column blocks of kRowsCols);
// dynamic shared memory (rows_smem): the ring of S stages of kRowsTile rows
// of a (row stride rows_lda) and two staging tiles of kRowsTile rows of c
// (the block's columns as they lie in c).  Warp w owns rows 32 (w / 4) ..
// + 31 of a tile (two m16 tiles) and the n8 tiles tpw (w % 4) .. + tpw - 1
// of its block's columns, tpw = ceil(tiles / 4) <= kRowsWarpTiles, whose
// b^T fragments over KS k16 steps it holds in registers.
// ---------------------------------------------------------------------------
constexpr int kRowsThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kRowsTile = 64;      // rows a stage, 32 a warp
constexpr int kRowsCols = 160;     // columns a block (l1's 150, the basis's 144)
constexpr int kRowsWarpTiles = kRowsCols / 8 / 4;  // n8 tiles a warp, at most
constexpr int kRowsMaxDepth = 160;                 // 10 k16 steps of b^T in registers

// the smallest w' >= w of 8 or 24 words mod 32 (w a multiple of 4): the
// rows g = 0..3 of a half-warp's float2 fragment access start on distinct
// groups of 8 banks
__host__ __device__ constexpr int pad_8_24(int w) {
  return w % 32 <= 8 ? w + 8 - w % 32 : (w % 32 <= 24 ? w + 24 - w % 32 : w + 40 - w % 32);
}
// a stage row: as it lies where K % 4 != 0 (the stage is one contiguous
// range), else padded
__host__ __device__ constexpr int rows_lda(int k) { return k % 4 ? k : pad_8_24(k); }
// n8 tiles a warp for a block of `cols` columns
__host__ __device__ constexpr int rows_tpw(int cols) { return ((cols + 7) / 8 + 3) / 4; }
// k16 steps of b^T an instantiation holds for depth k (<= kRowsMaxDepth)
__host__ __device__ constexpr int rows_ks(int k) {
  return k <= 16 ? 1 : (k <= 64 ? 4 : (k <= 128 ? 8 : 10));
}

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);  // round to nearest even; x low
  return *reinterpret_cast<const uint32_t*>(&h);
}

// columns col, col + 1 of a float32 row in shared memory as a bf16 pair: a
// float2 load where the row stride is even and the step lies inside K,
// else two loads, zero past K
__device__ __forceinline__ uint32_t bf16_pair(const float* row, int col, int k, bool full,
                                              bool even) {
  float x, y;
  if (full && even) {
    const float2 v = *reinterpret_cast<const float2*>(row + col);
    x = v.x, y = v.y;
  } else {
    x = full || col < k ? row[col] : 0.0f;
    y = full || col + 1 < k ? row[col + 1] : 0.0f;
  }
  return pack_bf16(x, y);
}

// shared -> global by the bulk-copy engine (cp.async.bulk): both addresses
// 16-byte aligned, bytes a multiple of 16; the issuing thread's groups are
// waited for by bulk_wait_read (the source may be written again) and
// bulk_wait (the writes are done)
__device__ __forceinline__ void bulk_store(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// this thread's writes to shared memory, made visible to the bulk-copy engine
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int S, int KS>
__global__ void __launch_bounds__(kRowsThreads, 1)
mm_rows_kernel(const float* __restrict__ a, long long m, int k, const float* __restrict__ b,
               long long sbk, long long sbn, int n, float* __restrict__ c) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.y * kRowsCols;
  const int cols = min(kRowsCols, n - n0);
  const int ntiles = (cols + 7) / 8, tpw = rows_tpw(cols);
  const int lda = rows_lda(k), ksteps = (k + 15) / 16;
  float* ring = reinterpret_cast<float*>(smem);
  float* stage_c = ring + S * kRowsTile * lda;  // [2][kRowsTile][cols]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = (warp & 3) * tpw;  // the warp's first n8 tile
  const long long tiles = (m + kRowsTile - 1) / kRowsTile;
  const int iters = (int)((tiles - 1 - blockIdx.x) / gridDim.x + 1);  // gridDim.x <= tiles
  auto row0 = [&](int i) { return (blockIdx.x + (long long)i * gridDim.x) * kRowsTile; };
  auto rows_of = [&](int i) { return (int)min((long long)kRowsTile, m - row0(i)); };
  // tile i's rows of a into slot i % S (an empty group past the last)
  auto issue = [&](int i) {
    if (i < iters) {
      const long long r0 = row0(i);
      float* dst = ring + (i % S) * kRowsTile * lda;
      if (lda == k) {
        copy_range<kRowsThreads>(dst, a + r0 * k, rows_of(i) * k);
      } else {
        for (int r = warp; r < rows_of(i); r += kRowsThreads / 32) {
          for (int p = lane; p < k / 4; p += 32) {
            cp_async16(dst + r * lda + 4 * p, a + (r0 + r) * k + 4 * p);
          }
        }
      }
    }
    cp_async_commit();
  };
  // tile i's sums from its staging tile to c: with one column block the
  // tile is one contiguous range of c, 16-byte aligned (64 rows from a
  // multiple of 64), which one thread hands to the bulk-copy engine (the
  // last (rows N) % 4 floats by plain stores); else row by row
  auto store = [&](int i) {
    const float* src = stage_c + (i & 1) * kRowsTile * cols;
    if (gridDim.y == 1) {
      const int floats = rows_of(i) * cols;
      float* dst = c + row0(i) * n;
      if (threadIdx.x == 0 && floats >= 4) bulk_store(dst, src, floats / 4 * 16);
      for (int e = floats / 4 * 4 + threadIdx.x; e < floats; e += kRowsThreads) dst[e] = src[e];
      return;
    }
    for (int r = warp; r < rows_of(i); r += kRowsThreads / 32) {
      float* dst = c + (row0(i) + r) * n + n0;
      for (int q = lane; q < cols; q += 32) dst[q] = src[r * cols + q];
    }
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s);
  // the warp's n8 tiles of b^T over the depth as mma B fragments, once:
  // lane (g, t) holds k = 2t, 2t + 1 and 2t + 8, 2t + 9 of column g of each
  // k16 step, zero past K and past the block's columns
  uint32_t fb[KS][kRowsWarpTiles][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int j = 0; j < kRowsWarpTiles; ++j) {
      const int col = 8 * (j0 + j) + g;
      const bool in = j < tpw && col < cols;
      const float* bcol = b + (long long)(n0 + col) * sbn;
      auto at = [&](int kk) { return in && kk < k ? __ldg(bcol + kk * sbk) : 0.0f; };
      const int k0 = 16 * ks + 2 * t;
      fb[ks][j][0] = pack_bf16(at(k0), at(k0 + 1));
      fb[ks][j][1] = pack_bf16(at(k0 + 8), at(k0 + 9));
    }
  }
  const bool even = lda % 2 == 0;

  for (int i = 0; i <= iters; ++i) {
    cp_async_wait<S - 2>();
    if (threadIdx.x == 0) bulk_wait_read();  // tile i - 2's staging tile is read
    // tile i is in place for every thread; iteration i - 1 has read its
    // slot and written its staging tile
    __syncthreads();
    issue(i + S - 1);  // into the slot of tile i - 1
    if (i > 0) store(i - 1);
    if (i == iters) {
      if (threadIdx.x == 0) bulk_wait();
      break;
    }
    float acc[2][kRowsWarpTiles][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int j = 0; j < kRowsWarpTiles; ++j) {
        acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.0f;
      }
    }
    const float* arow = ring + (i % S) * kRowsTile * lda + (32 * (warp >> 2) + g) * lda;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks < ksteps) {
        const int kc = 16 * ks;
        const bool full = kc + 16 <= k;
        // rows g, g + 8 of each m16 tile; columns kc + 2t, + 1 and kc + 2t + 8, + 9
        uint32_t fa[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* r = arow + 16 * mi * lda;
          fa[mi][0] = bf16_pair(r, kc + 2 * t, k, full, even);
          fa[mi][1] = bf16_pair(r + 8 * lda, kc + 2 * t, k, full, even);
          fa[mi][2] = bf16_pair(r, kc + 2 * t + 8, k, full, even);
          fa[mi][3] = bf16_pair(r + 8 * lda, kc + 2 * t + 8, k, full, even);
        }
#pragma unroll
        for (int j = 0; j < kRowsWarpTiles; ++j) {
          if (j < tpw && j0 + j < ntiles) {  // the same for the whole warp
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][j], fa[mi], fb[ks][j]);
          }
        }
      }
    }
    // rows g, g + 8 of each m16 tile, columns 2t, 2t + 1 of each n8 tile,
    // none past the block's columns
    float* out = stage_c + (i & 1) * kRowsTile * cols + (32 * (warp >> 2) + g) * cols;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int j = 0; j < kRowsWarpTiles; ++j) {
        if (j < tpw && j0 + j < ntiles) {
          const int col = 8 * (j0 + j) + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* o = out + (16 * mi + 8 * h) * cols + col;
            if (cols % 2 == 0 && col + 1 < cols) {
              *reinterpret_cast<float2*>(o) = make_float2(acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
            } else {
              if (col < cols) o[0] = acc[mi][j][2 * h];
              if (col + 1 < cols) o[1] = acc[mi][j][2 * h + 1];
            }
          }
        }
      }
    }
    fence_proxy_async();
  }
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// the rows layout's shared memory for depth k, n columns (the widest
// column block) and `stages` stages
size_t rows_smem(int k, int n, int stages) {
  return sizeof(float) * ((size_t)stages * kRowsTile * rows_lda(k) +
                          (size_t)2 * kRowsTile * min(kRowsCols, n));
}

// a persistent grid: one block an SM (its shared memory) for each column
// block, at most one a row tile
template <int S, int KS>
int launch_rows(const float* a, long long m, int k, const float* b, long long sbk, long long sbn,
                int n, float* c, cudaStream_t st) {
  const size_t smem = rows_smem(k, n, S);
  cudaError_t err = cudaFuncSetAttribute(mm_rows_kernel<S, KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mm_rows_kernel<S, KS>,
                                                        kRowsThreads, smem);
  }
  if (err == cudaSuccess) err = (cudaError_t)sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const unsigned col_blocks = (unsigned)((n + kRowsCols - 1) / kRowsCols);
  const long long tiles = (m + kRowsTile - 1) / kRowsTile;
  const long long room = (long long)per_sm * sms / col_blocks;
  const unsigned persistent = (unsigned)max(1LL, min(tiles, room));
  mm_rows_kernel<S, KS><<<dim3(persistent, col_blocks), kRowsThreads, smem, st>>>(
      a, m, k, b, sbk, sbn, n, c);
  return (int)cudaGetLastError();
}

// b^T's k16 steps in registers: the instantiation for depth k
template <int S>
int launch_rows_depth(const float* a, long long m, int k, const float* b, long long sbk,
                      long long sbn, int n, float* c, cudaStream_t st) {
  switch (rows_ks(k)) {
    case 1:
      return launch_rows<S, 1>(a, m, k, b, sbk, sbn, n, c, st);
    case 4:
      return launch_rows<S, 4>(a, m, k, b, sbk, sbn, n, c, st);
    case 8:
      return launch_rows<S, 8>(a, m, k, b, sbk, sbn, n, c, st);
    default:
      return launch_rows<S, 10>(a, m, k, b, sbk, sbn, n, c, st);
  }
}


// the forward's instantiations, in ops/mm.py::fwd_layout's order
enum FwdLayout { kNarrow4 = 0, kNarrow16 = 1, kWide64 = 2, kWide128 = 3 };

// the wide forward's shapes: 4 RG rows x 4 CG columns a thread, 16 thread
// columns x 8 thread rows: 128 rows x 128 columns a block at 16 x 8 a
// thread, 64 x 64 at 8 x 4
constexpr int wide_rg(int layout) { return layout == kWide64 ? 2 : 4; }
constexpr int wide_cg(int layout) { return layout == kWide64 ? 1 : 2; }

size_t fwd_smem(int layout, int k) {
  if (layout == kNarrow4 || layout == kNarrow16) {
    return sizeof(float) * (size_t)k * (layout == kNarrow4 ? 4 : 16);
  }
  const int rows = 32 * wide_rg(layout), cols = 64 * wide_cg(layout);
  return sizeof(float) * ((size_t)round4(k) * cols + (size_t)kFwdDepth * (rows + 4));
}

// kNarrowBlocks blocks an SM, at most one a tile of 256 rows; 16-byte loads
// where K and a allow
template <int NW>
int launch_narrow(const float* a, long long m, int k, const float* b, long long sbk,
                  long long sbn, int n, float* c, cudaStream_t st) {
  if (n > NW) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(NW == 4 ? kNarrow4 : kNarrow16, k);
  int sms = 0;
  cudaError_t err = (cudaError_t)sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (m + kNarrowThreads - 1) / kNarrowThreads;
  const unsigned grid = (unsigned)max(1LL, min(tiles, (long long)kNarrowBlocks * sms));
  auto kern = k % 4 == 0 && (uintptr_t)a % 16 == 0 ? mm_fwd_narrow_kernel<NW, 4>
                                                   : mm_fwd_narrow_kernel<NW, 1>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kNarrowThreads, smem, st>>>(a, m, k, b, sbk, sbn, n, c);
  return (int)cudaGetLastError();
}

// a persistent grid: as many blocks as fit on the card, at most one a row
// tile and column block
template <int L>
int launch_wide(const float* a, long long m, int k, const float* b, long long sbk, long long sbn,
                int n, float* c, cudaStream_t st) {
  constexpr int RG = wide_rg(L), CG = wide_cg(L), kTile = 32 * RG, kCols = 64 * CG;
  const size_t smem = fwd_smem(L, k);
  cudaError_t err = cudaFuncSetAttribute(mm_fwd_kernel<RG, CG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mm_fwd_kernel<RG, CG>,
                                                        kWideThreads, smem);
  }
  if (err == cudaSuccess) err = (cudaError_t)sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const unsigned col_blocks = (unsigned)((n + kCols - 1) / kCols);
  const long long tiles = (m + kTile - 1) / kTile;
  const long long room = (long long)per_sm * sms / col_blocks;
  const unsigned persistent = (unsigned)max(1LL, min(tiles, room));
  mm_fwd_kernel<RG, CG><<<dim3(persistent, col_blocks), kWideThreads, smem, st>>>(a, m, k, b, sbk,
                                                                                 sbn, n, c);
  return (int)cudaGetLastError();
}

// the reduce layout's shared memory: the ring of `stages` stages and two
// bf16 tiles
size_t db_smem(int k, int n, int stages) {
  return sizeof(float) * (size_t)stages * kDbRows * (k + n) +
         sizeof(__nv_bfloat16) * (size_t)2 * kDbRows * (ldm_stride(k) + ldm_stride(n));
}

template <int S, int WK>
int launch_db(const float* a, const float* d, long long m, int k, int n,
              long long rows_per_block, float* part, cudaStream_t st) {
  const size_t smem = db_smem(k, n, S);
  const long long splits = (m + rows_per_block - 1) / rows_per_block;
  if (splits > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned groups = (unsigned)(((k + db_group_k(WK) - 1) / db_group_k(WK)) *
                                     ((n + db_group_n(WK) - 1) / db_group_n(WK)));
  cudaError_t err = cudaFuncSetAttribute(mm_db_kernel<S, WK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mm_db_kernel<S, WK><<<dim3((unsigned)splits, groups), kDbThreads, smem, st>>>(
      a, d, m, k, n, rows_per_block, part);
  return (int)cudaGetLastError();
}

template <int WK>
int launch_db_stages(int stages, const float* a, const float* d, long long m, int k, int n,
                     long long rows_per_block, float* part, cudaStream_t st) {
  switch (stages) {
    case 2:
      return launch_db<2, WK>(a, d, m, k, n, rows_per_block, part, st);
    case 3:
      return launch_db<3, WK>(a, d, m, k, n, rows_per_block, part, st);
    case 4:
      return launch_db<4, WK>(a, d, m, k, n, rows_per_block, part, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a and c 16-byte aligned, 0 < k <= 160, stages 3 or 4 (ops/mm.py::da_stages), m > 0
extern "C" int mixed_mm_rows(const float* a, long long m, int k, const float* b, long long sbk,
                             long long sbn, int n, int stages, float* c, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || k <= 0 || k > kRowsMaxDepth || n <= 0 || ((uintptr_t)a | (uintptr_t)c) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  switch (stages) {
    case 3:
      return launch_rows_depth<3>(a, m, k, b, sbk, sbn, n, c, st);
    case 4:
      return launch_rows_depth<4>(a, m, k, b, sbk, sbn, n, c, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// layout: ops/mm.py::fwd_layout (0 narrow of 4 columns, 1 narrow of 16,
// 2 wide of 64 columns a block, 3 wide of 128)
extern "C" int mixed_mm_fwd(const float* a, long long m, int k, const float* b, long long sbk,
                            long long sbn, int n, int layout, float* c, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case kNarrow4:
      return launch_narrow<4>(a, m, k, b, sbk, sbn, n, c, st);
    case kNarrow16:
      return launch_narrow<16>(a, m, k, b, sbk, sbn, n, c, st);
    case kWide64:
      return launch_wide<kWide64>(a, m, k, b, sbk, sbn, n, c, st);
    case kWide128:
      return launch_wide<kWide128>(a, m, k, b, sbk, sbn, n, c, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// part: (splits, K, N) float32 scratch, splits = ceil(M / rows_per_block);
// a and d 16-byte aligned, rows_per_block a multiple of 32, stages 2 to 4,
// narrow 1 for 16 warps along K (ops/mm.py::db_row_ranges, db_stages,
// db_layout)
extern "C" int mixed_mm_db(const float* a, const float* d, long long m, int k, int n,
                           long long rows_per_block, int stages, int narrow, float* part,
                           float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows_per_block <= 0 || rows_per_block % kDbRows || ((uintptr_t)a | (uintptr_t)d) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = narrow ? launch_db_stages<16>(stages, a, d, m, k, n, rows_per_block, part, st)
                         : launch_db_stages<2>(stages, a, d, m, k, n, rows_per_block, part, st);
  if (err != 0) return err;
  const int size = k * n;
  const int splits = (int)((m + rows_per_block - 1) / rows_per_block);
  mm_db_sum_kernel<<<(size + kThreads - 1) / kThreads, kThreads, 0, st>>>(part, splits, size, out);
  return (int)cudaGetLastError();
}
