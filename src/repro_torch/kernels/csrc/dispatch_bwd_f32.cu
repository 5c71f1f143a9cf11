// The block walk on float32 grids, tiled for the FP32 FMA units: the
// forward x @ y of a float32 training step (kernels/dispatch.py
// block_matmul_nn) and its masked VJP (kernels/dispatch_bwd.py): dx =
// g @ w.T and dw = x.T @ g, each masked per block step by the forward's
// code grid.  One body, three layouts of the operands.
//
// The functions are the reference's block walk of
// src/repro/core/dynasparse.py:239-258 (a lax.switch per (i, j, k) step)
// and its gradient under jax.grad (its SKIP branch returns acc):
//
//   nn (y, m x n):    y[i, j] = sum over k with codes[i, j, k] != SKIP of
//                     x[i, k] @ y[k, j]         (blocks bm x bn, depth bk)
//   nt (dx, m x kd):  dx[i, k] = sum over j with codes[i, j, k] != SKIP of
//                     g[i, j] @ w[k, j].T       (blocks bm x bk, depth bn)
//   tn (dw, kd x n):  dw[k, j] = sum over i with codes[i, j, k] != SKIP of
//                     x[i, k].T @ g[i, j]       (blocks bk x bn, depth bm)
//
// Which route serves which float32 product (core/dynasparse.py
// BlockMatmulFn): at a block whose edges are all 64, 128 or 256 (the LM's
// (256, 256, 256)) this kernel takes the training forward (nn) and both
// backward products; elsewhere the forward and the backward's two
// products (over transposed operands and permuted grids) run on
// dispatch.cu's float32 route, the walk of 16 x 16 tiles per warp that
// skips empty x tiles, as the GNN path's Aggregates still do (no gradient,
// sparse A at 5 % occupancy).  At a dense 2048-row activation that walk
// feeds each operand value a lane loads to a handful of FMAs: on an H100
// (chip_smoke.py phase 11) 3.8-4.1 ms a forward product, 3.8-4.3 ms a
// backward product as two launches, each over a transposed copy of w or
// x and a permuted copy of the grid; this kernel takes 1.7-2.0 ms.
//
// What bounds it: operations.  llama3.2-1b's FFN products at 2048 tokens
// are 68.7 GFLOP each, 1.03 ms at the H100's 67 TFLOP/s in FP32, against
// at most 144 MB of operands and result (43 us at 3.35 TB/s); a pruned
// grid only removes operations.  What the design does about it:
//   - 128 x 128 output tiles (64 where a block edge is 64), 256 threads of
//     8 x 8 register microtiles (4 x 8, 8 x 4, 4 x 4 at the smaller
//     tiles): every operand value a thread loads from shared memory feeds
//     8 FMAs, every 16-byte load 32;
//   - operands read in place by 16-byte cp.async into a 4-stage ring of
//     32-deep stages, one barrier per stage.  An operand that is
//     contraction-contiguous (nt's g and w, nn's x) is staged with its
//     rows as they are (rows padded to 36 floats), and a thread reads 4
//     contraction steps of one row with one 16-byte load, its rows (and,
//     in nt, its columns) 16 apart so that the 16 column loads of a
//     half-warp hit 32 distinct banks.  An operand stored
//     contraction-major (tn's x and g, nn's y) is staged with each
//     contraction row as it is, and a thread reads 4 neighbouring rows or
//     columns of one contraction step with one 16-byte load.  No
//     transposed copy, no permuted grid; what lies past the operands
//     (ragged widths such as 10944) is zero-filled by the copies;
//   - the walk: a tile lies inside one output block; the threads read
//     that block's codes as they go and load only the active contraction
//     blocks, and of the last one only the slices inside the operands.  A
//     tile with no active block is stored as zeros;
//   - persistent CTAs (one per SM: registers and the ring) take tiles
//     from a queue in kernels/dispatch_bwd.py BwdLaunch.tile_rc's order
//     (groups of 8 tile rows, so the tiles in flight share operand rows
//     and columns in L2); a CTA whose tiles SKIP goes on to more of them.
// Not the tensor cores: TF32 (or 3xTF32) would change the rounding.
//
// Rounding: dispatch.cu's float32 walk's, bit for bit (for the backward,
// its two launches over the permuted grids).  For each output and each
// active contraction block in ascending order, a fresh float32 partial
// runs one fmaf chain over the block's contraction steps in ascending
// order, then acc += partial.  Every non-SKIP code (GEMM, SPDMM, SPMM)
// computes the same value on finite operands, since the walk skips only
// zero tiles, so this kernel runs every active block dense.  Zero-filled
// and zero-tile steps add exact zeros (fma(0, y, p) == p up to the sign
// of a zero partial, which acc += partial erases: acc starts at +0), so
// neither the tile shape nor the ring changes an output's bits.
#include "fma.cuh"

namespace {

constexpr int NT = 0, TN = 1, NN = 2;   // dispatch_bwd.F32_LAYOUTS
constexpr int KS = 32;          // contraction steps of a stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int RPAD = KS + 4;    // floats of a stage's operand row (16-byte
                                // pad), contraction-contiguous operands

struct Args {
  const float* a;           // nt: g (m, n); tn: x (m, kd); nn: x (m, kd)
  const float* b;           // nt: w (kd, n); tn: g (m, n); nn: y (kd, n)
  long a_rows, a_cols, lda, b_rows, b_cols, ldb;
  const int* codes;
  int* next_tile;           // the tile queue's head, zero at launch
  float* out;               // (rows, cols) contiguous
  long rows, cols;
  int row_tiles, col_tiles;
  int group;                // tile rows of a group in the tiles' order
  int row_edge, col_edge;   // the output blocks'
  int depth, steps;         // contraction blocks: edge and count
  long rs, cs, ts;          // codes[r * rs + c * cs + t * ts]
};

// Each stage copy is a whole number of 16-byte chunks per thread.
static_assert(64 * KS / 4 % THREADS == 0, "stage copies");

template <int LAYOUT, int BM, int BN>
struct Ring {
  static constexpr int A = LAYOUT == TN ? KS * BM : BM * RPAD;   // floats
  static constexpr int B = LAYOUT == NT ? BN * RPAD : KS * BN;
  static constexpr int STAGE = A + B;
  static constexpr int BYTES = STAGES * STAGE * 4;
};

// Four floats of row r, columns [c, c + 4), of a (rows x cols) row-major
// matrix with row stride ld (a multiple of 4, base 16-byte aligned), into
// shared dst by one 16-byte cp.async; what lies past the matrix reads as
// zeros (a ragged last chunk is copied in part).
__device__ __forceinline__ void cp_chunk(float* dst,
                                         const float* __restrict__ g, long r,
                                         long c, long rows, long cols,
                                         long ld) {
  const long left = r < rows ? cols - c : 0;
  const int bytes = left >= 4 ? 16 : left > 0 ? 4 * (int)left : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(rt::smem_addr(dst)), "l"(bytes ? g + r * ld + c : g),
                  "r"(bytes));
}

// The (row, column) tile of tile index `tile` (BwdLaunch.tile_rc).
__device__ __forceinline__ void tile_rc(const Args& p, int tile, int& tr,
                                        int& tc) {
  const int per_group = p.group * p.col_tiles;
  const int first = tile / per_group * p.group;
  const int rows = min(p.row_tiles - first, p.group);
  tr = first + tile % per_group % rows;
  tc = tile % per_group / rows;
}

template <int LAYOUT, int BM, int BN>
__global__ void __launch_bounds__(THREADS, 1)
dispatch_bwd_f32_kernel(const Args p) {
  constexpr int TM = BM / 16, TNN = BN / 16;   // a thread's microtile
  using R = Ring<LAYOUT, BM, BN>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int next_slot[2];

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int tiles = p.row_tiles * p.col_tiles;
  // contraction extent: the first operand's columns (nt: g's; nn: x's)
  // or the operands' rows (tn)
  const long ext = LAYOUT == TN ? p.a_rows : p.a_cols;
  auto n_slices = [&](int t) -> int {
    const long left = ext - (long)t * p.depth;
    if (left <= 0) return 0;
    return (int)(((left < p.depth ? left : p.depth) + KS - 1) / KS);
  };
  // the thread's output rows and columns inside the tile
  auto row_of = [&](int i) -> int {
    return LAYOUT == TN ? (i / 4) * 64 + ty * 4 + i % 4 : ty + 16 * i;
  };
  auto col_of = [&](int j) -> int {
    return LAYOUT == NT ? tx + 16 * j : (j / 4) * 64 + tx * 4 + j % 4;
  };

  int tile = blockIdx.x;
  for (int it = 0; tile < tiles; ++it) {
    if (tid == 0) next_slot[it & 1] = gridDim.x + atomicAdd(p.next_tile, 1);
    int tr, tc;
    tile_rc(p, tile, tr, tc);
    const long row0 = (long)tr * BM, col0 = (long)tc * BN;
    const long code0 = (row0 / p.row_edge) * p.rs + (col0 / p.col_edge) * p.cs;
    // the next active contraction block at or after t (p.steps if none)
    auto next_active = [&](int t) -> int {
      for (; t < p.steps; ++t)
        if (__ldg(p.codes + code0 + (long)t * p.ts) != rt::SKIP &&
            n_slices(t) > 0)
          return t;
      return p.steps;
    };

    // the copies of one stage: slice s of contraction block t into slot
    auto issue = [&](int t, int s, int slot) {
      float* as = smem + slot * R::STAGE;
      float* bs = as + R::A;
      const long k0 = (long)t * p.depth + (long)s * KS;
      if constexpr (LAYOUT != TN) {
        // operand rows as they are (nt: g rows row0..; nn: x rows row0..),
        // contraction columns k0..k0 + KS
#pragma unroll
        for (int n = 0; n < BM * KS / 4 / THREADS; ++n) {
          const int q = tid + n * THREADS;
          const int r = q / (KS / 4), c = q % (KS / 4) * 4;
          cp_chunk(as + r * RPAD + c, p.a, row0 + r, k0 + c, p.a_rows,
                   p.a_cols, p.lda);
        }
      } else {
        // contraction rows k0.. of x (columns row0..)
#pragma unroll
        for (int n = 0; n < KS * BM / 4 / THREADS; ++n) {
          const int q = tid + n * THREADS;
          const int r = q / (BM / 4), c = q % (BM / 4) * 4;
          cp_chunk(as + r * BM + c, p.a, k0 + r, row0 + c, p.a_rows,
                   p.a_cols, p.lda);
        }
      }
      if constexpr (LAYOUT == NT) {
        // w rows col0.., contraction columns k0..k0 + KS
#pragma unroll
        for (int n = 0; n < BN * KS / 4 / THREADS; ++n) {
          const int q = tid + n * THREADS;
          const int r = q / (KS / 4), c = q % (KS / 4) * 4;
          cp_chunk(bs + r * RPAD + c, p.b, col0 + r, k0 + c, p.b_rows,
                   p.b_cols, p.ldb);
        }
      } else {
        // contraction rows k0.. (tn: of g; nn: of y), columns col0..
#pragma unroll
        for (int n = 0; n < KS * BN / 4 / THREADS; ++n) {
          const int q = tid + n * THREADS;
          const int r = q / (BN / 4), c = q % (BN / 4) * 4;
          cp_chunk(bs + r * BN + c, p.b, k0 + r, col0 + c, p.b_rows,
                   p.b_cols, p.ldb);
        }
      }
    };

    // the running sums and the open block's partials
    float acc[TM][TNN], part[TM][TNN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TNN; ++j) acc[i][j] = part[i][j] = 0.f;

    // load cursor (lt, ls) runs STAGES - 1 stages ahead of the compute
    // cursor (ct, cs); both walk the active blocks' slices in order
    int lt = next_active(0), ls = 0;
    int ct = lt, cs = 0;
    int lns = lt < p.steps ? n_slices(lt) : 0;
    int cns = lns;
    auto advance_load = [&]() {
      if (++ls == lns) {
        ls = 0;
        lt = next_active(lt + 1);
        lns = lt < p.steps ? n_slices(lt) : 0;
      }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (lt < p.steps) {
        issue(lt, ls, s);
        advance_load();
      }
      rt::cp_async_commit();
    }
    for (int unit = 0; ct < p.steps; ++unit) {
      rt::cp_async_wait<STAGES - 2>();
      __syncthreads();   // `unit` landed; slot (unit - 1) % STAGES is free
      if (lt < p.steps) {
        issue(lt, ls, (unit + STAGES - 1) % STAGES);
        advance_load();
      }
      rt::cp_async_commit();
      const float* as = smem + (unit % STAGES) * R::STAGE;
      const float* bs = as + R::A;
      if constexpr (LAYOUT == NT) {
#pragma unroll
        for (int k4 = 0; k4 < KS / 4; ++k4) {
          float4 a[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i)
            a[i] = *reinterpret_cast<const float4*>(
                as + row_of(i) * RPAD + k4 * 4);
#pragma unroll
          for (int j = 0; j < TNN; ++j) {
            const float4 b = *reinterpret_cast<const float4*>(
                bs + col_of(j) * RPAD + k4 * 4);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float bk = rt::lane_of(b, kk);
#pragma unroll
              for (int i = 0; i < TM; ++i)
                part[i][j] = fmaf(rt::lane_of(a[i], kk), bk, part[i][j]);
            }
          }
        }
      } else if constexpr (LAYOUT == NN) {
#pragma unroll
        for (int k4 = 0; k4 < KS / 4; ++k4) {
          float4 a4[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i)
            a4[i] = *reinterpret_cast<const float4*>(
                as + row_of(i) * RPAD + k4 * 4);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float a[TM], b[TNN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = rt::lane_of(a4[i], kk);
#pragma unroll
            for (int j4 = 0; j4 < TNN / 4; ++j4) {
              const float4 v = *reinterpret_cast<const float4*>(
                  bs + (k4 * 4 + kk) * BN + j4 * 64 + tx * 4);
              b[4 * j4] = v.x;
              b[4 * j4 + 1] = v.y;
              b[4 * j4 + 2] = v.z;
              b[4 * j4 + 3] = v.w;
            }
            rt::fma_step(part, a, b);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          float a[TM], b[TNN];
#pragma unroll
          for (int i4 = 0; i4 < TM / 4; ++i4) {
            const float4 v = *reinterpret_cast<const float4*>(
                as + k * BM + i4 * 64 + ty * 4);
            a[4 * i4] = v.x;
            a[4 * i4 + 1] = v.y;
            a[4 * i4 + 2] = v.z;
            a[4 * i4 + 3] = v.w;
          }
#pragma unroll
          for (int j4 = 0; j4 < TNN / 4; ++j4) {
            const float4 v = *reinterpret_cast<const float4*>(
                bs + k * BN + j4 * 64 + tx * 4);
            b[4 * j4] = v.x;
            b[4 * j4 + 1] = v.y;
            b[4 * j4 + 2] = v.z;
            b[4 * j4 + 3] = v.w;
          }
          rt::fma_step(part, a, b);
        }
      }
      if (++cs == cns) {   // the block's partial joins the sum
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TNN; ++j) {
            acc[i][j] += part[i][j];
            part[i][j] = 0.f;
          }
        cs = 0;
        ct = next_active(ct + 1);
        cns = ct < p.steps ? n_slices(ct) : 0;
      }
    }
    rt::cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long r = row0 + row_of(i);
      if (r >= p.rows) continue;
      float* o = p.out + r * p.cols;
      if constexpr (LAYOUT != NT) {
        if (p.cols % 4 == 0) {
#pragma unroll
          for (int j4 = 0; j4 < TNN / 4; ++j4) {
            const long c = col0 + col_of(4 * j4);
            if (c < p.cols)
              *reinterpret_cast<float4*>(o + c) = make_float4(
                  acc[i][4 * j4], acc[i][4 * j4 + 1], acc[i][4 * j4 + 2],
                  acc[i][4 * j4 + 3]);
          }
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < TNN; ++j) {
        const long c = col0 + col_of(j);
        if (c < p.cols) o[c] = acc[i][j];
      }
    }
    __syncthreads();   // the ring is free for the next tile; its number
    tile = next_slot[it & 1];   // is visible
  }
}

template <int LAYOUT, int BM, int BN>
int launch(const Args& p, int ctas, cudaStream_t s) {
  constexpr int smem = Ring<LAYOUT, BM, BN>::BYTES;
  auto kernel = dispatch_bwd_f32_kernel<LAYOUT, BM, BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ctas, THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int LAYOUT>
int launch_tile(int tile_m, int tile_n, const Args& p, int ctas,
                cudaStream_t s) {
  if (tile_m == 128 && tile_n == 128) return launch<LAYOUT, 128, 128>(p, ctas, s);
  if (tile_m == 128 && tile_n == 64) return launch<LAYOUT, 128, 64>(p, ctas, s);
  if (tile_m == 64 && tile_n == 128) return launch<LAYOUT, 64, 128>(p, ctas, s);
  if (tile_m == 64 && tile_n == 64) return launch<LAYOUT, 64, 64>(p, ctas, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// layout 0 (nt): a = g (m, n), b = w (kd, n), out = dx (m, kd);
// layout 1 (tn): a = x (m, kd), b = g (m, n), out = dw (kd, n);
// layout 2 (nn, the forward): a = x (m, kd), b = y (kd, n), out = x @ y
// (m, n).
// a and b float32, row-major with row strides lda, ldb (multiples of 4
// elements) and 16-byte aligned bases; codes the forward's (I, J, K) int32
// grid; out (rows, cols) contiguous float32, every element written;
// next_tile one int of scratch.  The tile shape and grid, the output
// blocks' edges, the contraction blocks and the code strides as
// dispatch_bwd.bwd_launch_f32 computes them: tile_m, tile_n in {64, 128},
// tile_m | row_edge, tile_n | col_edge, depth % 32 == 0; ctas persistent
// CTAs share the row_tiles x col_tiles tiles.
extern "C" int rt_dispatch_bwd_f32(int layout, const float* a, long a_rows,
                                   long a_cols, long lda, const float* b,
                                   long b_rows, long b_cols, long ldb,
                                   const int* codes, int* next_tile,
                                   float* out, long rows, long cols,
                                   int tile_m, int tile_n, int row_tiles,
                                   int col_tiles, int ctas, int group,
                                   int row_edge, int col_edge, int depth,
                                   int steps, long rs, long cs, long ts,
                                   void* stream) {
  if ((layout != NT && layout != TN && layout != NN) || tile_m <= 0 ||
      tile_n <= 0 || row_edge % tile_m || col_edge % tile_n || depth <= 0 ||
      depth % KS || steps < 0 || (long)row_tiles * tile_m < rows ||
      (long)col_tiles * tile_n < cols || ctas <= 0 || group <= 0 ||
      (long)row_tiles * col_tiles > 0x7fffffffL || lda % 4 || ldb % 4 ||
      lda < a_cols || ldb < b_cols || ((uintptr_t)a & 15) ||
      ((uintptr_t)b & 15) || codes == nullptr || next_tile == nullptr ||
      out == nullptr || (long)steps * depth > 0x7fffffffL ||
      rows > 0x7fffffffL || cols > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (a_rows == 0 || a_cols == 0 || b_rows == 0 || b_cols == 0)
    // nothing to contract: the sums are all zero
    return (int)cudaMemsetAsync(out, 0, rows * cols * 4, s);
  const Args p{a,         b,         a_rows,    a_cols,   lda,   b_rows,
               b_cols,    ldb,       codes,     next_tile, out,  rows,
               cols,      row_tiles, col_tiles, group,    row_edge,
               col_edge,  depth,     steps,     rs,       cs,    ts};
  const cudaError_t err = cudaMemsetAsync(next_tile, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  return layout == NT   ? launch_tile<NT>(tile_m, tile_n, p, ctas, s)
         : layout == TN ? launch_tile<TN>(tile_m, tile_n, p, ctas, s)
                        : launch_tile<NN>(tile_m, tile_n, p, ctas, s);
}
