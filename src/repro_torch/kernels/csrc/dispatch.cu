// The executor's block path: one launch per dynasparse_matmul that walks
// the planner's (I, J, K) primitive-code grid on the device.
//
// Replaces the per-step dispatch of src/repro/core/dynasparse.py:239-258,
// where a lax.scan over output blocks and a fori_loop over k ran one
// lax.switch branch -- and, with kernels on, one Pallas call of
// src/repro/kernels/gemm.py:47, spdmm.py:92 or spmm.py:154 -- per (i, j, k)
// step.  Each warp owns output tiles inside one (bm, bn) block and runs
// the k loop in order, reading the code of its block, codes[i, j, k], from
// device memory:
//
//   SKIP   costs nothing;
//   GEMM   is a dense block MAC;
//   SPDMM  walks only the lhs block's nonzero 16x16 tiles;
//   SPMM   walks only the tile pairs nonzero on both sides.
//
// The code is the same for every thread of a warp, so the branches do
// not diverge.  ``skip`` (nullable) is a device flag: when it points to
// nonzero the whole grid exits at once (the executor picked the row-CSR
// path on the device).
//
// Two routes, chosen by the operands' type:
//
// * float32 (the GNN path), rt_dispatch, on the FP32 FMA units.  What
//   bounds it at the shapes the GNN path launches: the first Aggregate
//   (A_mean @ H0 at (64, 64, 16), 3327 x 3327 @ 3327 x 3703) does 3.3
//   GFLOP of occupied tile products (0.05 ms at 67 TFLOP/s), but only 5 %
//   of A_mean's 16 x 16 tiles hold an edge, so most steps carry one x
//   tile and the time goes to the walk, to staging y's rows and to the
//   longest row tile's chain of steps (150 nonzero tiles; no split of k).
//   The Updates (x @ W, 16 columns wide, at (16, 16, 16)) are bound by
//   reading x once, in practice by each warp's chain of 232 steps.  The
//   design does this about it:
//     - each warp walks alone (no CTA barrier): it owns 16 (or 8) rows x
//       16 columns inside one (bm, bn) block and follows that block's
//       codes, so SKIP, GEMM, SpDMM and SPMM keep their meaning per (i,
//       j, k); a CTA holds up to 4 warps of the same rows, whose x loads
//       meet in L1 (the host picks the shape: kernels/dispatch.py
//       fma_launch);
//     - x's occupancy is one bitmask word per (16-row tile, k-block, 32
//       slices), written by x_words_kernel (rt_dispatch_x_format) just
//       before the walk (rt_dispatch); a warp
//       turns 32 units' codes and words into its list of steps at once
//       (a scan over the lanes, the next window's loads in flight), so
//       an empty slice costs no load, barrier or FMA;
//     - a step's x tile rows and 16 x 16 of y go to the warp's own ring
//       of 16-byte cp.async copies; a lane multiplies 1-2 rows x 4
//       columns from 16-byte shared loads (fma.cuh); under SPMM the warp
//       tests its staged y tile (a ballot) and skips it when all zeros;
//     - x and y are not padded: rows and columns past them are
//       zero-filled copies.  Rows that are not 16-byte aligned (A_mean's
//       and H0's 3327 and 3703 floats) cost the walk far more than one
//       extra pass, so they are staged: x_words_kernel writes x's
//       nonzero tiles to an aligned scratch (x is read there anyway),
//       y_pad_kernel (in the walk's call) copies y to rows of a multiple
//       of 4 floats;
//     - x's bitmask words and staged tiles (its "format") depend on x
//       alone, so they are written by their own entry point,
//       rt_dispatch_x_format, and the walk takes them as arguments.  A
//       caller that knows x is unchanged since an earlier format pass
//       (the fused executor, for a resident graph input:
//       kernels/dispatch.py build_x_format) keeps that format and
//       launches only the walk; the pass reads all of x, an A-sized
//       matrix more than once per inference otherwise.
//   Rounding: the first version's, bit for bit, since its rounding
//   decides the writeback counts the next kernel plans from.  For each
//   output and each k-block in ascending k that is not SKIP, a fresh
//   float32 partial runs one fmaf chain over the k of its used slices in
//   ascending order, then acc += partial (the reference's acc + step).
//   Skipping a zero tile drops only exact-zero contributions, and a
//   k-block with no used slice would add an exact zero.  No split over k,
//   no atomics.  Not the tensor cores: TF32 would change the rounding.
//
// * bfloat16 (the LM's dynasparse FFN at (256, 256, 256)), rt_dispatch_mma,
//   on the tensor cores.  A prefill wave (512 x 2048 @ 2048 x 8192) is
//   bound by operations (17 GFLOP against 989 TFLOP/s); a decode step's 4
//   rows are bound by the bytes of the weight (33.5 MB against 3.35 TB/s).
//   The design does this about them:
//     - operands stay bf16 in shared memory, filled with 16-byte cp.async
//       in a 3-stage ring of 32-wide k slices, so loads overlap the MMAs;
//     - warps multiply with mma.sync m16n8k16 (bf16 in, float32 out) from
//       ldmatrix fragments (ldmatrix.trans for y, which is row-major
//       K x N), accumulating in float32 registers;
//     - the host picks the CTA tile from the rows that are really there
//       (16, 32, 64 or 128 rows, up to 128 columns; kernels/dispatch.py
//       mma_launch): a decode step launches one 16-row tile, not sixteen,
//       and x is not padded (cp.async zero-fills the rows past m); only
//       the m real rows are stored, and padding rows of out are written
//       (as zeros) only when the caller asks for the padded shape;
//     - when those tiles are too few to fill the card, the k-blocks are
//       split across CTAs (blockIdx.z takes k-blocks [z K / S,
//       (z + 1) K / S)); the partials go to a scratch buffer and a second
//       kernel adds them in split order, so results repeat run to run.
//   Accumulation: one float32 sum per output element runs through every
//   k-block of a split in k order (MMA after MMA), not acc + step: a
//   fresh partial per k-block would double the accumulator registers of
//   the 128 x 128 tile.  Both orders sum the same exact bf16 products in
//   float32, so the checks hold this route to 1e-4 of block_matmul_plain
//   (atol and rtol), far inside the bf16 tolerance of 5e-2.
//   Skipping keeps the walk's semantics: an x tile (16 rows x 16 k) is
//   loaded and multiplied only when the code is GEMM or its occupancy
//   flag is set; under SPMM a (16-row, 16-k) x (16-k, 16-col) pair is
//   multiplied only when the y tile holds a nonzero too.  x's flags come
//   from a small kernel launched by the same entry point just before the
//   walk (x_flags_kernel, the test of tile_occupancy), so a decode step
//   pays one C call and no torch op for them; the y flag is read from the
//   staged tile itself (a ballot over the ldmatrix fragments), so no pass
//   over the weight precedes the kernel.  Skipped products are exact
//   zeros, so the result does not depend on which tiles were skipped.
//   Still on the FMA units: the float32 route above, whose rounding the
//   GNN path's writeback counts depend on.
#include "fma.cuh"

namespace {

// --------------------------------------------------------------- float32 --

constexpr int FMA_SMEM_PER_WARP = 12288;   // bytes of ring a warp may use
constexpr int FMA_XS = rt::T + rt::XPAD;   // shared x row stride (floats)
constexpr int STEP_CAP = 128;              // steps of a walk window

struct FmaArgs {
  const float* x;           // (m, kdim) row-major
  const float* y;           // (kdim, ldy) row-major, ny real columns
  const int* codes;         // (I, J, K)
  uint32_t* occx;           // (ceil(m/16), K, W) x tile bitmasks
  float* xt;                // x's nonzero 16 x 16 tiles, or nullptr
  float* out;               // (out_rows, J * bn)
  const int* skip;
  int m, kdim, ny, ldy, out_rows;
  int I, J, K, bm, bk, bn, W;
  int row_warps, col_warps;  // warps of a CTA along rows and columns
};

// Ring geometry of one warp with WR rows: STAGES stages, each one k
// slice: the x tile's WR rows and 16 x 16 of y.
template <int WR>
struct FmaRing {
  static constexpr int X = WR * FMA_XS, Y = rt::T * rt::T;   // floats
  static constexpr int FIT = FMA_SMEM_PER_WARP / (4 * (X + Y));
  static constexpr int STAGES = FIT > 8 ? 8 : FIT < 2 ? 2 : FIT;
  static constexpr int BYTES = STAGES * (X + Y) * 4;
};

// occx[w] for w < words, w = (row tile * K + k-block) * W + word: bit j
// says whether x's 16 x 16 tile at that row tile and k slice
// (k-block * bk / 16 + 32 word + j) holds a nonzero (-0.0 counts as zero,
// as tile_nnz counts x != 0; what lies past x reads as zeros).  One warp
// per word: lane l reads 8 elements of the tile's row l / 2.  When x's
// rows are not 16-byte aligned (xt != nullptr), a nonzero tile is also
// written to xt, tile-major and aligned ((row tile * K bk / 16 + slice) *
// 256 floats), where the walk copies it from with 16-byte copies.
__global__ void x_words_kernel(FmaArgs a, int words) {
  if (a.skip != nullptr && *a.skip != 0) return;
  const int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (w >= words) return;                      // uniform over the warp
  const int lane = threadIdx.x % 32;
  const int kts = a.bk / rt::T;
  const int kw = a.K * a.W;
  const int kb = w % kw / a.W, word = w % a.W;
  const long rtile = w / kw, r = rtile * rt::T + lane / 2;
  const int n = min(32, kts - 32 * word);
  const bool vec = a.xt == nullptr;            // aligned rows
  uint32_t bits = 0;
#pragma unroll 2
  for (int j = 0; j < n; ++j) {
    const long slice = (long)kb * kts + 32 * word + j;
    const long c = slice * rt::T + (lane % 2) * 8;
    float4 u0 = make_float4(0.f, 0.f, 0.f, 0.f), u1 = u0;
    if (r < a.m) {
      const float* p = a.x + r * a.kdim + c;
      if (vec && c + 8 <= a.kdim) {
        u0 = reinterpret_cast<const float4*>(p)[0];
        u1 = reinterpret_cast<const float4*>(p)[1];
      } else {
        float e[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = c + i < a.kdim ? p[i] : 0.f;
        u0 = make_float4(e[0], e[1], e[2], e[3]);
        u1 = make_float4(e[4], e[5], e[6], e[7]);
      }
    }
    const uint32_t v = __float_as_uint(u0.x) | __float_as_uint(u0.y) |
                       __float_as_uint(u0.z) | __float_as_uint(u0.w) |
                       __float_as_uint(u1.x) | __float_as_uint(u1.y) |
                       __float_as_uint(u1.z) | __float_as_uint(u1.w);
    if (__any_sync(0xffffffffu, (v & 0x7fffffffu) != 0)) {
      bits |= 1u << j;
      if (!vec) {
        float4* t = reinterpret_cast<float4*>(
            a.xt + ((rtile * a.K * kts + slice) * rt::T + lane / 2) * rt::T +
            (lane % 2) * 8);
        t[0] = u0;
        t[1] = u1;
      }
    }
  }
  if (lane == 0) a.occx[w] = bits;
}

// y copied to rows of ldy floats (a multiple of 4), the columns past ny
// zero, so that the walk reads it with 16-byte copies: one thread per 4
// floats of the copy.
__global__ void y_pad_kernel(const float* __restrict__ y, int kdim, int ny,
                             float* __restrict__ dst, int ldy,
                             const int* __restrict__ skip) {
  if (skip != nullptr && *skip != 0) return;
  const int q = ldy / 4;                       // float4 per row
  const long total = (long)kdim * q;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const int r = (int)(i / q), c = (int)(i - (long)r * q) * 4;
    const float* src = y + (long)r * ny + c;
    float4 v;
    v.x = c < ny ? src[0] : 0.f;
    v.y = c + 1 < ny ? src[1] : 0.f;
    v.z = c + 2 < ny ? src[2] : 0.f;
    v.w = c + 3 < ny ? src[3] : 0.f;
    reinterpret_cast<float4*>(dst)[i] = v;
  }
}

// Each warp walks on its own: it owns WR rows (8 or 16, inside one 16-row
// x tile and one bm block) and 16 columns (inside one bn block, whose
// codes it follows), with no barrier shared with other warps.  Lane (ly,
// lx) = (lane / 4, lane % 4) owns rows ly + 8 h (h < WR / 8) and columns
// 4 lx .. 4 lx + 3.  The warp's steps are the (k-block, 16-wide k slice)
// pairs, in ascending k, where its code is GEMM, or SPDMM / SPMM while the
// x tile is nonzero; a step stages the x tile's WR rows and 16 x 16 of y
// in the warp's own ring.  The warps of a CTA share their x rows
// (row_warps x col_warps, columns first), so their x loads meet in L1.
template <int WR>
__global__ void __launch_bounds__(256, 2) dispatch_fma_kernel(FmaArgs a) {
  if (a.skip != nullptr && *a.skip != 0) return;
  using R = FmaRing<WR>;
  constexpr int S = R::STAGES;
  constexpr int RL = WR / 8;                  // rows per lane
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int st_kb[8][8];                 // [warp][slot] k-block
  __shared__ uint32_t st_spmm[8][8];          // [warp][slot] code SPMM
  __shared__ uint32_t st_steps[8][STEP_CAP];  // [warp] the window's steps

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ly = lane / 4, lx = lane % 4;
  const long ldo = (long)a.J * a.bn;
  const long wrow = ((long)blockIdx.y * a.row_warps + warp / a.col_warps) *
                    WR;
  const long wcol = ((long)blockIdx.x * a.col_warps + warp % a.col_warps) *
                    rt::T;
  if (wrow >= a.out_rows || wcol >= ldo) return;   // the whole warp
  float* xs = reinterpret_cast<float*>(smem) + (long)warp * (S * (R::X + R::Y));
  float* ys = xs + S * R::X;                  // [S][16][16]
  const int kts = a.bk / rt::T;
  const int U = a.K * a.W;                    // (k-block, word) units
  const long tile = wrow / rt::T;             // the warp's x row tile
  const bool tile_real = tile * rt::T < a.m;
  const int* code_row =
      a.codes + ((wrow / a.bm) * a.J + wcol / a.bn) * (long)a.K;

  // The walk's cursor.  A window is up to 32 units (k-block, word), one
  // per lane: each lane reads its unit's code and x word and writes the
  // unit's steps (slices with work, ascending) into the warp's step list
  // at its offset (a scan over the lanes), so that taking the next step
  // is one shared load.  A window holds at most STEP_CAP steps; the units
  // that do not fit start the next window.  A window's global loads are
  // issued when the previous window is built, so they fly during its
  // steps.
  uint32_t* steps = st_steps[warp];
  int u0 = 0, win_u0 = 0, win_n = 0, next_j = 0;
  int pf_u0 = -1, pf_code = 0;               // unit pf_u0 + lane, ahead
  uint32_t pf_occ = 0;
  auto prefetch = [&](int from) {
    const int u = from + lane;
    pf_u0 = from;
    pf_code = rt::SKIP;
    pf_occ = 0;
    if (u < U) {
      const int kb = a.W == 1 ? u : u / a.W, word = a.W == 1 ? 0 : u % a.W;
      if (tile_real) pf_occ = a.occx[(tile * a.K + kb) * a.W + word];
      pf_code = code_row[kb] & 3;
    }
  };
  auto load_window = [&]() {
    if (pf_u0 != u0) prefetch(u0);      // first window, or after a split
    const int u = u0 + lane, code = pf_code;
    const uint32_t occ = pf_occ;
    uint32_t any = 0;
    if (u < U && code != rt::SKIP) {
      const int word = a.W == 1 ? 0 : u % a.W;
      const int n = min(32, kts - 32 * word);
      any = code == rt::GEMM ? (n >= 32 ? 0xffffffffu : (1u << n) - 1)
                             : occ;
    }
    const int cnt = __popc(any);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    const int fit = __popc(__ballot_sync(0xffffffffu, incl <= STEP_CAP));
    const int lanes = min(fit, U - u0);
    __syncwarp();                       // the previous list is consumed
    if (lane < lanes) {
      const uint32_t tag = (uint32_t)lane << 5 |
                           (uint32_t)(code == rt::SPMM) << 18;
      int pos = incl - cnt;
      for (uint32_t bits = any; bits; bits &= bits - 1) {
        const int sb = __ffs(bits) - 1;
        steps[pos++] = (uint32_t)sb | tag | ((occ >> sb) & 1u) << 19;
      }
    }
    __syncwarp();
    win_u0 = u0;
    win_n = __shfl_sync(0xffffffffu, incl, lanes - 1);
    next_j = 0;
    u0 += lanes;
    if (u0 < U) prefetch(u0);           // the next window's loads fly now
  };
  // The next step (k-block, slice, flags: bit 0 SPMM, bit 1 the x tile is
  // nonzero), or false when the walk is done.  Uniform over the warp.
  auto next = [&](int& kb, int& slice, uint32_t& flags) -> bool {
    while (next_j == win_n) {
      if (u0 >= U) return false;
      load_window();
    }
    const uint32_t d = steps[next_j++];
    const int unit = win_u0 + (int)((d >> 5) & 31u);
    kb = a.W == 1 ? unit : unit / a.W;
    slice = (a.W == 1 ? 0 : unit % a.W) * 32 + (int)(d & 31u);
    flags = d >> 18;
    return true;
  };

  // x's WR rows come from x in place (16-byte aligned rows) or from its
  // aligned copy of the nonzero tiles (xt; a zero tile is zero-filled,
  // nothing read); y from y in place or its aligned padded copy.
  const int KS = a.K * kts;                   // k slices of x
  auto enqueue = [&](int slot, int kb, int slice, uint32_t flags) {
    const long k0 = (long)kb * a.bk + (long)slice * rt::T;
    float* xst = xs + slot * R::X;
    if (a.xt == nullptr)
      rt::warp_copy<WR, rt::T>(xst, FMA_XS, a.x, wrow, k0, a.m, a.kdim,
                               a.kdim, lane);
    else if (flags & 2u)
      rt::warp_copy<WR, rt::T>(
          xst, FMA_XS,
          a.xt + ((tile * KS + (long)kb * kts + slice) * rt::T +
                  wrow % rt::T) * rt::T,
          0, 0, WR, rt::T, rt::T, lane);
    else                                       // a zero tile: zero-fill
      rt::warp_copy<WR, rt::T>(xst, FMA_XS, a.xt, 0, 0, 0, rt::T, rt::T,
                               lane);
    rt::warp_copy<rt::T, rt::T>(ys + slot * R::Y, rt::T, a.y, k0, wcol,
                                a.kdim, a.ldy, a.ldy, lane);
    if (lane == 0) {
      st_kb[warp][slot] = kb;
      st_spmm[warp][slot] = flags & 1u;
    }
  };

  // acc: the running sum; part: the open k-block's partial.  A k-block
  // opens at the warp's first step in it (part = 0) and closes at its
  // first step in a later k-block, or at the end (acc += part).  A
  // k-block with no step of this warp adds an exact zero.
  float acc[RL][4], part[RL][4];
#pragma unroll
  for (int h = 0; h < RL; ++h)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[h][v] = part[h][v] = 0.f;
  int open_kb = -1;

  auto compute = [&](int slot) {
    const int kb = st_kb[warp][slot];
    if (kb != open_kb) {
#pragma unroll
      for (int h = 0; h < RL; ++h)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[h][v] += part[h][v];
          part[h][v] = 0.f;
        }
      open_kb = kb;
    }
    const float* yst = ys + slot * R::Y;
    if (st_spmm[warp][slot]) {
      // SPMM: the pair runs only if this 16 x 16 y tile holds a nonzero
      // (-0.0 counts as zero, as in tile_occupancy)
      const float4* q = reinterpret_cast<const float4*>(
          yst + (lane / 2) * rt::T + lane % 2 * 8);
      const float4 v0 = q[0], v1 = q[1];
      const uint32_t v = __float_as_uint(v0.x) | __float_as_uint(v0.y) |
                         __float_as_uint(v0.z) | __float_as_uint(v0.w) |
                         __float_as_uint(v1.x) | __float_as_uint(v1.y) |
                         __float_as_uint(v1.z) | __float_as_uint(v1.w);
      if (!__any_sync(0xffffffffu, (v & 0x7fffffffu) != 0)) return;
    }
    const float* xst = xs + slot * R::X;
#pragma unroll
    for (int k4 = 0; k4 < rt::T / 4; ++k4) {
      float4 xa[RL], bv[4];
#pragma unroll
      for (int h = 0; h < RL; ++h)
        xa[h] = *reinterpret_cast<const float4*>(
            xst + (ly + 8 * h) * FMA_XS + k4 * 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        bv[kk] = *reinterpret_cast<const float4*>(
            yst + (k4 * 4 + kk) * rt::T + lx * 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float b[4] = {bv[kk].x, bv[kk].y, bv[kk].z, bv[kk].w};
        float ak[RL];
#pragma unroll
        for (int h = 0; h < RL; ++h) ak[h] = rt::lane_of(xa[h], kk);
        rt::fma_step(part, ak, b);
      }
    }
  };

  // The warp's ring of S slots: step t lives in slot t % S; cp.async
  // group t holds step t (empty groups only once the walk is done).
  int queued = 0, kb, slice;
  uint32_t flags;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (next(kb, slice, flags)) {
      enqueue(queued % S, kb, slice, flags);
      ++queued;
    }
    rt::cp_async_commit();
  }
  for (int done = 0; done < queued; ++done) {
    rt::cp_async_wait<S - 2>();
    __syncwarp();   // step `done` landed; slot (done - 1) % S is free
    if (next(kb, slice, flags)) {
      enqueue(queued % S, kb, slice, flags);
      ++queued;
    }
    rt::cp_async_commit();
    compute(done % S);
  }
  rt::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < RL; ++h) {
    const long r = wrow + ly + 8 * h;
    if (r >= a.out_rows) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[h][v] += part[h][v];
    *reinterpret_cast<float4*>(&a.out[r * ldo + wcol + lx * 4]) =
        make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
  }
}

template <int WR>
int launch_fma(const FmaArgs& a, cudaStream_t s) {
  auto kernel = dispatch_fma_kernel<WR>;
  const int warps = a.row_warps * a.col_warps;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      8 * FmaRing<WR>::BYTES);
  if (err != cudaSuccess) return (int)err;
  const long rows = (long)a.row_warps * WR, cols = (long)a.col_warps * rt::T;
  const dim3 grid((unsigned)(((long)a.J * a.bn + cols - 1) / cols),
                  (unsigned)((a.out_rows + rows - 1) / rows));
  kernel<<<grid, warps * 32, warps * FmaRing<WR>::BYTES, s>>>(a);
  return (int)cudaGetLastError();
}

bool block_edge(int e) {
  return e == 16 || e == 32 || e == 64 || e == 128 || e == 256;
}

// ---------------------------------------------------------------- bf16 --

constexpr int MMA_THREADS = 128;   // 4 warps
constexpr int STAGES = 3;          // cp.async ring depth
constexpr int BK = 32;             // k slice per stage (two MMA k-steps)
constexpr int KT = BK / rt::T;
constexpr int PAD = 8;             // bf16 padding per shared row: ldmatrix
                                   // rows then fall in distinct banks

// Warp grid of a BM x BN CTA tile: WM x WN warps (WM * WN <= 4; the rest
// only help with loads), each owning MI 16-row and NI 8-column MMA tiles.
template <int BM, int BN>
struct Warps {
  static constexpr int WN = BN >= 64 ? (BM >= 64 ? 2 : 4) : (BN == 32 ? 2 : 1);
  static constexpr int WM = 4 / WN < BM / 16 ? 4 / WN : BM / 16;
  static constexpr int MI = BM / (16 * WM);
  static constexpr int NI = BN / (8 * WN);
  static_assert(NI % 2 == 0 && MI >= 1, "warp tile must be 16 x 16k");
};

template <int BM, int BN>
constexpr int mma_smem_bytes() {
  return STAGES * (BM * (BK + PAD) + BK * (BN + PAD)) * 2;
}

// One BM x BN output tile of one (bm, bn) block, over k-blocks
// [z K / S, (z + 1) K / S) for z = blockIdx.z; its rows below m are
// written to dst + z * split_stride (row stride ldy).  x (m, K bk) and y
// (K bk, J bn) are row-major bf16, 16-byte aligned rows; x rows past m
// read as zeros.
template <int BM, int BN>
__global__ void __launch_bounds__(MMA_THREADS)
dispatch_mma_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ y,
                    const int* __restrict__ codes,
                    const int* __restrict__ occx, int m,
                    float* __restrict__ dst, const int* __restrict__ skip,
                    int J, int K, int bm, int bk, int bn, int splits,
                    long ldx, long ldy, long split_stride) {
  if (skip != nullptr && *skip != 0) return;
  using W = Warps<BM, BN>;
  constexpr int MT = BM / rt::T;
  constexpr int XS = BK + PAD, YS = BN + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  auto xs = reinterpret_cast<__nv_bfloat16 (*)[BM][XS]>(smem);
  auto ys = reinterpret_cast<__nv_bfloat16 (*)[BK][YS]>(
      smem + STAGES * BM * XS * 2);
  __shared__ uint32_t stage_mask[STAGES];   // x tile bits (a * KT + kt)
  __shared__ int stage_spmm[STAGES];

  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int z = blockIdx.z;
  const int kb_end = (int)((long)(z + 1) * K / splits);
  const int* code_row = codes + ((long)(row0 / bm) * J + col0 / bn) * K;
  const long xtc = ldx / rt::T;          // tile columns of x
  const int mtiles = (m + rt::T - 1) / rt::T;   // row tiles holding a row
  const int kslices = bk / rt::T;        // 16-wide k slices per k-block
  const int steps_per_kb = (bk + BK - 1) / BK;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / W::WN, wn = warp % W::WN;
  const bool mma_warp = warp < W::WM * W::WN;

  // The walk's cursor: the next (k-block, BK slice) to look at.  next()
  // runs uniformly on every thread (the code and the flags are the same
  // for all), so its ballots see full warps.
  int kb = (int)((long)z * K / splits), ks = 0;
  auto next = [&](int& s_kb, int& s_ks, uint32_t& mx, int& spmm) -> bool {
    while (kb < kb_end) {
      const int code = code_row[kb];
      if (code == rt::SKIP) {
        ++kb;
        ks = 0;
        continue;
      }
      const int a = lane / KT, kt = lane % KT;
      const int slice = ks * KT + kt;
      const int tile_row = row0 / rt::T + a;
      bool use = false;
      if (lane < MT * KT && slice < kslices && tile_row < mtiles)
        use = code == rt::GEMM ||
              occx[(long)tile_row * xtc + (long)kb * kslices + slice] != 0;
      const uint32_t bits = __ballot_sync(0xffffffffu, use);
      s_kb = kb;
      s_ks = ks;
      if (++ks == steps_per_kb) {
        ks = 0;
        ++kb;
      }
      if (bits) {
        mx = bits;
        spmm = code == rt::SPMM;
        return true;
      }
    }
    return false;
  };

  // Queue the x tiles marked in mx and every y row of the k slices that
  // hold one, for step (s_kb, s_ks), into ring slot `slot`.
  auto enqueue = [&](int slot, int s_kb, int s_ks, uint32_t mx, int spmm) {
    const long k0 = (long)s_kb * bk + (long)s_ks * BK;
    uint32_t kt_used = 0;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t col = 0;
#pragma unroll
      for (int a = 0; a < MT; ++a) col |= 1u << (a * KT + kt);
      if (mx & col) kt_used |= 1u << kt;
    }
    constexpr int XCH = BM * BK / 8;       // 16-byte chunks per x tile
    for (int c = threadIdx.x; c < XCH; c += MMA_THREADS) {
      const int r = c / (BK / 8), cc = c % (BK / 8);
      if ((mx >> ((r / rt::T) * KT + cc / 2)) & 1u)   // rows past m: zeros
        rt::cp_async16(&xs[slot][r][cc * 8],
                       x + (long)min(row0 + r, m - 1) * ldx + k0 + cc * 8,
                       row0 + r < m);
    }
    constexpr int YCH = BK * BN / 8;
    for (int c = threadIdx.x; c < YCH; c += MMA_THREADS) {
      const int r = c / (BN / 8), cc = c % (BN / 8);
      if ((kt_used >> (r / rt::T)) & 1u)
        rt::cp_async16(&ys[slot][r][cc * 8],
                       y + (k0 + r) * ldy + col0 + cc * 8);
    }
    if (threadIdx.x == 0) {
      stage_mask[slot] = mx;
      stage_spmm[slot] = spmm;
    }
  };

  float acc[W::MI][W::NI][4];
#pragma unroll
  for (int a = 0; a < W::MI; ++a)
#pragma unroll
    for (int n = 0; n < W::NI; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;

  auto compute = [&](int slot) {
    const uint32_t mx = stage_mask[slot];
    const bool spmm = stage_spmm[slot] != 0;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t xrow = 0;   // this warp's x tiles in slice kt
#pragma unroll
      for (int a = 0; a < W::MI; ++a)
        xrow |= ((mx >> ((wm * W::MI + a) * KT + kt)) & 1u) << a;
      if (!xrow) continue;                       // uniform over the warp
      uint32_t b[W::NI / 2][4];
      bool ny[W::NI / 2];
#pragma unroll
      for (int nb = 0; nb < W::NI / 2; ++nb) {
        const int c = wn * W::NI * 8 + nb * 16;  // first column in the CTA
        rt::ldmatrix_x4_trans(
            b[nb], &ys[slot][kt * 16 + lane % 16][c + (lane / 16) * 8]);
        // SPMM: the pair runs only if this 16 x 16 y tile holds a
        // nonzero (the fragments of the warp cover it exactly once;
        // -0.0 counts as zero, as in tile_occupancy)
        ny[nb] = !spmm ||
                 __any_sync(0xffffffffu,
                            ((b[nb][0] | b[nb][1] | b[nb][2] | b[nb][3]) &
                             0x7fff7fffu) != 0);
      }
#pragma unroll
      for (int a = 0; a < W::MI; ++a) {
        if (!((xrow >> a) & 1u)) continue;
        uint32_t af[4];
        rt::ldmatrix_x4(af, &xs[slot][(wm * W::MI + a) * 16 + lane % 16]
                                   [kt * 16 + (lane / 16) * 8]);
#pragma unroll
        for (int nb = 0; nb < W::NI / 2; ++nb) {
          if (!ny[nb]) continue;
          rt::mma_bf16(acc[a][2 * nb], af, b[nb][0], b[nb][1]);
          rt::mma_bf16(acc[a][2 * nb + 1], af, b[nb][2], b[nb][3]);
        }
      }
    }
  };

  // Ring of STAGES slots: step t lives in slot t % STAGES; group t of
  // cp.async holds step t (empty groups only once the walk is done).
  int queued = 0, s_kb, s_ks, spmm;
  uint32_t mx;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (next(s_kb, s_ks, mx, spmm)) {
      enqueue(queued % STAGES, s_kb, s_ks, mx, spmm);
      ++queued;
    }
    rt::cp_async_commit();
  }
  for (int done = 0; done < queued; ++done) {
    rt::cp_async_wait<STAGES - 2>();
    __syncthreads();   // step `done` landed; slot (done - 1) % STAGES free
    if (next(s_kb, s_ks, mx, spmm)) {
      enqueue(queued % STAGES, s_kb, s_ks, mx, spmm);
      ++queued;
    }
    rt::cp_async_commit();
    if (mma_warp) compute(done % STAGES);
  }
  rt::cp_async_wait<0>();

  if (!mma_warp) return;
  float* base = dst + (long)z * split_stride;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int a = 0; a < W::MI; ++a)
#pragma unroll
    for (int n = 0; n < W::NI; ++n) {
      const long r = row0 + (wm * W::MI + a) * 16 + g;
      const long c = col0 + wn * W::NI * 8 + n * 8 + 2 * q;
      if (r < m)
        *reinterpret_cast<float2*>(&base[r * ldy + c]) =
            make_float2(acc[a][n][0], acc[a][n][1]);
      if (r + 8 < m)
        *reinterpret_cast<float2*>(&base[(r + 8) * ldy + c]) =
            make_float2(acc[a][n][2], acc[a][n][3]);
    }
}

// occx[t] for t < tiles, t = row tile * xtc + k slice: whether x's 16 x 16
// tile holds a nonzero (-0.0 counts as zero, as tile_nnz counts x != 0;
// rows past m read as zeros).  One warp per tile: lane l reads 8 elements
// of the tile's row l / 2 (16 bytes; ldx % 16 == 0 and x 16-byte aligned).
__global__ void x_flags_kernel(const __nv_bfloat16* __restrict__ x, int m,
                               long ldx, long xtc, long tiles,
                               int* __restrict__ occx,
                               const int* __restrict__ skip) {
  if (skip != nullptr && *skip != 0) return;
  const long t = (long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (t >= tiles) return;                      // uniform over the warp
  const int lane = threadIdx.x % 32;
  const long r = t / xtc * rt::T + lane / 2;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (r < m)
    v = *reinterpret_cast<const uint4*>(x + r * ldx + t % xtc * rt::T +
                                        (lane % 2) * 8);
  const bool nz = ((v.x | v.y | v.z | v.w) & 0x7fff7fffu) != 0;
  const unsigned any = __any_sync(0xffffffffu, nz);
  if (lane == 0) occx[t] = any != 0;
}

// out[i] for i in [begin, total) (float4 units): the sum of the `splits`
// partials in split order where i < covered (x's m rows), zero beyond (the
// padding rows the caller asked for).
__global__ void finish_kernel(const float4* __restrict__ part,
                              float4* __restrict__ out,
                              const int* __restrict__ skip, int splits,
                              long covered, long begin, long total) {
  if (skip != nullptr && *skip != 0) return;
  for (long i = begin + blockIdx.x * (long)blockDim.x + threadIdx.x;
       i < total; i += (long)gridDim.x * blockDim.x) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < covered) {
      v = part[i];
      for (int s = 1; s < splits; ++s) {
        const float4 p = part[s * covered + i];
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
    }
    out[i] = v;
  }
}

struct MmaArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* y;
  const int* codes;
  const int* occx;
  int m;
  float* dst;
  const int* skip;
  int J, K, bm, bk, bn, splits, row_ctas;
  long ldx, ldy, split_stride;
  cudaStream_t stream;
};

template <int BM, int BN>
int launch_mma(const MmaArgs& a) {
  constexpr int smem = mma_smem_bytes<BM, BN>();
  auto kernel = dispatch_mma_kernel<BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(a.ldy / BN), a.row_ctas, a.splits);
  kernel<<<grid, MMA_THREADS, smem, a.stream>>>(
      a.x, a.y, a.codes, a.occx, a.m, a.dst, a.skip, a.J, a.K, a.bm, a.bk,
      a.bn,
      a.splits, a.ldx, a.ldy, a.split_stride);
  return (int)cudaGetLastError();
}

template <int BM>
int launch_mma_bn(int cta_n, const MmaArgs& a) {
  switch (cta_n) {
    case 16: return launch_mma<BM, 16>(a);
    case 32: return launch_mma<BM, 32>(a);
    case 64: return launch_mma<BM, 64>(a);
    case 128: return launch_mma<BM, 128>(a);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_mma_bm(int cta_m, int cta_n, const MmaArgs& a) {
  switch (cta_m) {
    case 16: return launch_mma_bn<16>(cta_n, a);
    case 32: return launch_mma_bn<32>(cta_n, a);
    case 64: return launch_mma_bn<64>(cta_n, a);
    case 128: return launch_mma_bn<128>(cta_n, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x's format for the float32 walk: x (m, kdim) row-major float32, not
// padded (what lies past it reads as zeros, kdim <= K*bk), bk % 16 == 0.
// occx, 16-byte aligned: ceil(m/16) * K * ceil(bk/512) uint32 of bitmask
// words; xt, 16-byte aligned: room for x's tiles (ceil(m/16) * K*bk * 16
// floats) when x's rows are not 16-byte aligned, else nullptr (as
// kernels/dispatch.py fma_scratch sizes them).  When skip is given and
// *skip != 0 nothing is written: only a format used by the one walk of
// the same flag may take it, never one kept for later walks.
extern "C" int rt_dispatch_x_format(const float* x, int m, int kdim, int K,
                                    int bk, void* occx, float* xt,
                                    const int* skip, void* stream) {
  if (bk <= 0 || bk % rt::T || K < 0 || m < 0 || kdim < 0 ||
      kdim > (long)K * bk)
    return (int)cudaErrorInvalidValue;
  const int W = (bk / rt::T + 31) / 32;
  const long words = (m + rt::T - 1) / rt::T * (long)K * W;
  if (words == 0) return 0;
  const bool x_in_place = (uintptr_t)x % 16 == 0 && kdim % 4 == 0;
  if (words > 0x7fffffffL || occx == nullptr || ((uintptr_t)occx & 15) ||
      (x_in_place != (xt == nullptr)) || ((uintptr_t)xt & 15))
    return (int)cudaErrorInvalidValue;
  FmaArgs a{};
  a.x = x;
  a.occx = reinterpret_cast<uint32_t*>(occx);
  a.xt = xt;
  a.skip = skip;
  a.m = m;
  a.kdim = kdim;
  a.K = K;
  a.bk = bk;
  a.W = W;
  x_words_kernel<<<(unsigned)((words + 7) / 8), 256, 0,
                   (cudaStream_t)stream>>>(a, (int)words);
  return (int)cudaGetLastError();
}

// float32 route, the walk.  x (m, kdim) and y (kdim, ny) row-major
// float32, not padded (what lies past them reads as zeros; m <= I*bm,
// kdim <= K*bk, ny <= J*bn); codes (I, J, K) int32; out (out_rows, J*bn)
// float32 with m <= out_rows <= I*bm, 16-byte aligned, every element
// written unless *skip.  occx and xt: x's format at (K, bk), written by
// rt_dispatch_x_format over this x (before, on the same stream, or
// earlier and x unchanged since); ypad, 16-byte aligned: room for y
// padded to rows of a multiple of 4 floats when y's rows are not 16-byte
// aligned (and kdim > 0), else nullptr.  bm, bn in {16, 32, 64, 128, 256}, bk % 16 ==
// 0.  A warp owns warp_rows (8 or 16) x 16 outputs, a CTA row_warps x
// col_warps warps (at most 8), as fma_launch picks them.
extern "C" int rt_dispatch(const float* x, int m, int kdim, const float* y,
                           int ny, const int* codes, float* out,
                           int out_rows, const void* occx, const float* xt,
                           float* ypad, const int* skip, int I, int J, int K,
                           int bm, int bk, int bn, int warp_rows,
                           int row_warps, int col_warps, void* stream) {
  const int W = (bk / rt::T + 31) / 32;
  if (!block_edge(bm) || !block_edge(bn) || bk <= 0 || bk % rt::T ||
      I < 0 || J < 0 || K < 0 || m < 0 || m > (long)I * bm ||
      kdim > (long)K * bk || ny > (long)J * bn || out_rows < m ||
      out_rows > (long)I * bm || (warp_rows != 8 && warp_rows != 16) ||
      row_warps < 1 || col_warps < 1 || row_warps * col_warps > 8 ||
      out == nullptr || ((uintptr_t)out & 15) || ((uintptr_t)occx & 15) ||
      ((uintptr_t)xt & 15) || ((uintptr_t)ypad & 15))
    return (int)cudaErrorInvalidValue;
  if (out_rows == 0 || J == 0) return 0;
  const long words = (m + rt::T - 1) / rt::T * (long)K * W;
  const bool x_in_place = (uintptr_t)x % 16 == 0 && kdim % 4 == 0;
  const bool y_in_place = (uintptr_t)y % 16 == 0 && ny % 4 == 0;
  if (words > 0x7fffffffL || (words > 0 && occx == nullptr) ||
      (words > 0 && x_in_place != (xt == nullptr)) ||
      (y_in_place && ypad != nullptr) ||
      (!y_in_place && kdim > 0 && ypad == nullptr))
    return (int)cudaErrorInvalidValue;
  const int ldy = y_in_place ? ny : (ny + 3) / 4 * 4;
  cudaStream_t s = (cudaStream_t)stream;
  if (ypad != nullptr && kdim > 0) {
    const long total = (long)kdim * ldy / 4;
    y_pad_kernel<<<(unsigned)min((total + 255) / 256, 8L * 1056), 256, 0,
                   s>>>(y, kdim, ny, ypad, ldy, skip);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  FmaArgs a{x, ypad ? ypad : y, codes,
            const_cast<uint32_t*>(static_cast<const uint32_t*>(occx)),
            const_cast<float*>(words > 0 ? xt : nullptr), out, skip, m,
            kdim, ny, ldy, out_rows, I, J, K, bm, bk, bn, W, row_warps,
            col_warps};
  return warp_rows == 8 ? launch_fma<8>(a, s) : launch_fma<16>(a, s);
}

// bfloat16 route.  x (m, K*bk) and y (K*bk, J*bn) row-major bf16 with
// 16-byte aligned rows and base pointers (x's rows are not padded: rows
// past m read as zeros); codes (I, J, K) int32; out (out_rows, J*bn)
// float32 with m <= out_rows <= I*bm, every element written (rows past m
// as zeros) unless *skip.  occx: ceil(m/16) * K*bk/16 int32 of scratch
// for x's tile flags (written here first); partial: (splits, m, J*bn)
// float32 of scratch when splits > 1.  cta_m in {16, 32, 64, 128} divides
// bm, cta_n in {16, 32, 64, 128} divides bn, bk % 16 == 0, 1 <= splits <=
// max(K, 1).  row_ctas == 0 (no rows) only zero-fills out.
extern "C" int rt_dispatch_mma(const void* x, int m, const void* y,
                               const int* codes, float* out, int out_rows,
                               int* occx, float* partial, const int* skip,
                               int I, int J, int K, int bm, int bk, int bn,
                               int cta_m, int cta_n, int row_ctas,
                               int splits, void* stream) {
  const long n = (long)J * bn;
  const long rows = (long)row_ctas * cta_m;
  if (cta_m <= 0 || cta_n <= 0 || bm % cta_m || bn % cta_n || bk % rt::T ||
      splits < 1 || splits > (K > 1 ? K : 1) || rows > (long)I * bm ||
      row_ctas < 0 || rows < m || rows - cta_m >= m || out_rows < m ||
      out_rows > (long)I * bm || (row_ctas > 0 && occx == nullptr) ||
      (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const long ldx = (long)K * bk;
  if (row_ctas > 0 && n > 0) {
    const long xtc = ldx / rt::T, tiles = (m + rt::T - 1) / rt::T * xtc;
    if (tiles > 0) {
      x_flags_kernel<<<(unsigned)((tiles + 7) / 8), 256, 0, s>>>(
          xb, m, ldx, xtc, tiles, occx, skip);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    MmaArgs a{xb, static_cast<const __nv_bfloat16*>(y), codes, occx, m,
              splits > 1 ? partial : out, skip, J, K, bm, bk, bn, splits,
              row_ctas, ldx, n, (long)m * n, s};
    const int err = launch_mma_bm(cta_m, cta_n, a);
    if (err != 0) return err;
  }
  const long covered = (long)m * n / 4, total = (long)out_rows * n / 4;
  const long begin = splits > 1 ? 0 : covered;
  if (begin < total) {
    const long blocks = (total - begin + 255) / 256;
    finish_kernel<<<(unsigned)(blocks < 1056 ? blocks : 1056), 256, 0, s>>>(
        reinterpret_cast<const float4*>(partial),
        reinterpret_cast<float4*>(out), skip, splits, covered, begin, total);
    return (int)cudaGetLastError();
  }
  return 0;
}
