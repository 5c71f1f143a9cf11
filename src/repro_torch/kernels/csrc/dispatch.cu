// The executor's block path: one launch per dynasparse_matmul that walks
// the planner's (I, J, K) primitive-code grid on the device.
//
// Replaces the per-step dispatch of src/repro/core/dynasparse.py:239-258,
// where a lax.scan over output blocks and a fori_loop over k ran one
// lax.switch branch -- and, with kernels on, one Pallas call of
// src/repro/kernels/gemm.py:47, spdmm.py:92 or spmm.py:154 -- per (i, j, k)
// step.  Each CTA owns one output tile inside one (bm, bn) block and runs
// the k loop in order, reading the code of its block, codes[i, j, k], from
// device memory:
//
//   SKIP   costs nothing;
//   GEMM   is a dense block MAC;
//   SPDMM  walks only the lhs block's nonzero 16x16 tiles;
//   SPMM   walks only the tile pairs nonzero on both sides.
//
// The code is the same for every thread of the CTA, so the branches do
// not diverge.  ``skip`` (nullable) is a device flag: when it points to
// nonzero the whole grid exits at once (the executor picked the row-CSR
// path on the device).
//
// Two routes, chosen by the operands' type:
//
// * float32 (the GNN path), rt_dispatch, on the FP32 FMA units.  It stays
//   the first version bit for bit: its rounding decides the writeback
//   counts the next kernel plans from.  Blocks of 128 or 256 rows or
//   columns run as 2 x 2 or 4 x 4 CTAs of 64 x 64 sharing their block's
//   codes; operands are widened to float32 in shared memory; each step
//   accumulates into a fresh float32 partial that is then added to the
//   running sum, as the reference adds acc + step.  Bound: operations (the
//   FP32 rate; the tensor cores' TF32 would change the rounding).
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
#include "common.cuh"
#include "mma.cuh"

namespace {

template <int TM, int TN>
__global__ void dispatch_kernel(const float* __restrict__ x,
                                const float* __restrict__ y,
                                const int* __restrict__ codes,
                                const uint8_t* __restrict__ occx,
                                const uint8_t* __restrict__ occy,
                                float* __restrict__ out,
                                const int* __restrict__ skip, int J, int K,
                                int bk, int rm, int rn, long ldx, long ldy) {
  if (skip != nullptr && *skip != 0) return;
  constexpr int BM = TM * rt::T, BN = TN * rt::T;
  __shared__ float xs[BM][rt::T + 1];
  __shared__ float ys[rt::T][BN + 1];
  const int bi = blockIdx.y, bj = blockIdx.x;   // sub-block of the output
  const int kts = bk / rt::T;       // 16-wide k slices per block
  const long xtc = ldx / rt::T;     // tile columns of x (= tile rows of y)
  const long ytc = ldy / rt::T;     // tile columns of y
  const int* code_row = codes + ((long)(bi / rm) * J + bj / rn) * K;

  float acc[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = 0.f;

  for (int k = 0; k < K; ++k) {
    const int code = code_row[k];
    if (code == rt::SKIP) continue;
    float part[TM][TN];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b) part[a][b] = 0.f;

    for (int kt = 0; kt < kts; ++kt) {
      const long gk = (long)k * kts + kt;  // global 16-wide k slice
      bool ux[TM], uy[TN];
      bool anyx = false, anyy = false;
#pragma unroll
      for (int a = 0; a < TM; ++a) {
        ux[a] = code == rt::GEMM || occx[((long)bi * TM + a) * xtc + gk];
        anyx |= ux[a];
      }
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        uy[b] = code != rt::SPMM || occy[gk * ytc + (long)bj * TN + b];
        anyy |= uy[b];
      }
      if (!(anyx && anyy)) continue;  // uniform across the CTA
#pragma unroll
      for (int a = 0; a < TM; ++a)
        if (ux[a])
          rt::load_tile(xs, a * rt::T, 0,
                        x + ((long)bi * BM + a * rt::T) * ldx + gk * rt::T,
                        ldx);
#pragma unroll
      for (int b = 0; b < TN; ++b)
        if (uy[b])
          rt::load_tile(ys, 0, b * rt::T,
                        y + gk * rt::T * ldy + (long)bj * BN + b * rt::T, ldy);
      __syncthreads();
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b)
          if (ux[a] && uy[b])
            part[a][b] = rt::tile_fma(xs, a * rt::T, ys, b * rt::T, part[a][b]);
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b) acc[a][b] += part[a][b];
  }
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b)
      out[((long)bi * BM + a * rt::T + threadIdx.y) * ldy + (long)bj * BN +
          b * rt::T + threadIdx.x] = acc[a][b];
}

struct Args {
  const float* x;
  const float* y;
  const int* codes;
  const uint8_t* occx;
  const uint8_t* occy;
  float* out;
  const int* skip;
  int I, J, K, bk, rm, rn;
  long ldx, ldy;
  cudaStream_t stream;
};

template <int TM, int TN>
int launch(const Args& a) {
  dim3 grid(a.J * a.rn, a.I * a.rm), block(rt::T, rt::T);
  dispatch_kernel<TM, TN><<<grid, block, 0, a.stream>>>(
      a.x, a.y, a.codes, a.occx, a.occy, a.out, a.skip, a.J, a.K, a.bk,
      a.rm, a.rn, a.ldx, a.ldy);
  return (int)cudaGetLastError();
}

template <int TM>
int launch_tn(int tn, const Args& a) {
  switch (tn) {
    case 1: return launch<TM, 1>(a);
    case 2: return launch<TM, 2>(a);
    case 4: return launch<TM, 4>(a);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_tm(int tm, int tn, const Args& a) {
  switch (tm) {
    case 1: return launch_tn<1>(tn, a);
    case 2: return launch_tn<2>(tn, a);
    case 4: return launch_tn<4>(tn, a);
  }
  return (int)cudaErrorInvalidValue;
}

// Sub-block edge in 16-wide tiles, and sub-blocks per block edge, for a
// block edge of 16, 32 or a multiple of 64.
bool split(int edge, int* tiles, int* per_block) {
  if (edge == 16 || edge == 32) {
    *tiles = edge / rt::T;
    *per_block = 1;
    return true;
  }
  if (edge > 0 && edge % 64 == 0) {
    *tiles = 4;
    *per_block = edge / 64;
    return true;
  }
  return false;
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

// float32 route.  x (I*bm, K*bk) and y (K*bk, J*bn) row-major float32,
// zero-padded to block multiples; codes (I, J, K) int32; occx (I*bm/16,
// K*bk/16) and occy (K*bk/16, J*bn/16) uint8 tile-occupancy flags; out
// (I*bm, J*bn) float32.  bm and bn must be 16, 32 or a multiple of 64; bk
// a multiple of 16.
extern "C" int rt_dispatch(const float* x, const float* y, const int* codes,
                           const uint8_t* occx, const uint8_t* occy,
                           float* out, const int* skip, int I, int J, int K,
                           int bm, int bk, int bn, void* stream) {
  Args a{x, y, codes, occx, occy, out, skip, I, J, K, bk, 1, 1,
         (long)K * bk, (long)J * bn, (cudaStream_t)stream};
  int tm, tn;
  if (!split(bm, &tm, &a.rm) || !split(bn, &tn, &a.rn) || bk % rt::T)
    return (int)cudaErrorInvalidValue;
  return launch_tm(tm, tn, a);
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
