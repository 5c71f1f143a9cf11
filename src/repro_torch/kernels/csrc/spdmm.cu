// Block-sparse x dense: out = dense(x) @ y with x in Block-CSR.
//
// Replaces the Pallas kernel src/repro/kernels/spdmm.py:50 (spdmm, body
// _spdmm_kernel).  The TPU grid ran Smax steps per tile-row and masked the
// steps past counts[i] with clamped index maps.  Here each tile-row walks
// exactly its counts[i] nonzero tiles (sparse.cuh), reading the rhs rows
// from col_idx[i, s] on the device, so an empty row costs one store.
//
// Bound on the H100: the bytes of the nonzero x tiles plus the y rows they
// select, or the FMAs of those tiles, whichever is larger (A_mean @ H0 on
// CiteSeer: operations).  Every selected y row is needed once per tile,
// so the slabs are read from L2 once per (tile, column strip).  Two
// routes, picked on the host from the output's shape (kernels/spdmm.py
// spdmm_launch):
//   * wide (n >= 128): a CTA of 128 threads owns 16 rows x 128 columns
//     and stages, per 16-deep step, x's 16 x 16 slice and the 16 x 128
//     slab of y rows it selects once for all its threads, through a
//     4-stage 16-byte cp.async ring with one barrier per step; each thread
//     keeps a 4 x 4 register microtile (warp w: rows 4 w .. 4 w + 3; lane
//     l: columns 4 l .. 4 l + 3) for the whole walk.  Most of its time
//     is the slabs' traffic from L2: 16 rows of y for every nonzero tile
//     and strip (on A_mean @ H0, 2106 tiles x 16 x 3712 floats, 0.5 GB a
//     call, ten times the bytes it must read from memory).  8 x 4
//     microtiles in 64-thread CTAs (half the shared loads a FMA) ran
//     slower on the H100 (0.180 against 0.159 ms);
//   * warp (narrow outputs): each warp owns 16 (or 8) rows x 16 columns
//     and walks alone through a 4-stage ring of (x slice, y slice) pairs;
//     a CTA groups up to 4 warps.  A 232-step chain is bound by its
//     warp's latency: the compiler places each shared load just before
//     its FMAs, so every k of a step waits for one; an 8-stage ring ran
//     slower (0.065 against 0.051 ms on the Update).
// Tile-rows run longest first (sparse.cuh row_order_kernel, ranked by
// counts), so the 150-tile rows of A_mean do not start last.
#include "sparse.cuh"

namespace {

struct Args {
  const int* col_idx;   // (mb, smax)
  const int* counts;    // (mb,)
  const float* blocks;  // (mb, smax, tm, tk)
  const float* y;       // (y_rows, n)
  const int* order;     // (mb,) tile-rows, longest first
  float* out;           // (mb * tm, n)
  int smax, tm, tk, n;
  long y_rows;
  int unit_rows, col_units, per_cta;
  long units;           // row units x col_units
};

// Tile-row, first output row and tile count of row unit `rank`.
struct Row {
  int i, cnt;
  long r0;
  __device__ Row(const Args& a, long rank) {
    const int subs = a.tm / a.unit_rows;
    i = a.order[rank / subs];
    r0 = (long)i * a.tm + rank % subs * a.unit_rows;
    cnt = max(0, min(a.counts[i], a.smax));
  }
  // the unit's first row in the tile at slot 0 (slot s: + s tm tk)
  __device__ const float* x_row(const Args& a) const {
    return a.blocks + ((long)i * a.smax * a.tm + r0 % a.tm) * a.tk;
  }
};

constexpr int WIDE = 128, WIDE_STAGES = 4, WIDE_THREADS = 128;
constexpr int WIDE_ROWS = rt::T / (WIDE_THREADS / 32);   // a thread's rows
constexpr int WARP_STAGES = 4;

__global__ void __launch_bounds__(WIDE_THREADS)
spdmm_wide_kernel(Args a) {
  constexpr int S = WIDE_STAGES;
  __shared__ __align__(16) float xs[S][rt::T][rt::XS];
  __shared__ __align__(16) float ys[S][rt::T][WIDE];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long rank = blockIdx.x / a.col_units;
  const long col0 = (long)(blockIdx.x % a.col_units) * WIDE;
  const Row row(a, rank);
  const int kts = a.tk / rt::T, steps = row.cnt * kts;
  rt::SlotWindow cols;
  cols.start(a.col_idx + (long)row.i * a.smax, row.cnt, lane);

  // this thread's 16-byte pieces of a step: x's (threads 0..63: row
  // tid / 4, columns 4 (tid % 4) ..) and y's four (row q / 32, columns
  // col0 + 4 (q % 32) .., q = tid + 128 p; zero past column n)
  constexpr int NY = rt::T * WIDE / 4 / WIDE_THREADS;
  const bool has_x = tid < rt::T * rt::T / 4;
  const long gx = tid / 4 * a.tk + tid % 4 * 4;
  long gy[NY];
  bool yin[NY];
#pragma unroll
  for (int p = 0; p < NY; ++p) {
    const int q = tid + WIDE_THREADS * p;
    gy[p] = (long)(q / (WIDE / 4)) * a.n + col0 + q % (WIDE / 4) * 4;
    yin[p] = col0 + q % (WIDE / 4) * 4 < a.n;
  }
  const float* xrow = row.x_row(a);
  const long tile = (long)a.tm * a.tk;
  int q_s = 0, q_kc = 0;          // the next step to enqueue: slot, slice
  auto enqueue = [&](int t) {
    const int slot = t % S;
    const long c = cols.get(q_s, lane);
    const float* xt = xrow + q_s * tile + q_kc * rt::T;
    const float* yt = a.y + (c * a.tk + q_kc * rt::T) * a.n;
    if (++q_kc == kts) {
      q_kc = 0;
      ++q_s;
    }
    if (has_x) rt::cp_async16(&xs[slot][tid / 4][tid % 4 * 4], xt + gx);
#pragma unroll
    for (int p = 0; p < NY; ++p) {
      const int q = tid + WIDE_THREADS * p;
      rt::cp_async16(&ys[slot][q / (WIDE / 4)][q % (WIDE / 4) * 4],
                     yin[p] ? yt + gy[p] : a.y, yin[p]);
    }
  };

  float acc[WIDE_ROWS][4];
#pragma unroll
  for (int h = 0; h < WIDE_ROWS; ++h)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[h][v] = 0.f;
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < steps) enqueue(t);
    rt::cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    rt::cp_async_wait<S - 2>();
    __syncthreads();   // step t landed; slot (t - 1) % S is free
    if (t + S - 1 < steps) enqueue(t + S - 1);
    rt::cp_async_commit();
    const int slot = t % S;
#pragma unroll
    for (int k4 = 0; k4 < rt::T / 4; ++k4) {
      float4 xa[WIDE_ROWS];
#pragma unroll
      for (int h = 0; h < WIDE_ROWS; ++h)
        xa[h] = *reinterpret_cast<const float4*>(
            &xs[slot][warp * WIDE_ROWS + h][k4 * 4]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 bv = *reinterpret_cast<const float4*>(
            &ys[slot][k4 * 4 + kk][lane * 4]);
        const float b[4] = {bv.x, bv.y, bv.z, bv.w};
        float ak[WIDE_ROWS];
#pragma unroll
        for (int h = 0; h < WIDE_ROWS; ++h) ak[h] = rt::lane_of(xa[h], kk);
        rt::fma_step(acc, ak, b);
      }
    }
  }
  rt::cp_async_wait<0>();

  const long c = col0 + lane * 4;
  if (c < a.n)
#pragma unroll
    for (int h = 0; h < WIDE_ROWS; ++h)
      *reinterpret_cast<float4*>(
          &a.out[(row.r0 + warp * WIDE_ROWS + h) * a.n + c]) =
          make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
}

template <int WR>
__global__ void __launch_bounds__(128) spdmm_warp_kernel(Args a) {
  constexpr int S = WARP_STAGES;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long w = (long)blockIdx.x * a.per_cta + warp;
  if (w >= a.units) return;                       // the whole warp
  const Row row(a, w / a.col_units);
  const long col0 = (w % a.col_units) * rt::T;
  float* xs = smem + warp * rt::ring_floats<WR, S>();
  float* ys = xs + S * WR * rt::XS;
  const int kts = a.tk / rt::T;
  rt::SlotWindow cols;
  cols.start(a.col_idx + (long)row.i * a.smax, row.cnt, lane);

  const float* xrow = row.x_row(a);
  const long tile = (long)a.tm * a.tk;
  int q_s = 0, q_kc = 0;          // the next step to enqueue: slot, slice
  auto bases = [&](const float*& xt, const float*& yt) {
    const long c = cols.get(q_s, lane);
    xt = xrow + q_s * tile + q_kc * rt::T;
    yt = a.y + (c * a.tk + q_kc * rt::T) * a.n + col0;
    if (++q_kc == kts) {
      q_kc = 0;
      ++q_s;
    }
  };
  float acc[WR / 8][4] = {};
  rt::warp_walk<WR, S, false>(xs, ys, row.cnt * kts, a.tk, a.n, bases, acc,
                              lane);
  rt::warp_store<WR>(a.out, a.n, row.r0, col0, acc, lane);
}

template <int WR>
int launch_warp(const Args& a, long ctas, cudaStream_t s) {
  auto kernel = spdmm_warp_kernel<WR>;
  const int bytes = a.per_cta * rt::ring_floats<WR, WARP_STAGES>() * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)ctas, a.per_cta * 32, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// col_idx (mb, smax) int32, counts (mb,) int32 <= smax, blocks
// (mb, smax, tm, tk), y (y_rows, n) with y_rows = Kb * tk, order (mb,)
// scratch for the tile-rows' order, out (mb * tm, n); tm, tk, n multiples of
// 16, y and blocks 16-byte aligned.  unit_cols 128: the wide route
// (unit_rows 16, one unit per CTA); unit_cols 16: the warp route
// (unit_rows 16 or 8, per_cta warps a CTA, at most 4), as
// kernels/spdmm.py spdmm_launch picks them.
extern "C" int rt_spdmm(const int* col_idx, const int* counts,
                        const float* blocks, const float* y, int* order,
                        float* out, int mb, int smax, int tm, int tk, int n,
                        long y_rows, int unit_rows, int unit_cols,
                        int per_cta, void* stream) {
  const bool wide = unit_cols == WIDE && unit_rows == 16 && per_cta == 1;
  const bool warp = unit_cols == rt::T && (unit_rows == 16 || unit_rows == 8) &&
                    per_cta >= 1 && per_cta <= 4;
  if (tm % rt::T || tk % rt::T || n % rt::T || mb <= 0 || n <= 0 ||
      !(wide || warp))
    return (int)cudaErrorInvalidValue;
  Args a{col_idx, counts, blocks, y, order, out, smax, tm, tk, n, y_rows,
         unit_rows, (n + unit_cols - 1) / unit_cols, per_cta, 0};
  a.units = (long)mb * (tm / unit_rows) * a.col_units;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = rt::launch_row_order(counts, mb, order, s);
  if (err != cudaSuccess) return (int)err;
  if (wide) {
    spdmm_wide_kernel<<<(unsigned)a.units, WIDE_THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  const long ctas = (a.units + per_cta - 1) / per_cta;
  return unit_rows == 16 ? launch_warp<16>(a, ctas, s)
                         : launch_warp<8>(a, ctas, s);
}
