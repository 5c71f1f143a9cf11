// Block-sparse x block-sparse: out = dense(x) @ dense(y), x in Block-CSR,
// y in Block-CSC, walking only the tile pairs that are nonzero on both
// sides.
//
// Replaces the Pallas kernel src/repro/kernels/spmm.py:110 (spmm, body
// _spmm_kernel).  The TPU grid ran S steps per output tile with the
// intersection schedule (xpos, ypos, counts) in scalar prefetch.  Here
// each output tile walks exactly its counts[i, j] slot pairs (sparse.cuh),
// reading the slots from the plan on the device.
//
// Bound on the H100: the bytes of the intersecting tile pairs, or their
// FMAs, whichever is larger (A_mean x H0 on CiteSeer: operations).  Each
// warp owns 16 (or 8) rows x 16 columns of one output tile and walks its
// pairs alone through a 4-stage cp.async ring (most tiles of A_mean x H0
// walk fewer than 16 pairs), a 2 x 4 (or 1 x 4) register microtile a
// lane.  A CTA places up to 8 warps of the same tile-row on neighbouring
// column tiles, and x's slices are copied through L1 (cp.async.ca), so
// the warps that share an x tile meet there.  Tile-rows run longest
// first, ranked by x's tile counts (sparse.cuh row_order_kernel).
#include "sparse.cuh"

namespace {

constexpr int STAGES = 4;

struct Args {
  const int* xpos;      // (mb, nb, S)
  const int* ypos;      // (mb, nb, S)
  const int* counts;    // (mb, nb)
  const float* xb;      // (mb, sx, tm, tk)
  const float* yb;      // (nb, sy, tk, tn)
  const int* order;     // (mb,) tile-rows, longest first
  float* out;           // (mb * tm, nb * tn)
  int nb, S, sx, sy, tm, tk, tn;
  int unit_rows, col_units, per_cta;
  long units;           // row units x col_units
};

template <int WR>
__global__ void __launch_bounds__(256) spmm_warp_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long w = (long)blockIdx.x * a.per_cta + warp;
  if (w >= a.units) return;                       // the whole warp
  const long rank = w / a.col_units, cu = w % a.col_units;
  const int subm = a.tm / WR, subn = a.tn / rt::T;
  const int i = a.order[rank / subm], j = (int)(cu / subn);
  const int xr = (int)(rank % subm) * WR, yc = (int)(cu % subn) * rt::T;
  const long ij = (long)i * a.nb + j;
  const int cnt = max(0, min(a.counts[ij], a.S));
  const int kts = a.tk / rt::T;
  float* xs = smem + warp * rt::ring_floats<WR, STAGES>();
  float* ys = xs + STAGES * WR * rt::XS;
  rt::SlotWindow xw, yw;
  xw.start(a.xpos + ij * a.S, cnt, lane);
  yw.start(a.ypos + ij * a.S, cnt, lane);
  const float* xrow = a.xb + ((long)i * a.sx * a.tm + xr) * a.tk;
  const float* ycol = a.yb + (long)j * a.sy * a.tk * a.tn + yc;
  const long xtile = (long)a.tm * a.tk, ytile = (long)a.tk * a.tn;
  int q_s = 0, q_kc = 0;          // the next step to enqueue: pair, slice
  auto bases = [&](const float*& xt, const float*& yt) {
    xt = xrow + xw.get(q_s, lane) * xtile + q_kc * rt::T;
    yt = ycol + yw.get(q_s, lane) * ytile + (long)q_kc * rt::T * a.tn;
    if (++q_kc == kts) {
      q_kc = 0;
      ++q_s;
    }
  };
  float acc[WR / 8][4] = {};
  rt::warp_walk<WR, STAGES, true>(xs, ys, cnt * kts, a.tk, a.tn, bases, acc,
                                  lane);
  rt::warp_store<WR>(a.out, (long)a.nb * a.tn, (long)i * a.tm + xr,
                     (long)j * a.tn + yc, acc, lane);
}

template <int WR>
int launch(const Args& a, cudaStream_t s) {
  auto kernel = spmm_warp_kernel<WR>;
  const int bytes = a.per_cta * rt::ring_floats<WR, STAGES>() * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long ctas = (a.units + a.per_cta - 1) / a.per_cta;
  kernel<<<(unsigned)ctas, a.per_cta * 32, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// xpos/ypos (mb, nb, S) int32, counts (mb, nb) int32 <= S, xb
// (mb, sx, tm, tk), yb (nb, sy, tk, tn), x_counts (mb,) x's tile counts,
// order (mb,) scratch for the tile-rows' order, out (mb * tm, nb * tn); tile edges multiples of 16, xb and yb
// 16-byte aligned.  Warps of unit_rows (16 or 8) x 16 outputs, per_cta
// (at most 8) a CTA, as kernels/spmm.py spmm_launch picks them.
extern "C" int rt_spmm(const int* xpos, const int* ypos, const int* counts,
                       const float* xb, const float* yb, const int* x_counts,
                       int* order, float* out, int mb, int nb, int S, int sx,
                       int sy, int tm, int tk, int tn, int unit_rows,
                       int per_cta, void* stream) {
  if (tm % rt::T || tk % rt::T || tn % rt::T || mb <= 0 || nb <= 0 ||
      (unit_rows != 16 && unit_rows != 8) || per_cta < 1 || per_cta > 8)
    return (int)cudaErrorInvalidValue;
  Args a{xpos, ypos, counts, xb, yb, order, out, nb, S, sx, sy, tm, tk, tn,
         unit_rows, nb * (tn / rt::T), per_cta, 0};
  a.units = (long)mb * (tm / unit_rows) * a.col_units;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = rt::launch_row_order(x_counts, mb, order, s);
  if (err != cudaSuccess) return (int)err;
  return unit_rows == 16 ? launch<16>(a, s) : launch<8>(a, s);
}
