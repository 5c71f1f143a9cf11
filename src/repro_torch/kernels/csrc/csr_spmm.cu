// Row-gather SPMM over the ELL view: out[i] = sum_{s < min(counts[i], rmax)}
// vals[i, s] * y[cols[i, s]], float32 or bf16 operands (one type), float32
// accumulation and output.
//
// Replaces the Pallas kernel src/repro/kernels/csr_spmm.py:43 (csr_spmm,
// body _csr_spmm_kernel), whose (m, nb, rmax) grid took one row and one
// slot per step and masked slots past the row's count.
//
// Rounding: each output is one fmaf chain over its row's slots in slot
// order, from 0; no row's slots are split across threads and no float
// atomic is used.  ELL stores a row's columns in ascending order and
// fma(0, y, p) == p for finite y, so on float32 operands the result equals
// the dense gemm's (one fmaf chain over k ascending) bit for bit.
//
// Bound on the H100: y's distinct rows read once and the output written
// once (bytes); below one FMA per byte.  The gathers themselves are nnz *
// n elements, unaligned rows of y at random, so in practice the kernel
// waits on the memory-level parallelism of its gathers.  The first version
// ran one thread per output with two dependent loads per slot, so a hub
// row's 541 slots were a chain of load latencies and thousands of 1-slot
// rows each paid a whole CTA.  Here:
//
// * Rows start longest first: a one-CTA counting sort ranks them by count
//   on the device, in the same C call (no host sync).
// * A group of G lanes walks one row over a strip of columns (lane p owns
//   columns c0 + p + G j, scalar loads that coalesce whatever y's row
//   alignment).  The row's column ids and values are staged G slots at a
//   time, one per lane, with the next G in flight, so a slot's address
//   costs a shuffle, not a load.  A chunk issues 32 y loads a lane (J
//   columns of D slots) before their FMAs.
// * Shapes by row length (csr_spmm.csr_launch on the host): the longest
//   ranks (the "heavy" rows, e.g. CiteSeer's 541-slot hub) first walk
//   G-column strips with D = 32, so a hub spreads over many warps, each
//   waiting on about count / 32 chunks; the others walk 1024-column
//   strips, one row a warp, in passes of 32 J columns, J = 32 for a 1-slot
//   row down to J = 4 beyond 4 slots (walk_light), so a short row's unit
//   is a few load latencies, not one per 128 columns.  Outputs up to 16
//   wide put two rows in a warp (G = 16), so no lane idles.
//
// ``run`` (nullable) is a device flag: when it points to 0 both kernels
// exit at once.  The executor launches this kernel and the block path
// together and lets the device pick, so it never copies the format
// decision to the host.
#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP = 32;
constexpr long LIGHT_COLS = 1024;   // columns of a light unit (G = 32)
constexpr int HUB_THREADS = 128;    // a CTA: a hub unit, or 4 warps
constexpr int HUB_SLOTS = 128;      // slots a hub unit stages at a time
constexpr int ORDER_THREADS = 1024;
constexpr int BINS = 1024;          // counts >= BINS - 1 share the top bin
static_assert(BINS == ORDER_THREADS, "the scan gives each thread one bin");

// The rows by descending min(count, rmax): a counting sort in one CTA
// (histogram, descending scan, scatter), with warp-aggregated shared
// atomics.  Ties land in any order; every row lands exactly once.
__global__ void __launch_bounds__(ORDER_THREADS)
csr_row_order_kernel(const int* __restrict__ counts, int m, int rmax,
                     const int* __restrict__ run, int* __restrict__ order) {
  if (run != nullptr && *run == 0) return;
  __shared__ int start[BINS];
  __shared__ int warp_sums[ORDER_THREADS / WARP];
  const int tid = threadIdx.x, lane = tid % WARP, warp = tid / WARP;
  for (int b = tid; b < BINS; b += ORDER_THREADS) start[b] = 0;
  __syncthreads();
  auto key_of = [&](int i) {
    return i < m ? min(min(counts[i], rmax), BINS - 1) : -1;
  };
  for (int base = 0; base < m; base += ORDER_THREADS) {
    const int key = key_of(base + tid);
    const unsigned peers = __match_any_sync(FULL, key);
    if (key >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&start[key], __popc(peers));
  }
  __syncthreads();
  // start[b] = rows with a larger key: thread t scans bin BINS - 1 - t
  const int b = BINS - 1 - tid;
  const int h = start[b];
  int inc = h;
#pragma unroll
  for (int d = 1; d < WARP; d *= 2) {
    const int v = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += v;
  }
  if (lane == WARP - 1) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < WARP; d *= 2) {
      const int v = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w += v;
    }
    warp_sums[lane] = w - warp_sums[lane];    // exclusive, by warp
  }
  __syncthreads();
  start[b] = warp_sums[warp] + inc - h;
  __syncthreads();
  for (int base = 0; base < m; base += ORDER_THREADS) {
    const int i = base + tid, key = key_of(i);
    const unsigned peers = __match_any_sync(FULL, key);
    const int leader = __ffs(peers) - 1;
    int pos = 0;
    if (key >= 0 && lane == leader)
      pos = atomicAdd(&start[key], __popc(peers));
    pos = __shfl_sync(FULL, pos, leader);
    if (key >= 0) order[pos + __popc(peers & ((1u << lane) - 1))] = i;
  }
}

// The slots of one row (row < 0: none) for a group of G lanes (p = lane %
// G), staged NW windows of G slots at a time: lane p holds slot w G + p of
// the current windows w (column id c, value v) and of the next NW (cn,
// vn).  cmax is the warp's longest row (two rows share a warp when G =
// 16).  The first window is read with the row's count, not after it
// (every row of the ELL view has rmax slots, and a slot past the count is
// never used).
template <int G, int NW, typename TV>
struct RowSlots {
  const int* cr;
  const TV* vr;
  int cnt, cmax, end, c[NW], cn[NW];
  float v[NW], vn[NW];

  __device__ __forceinline__ void start(const TV* vals, const int* cols,
                                        const int* counts, int row, int rmax,
                                        int p) {
    cr = cols + (long)max(row, 0) * rmax;
    vr = vals + (long)max(row, 0) * rmax;
    const bool first = row >= 0 && p < rmax;
    c[0] = first ? cr[p] : 0;
    v[0] = first ? rt::to_f32(vr[p]) : 0.f;
    cnt = row >= 0 ? min(counts[row], rmax) : 0;
    cmax = cnt;
    if (G < WARP) cmax = max(cmax, __shfl_xor_sync(FULL, cmax, G));
#pragma unroll
    for (int w = 1; w < NW; ++w) load(c[w], v[w], w * G + p);
    end = 0;
    advance(p);
  }

  __device__ __forceinline__ void load(int& ci, float& vi, int s) {
    ci = s < cnt ? cr[s] : 0;
    vi = s < cnt ? rt::to_f32(vr[s]) : 0.f;
  }

  // the next windows become current once the walk reaches end; the ones
  // after them are read one chunk ahead
  __device__ __forceinline__ void advance(int p) {
    if (end > 0) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        c[w] = cn[w];
        v[w] = vn[w];
      }
    }
    end += NW * G;
#pragma unroll
    for (int w = 0; w < NW; ++w) load(cn[w], vn[w], end + w * G + p);
  }
};

// The row over the strip of G * J columns from c0 (lane p owns columns c0
// + p + G j), from its slots as start() left them (a copy: each strip
// walks them anew); the whole warp calls it.  Chunks of D slots (D J =
// 32 loads a lane, inside the NW staged windows): D shuffles for the
// column ids, the D * J y loads, then the FMAs in slot order; each lane
// stops using slots at its own count.
template <int G, int J, int D, int NW, typename TV>
__device__ __forceinline__ void walk_strip(
    RowSlots<G, NW, TV> rs, const TV* __restrict__ y,
    float* __restrict__ out, int row, long c0, int n, long ldo, int p) {
  static_assert(((NW == 1 && G % D == 0) || D == NW * G) && D * J <= 32,
                "a chunk lies inside one window or spans all NW");
  float acc[J];
  bool in[J];                   // the lane's columns that lie inside y
  const long col0 = c0 + p;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    acc[j] = 0.f;
    in[j] = col0 + G * j < n;
  }
  const TV* yp = y + col0;
  for (int s0 = 0; s0 < rs.cmax; s0 += D) {
    if (s0 == rs.end) rs.advance(p);
    const int w0 = s0 % (NW * G);
    // straight-line code: every load of the chunk is issued (predicated
    // on the lane's own count) before the first FMA waits on one; a row's
    // offset k n is 32-bit (the wrapper keeps y under 2^32 elements)
    float yv[D][J];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int w = NW == 1 ? 0 : d / G;   // the staged window of slot d
      const int k = __shfl_sync(FULL, rs.c[w], (w0 + d) % G, G);
      const bool live = s0 + d < rs.cnt;
      const TV* yr = yp + (unsigned)k * (unsigned)n;
#pragma unroll
      for (int j = 0; j < J; ++j)
        yv[d][j] = live && in[j] ? rt::to_f32(yr[G * j]) : 0.f;
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int w = NW == 1 ? 0 : d / G;
      const float vs = __shfl_sync(FULL, rs.v[w], (w0 + d) % G, G);
      if (s0 + d < rs.cnt) {
#pragma unroll
        for (int j = 0; j < J; ++j) acc[j] = fmaf(vs, yv[d][j], acc[j]);
      }
    }
  }
  if (row >= 0) {
    float* o = out + row * ldo + col0;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (in[j]) __stcs(o + G * j, acc[j]);
  }
}

// The LIGHT_COLS columns from c0 of one row, one row a warp: the fewer the
// slots, the more columns a lane takes per pass (1 slot: 32 columns, one
// pass; more than 4: 4 columns, eight passes), so a pass keeps 32 loads a
// lane in flight whatever the row's length.  (Written out per count: a
// generic loop over the passes compiled to more registers and ran slower.)
template <typename TV>
__device__ __forceinline__ void walk_light(
    const RowSlots<WARP, 1, TV>& rs, const TV* __restrict__ y,
    float* __restrict__ out, int row, long c0, int n, long ldo, int p) {
  static_assert(LIGHT_COLS == 32 * WARP, "a 1-slot row takes one pass");
  const long c1 = min(c0 + LIGHT_COLS, (long)n);
  if (rs.cmax <= 1) {
    walk_strip<WARP, 32, 1>(rs, y, out, row, c0, n, ldo, p);
  } else if (rs.cmax <= 2) {
    for (long c = c0; c < c1; c += WARP * 16)
      walk_strip<WARP, 16, 2>(rs, y, out, row, c, n, ldo, p);
  } else if (rs.cmax <= 4) {
    for (long c = c0; c < c1; c += WARP * 8)
      walk_strip<WARP, 8, 4>(rs, y, out, row, c, n, ldo, p);
  } else {
    for (long c = c0; c < c1; c += WARP * 4)
      walk_strip<WARP, 4, 8>(rs, y, out, row, c, n, ldo, p);
  }
}

// A hub row (one of the longest ranks) over the 32 columns from c0, by a
// whole CTA of HUB_THREADS threads: HUB_SLOTS slots at a time, every
// thread loads its column of HUB_SLOTS / 4 slots (all in flight at once)
// into shared memory, then the first warp runs the FMA chains from there
// in slot order.  So a 541-slot hub waits on 5 rounds of loads, not 17.
template <typename TV>
__device__ __forceinline__ void walk_hub(
    const TV* __restrict__ vals, const int* __restrict__ cols,
    const int* __restrict__ counts, const TV* __restrict__ y,
    float* __restrict__ out, int row, long c0, int rmax, int n, long ldo) {
  __shared__ int ids[HUB_SLOTS];
  __shared__ float vs[HUB_SLOTS];
  __shared__ float ys[HUB_SLOTS][WARP];
  const int tid = threadIdx.x, lane = tid % WARP;
  constexpr int ROWS = HUB_THREADS / WARP;     // slots loaded per pass
  const int cnt = min(counts[row], rmax);
  const int* cr = cols + (long)row * rmax;
  const TV* vr = vals + (long)row * rmax;
  const long col = c0 + lane;
  const bool in = col < n;
  const TV* yp = y + col;
  float acc = 0.f;
  for (int sb = 0; sb < cnt; sb += HUB_SLOTS) {
    const int nb = min(HUB_SLOTS, cnt - sb);
    for (int t = tid; t < nb; t += HUB_THREADS) {
      ids[t] = cr[sb + t];
      vs[t] = rt::to_f32(vr[sb + t]);
    }
    __syncthreads();
    float v[HUB_SLOTS / ROWS];
#pragma unroll
    for (int i = 0; i < HUB_SLOTS / ROWS; ++i) {
      const int s = tid / WARP + ROWS * i;
      v[i] = s < nb && in ? rt::to_f32(yp[(unsigned)ids[s] * (unsigned)n])
                          : 0.f;
    }
#pragma unroll
    for (int i = 0; i < HUB_SLOTS / ROWS; ++i)
      ys[tid / WARP + ROWS * i][lane] = v[i];
    __syncthreads();
    if (tid < WARP) {
#pragma unroll 8
      for (int s = 0; s < nb; ++s) acc = fmaf(vs[s], ys[s][lane], acc);
    }
    __syncthreads();
  }
  if (tid < WARP && in) __stcs(out + row * ldo + col, acc);
}

// CTA b < hub * hub_strips: hub unit b (rank b / hub_strips, the 32-column
// strip b % hub_strips; they start first).  The later CTAs' warps u: heavy
// unit u while u < ceil((heavy - hub) / R) * hstrips (R = 32 / G ranks a
// warp: ranks hub + (u / hstrips) R + lane / G, the G-column strip u %
// hstrips; a CTA holds one rank's strips, so no long row keeps a CTA of
// short ones), then light unit v = u - that: rank group v % groups over
// strip v / groups of LIGHT_COLS columns (G = 32, walk_light; one strip of
// n <= 16 columns for G = 16).  The light units run strip by strip, so the
// warps in flight gather from one or two strips of y; the output is
// stored with the streaming hint (__stcs), so that it does not evict them
// from L2.
template <int G, typename TV>
__global__ void __launch_bounds__(HUB_THREADS)
csr_spmm_kernel(const TV* __restrict__ vals, const int* __restrict__ cols,
                const int* __restrict__ counts, const TV* __restrict__ y,
                const int* __restrict__ order, float* __restrict__ out,
                const int* __restrict__ run, int m, int rmax, int n, long ldo,
                int hub, int heavy, int hstrips, int strips) {
  if (run != nullptr && *run == 0) return;
  const int hub_strips = (n + WARP - 1) / WARP;
  const long hubs = (long)hub * hub_strips;
  if (blockIdx.x < hubs) {
    walk_hub(vals, cols, counts, y, out, order[blockIdx.x / hub_strips],
             (blockIdx.x % hub_strips) * WARP, rmax, n, ldo);
    return;
  }
  const int lane = threadIdx.x % WARP, p = lane % G;
  long u = (blockIdx.x - hubs) * (blockDim.x / WARP) + threadIdx.x / WARP;
  constexpr int R = WARP / G;
  const long hunits = (long)((heavy - hub + R - 1) / R) * hstrips;
  if (u < hunits) {              // 32 slots a chunk: 32 / G staged windows
    const int rank = hub + (int)(u / hstrips) * R + lane / G;
    const int row = rank < heavy ? order[rank] : -1;
    RowSlots<G, 32 / G, TV> hs;
    hs.start(vals, cols, counts, row, rmax, p);
    walk_strip<G, 1, 32>(hs, y, out, row, (u % hstrips) * G, n, ldo, p);
    return;
  }
  u -= hunits;
  const long groups = (m - heavy + R - 1) / R;
  if (u >= groups * strips) return;
  const int rank = heavy + (int)(u % groups) * R + lane / G;
  const int row = rank < m ? order[rank] : -1;
  RowSlots<G, 1, TV> rs;
  rs.start(vals, cols, counts, row, rmax, p);
  if constexpr (G == WARP)
    walk_light(rs, y, out, row, (u / groups) * LIGHT_COLS, n, ldo, p);
  else
    walk_strip<G, 1, G>(rs, y, out, row, 0, n, ldo, p);
}

template <int G, typename TV>
cudaError_t launch(const void* vals, const int* cols, const int* counts,
                   const void* y, const int* order, float* out,
                   const int* run, int m, int rmax, int n, long ldo, int hub,
                   int heavy, int hstrips, int strips, int per_cta, int ctas,
                   cudaStream_t s) {
  if (hub > 0 && per_cta * WARP != HUB_THREADS) return cudaErrorInvalidValue;
  csr_spmm_kernel<G, TV><<<ctas, per_cta * WARP, 0, s>>>(
      static_cast<const TV*>(vals), cols, counts, static_cast<const TV*>(y),
      order, out, run, m, rmax, n, ldo, hub, heavy, hstrips, strips);
  return cudaGetLastError();
}

template <typename TV>
cudaError_t launch_route(int group, const void* vals, const int* cols,
                         const int* counts, const void* y, const int* order,
                         float* out, const int* run, int m, int rmax, int n,
                         long ldo, int hub, int heavy, int hstrips,
                         int strips, int per_cta, int ctas, cudaStream_t s) {
  if (group == 16)
    return launch<16, TV>(vals, cols, counts, y, order, out, run, m, rmax, n,
                          ldo, hub, heavy, hstrips, strips, per_cta, ctas, s);
  if (group == WARP)
    return launch<WARP, TV>(vals, cols, counts, y, order, out, run, m, rmax,
                            n, ldo, hub, heavy, hstrips, strips, per_cta,
                            ctas, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// vals/cols (m, rmax), counts (m,) true per-row counts (capped here), y
// (k, n) row-major, all of vals and y float32 (bf16 = 0) or bf16 (bf16 =
// 1); out float32 rows of stride ldo (only [:m, :n] is written); order (m,)
// int32 scratch.  The launch shape (group, hub rows, heavy rows and their
// strips, light strips, warps per CTA, CTAs) comes from
// csr_spmm.csr_launch.
extern "C" int rt_csr_spmm(const void* vals, const int* cols,
                           const int* counts, const void* y, float* out,
                           int* order, const int* run, int bf16, int m,
                           int rmax, int n, long ldo, int group, int hub,
                           int heavy, int hstrips, int strips, int per_cta,
                           int ctas, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  csr_row_order_kernel<<<1, ORDER_THREADS, 0, s>>>(counts, m, rmax, run,
                                                   order);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = bf16 ? launch_route<__nv_bfloat16>(group, vals, cols, counts, y,
                                          order, out, run, m, rmax, n, ldo,
                                          hub, heavy, hstrips, strips,
                                          per_cta, ctas, s)
           : launch_route<float>(group, vals, cols, counts, y, order, out,
                                 run, m, rmax, n, ldo, hub, heavy, hstrips,
                                 strips, per_cta, ctas, s);
  return (int)e;
}
