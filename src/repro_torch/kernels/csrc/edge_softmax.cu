// Masked edge-softmax of GAT's attention kernel, thresholded, with the
// block counts of its output:
//
//   s      = z @ [att_src | att_dst]                       (n, 2)
//   score  = LeakyReLU(s[i, 0] + s[j, 1], slope)
//   alpha  = softmax of score over row i's support (a != 0), else 0
//   out    = alpha > threshold ? alpha : 0, stored as promote_types(a, z)
//   counts = nonzeros of out per (bm, bn) tile, ragged edge tiles included
//
// Replaces the jnp body of attention_adjacency,
// src/repro/core/dynasparse.py:311 (:353-375, the block counts of
// profiler.block_counts included); the reference has no Pallas kernel for
// it.  Rows with no support (bucket padding) take row_max := 0 and denom
// := max(sum, 1e-30), so they come out exactly zero, not NaN.
//
// Bound on the H100: bytes -- a read once and out written once (4 + 4
// bytes an element in float32: 88.6 MB at n = 3327, 0.026 ms at 3.35
// TB/s; a bf16 a or out halves its share), the counts 4 bytes a tile.
//
// Design:
//
// * project_kernel: one thread per row computes its two projections, each
//   one fmaf chain over f ascending, so alpha's rounding does not depend on
//   a library matmul or on the TF32 setting.  The main kernel is launched
//   as its programmatic dependent: it starts while the projections run and
//   waits for them (griddepcontrol.wait) only after pass 1.
// * edge_softmax_kernel: one warp per row, a CTA per (up to 16) rows of
//   one tile row.  Pass 1 reads the row of a once, 32 columns (a chunk)
//   at a time with one coalesced load a lane (rows of 3327 floats are not
//   16-byte aligned), 8 chunks in flight a lane (16 in bf16), and turns
//   each chunk into a support word, __ballot_sync(a != 0).  A chunk whose
//   word is 0 is all zeros in out, so pass 1 writes it at once: out's
//   stores stream beside a's loads instead of after them (at n = 3327 a
//   row has a handful of support entries, so nearly all of out is written
//   there).  The other chunks go to the warp's list in shared memory,
//   (chunk, word) in ascending order, and a is not read again.  Pass 2
//   walks the list 4 chunks a step for the masked max, then for the
//   masked sum of expf(score - max); each step's loads and exps are taken
//   for every lane without branches, so that the 4 overlap.  Pass 3 (the
//   listed chunks of the output rows) is shared by the CTA's warps: every
//   output element is alone, so any warp may write it, and a hub row (one
//   of CiteSeer's has support in all of its 104 chunks) no longer holds
//   the kernel's end alone.  Rows longer than 32768 columns (n / 4 bytes
//   of list a row) keep no list: passes 2 and 3 re-read a, one warp a row
//   (the first design's route), and pass 1 takes the max.
// * s_dst, read at every support entry of the walks, is staged in shared
//   memory once pass 1 is done, up to 16384 columns (64 KB).
// * The rounding is the first design's, bit for bit: each lane walks
//   columns lane, lane + 32, ... ascending, its running sum in that order
//   (a chunk without support adds nothing, so skipping it changes no
//   bit); a fixed xor-shuffle tree (16, 8, 4, 2, 1) combines the lanes;
//   expf and IEEE division, no fast-math intrinsics; the threshold
//   compares with strict '>'.  No atomics in the arithmetic, so the fused
//   and per-kernel engines see bitwise the same alpha.
// * The counts: in pass 3 the warp ballots out != 0 (on the stored value:
//   a float32 denormal may round to 0 in bf16).  The first lane of each
//   tile's segment of the chunk adds the popcount of its segment to the
//   tile row's counter in shared memory (any bn: 16 gives the two halves);
//   the CTA stores the counters, or adds them to the zeroed output with
//   integer atomics when several CTAs share a tile row.  A tile row too
//   wide for shared memory (over 8192 tiles) counts straight into the
//   zeroed output.  Integer sums do not depend on order: the counts are
//   exact and deterministic.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int MAX_WARPS = 16;      // rows per CTA at most, one warp each
constexpr int PROJ_THREADS = 256;
constexpr int BATCH = 4;           // listed chunks a walk step takes
constexpr unsigned FULL = 0xffffffffu;

enum Route { LIST = 0, REREAD = 1 };

struct Args {
  const void* a;
  long lda;
  const float* s_src;
  const float* s_dst;
  void* out;
  int* counts;          // (ceil(n / bm), nb) int32
  int n, bm, bn, nb;
  int rows;             // rows per CTA, within one tile row
  int chunks;           // CTAs per tile row
  int stage_dst, smem_counts;
  float slope, threshold;
};

template <typename TZ>
__global__ void project_kernel(const TZ* __restrict__ z,
                               const float* __restrict__ att_src,
                               const float* __restrict__ att_dst,
                               float* __restrict__ s_src,
                               float* __restrict__ s_dst, int n, int f) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const TZ* zi = z + (long)i * f;
  float p = 0.f, q = 0.f;
  for (int k = 0; k < f; ++k) {
    const float v = rt::to_f32(zi[k]);
    p = fmaf(v, att_src[k], p);
    q = fmaf(v, att_dst[k], q);
  }
  s_src[i] = p;
  s_dst[i] = q;
}

__device__ __forceinline__ float leaky(float e, float slope) {
  return e >= 0.f ? e : slope * e;
}

template <typename TO> __device__ __forceinline__ TO from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A listed row's state for the CTA's shared pass 3.
struct RowState {
  float si, mx, denom;
  int m;                // listed chunks
};

// Up to BATCH chunks with support, in ascending order: chunk c[b] (-1 for
// none) and its word w[b] (0 for none), the same in every lane.
struct Batch {
  int c[BATCH];
  unsigned w[BATCH];
};

__device__ __forceinline__ Batch empty_batch() {
  Batch bt;
#pragma unroll
  for (int b = 0; b < BATCH; ++b) {
    bt.c[b] = -1;
    bt.w[b] = 0u;
  }
  return bt;
}

// Pass 1 over chunks [c0, c0 + U) of a row: one load a lane a chunk, all U
// issued before the first ballot.  A chunk without support is all zeros
// in out, written here so that out's stores stream beside a's loads; a
// chunk with support is appended to the list (LIST) or gives the masked
// max (REREAD, which keeps no list and would read a again for it).
template <int ROUTE, int U, typename TA, typename TO>
__device__ __forceinline__ void pass1(const TA* __restrict__ ai,
                                      TO* __restrict__ oi, int n, int c0,
                                      int nchunks, int lane, int2* list,
                                      int& m, const float* sdst, float si,
                                      float slope, float& mx) {
  float v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = (c0 + u) * 32 + lane;
    v[u] = j < n ? rt::to_f32(ai[j]) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = c0 + u, j = c * 32 + lane;
    if (c >= nchunks) break;                // warp-uniform
    const unsigned w = __ballot_sync(FULL, v[u] != 0.f);
    if (w == 0u) {
      if (j < n) oi[j] = from_f32<TO>(0.f);
    } else if constexpr (ROUTE == LIST) {
      if (lane == 0) list[m] = make_int2(c, (int)w);
      ++m;
    } else if (v[u] != 0.f) {
      mx = fmaxf(mx, leaky(si + sdst[j], slope));
    }
  }
}

// body(batch) over the chunks of a row with support, in ascending order,
// BATCH at a time: from the list, or (REREAD) from a read again.
template <int ROUTE, typename TA, typename F>
__device__ __forceinline__ void walk(const int2* list, int m, const TA* ai,
                                     int n, int nchunks, int lane,
                                     F&& body) {
  if constexpr (ROUTE == LIST) {
    for (int t0 = 0; t0 < m; t0 += BATCH) {
      Batch bt;
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int2 e = t0 + b < m ? list[t0 + b] : make_int2(-1, 0);
        bt.c[b] = e.x;
        bt.w[b] = (unsigned)e.y;
      }
      body(bt);
    }
  } else {
    Batch bt = empty_batch();
    int k = 0;
    for (int c = 0; c < nchunks; ++c) {
      const int j = c * 32 + lane;
      const unsigned w =
          __ballot_sync(FULL, j < n && rt::to_f32(ai[j]) != 0.f);
      if (w == 0u) continue;
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        bt.c[b] = b == k ? c : bt.c[b];
        bt.w[b] = b == k ? w : bt.w[b];
      }
      if (++k == BATCH) {
        body(bt);
        bt = empty_batch();
        k = 0;
      }
    }
    if (k) body(bt);
  }
}

// The first lane of each tile's segment of the chunk at column j - lane
// adds the segment's nonzeros (bits of b) to the tile row's counter: in
// shared memory (cnt_sh) or, when it does not fit, in device memory
// (cnt_g).  shift is log2(bn) when bn is a power of two, else -1.
__device__ __forceinline__ void add_counts(int* cnt_sh, int* cnt_g,
                                           bool smem, unsigned b, int j,
                                           int lane, int n, int bn,
                                           int shift) {
  const int t = shift >= 0 ? j >> shift : j / bn;
  const int off = j - t * bn;
  if (j < n && (lane == 0 || off == 0)) {
    const int len = min(bn - off, 32 - lane);
    const unsigned seg = (len >= 32 ? FULL : (1u << len) - 1u) << lane;
    const int k = __popc(b & seg);
    if (k) {
      if (smem)
        atomicAdd(&cnt_sh[t], k);
      else
        atomicAdd(&cnt_g[t], k);
    }
  }
}

template <typename TA, typename TO, int ROUTE>
__global__ void __launch_bounds__(MAX_WARPS * 32)
edge_softmax_kernel(const Args p) {
  constexpr int U = 32 / sizeof(TA);        // chunks in flight a lane
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = p.n, nchunks = (n + 31) >> 5, bn = p.bn;
  const int shift = (bn & (bn - 1)) ? -1 : __ffs(bn) - 1;
  const float slope = p.slope, threshold = p.threshold;
  const int ti = blockIdx.x / p.chunks;     // tile row
  const int r0 = ti * p.bm + (blockIdx.x % p.chunks) * p.rows;
  const int r1 = min(min(r0 + p.rows, (ti + 1) * p.bm), n);

  // shared memory: [lists: nchunks int2 a warp][row states: one a warp]
  // [s_dst: n floats][counts: nb ints]
  const int nw = blockDim.x >> 5;
  int2* lists = reinterpret_cast<int2*>(smem);
  int2* list = lists + (size_t)warp * nchunks;
  RowState* rows_sh =
      reinterpret_cast<RowState*>(lists + (size_t)nw * nchunks);
  size_t off = ROUTE == LIST ? (size_t)nw * (nchunks * sizeof(int2) +
                                             sizeof(RowState))
                             : 0;
  float* sd_sh = reinterpret_cast<float*>(smem + off);
  off += p.stage_dst ? (size_t)n * sizeof(float) : 0;
  int* cnt_sh = reinterpret_cast<int*>(smem + off);
  int* cnt_g = p.counts + (long)ti * p.nb;
  if (p.smem_counts)
    for (int t = threadIdx.x; t < p.nb; t += blockDim.x) cnt_sh[t] = 0;

  // one row a warp; a warp past the tile row's last row only helps stage
  const int i = r0 + warp;
  const bool live = i < r1;
  const TA* ai = static_cast<const TA*>(p.a) + (long)i * p.lda;
  TO* oi = static_cast<TO*>(p.out) + (long)i * n;
  float mx = __int_as_float(0xff800000);    // -inf
  int m = 0;                                // listed chunks

  // The projections come from project_kernel, launched just before this
  // grid, which may start while it runs (programmatic dependent launch):
  // pass 1 needs none of them, except on the re-read route.
  if constexpr (ROUTE == REREAD)
    asm volatile("griddepcontrol.wait;" ::: "memory");
  const float si_early = ROUTE == REREAD && live ? p.s_src[i] : 0.f;

  // pass 1: read the row once; zeros where no support, the rest listed
  if (live)
    for (int c0 = 0; c0 < nchunks; c0 += U)
      pass1<ROUTE, U>(ai, oi, n, c0, nchunks, lane, list, m, p.s_dst,
                      si_early, slope, mx);
  if constexpr (ROUTE == LIST)
    asm volatile("griddepcontrol.wait;" ::: "memory");
  if (p.stage_dst) {
    for (int j0 = threadIdx.x; j0 < n; j0 += 8 * blockDim.x) {
      float v[8];                           // 8 loads in flight a thread
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = j0 + u * blockDim.x;
        v[u] = j < n ? p.s_dst[j] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = j0 + u * blockDim.x;
        if (j < n) sd_sh[j] = v[u];
      }
    }
  }
  __syncthreads();                          // also publishes the lists
  const float* sd = p.stage_dst ? sd_sh : p.s_dst;

  if (live) {
    const float si = p.s_src[i];
    // every lane's score in chunk c (clamped, for the batches' empty
    // slots and the columns past n: their bits are 0)
    auto score = [&](int c) {
      return leaky(si + sd[min(max(c, 0) * 32 + lane, n - 1)], slope);
    };
    // pass 2: the masked max (on the re-read route, from pass 1), then
    // the masked sum, lane by lane in column order, each combined by the
    // tree
    if constexpr (ROUTE == LIST) {
      walk<ROUTE>(list, m, ai, n, nchunks, lane, [&](const Batch& bt) {
        float x[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b) x[b] = score(bt.c[b]);
#pragma unroll
        for (int b = 0; b < BATCH; ++b)
          if ((bt.w[b] >> lane) & 1u) mx = fmaxf(mx, x[b]);
      });
    }
    for (int d = 16; d; d >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, d));
    if (!isfinite(mx)) mx = 0.f;            // no support: 0, as the reference
    float sum = 0.f;
    walk<ROUTE>(list, m, ai, n, nchunks, lane, [&](const Batch& bt) {
      float e[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) e[b] = expf(score(bt.c[b]) - mx);
#pragma unroll
      for (int b = 0; b < BATCH; ++b)
        if ((bt.w[b] >> lane) & 1u) sum += e[b];
    });
    for (int d = 16; d; d >>= 1) sum += __shfl_xor_sync(FULL, sum, d);
    const float denom = fmaxf(sum, 1e-30f);

    if constexpr (ROUTE == LIST) {
      if (lane == 0) rows_sh[warp] = RowState{si, mx, denom, m};
    } else {
      // pass 3 (re-read route): the chunks with support, thresholded, and
      // their tile counts
      walk<ROUTE>(list, m, ai, n, nchunks, lane, [&](const Batch& bt) {
        TO o[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          const float q = expf(score(bt.c[b]) - mx) / denom;
          const float al = (bt.w[b] >> lane) & 1u ? q : 0.f;
          o[b] = from_f32<TO>(al > threshold ? al : 0.f);
        }
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          if (bt.c[b] < 0) break;           // warp-uniform
          const int j = bt.c[b] * 32 + lane;
          if (j < n) oi[j] = o[b];
          const unsigned nz = __ballot_sync(FULL, rt::to_f32(o[b]) != 0.f);
          if (nz)
            add_counts(cnt_sh, cnt_g, p.smem_counts, nz, j, lane, n, bn,
                       shift);
        }
      });
    }
  } else if (ROUTE == LIST && lane == 0) {
    rows_sh[warp] = RowState{0.f, 0.f, 1.f, 0};
  }

  if constexpr (ROUTE == LIST) {
    // pass 3, shared by the CTA's warps (each output element is alone, so
    // any warp may write it): every listed chunk of the CTA's rows,
    // thresholded, and its tile counts.  Task t is entry t - start[r] of
    // row r's list, where start is the scan of the rows' list lengths.
    __syncthreads();                        // the row states
    const int mm = lane < nw ? rows_sh[lane].m : 0;
    int start = mm;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, start, d);
      if (lane >= d) start += y;
    }
    const int total = __shfl_sync(FULL, start, 31);
    start -= mm;                            // lane r: row r's first task
    for (int t0 = warp * BATCH; t0 < total; t0 += nw * BATCH) {
      int r[BATCH], c[BATCH];
      TO o[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int t = min(t0 + b, total - 1);
        r[b] = __popc(__ballot_sync(FULL, lane < nw && start <= t)) - 1;
        const int2 e =
            lists[r[b] * nchunks + t - __shfl_sync(FULL, start, r[b])];
        const RowState rs = rows_sh[r[b]];
        c[b] = e.x;
        const float x =
            leaky(rs.si + sd[min(e.x * 32 + lane, n - 1)], slope);
        const float q = expf(x - rs.mx) / rs.denom;
        const float al = ((unsigned)e.y >> lane) & 1u ? q : 0.f;
        o[b] = from_f32<TO>(al > threshold ? al : 0.f);
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        if (t0 + b >= total) break;         // warp-uniform
        const int j = c[b] * 32 + lane;
        if (j < n)
          static_cast<TO*>(p.out)[(long)(r0 + r[b]) * n + j] = o[b];
        const unsigned nz = __ballot_sync(FULL, rt::to_f32(o[b]) != 0.f);
        if (nz)
          add_counts(cnt_sh, cnt_g, p.smem_counts, nz, j, lane, n, bn,
                     shift);
      }
    }
  }

  if (p.smem_counts) {
    __syncthreads();
    if (p.chunks == 1) {
      for (int t = threadIdx.x; t < p.nb; t += blockDim.x)
        cnt_g[t] = cnt_sh[t];
    } else {
      for (int t = threadIdx.x; t < p.nb; t += blockDim.x)
        if (cnt_sh[t]) atomicAdd(&cnt_g[t], cnt_sh[t]);
    }
  }
}

template <typename TA, typename TO, int ROUTE>
int launch_main(const Args& p, int ctas, int threads, int smem_bytes,
                cudaStream_t st) {
  auto kernel = edge_softmax_kernel<TA, TO, ROUTE>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, p);
}

template <typename TA, typename TO>
int launch_route(int route, const Args& p, int ctas, int threads,
                 int smem_bytes, cudaStream_t st) {
  switch (route) {
    case LIST:
      return launch_main<TA, TO, LIST>(p, ctas, threads, smem_bytes, st);
    case REREAD:
      return launch_main<TA, TO, REREAD>(p, ctas, threads, smem_bytes, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a (n, n) float32 (a_bf16 = 0) or bf16 (1) with row stride lda; z (n, f)
// float32 or bf16 contiguous; att_src, att_dst (f,) float32; s scratch of
// 2n floats; out (n, n) contiguous, bf16 when a and z both are, else
// float32, every element written; counts (ceil(n / bm), ceil(n / bn))
// int32, zeroed by the caller unless smem_counts is set and chunks is 1.
// The launch shape (route, rows, chunks, stage_dst, smem_counts,
// smem_bytes) is the wrapper's (kernels/edge_softmax.py edge_launch).
extern "C" int rt_edge_softmax(const void* a, int a_bf16, long lda,
                               const void* z, int z_bf16,
                               const float* att_src, const float* att_dst,
                               float* s, void* out, int* counts, int n, int f,
                               int bm, int bn, int route, int rows,
                               int chunks, int stage_dst, int smem_counts,
                               int smem_bytes, float slope, float threshold,
                               void* stream) {
  if (n <= 0) return 0;
  if (f < 0 || bm <= 0 || bn <= 0 || rows <= 0 || rows > MAX_WARPS ||
      chunks <= 0 || (chunks - 1) * rows >= bm)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (n + PROJ_THREADS - 1) / PROJ_THREADS;
  if (z_bf16)
    project_kernel<__nv_bfloat16><<<blocks, PROJ_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(z), att_src, att_dst, s, s + n, n,
        f);
  else
    project_kernel<float><<<blocks, PROJ_THREADS, 0, st>>>(
        static_cast<const float*>(z), att_src, att_dst, s, s + n, n, f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int mb = (n + bm - 1) / bm;
  Args p{a, lda, s, s + n, out, counts, n, bm, bn, (n + bn - 1) / bn,
         rows, chunks, stage_dst, smem_counts, slope, threshold};
  const int ctas = mb * chunks, threads = 32 * rows;
  if (!a_bf16)
    return launch_route<float, float>(route, p, ctas, threads, smem_bytes,
                                      st);
  if (!z_bf16)
    return launch_route<__nv_bfloat16, float>(route, p, ctas, threads,
                                              smem_bytes, st);
  return launch_route<__nv_bfloat16, __nv_bfloat16>(route, p, ctas, threads,
                                                    smem_bytes, st);
}
