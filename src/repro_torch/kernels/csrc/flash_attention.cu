// FlashAttention forward: online softmax, the (Sq x Skv) scores never
// stored.
//
// Replaces the Pallas kernel of src/repro/kernels/flash_attention.py:75
// (its pallas_call at :92), which ran a (b*h, q-block, kv-block) grid with
// the running max m, denominator l and accumulator acc in VMEM scratch.
// Here a CTA owns a block of query rows of one (b, h) and loops over the
// kv positions itself (the TPU grid's sequential kv axis becomes the
// loop).  Two routes, chosen by the type:
//
// * bfloat16 (the LM's scoring forward), rt_flash_attention_bf16, on the
//   tensor cores: a FlashAttention-2-style forward.  Bound on the H100:
//   operations (4 * D flops per visible (query, key) pair against the bf16
//   tensor-core rate; q, k, v and o are read or written once).  The design
//   does this about it:
//     - a CTA of 4 warps owns 64 query rows, 16 per warp, whose Q
//       fragments stay in registers for the whole walk;
//     - K and V stream through shared memory as bf16 in tiles of 64 keys,
//       double-buffered with 16-byte cp.async (the next tile loads while
//       this one is multiplied);
//     - S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 in, float32
//       out) from ldmatrix fragments (ldmatrix.trans for V); P is rounded
//       to bf16 for the second product, the row sum l is taken over the
//       float32 P;
//     - the row max, the row sum and O stay in float32 registers; a row's
//       four lanes (a quad) combine their maxima with two shuffles, and
//       their partial sums once at the end;
//     - whole key tiles past the CTA's last processed key are never
//       loaded; only tiles that reach past the first row's unmasked keys
//       are masked element by element;
//     - CTAs start from the last query block, whose causal rows are the
//       longest.
//
// * float32 (checks, tests and float32 configs at 3e-4, which P in bf16
//   would not meet), rt_flash_attention_f32, on the FP32 FMA units.  Bound
//   on the H100: operations (4 * D flops per visible pair against FP32's
//   67 TFLOP/s; llama3.2-1b's 2 x 2048 causal scoring batch: 0.51 ms).
//   The first version gave each query row to D / 16 lanes holding 16 dims
//   each, so every K and V value read from shared memory fed one FMA and
//   shared-memory bandwidth capped it near a quarter of the FMA rate.  The
//   design does this about it:
//     - a CTA of 256 threads owns 128 query rows of one (b, h); S = Q K^T
//       and O += P V are register-tiled products: a thread holds 8 rows x
//       8 keys of S (4 at D = 128) and 8 rows x D / 16 dims of O, and
//       every 16-byte shared load of Q or P feeds 32-64 FMAs;
//     - Q stays in shared memory for the whole walk; K and V tiles of 128
//       keys (64 at D = 128, where the larger tiles do not fit beside Q)
//       stream through it by 16-byte cp.async, each loaded while the
//       other half of the tile is multiplied (K of the next tile during
//       the softmax and P V, V of the next during the next Q K^T);
//     - the online softmax in the log2 domain (exp2f of scores scaled by
//       log2(e) / sqrt(D), as the bf16 route): a row's 16 lanes combine
//       their maxima with four shuffles, rescale O and their partial sums
//       once per tile, and add the partial sums once at the end; only
//       tiles that reach past the CTA's first unmasked key are masked
//       element by element; P stays float32;
//     - whole key tiles past the CTA's last processed key are never
//       loaded; CTAs start from the last query block of every (b, h),
//       whose causal rows are the longest.
//
// Semantics both routes keep from the reference, which the wrapper
// (ops.py) relies on: queries sit at the end of the kv sequence (qpos =
// row + Skv - Sq, Sq a multiple of the reference's bq); a kv block of the
// reference's bk is processed only if it is not strictly in the future of
// the row's whole bq-block, so a row sees exactly the keys the TPU kernel
// fed it, whatever the kernel's own tiles; masked scores are -1e30 and
// unprocessed keys -inf; the running max starts at -1e30, so a row with
// no processed key gives 0 (not exp(-inf - -inf) = NaN) and a row whose
// processed keys are all masked averages them uniformly; the output is
// acc / max(l, 1e-30) in q's type.  GQA: head h reads kv head h / (H /
// Hkv) in place, with no repeated copy of K and V.
#include "common.cuh"
#include "mma.cuh"

namespace {

// ------------------------------------------------------------- float32 --

constexpr int BQ = 128;        // query rows of a CTA, 8 per thread
constexpr int THREADS = 256;   // 16 row groups x 16 lanes
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of the float32 route, in floats, for tiles of BK keys: Q
// and K with rows padded by 16 bytes (the 16 key rows a half-warp reads at
// once hit distinct banks), V as stored, P of the current tile (rows
// padded by 64 bytes: the two rows a warp writes hit distinct banks).
template <int D, int BK>
struct F32Smem {
  static constexpr int QS = D + 4;   // Q and K row stride
  static constexpr int PS = BK + 16;   // P row stride
  static constexpr int Q = BQ * QS, K = BK * QS, V = BK * D, P = BQ * PS;
  static constexpr int BYTES = (Q + K + V + P) * 4;
};

// Dim c (0 .. D/16 - 1) of a thread's O columns: 4 neighbouring dims per
// 16-byte load, lanes on neighbouring 16 bytes.
template <int D>
__device__ __forceinline__ int o_dim(int tx, int c) {
  constexpr int DP = D / 16;
  if constexpr (DP >= 4) return (c / 4) * 64 + tx * 4 + c % 4;
  else return tx * DP + c;
}

template <int D>
__device__ __forceinline__ void v_row(float (&v)[D / 16],
                                      const float* row, int tx) {
  constexpr int DP = D / 16;
  if constexpr (DP >= 4) {
#pragma unroll
    for (int c4 = 0; c4 < DP / 4; ++c4) {
      const float4 t = *reinterpret_cast<const float4*>(row + c4 * 64 + tx * 4);
      v[4 * c4] = t.x;
      v[4 * c4 + 1] = t.y;
      v[4 * c4 + 2] = t.z;
      v[4 * c4 + 3] = t.w;
    }
  } else if constexpr (DP == 2) {
    const float2 t = *reinterpret_cast<const float2*>(row + tx * 2);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = row[tx];
  }
}

__device__ __forceinline__ float lane4(const float4& v, int kk) {
  return kk == 0 ? v.x : kk == 1 ? v.y : kk == 2 ? v.z : v.w;
}

// CTA c owns query rows [row0, row0 + BQ) of (b, h) = bh: the last query
// block of every (b, h) first, then the one before (the longest causal
// rows run first; kernels/flash_attention.py flash_launch_f32).  Thread
// (ty, tx) holds rows ty + 16 i (i < 8): their scores against keys tx +
// 16 j (j < BK / 16) of the tile and their O columns o_dim(tx, c).
template <int D, int BK>
__global__ void __launch_bounds__(THREADS, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int BH,
                 int H, int rep, int Sq, int Skv, int bq, int bk, int causal,
                 float scale_log2, int nq) {
  using SM = F32Smem<D, BK>;
  constexpr int QS = SM::QS, PS = SM::PS, DP = D / 16, CH = D / 4;
  constexpr int KPT = BK / 16;   // keys of a thread; CH: 16-byte chunks
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + SM::Q;
  float* vs = ks + SM::K;
  float* ps = vs + SM::V;

  const int cta = blockIdx.x;
  const int bh = cta % BH;
  const int row0 = (nq - 1 - cta / BH) * BQ;
  const int b = bh / H, h = bh % H;
  const int kvh = b * (H / rep) + h / rep;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int off = Skv - Sq;   // queries aligned to the end of the kv

  // keys [0, L(r)) of row r are processed (the reference's block skip)
  auto limit = [&](int r) -> int {
    if (!causal) return Skv;
    const int q_end = (r / bq + 1) * bq - 1 + off;
    if (q_end < 0) return 0;
    return min(Skv, (q_end / bk + 1) * bk);
  };
  const int cta_limit = limit(min(row0 + BQ, Sq) - 1);   // L nondecreasing
  const int tiles = (cta_limit + BK - 1) / BK;
  // keys below `clean` are processed and visible for every real row
  int clean = limit(row0);
  if (causal) clean = min(clean, row0 + off + 1);
  int lim[8], qpos[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + ty + 16 * i;
    lim[i] = r < Sq ? limit(r) : 0;
    qpos[i] = r + off;
  }

  const float* qb = q + (long)bh * Sq * D;
  const float* kb = k + (long)kvh * Skv * D;
  const float* vb = v + (long)kvh * Skv * D;
  auto load_kv = [&](float* dst, const float* src, int stride, int t0) {
    for (int c = tid; c < BK * CH; c += THREADS) {
      const int r = c / CH, cc = c % CH, key = t0 + r;
      rt::cp_async16(dst + r * stride + cc * 4,
                     src + (long)min(key, Skv - 1) * D + cc * 4, key < Skv);
    }
  };

  float oacc[8][DP], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DP; ++c) oacc[i][c] = 0.f;
  }

  if (tiles > 0) {
    for (int c = tid; c < BQ * CH; c += THREADS) {
      const int r = c / CH, cc = c % CH, row = row0 + r;
      rt::cp_async16(qs + r * QS + cc * 4,
                     qb + (long)min(row, Sq - 1) * D + cc * 4, row < Sq);
    }
    load_kv(ks, kb, QS, 0);
  }
  rt::cp_async_commit();   // Q and K of tile 0
  if (tiles > 0) load_kv(vs, vb, D, 0);
  rt::cp_async_commit();   // V of tile 0

  for (int t = 0; t < tiles; ++t) {
    const int t0 = t * BK;
    rt::cp_async_wait<1>();
    __syncthreads();   // K of tile t (and Q) landed
    // S = Q K^T: 8 rows x KPT keys, 4 dims per 16-byte load
    float s[8][KPT];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      float4 qf[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        qf[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * QS +
                                                 d4 * 4);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float4 kf = *reinterpret_cast<const float4*>(
            ks + (tx + 16 * j) * QS + d4 * 4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            s[i][j] = fmaf(lane4(qf[i], kk), lane4(kf, kk), s[i][j]);
      }
    }
    __syncthreads();   // every thread is done with K
    if (t + 1 < tiles) load_kv(ks, kb, QS, t0 + BK);
    rt::cp_async_commit();

    // scale (log2 domain), mask (only tiles that reach past `clean`),
    // online softmax (a row's 16 lanes share its max), P
    const bool edge = t0 + BK > clean;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        float x = s[i][j] * scale_log2;
        if (edge) {
          const int key = t0 + tx + 16 * j;
          if (key >= lim[i]) x = -INFINITY;              // never processed
          else if (causal && key > qpos[i]) x = NEG;     // masked
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 1; w < 16; w *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mn = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - mn);
      m[i] = mn;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[i][j] = exp2f(s[i][j] - mn);
        psum += s[i][j];
        ps[(ty + 16 * i) * PS + tx + 16 * j] = s[i][j];
      }
      l[i] = alpha * l[i] + psum;
#pragma unroll
      for (int c = 0; c < DP; ++c) oacc[i][c] *= alpha;
    }
    rt::cp_async_wait<1>();
    __syncthreads();   // V of tile t landed; P written

    // O += P V: 4 keys of P per 16-byte load
#pragma unroll 2
    for (int k4 = 0; k4 < BK / 4; ++k4) {
      float4 pf[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pf[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * PS +
                                                 k4 * 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float vv[DP];
        v_row<D>(vv, vs + (k4 * 4 + kk) * D, tx);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < DP; ++c)
            oacc[i][c] = fmaf(lane4(pf[i], kk), vv[c], oacc[i][c]);
      }
    }
    __syncthreads();   // every thread is done with V and P
    if (t + 1 < tiles) load_kv(vs, vb, D, t0 + BK);
    rt::cp_async_commit();
  }
  rt::cp_async_wait<0>();

  float* ob = o + (long)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float li = l[i];
#pragma unroll
    for (int w = 1; w < 16; w *= 2)
      li += __shfl_xor_sync(0xffffffffu, li, w);
    const int r = row0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    float* orow = ob + (long)r * D;
    if constexpr (DP >= 4) {
#pragma unroll
      for (int c4 = 0; c4 < DP / 4; ++c4)
        *reinterpret_cast<float4*>(orow + o_dim<D>(tx, 4 * c4)) =
            make_float4(oacc[i][4 * c4] * inv, oacc[i][4 * c4 + 1] * inv,
                        oacc[i][4 * c4 + 2] * inv, oacc[i][4 * c4 + 3] * inv);
    } else {
#pragma unroll
      for (int c = 0; c < DP; ++c) orow[o_dim<D>(tx, c)] = oacc[i][c] * inv;
    }
  }
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v, float* o,
               int B, int H, int Hkv, int Sq, int Skv, int bq, int bk,
               int causal, float scale, int nq, cudaStream_t stream) {
  constexpr int BK = D <= 64 ? 128 : 64;       // keys of a tile
  constexpr int smem = F32Smem<D, BK>::BYTES;
  auto kernel = flash_f32_kernel<D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nq * B * H, THREADS, smem, stream>>>(
      q, k, v, o, B * H, H, H / Hkv, Sq, Skv, bq, bk, causal, scale * LOG2E,
      nq);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 --

constexpr int FQ = 64;         // query rows per CTA, 16 per warp
constexpr int FK = 64;         // keys per shared-memory tile
constexpr int F_THREADS = 128;

template <int D>
constexpr int flash_smem_bytes() {
  return (FQ + 4 * FK) * (D + 8) * 2;   // Q, then 2 stages of K and of V
}

template <int D>
__global__ void __launch_bounds__(F_THREADS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int H, int rep, int Sq,
                 int Skv, int bq, int bk, int causal, float scale_log2) {
  constexpr int DS = D + 8;      // shared row stride: ldmatrix rows in
                                 // distinct banks
  constexpr int DT = D / 16;     // 16-wide head-dim slices
  constexpr int NT = FK / 8;     // 8-key score tiles per warp row block
  extern __shared__ __align__(16) unsigned char smem[];
  auto qs = reinterpret_cast<__nv_bfloat16 (*)[DS]>(smem);
  auto ks = reinterpret_cast<__nv_bfloat16 (*)[FK][DS]>(smem + FQ * DS * 2);
  auto vs = reinterpret_cast<__nv_bfloat16 (*)[FK][DS]>(
      smem + (FQ + 2 * FK) * DS * 2);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = b * (H / rep) + h / rep;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * FQ;
  const int off = Skv - Sq;   // queries aligned to the end of the kv
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;

  // keys [0, L(r)) of row r are processed (the reference's block skip)
  auto limit = [&](int r) -> int {
    if (!causal) return Skv;
    const int q_end = (r / bq + 1) * bq - 1 + off;
    if (q_end < 0) return 0;
    return min(Skv, (q_end / bk + 1) * bk);
  };
  const int last = min(row0 + FQ, Sq) - 1;
  const int cta_limit = limit(last);        // L is nondecreasing in r
  // keys below `clean` are processed and visible for every real row
  int clean = limit(row0);
  if (causal) clean = min(clean, row0 + off + 1);
  const int tiles = (cta_limit + FK - 1) / FK;

  // this thread's two rows of each score / output fragment
  const int ra = row0 + warp * 16 + g, rb = ra + 8;
  const int lim_a = ra < Sq ? limit(ra) : 0;
  const int lim_b = rb < Sq ? limit(rb) : 0;
  const int qpos_a = ra + off, qpos_b = rb + off;

  const __nv_bfloat16* qb = q + (long)bh * Sq * D;
  const __nv_bfloat16* kb = k + (long)kvh * Skv * D;
  const __nv_bfloat16* vb = v + (long)kvh * Skv * D;
  constexpr int CH = D / 8;      // 16-byte chunks per row

  auto load_kv = [&](int slot, int t0) {
    for (int c = threadIdx.x; c < FK * CH; c += F_THREADS) {
      const int r = c / CH, cc = c % CH;
      const int key = t0 + r;
      const long src = (long)min(key, Skv - 1) * D + cc * 8;
      rt::cp_async16(&ks[slot][r][cc * 8], kb + src, key < Skv);
      rt::cp_async16(&vs[slot][r][cc * 8], vb + src, key < Skv);
    }
  };

  float oacc[2 * DT][4];
#pragma unroll
  for (int n = 0; n < 2 * DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m_a = -1e30f, m_b = -1e30f, l_a = 0.f, l_b = 0.f;
  uint32_t qf[DT][4];

  if (tiles > 0) {
    for (int c = threadIdx.x; c < FQ * CH; c += F_THREADS) {
      const int r = c / CH, cc = c % CH;
      const int row = row0 + r;
      rt::cp_async16(&qs[r][cc * 8],
                     qb + (long)min(row, Sq - 1) * D + cc * 8, row < Sq);
    }
    load_kv(0, 0);
  }
  rt::cp_async_commit();

  for (int t = 0; t < tiles; ++t) {
    const int slot = t & 1, t0 = t * FK;
    if (t + 1 < tiles) load_kv(slot ^ 1, t0 + FK);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();
    __syncthreads();               // tile t (and Q) landed for all warps
    if (t == 0) {
#pragma unroll
      for (int d = 0; d < DT; ++d)
        rt::ldmatrix_x4(qf[d], &qs[warp * 16 + lane % 16]
                                  [d * 16 + (lane / 16) * 8]);
    }

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int nb = 0; nb < FK / 16; ++nb) {
        uint32_t kf[4];
        rt::ldmatrix_x4(kf, &ks[slot][nb * 16 + (lane / 16) * 8 + lane % 8]
                                 [d * 16 + ((lane / 8) % 2) * 8]);
        rt::mma_bf16(s[2 * nb], qf[d], kf[0], kf[1]);
        rt::mma_bf16(s[2 * nb + 1], qf[d], kf[2], kf[3]);
      }

    // scale (log2 domain), mask, row max
    const bool edge = t0 + FK > clean;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int key = t0 + n * 8 + 2 * qd + (e & 1);
          const int lim = e < 2 ? lim_a : lim_b;
          const int qpos = e < 2 ? qpos_a : qpos_b;
          if (key >= lim) x = -INFINITY;             // never processed
          else if (causal && key > qpos) x = -1e30f;  // masked
        }
        s[n][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
#pragma unroll
    for (int w = 1; w < 4; w *= 2) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, w));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, w));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2f(s[n][0] - mn_a);
      s[n][1] = exp2f(s[n][1] - mn_a);
      s[n][2] = exp2f(s[n][2] - mn_b);
      s[n][3] = exp2f(s[n][3] - mn_b);
      ps_a += s[n][0] + s[n][1];
      ps_b += s[n][2] + s[n][3];
    }
    l_a = al_a * l_a + ps_a;
    l_b = al_b * l_b + ps_b;
#pragma unroll
    for (int n = 0; n < 2 * DT; ++n) {
      oacc[n][0] *= al_a;
      oacc[n][1] *= al_a;
      oacc[n][2] *= al_b;
      oacc[n][3] *= al_b;
    }

    // O += P V, P in bf16 as the A fragment of each 16-key slice
#pragma unroll
    for (int j = 0; j < FK / 16; ++j) {
      const uint32_t pa[4] = {rt::pack_bf16(s[2 * j][0], s[2 * j][1]),
                              rt::pack_bf16(s[2 * j][2], s[2 * j][3]),
                              rt::pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              rt::pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        uint32_t vf[4];
        rt::ldmatrix_x4_trans(vf, &vs[slot][j * 16 + lane % 16]
                                          [d * 16 + (lane / 16) * 8]);
        rt::mma_bf16(oacc[2 * d], pa, vf[0], vf[1]);
        rt::mma_bf16(oacc[2 * d + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();               // all warps done with slot before reuse
  }
  rt::cp_async_wait<0>();

#pragma unroll
  for (int w = 1; w < 4; w *= 2) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, w);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, w);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  __nv_bfloat16* ob = o + (long)bh * Sq * D;
#pragma unroll
  for (int n = 0; n < 2 * DT; ++n) {
    const int c = n * 8 + 2 * qd;
    if (ra < Sq)
      *reinterpret_cast<uint32_t*>(&ob[(long)ra * D + c]) =
          rt::pack_bf16(oacc[n][0] * inv_a, oacc[n][1] * inv_a);
    if (rb < Sq)
      *reinterpret_cast<uint32_t*>(&ob[(long)rb * D + c]) =
          rt::pack_bf16(oacc[n][2] * inv_b, oacc[n][3] * inv_b);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int H, int Hkv, int Sq, int Skv, int bq, int bk, int causal,
                float scale, cudaStream_t stream) {
  constexpr int smem = flash_smem_bytes<D>();
  auto kernel = flash_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + FQ - 1) / FQ, B * H);
  kernel<<<grid, F_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, H / Hkv, Sq, Skv, bq, bk, causal, scale * LOG2E);
  return (int)cudaGetLastError();
}

bool bad_args(int B, int H, int Hkv, int bq, int bk) {
  return B < 0 || H < 0 || Hkv <= 0 || H % Hkv || bq <= 0 || bk <= 0;
}

}  // namespace

// q, o (B, H, Sq, D); k, v (B, Hkv, Skv, D); contiguous float32, 16-byte
// aligned base pointers.  D in {16, 32, 64, 128}; H % Hkv == 0; Sq % bq
// == 0 and Skv % bk == 0 (the wrapper front-pads); query_blocks =
// ceil(Sq / 128), as kernels/flash_attention.py flash_launch_f32 gives it.
extern "C" int rt_flash_attention_f32(const float* q, const float* k,
                                      const float* v, float* o, int B, int H,
                                      int Hkv, int Sq, int Skv, int D, int bq,
                                      int bk, int causal, float scale,
                                      int query_blocks, void* stream) {
  if (bad_args(B, H, Hkv, bq, bk)) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Sq <= 0) return 0;
  if (query_blocks != (Sq + BQ - 1) / BQ) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nq = query_blocks;
  switch (D) {
    case 16: return launch_f32<16>(q, k, v, o, B, H, Hkv, Sq, Skv, bq, bk, causal, scale, nq, s);
    case 32: return launch_f32<32>(q, k, v, o, B, H, Hkv, Sq, Skv, bq, bk, causal, scale, nq, s);
    case 64: return launch_f32<64>(q, k, v, o, B, H, Hkv, Sq, Skv, bq, bk, causal, scale, nq, s);
    case 128: return launch_f32<128>(q, k, v, o, B, H, Hkv, Sq, Skv, bq, bk, causal, scale, nq, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The same shapes in bfloat16, 16-byte aligned base pointers.
extern "C" int rt_flash_attention_bf16(const void* q, const void* k,
                                       const void* v, void* o, int B, int H,
                                       int Hkv, int Sq, int Skv, int D,
                                       int bq, int bk, int causal,
                                       float scale, void* stream) {
  if (bad_args(B, H, Hkv, bq, bk)) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Sq <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_bf16<16>(q, k, v, o, B, H, Hkv, Sq, Skv, bq, bk, causal, scale, s);
    case 32: return launch_bf16<32>(q, k, v, o, B, H, Hkv, Sq, Skv, bq, bk, causal, scale, s);
    case 64: return launch_bf16<64>(q, k, v, o, B, H, Hkv, Sq, Skv, bq, bk, causal, scale, s);
    case 128: return launch_bf16<128>(q, k, v, o, B, H, Hkv, Sq, Skv, bq, bk, causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
