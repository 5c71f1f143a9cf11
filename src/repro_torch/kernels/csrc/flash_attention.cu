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
// * float32 (checks and tests at 3e-4, which P in bf16 would not meet),
//   rt_flash_attention_f32, the first version on the FP32 FMA units: a
//   CTA of 256 threads owns BQ = 256 / G query rows; a group of G = D / 16
//   neighbouring lanes shares one query row, lane g holding dims g, g + G,
//   ... (16 of them) of q and of the float32 accumulator, so a score is 16
//   FMAs per lane and a butterfly of log2(G) shuffles; K and V stream
//   through shared memory in tiles of BK = 256 / G keys, widened to
//   float32; every 16 keys m, l and acc are rescaled once.
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

constexpr int THREADS = 256;
constexpr int PER_LANE = 16;   // head dims per lane
constexpr int CHUNK = 16;      // keys per online-softmax rescale
constexpr float NEG = -1e30f;

template <int G>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int H,
             int rep, int Sq, int Skv, int bq, int bk, int causal,
             float scale) {
  constexpr int D = PER_LANE * G;
  constexpr int BQ = THREADS / G;
  constexpr int BK = THREADS / G;
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = b * (H / rep) + h / rep;
  const int g = threadIdx.x % G;
  const int row0 = blockIdx.x * BQ;
  const int row = row0 + threadIdx.x / G;
  const int off = Skv - Sq;   // queries aligned to the end of the kv

  // keys [0, L(r)) of row r are processed (the reference's block skip)
  auto limit = [&](int r) -> int {
    if (!causal) return Skv;
    const int q_end = (r / bq + 1) * bq - 1 + off;
    if (q_end < 0) return 0;
    return min(Skv, (q_end / bk + 1) * bk);
  };
  const int my_limit = row < Sq ? limit(row) : 0;
  const int cta_limit = limit(min(row0 + BQ, Sq) - 1);
  const int qpos = row + off;

  const float* qrow = q + ((long)bh * Sq + min(row, Sq - 1)) * D;
  const float* kb = k + (long)kvh * Skv * D;
  const float* vb = v + (long)kvh * Skv * D;
  float qr[PER_LANE], acc[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    qr[i] = qrow[g + G * i];
    acc[i] = 0.f;
  }
  float m = NEG, l = 0.f;

  for (int t0 = 0; t0 < cta_limit; t0 += BK) {
    __syncthreads();
    for (int e = threadIdx.x; e < BK * D; e += THREADS) {
      const int kk = t0 + e / D;
      const bool in = kk < Skv;
      ks[e / D][e % D] = in ? kb[(long)kk * D + e % D] : 0.f;
      vs[e / D][e % D] = in ? vb[(long)kk * D + e % D] : 0.f;
    }
    __syncthreads();
    for (int c0 = 0; c0 < BK && t0 + c0 < cta_limit; c0 += CHUNK) {
      float s[CHUNK];
      float m_cur = -INFINITY;
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < PER_LANE; ++i)
          part = fmaf(qr[i], ks[c0 + c][g + G * i], part);
#pragma unroll
        for (int w = G / 2; w > 0; w /= 2)
          part += __shfl_xor_sync(0xffffffffu, part, w);
        const int kpos = t0 + c0 + c;
        float sc = part * scale;
        if (kpos >= my_limit) sc = -INFINITY;         // never processed
        else if (causal && kpos > qpos) sc = NEG;     // masked
        s[c] = sc;
        m_cur = fmaxf(m_cur, sc);
      }
      const float m_new = fmaxf(m, m_cur);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        s[c] = expf(s[c] - m_new);
        psum += s[c];
      }
      l = alpha * l + psum;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        float pv = 0.f;
#pragma unroll
        for (int c = 0; c < CHUNK; ++c)
          pv = fmaf(s[c], vs[c0 + c][g + G * i], pv);
        acc[i] = alpha * acc[i] + pv;
      }
      m = m_new;
    }
  }
  if (row < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* orow = o + ((long)bh * Sq + row) * D;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      orow[g + G * i] = acc[i] * inv;
  }
}

template <int G>
int launch_f32(const float* q, const float* k, const float* v, float* o,
               int B, int H, int Hkv, int Sq, int Skv, int bq, int bk,
               int causal, float scale, cudaStream_t stream) {
  constexpr int BQ = THREADS / G;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_kernel<G><<<grid, THREADS, 0, stream>>>(
      q, k, v, o, H, H / Hkv, Sq, Skv, bq, bk, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 --

constexpr int FQ = 64;         // query rows per CTA, 16 per warp
constexpr int FK = 64;         // keys per shared-memory tile
constexpr int F_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

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

// q, o (B, H, Sq, D); k, v (B, Hkv, Skv, D); contiguous float32.  D in
// {16, 32, 64, 128}; H % Hkv == 0; Sq % bq == 0 and Skv % bk == 0 (the
// wrapper front-pads).
extern "C" int rt_flash_attention_f32(const float* q, const float* k,
                                      const float* v, float* o, int B, int H,
                                      int Hkv, int Sq, int Skv, int D, int bq,
                                      int bk, int causal, float scale,
                                      void* stream) {
  if (bad_args(B, H, Hkv, bq, bk)) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Sq <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_f32<1>(q, k, v, o, B, H, Hkv, Sq, Skv, bq, bk, causal, scale, s);
    case 32: return launch_f32<2>(q, k, v, o, B, H, Hkv, Sq, Skv, bq, bk, causal, scale, s);
    case 64: return launch_f32<4>(q, k, v, o, B, H, Hkv, Sq, Skv, bq, bk, causal, scale, s);
    case 128: return launch_f32<8>(q, k, v, o, B, H, Hkv, Sq, Skv, bq, bk, causal, scale, s);
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
