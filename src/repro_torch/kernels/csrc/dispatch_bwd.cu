// The masked dispatch VJP on bf16 grids (kernels/dispatch_bwd.py): dx = g @
// w.T and dw = x.T @ g, each masked per block step by the forward's code
// grid, on the Hopper tensor cores (wgmma) fed by TMA.
//
// Replaces the two launches of the forward kernel (dispatch.cu,
// dispatch_mma_kernel) that the first port of the VJP made per backward,
// over a transposed copy of w or x and a permuted copy of the code grid:
// the reference's gradient of the block walk of
// src/repro/core/dynasparse.py:239 under jax.grad, where a SKIPped step
// (i, j, k) adds nothing to dx[i, k] or dw[k, j].
//
//   nt (dx, m x kd):  dx[i, k] = sum over j with codes[i, j, k] != SKIP of
//                     g[i, j] @ w[k, j].T       (blocks bm x bk, depth bn)
//   tn (dw, kd x n):  dw[k, j] = sum over i with codes[i, j, k] != SKIP of
//                     x[i, k].T @ g[i, j]       (blocks bk x bn, depth bm)
//
// What bounds it: operations.  llama3.2-1b's FFN products at 2048 tokens
// are 68.7 GFLOP each (2 x 2048 x 2048 x 8192), 69 us at the H100's 989
// TFLOP/s in bf16, against 72 MiB at most of operands and result (23 us
// at 3.35 TB/s); a pruned grid only removes operations.  What the design
// does about it:
//   - the tensor cores at their full rate: each consumer warpgroup issues
//     wgmma.m64nNk16 (N = the tile's columns, 256 at the LM's (256, 256,
//     256)) with float32 accumulators in registers, two consumer
//     warpgroups per 128-row tile; setmaxnreg moves the producer's
//     registers to them (232 a thread);
//   - operands read in place by TMA, 128-byte swizzled, into a ring of
//     64-deep stages (3 of 48 KiB at 128 x 256, 4 at the smaller tiles)
//     guarded by full and empty mbarriers; one producer thread keeps the
//     loads in flight.  dx's A is g (row-major, contraction-contiguous)
//     and its B is w itself (each output column is a row of w): both
//     K-major, no transpose.  dw's A is x and its B is g, both
//     contraction-major: MN-major operands that wgmma reads through its
//     transpose bits, so no copy of x.T either;
//   - the walk: a tile lies inside one output block; the producer reads
//     that block's codes (32 at a time, a ballot) and loads only the
//     active contraction blocks; no x flags, no k split, no partials.  A
//     tile with no active block is stored as exact zeros;
//   - persistent CTAs (one per SM) take tiles from a queue in an order
//     that keeps the tiles in flight on shared operand rows and columns
//     (groups of 8 tile rows); the producer loads the next tile while the
//     consumers store this one, and a CTA whose tiles SKIP goes on to
//     more of them;
//   - the epilogue rounds each float32 sum once to bf16 (round to
//     nearest even, as torch's .to rounds), stages it in shared memory in
//     the output's swizzled layout and stores it with TMA, which drops
//     rows and columns past the output (TMA also zero-fills what lies
//     past the operands: ragged widths such as 10944).  Stored from
//     registers, the same result cost about 7 us a tile (measured on an
//     H100 80GB HBM3 at 700 W), a quarter of the 2048-deep tile's time.
//     Float32 sums (the checks' form) are stored from registers.
// The tensor maps are encoded on the host for each call
// (cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point, so nothing links against libcuda) and passed as
// __grid_constant__ parameters.
#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int NT = 0, TN = 1;   // layouts, as dispatch_bwd.LAYOUTS
constexpr int KD = 64;          // contraction depth of a stage (128 bytes)
constexpr int WG = 128;         // threads of a warpgroup
constexpr int CHUNK = 64 * KD * 2;   // one 64 x 64 box: 8 KiB
constexpr int SW = 1024;        // bytes of a 128-byte swizzle atom (8 rows)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Spin until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// One 2-D TMA box of `map` at element coordinates (c0 inner, c1 outer)
// into shared memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1) : "memory");
}

// One 2-D TMA box from shared memory at `src` to `map` at (c0, c1), in
// this thread's bulk group; rows and columns past the tensor are dropped.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The threads of one consumer warpgroup (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(WG) : "memory");
}

// wgmma's shared-memory descriptor of a 128-byte swizzled operand at
// `addr`: leading and stride byte offsets in 16-byte units, layout type 1
// (128B swizzle) in bits 62-63.  K-major: rows of 64 contraction elements
// (128 bytes), 8-row groups `sbo` = 1024 bytes apart (`lbo` unused).
// MN-major: per contraction row 64 MN elements, 8-row groups `sbo` = 1024
// bytes apart, 64-wide MN chunks `lbo` bytes apart.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x N float32, the warpgroup's accumulator fragments) += A (64 x 16)
// @ B (16 x N), both from shared memory through descriptors a and b; TA /
// TB set for MN-major (transposed) operands.  Fragment of thread t: row
// 16 (t / 32) + (t % 32) / 4 (+ 8 for the odd pair), columns 8 c + 2 (t %
// 4) + {0, 1} in d[4 c .. 4 c + 3] (PTX ISA, wgmma's D layout).
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

struct Args {
  const int* codes;
  int* next_tile;           // the tile queue's head, zero at launch
  void* out;
  int out_f32;
  int tma_out;              // bf16 rows of 16-byte multiples: TMA stores
  long rows, cols;          // the output's
  int row_tiles, col_tiles;
  int group;                // tile rows of a group in the tiles' order
  int row_edge, col_edge;   // the output blocks'
  int depth, steps;         // contraction blocks: edge and count
  long rs, cs, ts;          // codes[r * rs + c * cs + t * ts]
};

// Shared memory: a ring of stages (A then B, 64-deep) and, per consumer
// warpgroup, its 64 x BN bf16 result staged for the TMA store as 64 x 64
// boxes; as many stages as fit beside it (3 at 128 x 256, else 4).
template <int BM, int BN>
struct Smem {
  static constexpr int STAGE = (BM + BN) * KD * 2;
  static constexpr int OUT = BM * BN * 2;
  static constexpr int STAGES =
      (232448 - 1024 - 256 - OUT) / STAGE < 4
          ? (232448 - 1024 - 256 - OUT) / STAGE : 4;
  static constexpr int BYTES = STAGES * STAGE + OUT + SW;
  static_assert(STAGES >= 2, "tile too large for the ring");
};

// Whether contraction block t of the output block that holds the tile at
// (row0, col0) is active (its forward step was not SKIPped).
__device__ __forceinline__ bool active(const Args& p, long code0, int t) {
  return t < p.steps && p.codes[code0 + t * p.ts] != rt::SKIP;
}

__device__ __forceinline__ long code_base(const Args& p, int row0, int col0) {
  return (long)(row0 / p.row_edge) * p.rs + (long)(col0 / p.col_edge) * p.cs;
}

// The (row, column) tile of tile index `tile`: groups of p.group tile
// rows, column-major inside a group, so that the tiles in flight at once
// share operand rows and columns in L2 (128 of a 16 x 32 grid: 8 x 16,
// not 4 x 32); kernels/dispatch_bwd.py BwdLaunch.tile_rc.
__device__ __forceinline__ void tile_rc(const Args& p, int tile, int& tr,
                                        int& tc) {
  const int per_group = p.group * p.col_tiles;
  const int first = tile / per_group * p.group;
  const int rows = min(p.row_tiles - first, p.group);
  tr = first + tile % per_group % rows;
  tc = tile % per_group / rows;
}

// Persistent CTAs over a queue of tiles (in tile_rc's order), each BM x
// BN inside one output block: CTA b starts with tile b and takes the next
// one from the queue (an atomic add) once it has issued its loads, so a
// CTA whose tiles SKIP most of their blocks takes more tiles.  Warpgroups
// 0 .. BM/64 - 1 consume (64 rows each), the last one produces: its first
// thread issues every TMA load, running ahead into the next tile while
// the consumers store this one, and passes the tile numbers to the
// consumers through a 2-slot ring (the number `tiles` ends it).
template <int LAYOUT, int BM, int BN>
__global__ void __launch_bounds__((BM / 64 + 1) * WG, 1)
dispatch_bwd_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const __grid_constant__ CUtensorMap map_out,
                    const Args p) {
  constexpr int NC = BM / 64;
  constexpr int A_BYTES = BM * KD * 2;
  constexpr int STAGE = Smem<BM, BN>::STAGE;
  constexpr int STAGES = Smem<BM, BN>::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ __align__(8) uint64_t tile_full[2], tile_empty[2];
  __shared__ int tile_slot[2];
  volatile int* slot = tile_slot;

  const uint32_t base = (smem_u32(smem_raw) + SW - 1) & ~(uint32_t)(SW - 1);
  const int tiles = p.row_tiles * p.col_tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slices = p.depth / KD;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), NC);
    }
    for (int q = 0; q < 2; ++q) {
      mbar_init(smem_u32(&tile_full[q]), 1);
      mbar_init(smem_u32(&tile_empty[q]), NC * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NC * 4) {
    // ---- producer: walk each tile's codes, load the active blocks ----
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != NC * 4) return;
    int stage = 0, phase = 0, q = 0, qphase = 0;
    for (int tile = blockIdx.x;;) {
      if (lane == 0) {   // post the tile to the consumers
        mbar_wait(smem_u32(&tile_empty[q]), qphase ^ 1);
        slot[q] = tile < tiles ? tile : tiles;
        mbar_arrive(smem_u32(&tile_full[q]));
      }
      if (++q == 2) {
        q = 0;
        qphase ^= 1;
      }
      if (tile >= tiles) break;
      int tr, tc;
      tile_rc(p, tile, tr, tc);
      const int row0 = tr * BM, col0 = tc * BN;
      const long code0 = code_base(p, row0, col0);
      for (int t0 = 0; t0 < p.steps; t0 += 32) {
        uint32_t mask = __ballot_sync(0xffffffffu, active(p, code0, t0 + lane));
        while (mask) {
          const int t = t0 + __ffs(mask) - 1;
          mask &= mask - 1;
          for (int s = 0; s < slices; ++s) {
            if (lane == 0) {
              const int kc = t * p.depth + s * KD;
              const uint32_t fb = smem_u32(&full[stage]);
              const uint32_t sa = base + stage * STAGE, sb = sa + A_BYTES;
              mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
              mbar_expect_tx(fb, STAGE);
              if constexpr (LAYOUT == NT) {
                tma_load(sa, &map_a, fb, kc, row0);
                tma_load(sb, &map_b, fb, kc, col0);
              } else {
#pragma unroll
                for (int c = 0; c < BM / 64; ++c)
                  tma_load(sa + c * CHUNK, &map_a, fb, row0 + 64 * c, kc);
#pragma unroll
                for (int c = 0; c < BN / 64; ++c)
                  tma_load(sb + c * CHUNK, &map_b, fb, col0 + 64 * c, kc);
              }
            }
            __syncwarp();
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
      int next = 0;
      if (lane == 0) next = gridDim.x + atomicAdd(p.next_tile, 1);
      tile = __shfl_sync(0xffffffffu, next, 0);
    }
  } else {
    // ---- consumers: 64 rows each, the whole tile's columns ----
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp / 4, t = threadIdx.x % WG;
    const bool pairs = p.cols % 2 == 0;
    int stage = 0, phase = 0, q = 0, qphase = 0;
    float acc[BN / 2];
    for (;;) {
      mbar_wait(smem_u32(&tile_full[q]), qphase);
      const int tile = slot[q];
      mbar_arrive(smem_u32(&tile_empty[q]));
      if (++q == 2) {
        q = 0;
        qphase ^= 1;
      }
      if (tile >= tiles) break;
      int tr, tc;
      tile_rc(p, tile, tr, tc);
      const int row0 = tr * BM, col0 = tc * BN;
      const long code0 = code_base(p, row0, col0);
      int n_active = 0;
      for (int t0 = 0; t0 < p.steps; t0 += 32)
        n_active += __popc(
            __ballot_sync(0xffffffffu, active(p, code0, t0 + lane)));
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int it = 0; it < n_active * slices; ++it) {
        mbar_wait(smem_u32(&full[stage]), phase);
        const uint32_t sa = base + stage * STAGE, sb = sa + A_BYTES;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < KD / 16; ++k) {
          if constexpr (LAYOUT == NT)   // K-major: 16 elements = 32 bytes on
            wgmma<0, 0>(acc, desc(sa + wg * 64 * 128 + k * 32, 16, SW),
                        desc(sb + k * 32, 16, SW));
          else                          // MN-major: 16 rows of 128 bytes on
            wgmma<1, 1>(acc, desc(sa + wg * CHUNK + k * 2048, CHUNK, SW),
                        desc(sb + k * 2048, CHUNK, SW));
        }
        wgmma_commit();
        fence_regs(acc);
        wgmma_wait<1>();    // the previous stage's products are done
        if (prev >= 0 && t == 0) mbar_arrive(smem_u32(&empty[prev]));
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0 && t == 0) mbar_arrive(smem_u32(&empty[prev]));

      if (p.tma_out) {
        // bf16 into this warpgroup's staging boxes, 128-byte swizzled as
        // the output's tensor map reads them (16-byte chunk c ^ row % 8:
        // a warp's stores hit 32 banks), then one TMA store per box.  The
        // previous tile's stores must have read the boxes first.
        const uint32_t stage_out = base + STAGES * STAGE + wg * 64 * BN * 2;
        if (t == 0) bulk_wait_read();
        wg_sync(wg);
        const int g = (t % 32) / 4, row = (t / 32) * 16 + g;
#pragma unroll
        for (int c = 0; c < BN / 8; ++c) {
          const uint32_t at = stage_out + (c / 8) * CHUNK + row * 128 +
                              (((c % 8) ^ g) << 4) + 4 * (t % 4);
          asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(at),
                       "r"(rt::pack_bf16(acc[4 * c], acc[4 * c + 1])));
          asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(at + 8 * 128),
                       "r"(rt::pack_bf16(acc[4 * c + 2], acc[4 * c + 3])));
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wg_sync(wg);
        if (t == 0) {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_store(&map_out, stage_out + c * CHUNK, col0 + 64 * c,
                      row0 + wg * 64);
          bulk_commit();
        }
        continue;
      }
      // float32 sums, or rows the TMA cannot address: stored directly
      const long r = row0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
      auto put = [&](long row, long col, float v0, float v1) {
        if (row >= p.rows || col >= p.cols) return;
        const long at = row * p.cols + col;
        const bool two = col + 1 < p.cols;
        if (p.out_f32) {
          float* o = static_cast<float*>(p.out) + at;
          if (two && pairs) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            if (two) o[1] = v1;
          }
        } else {
          __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + at;
          if (two && pairs) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            o[0] = __float2bfloat16_rn(v0);
            if (two) o[1] = __float2bfloat16_rn(v1);
          }
        }
      };
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const long col = col0 + 8 * c + 2 * (t % 4);
        put(r, col, acc[4 * c], acc[4 * c + 1]);
        put(r + 8, col, acc[4 * c + 2], acc[4 * c + 3]);
      }
    }
    if (p.tma_out && t == 0) bulk_wait();   // before the CTA's smem goes
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix with row stride ld, cut into boxes
// of box_rows x box_cols (box_cols * 2 = 128 bytes: one swizzle row).
bool make_map(CUtensorMap* map, const void* ptr, long rows, long cols,
              long ld, int box_rows, int box_cols) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int LAYOUT, int BM, int BN>
int launch(const void* a, long a_rows, long a_cols, long lda, const void* b,
           long b_rows, long b_cols, long ldb, const Args& p, int ctas,
           cudaStream_t s) {
  CUtensorMap ma, mb, mo = {};
  const bool ok =
      (LAYOUT == NT
           ? make_map(&ma, a, a_rows, a_cols, lda, BM, KD) &&
                 make_map(&mb, b, b_rows, b_cols, ldb, BN, KD)
           : make_map(&ma, a, a_rows, a_cols, lda, KD, 64) &&
                 make_map(&mb, b, b_rows, b_cols, ldb, KD, 64)) &&
      (!p.tma_out || make_map(&mo, p.out, p.rows, p.cols, p.cols, 64, 64));
  if (!ok) return (int)cudaErrorInvalidValue;
  constexpr int smem = Smem<BM, BN>::BYTES;
  auto kernel = dispatch_bwd_kernel<LAYOUT, BM, BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ctas, (BM / 64 + 1) * WG, smem, s>>>(ma, mb, mo, p);
  return (int)cudaGetLastError();
}

template <int LAYOUT>
int launch_tile(int tile_m, int tile_n, const void* a, long a_rows,
                long a_cols, long lda, const void* b, long b_rows,
                long b_cols, long ldb, const Args& p, int ctas,
                cudaStream_t s) {
  if (tile_m == 128 && tile_n == 256)
    return launch<LAYOUT, 128, 256>(a, a_rows, a_cols, lda, b, b_rows, b_cols,
                                    ldb, p, ctas, s);
  if (tile_m == 64 && tile_n == 128)
    return launch<LAYOUT, 64, 128>(a, a_rows, a_cols, lda, b, b_rows, b_cols,
                                   ldb, p, ctas, s);
  if (tile_m == 64 && tile_n == 64)
    return launch<LAYOUT, 64, 64>(a, a_rows, a_cols, lda, b, b_rows, b_cols,
                                  ldb, p, ctas, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// layout 0 (nt): a = g (m, n), b = w (kd, n), out = dx (m, kd);
// layout 1 (tn): a = x (m, kd), b = g (m, n), out = dw (kd, n).
// a and b bf16, row-major with row strides lda, ldb (multiples of 8
// elements) and 16-byte aligned bases; codes the forward's (I, J, K) int32
// grid; out (rows, cols) contiguous, float32 when out_f32 else bf16, every
// element written; next_tile one int of scratch.  The tile shape and grid, the output blocks' edges, the
// contraction blocks and the code strides as dispatch_bwd.bwd_launch
// computes them: (tile_m, tile_n) in {(128, 256), (64, 128), (64, 64)},
// tile_m | row_edge, tile_n | col_edge, depth % 64 == 0; ctas persistent
// CTAs share the row_tiles x col_tiles tiles.
extern "C" int rt_dispatch_bwd(int layout, const void* a, long a_rows,
                               long a_cols, long lda, const void* b,
                               long b_rows, long b_cols, long ldb,
                               const int* codes, int* next_tile, void* out,
                               int out_f32,
                               long rows, long cols, int tile_m, int tile_n,
                               int row_tiles, int col_tiles, int ctas,
                               int group, int row_edge, int col_edge,
                               int depth,
                               int steps, long rs, long cs, long ts,
                               void* stream) {
  if ((layout != NT && layout != TN) || tile_m <= 0 || tile_n <= 0 ||
      row_edge % tile_m || col_edge % tile_n || depth <= 0 || depth % KD ||
      steps < 0 || (long)row_tiles * tile_m < rows ||
      (long)col_tiles * tile_n < cols || ctas <= 0 || group <= 0 ||
      (long)row_tiles * col_tiles > 0x7fffffffL || lda % 8 || ldb % 8 ||
      lda < a_cols || ldb < b_cols || ((uintptr_t)a & 15) ||
      ((uintptr_t)b & 15) || codes == nullptr || next_tile == nullptr ||
      out == nullptr ||
      (long)steps * depth > 0x7fffffffL || rows > 0x7fffffffL ||
      cols > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return 0;
  if (a_rows == 0 || a_cols == 0 || b_rows == 0 || b_cols == 0) {
    // nothing to contract: the sums are all zero
    return (int)cudaMemsetAsync(out, 0, rows * cols * (out_f32 ? 4 : 2),
                                (cudaStream_t)stream);
  }
  const int tma_out = !out_f32 && cols % 8 == 0 && ((uintptr_t)out & 15) == 0;
  const Args p{codes,    next_tile, out,   out_f32, tma_out, rows,
               cols,     row_tiles, col_tiles, group, row_edge, col_edge,
               depth,    steps,     rs,    cs,      ts};
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(next_tile, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  return layout == NT
             ? launch_tile<NT>(tile_m, tile_n, a, a_rows, a_cols, lda, b,
                               b_rows, b_cols, ldb, p, ctas, s)
             : launch_tile<TN>(tile_m, tile_n, a, a_rows, a_cols, lda, b,
                               b_rows, b_cols, ldb, p, ctas, s);
}
