// Hand-written Hopper (sm_90a) kernel of the sparse-sign (SASO) sketch.
//
// K4 saso_sketch_kernel replaces randblas_tpu/ops/saso_sketch.py:67::_kernel
// (the Pallas one-hot kernel reached through _call / saso_sketch). It computes
//   B = alpha * S @ A
// for a wide SASO S (d x m) with exactly k <= 16 entries +-1 in each column,
// given as the operator's (m, k) structure: idx[c, s] is the output row of
// slot s of data row c (-1 for a padding column), sgn[c, s] its sign. A
// (m x n) is float32 or bf16, row-major, column-major (the right sketch
// hands in a transposed view) or any other strides; each value is rounded
// to bf16, as the JAX package pre-casts A, and the sums run in float32.
//
// The TPU kernel builds one-hot bf16 panels of S in VMEM and contracts them
// on the MXU. This kernel does the same contraction on the tensor cores:
// a +-1 panel is exact in bf16, so the numerics are the JAX kernel's, the
// sums are deterministic without ownership tricks, and no output has to sit
// whole in one block's shared memory (any d the JAX gate takes, d <= 4096).
//
// What bounds it on the H100, and what this design does about it:
// - Operations and A's bytes through L2. The dense product is 2 d m n
//   (275 GFLOP at benchmarks/run_all.py config 3: d=1024, m=65536, n=2048,
//   0.28 ms at 989 TFLOP/s); A is read once from device memory (537 MB as
//   float32, 0.16 ms at 3.35 TB/s) but once per row tile from L2. A CTA owns
//   a TI x TN = 256 x 128 output tile, so A crosses L2 d / 256 times (4 at
//   config 3, 2.1 GB), half as often as with K1's 128-row tiles; the row
//   tiles that read one tile of A are adjacent on grid.x, so they run
//   together and A comes from device memory once. (Clusters of two row
//   tiles sharing A's tile by TMA multicast ran slower: PERF.md.)
// - Overlap. Two consumer warpgroups, 128 output rows each (two
//   wgmma.m64n128k16 per k16 step, bf16 in, float32 accumulate); while a
//   step's products run, each converts its half of the next step's data
//   tile to bf16 (K1's scheme: MN-major tile for row-major A, K-major for
//   column-major A, element loads for strides TMA cannot take) and loads
//   the half after that by TMA into one of two float32 staging tiles.
//   mbarriers order the rings: full and empty per panel (the writers, the
//   consumers), converted per data tile (both consumer warpgroups), staged
//   per staging tile (TMA's bytes).
// - The panel, built by the producer warpgroup in shared memory. Thread c
//   of warps 8, 9 owns column c of the TI x TK panel and adds sgn at row
//   idx - i0 for each slot whose index falls in the tile, in slot order
//   (repeated rows add up); all four warps first clear the rows the column
//   took when the panel last held a step. Warps 10, 11 copy each step's
//   slices of the tables into shared memory (4-byte cp.async, read in the
//   tables' order and written as [slot][column]) a few steps ahead, and
//   never fence: a fence for wgmma waits for the thread's copies in flight.
//   What set the pace as the design went (PERF.md): the tables' latency
//   when each step loaded them, then the producers' instructions (they
//   share the schedulers with the consumers: 32-bit offsets, loops
//   unrolled to KMAX = 8 or 16 slots), then the producer's one step of
//   slack: for k <= 8 the panels have three stages. What is left is the
//   ring's handoffs: with no panel, no conversion and no products a step
//   still takes about 0.8 us (512 steps per CTA at config 3;
//   saso_ablation.py).
// - Filling 132 SMs. One CTA fits an SM (212 or 219 KB of shared memory).
//   The launch plan (ops/saso_sketch.py::launch_plan) cuts the contraction
//   into splits on grid.z; split_reduce_kernel (hopper.cuh) adds their
//   partial sums in split order. The launcher only checks the plan.
// Sums are deterministic: no atomics, the wgmma order inside each CTA and a
// fixed split order. Launching twice gives the same bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int TI = 256;         // output rows per CTA, 128 per consumer
constexpr int TN = 128;         // output columns per CTA
constexpr int TK = 64;          // contraction step: one 128-byte bf16 row
constexpr int STAGES = 2;       // ring of bf16 data tiles
constexpr int TABLES = 6;       // ring of the steps' table slices
constexpr int CONSUMERS = 256;  // warpgroups 0, 1: wgmma, 128 rows each
constexpr int PRODUCERS = 128;  // warpgroup 2: the panels and tables
constexpr int THREADS = CONSUMERS + PRODUCERS;
// registers per thread: 168 at entry (65536 / 384); 2 x 216 + 72 = 3 x 168
constexpr int CONSUMER_REGS = 216;
constexpr int PRODUCER_REGS = 72;
constexpr int MAX_K = 16;
constexpr int ROW_BYTES = TK * 2;                  // 128
constexpr int PANEL_BYTES = TI * ROW_BYTES;        // 32 KB
constexpr int TILE_BYTES = TN * ROW_BYTES;         // 16 KB
constexpr int STAGING_BYTES = TK * TN * 4;         // A's tile as TMA lands it
// The rings that depend on KMAX, the slots of a column that the
// producers' loops unroll to (8 or 16): a table slot holds a step's idx and
// sgn slices, KMAX rows of TPITCH, and the ring of panels has a third stage
// where the smaller table slots leave room. The shared memory: 1024 bytes
// of slack to align the swizzle atoms, the panels, the data tiles, two
// staging tiles, the table slots, then the full and empty barriers per
// panel, a full barrier per data tile and two staged barriers per staging
// tile (223,840 bytes at KMAX 8, 217,168 at 16, of the 232,448 a CTA may
// have).
constexpr int TPITCH = TK + 4;  // a table slot's row: 4 slot rows per bank
template <int KMAX>
struct Rings {
  static constexpr int kTableBytes = 2 * KMAX * TPITCH * 4;
  static constexpr int kPanels = KMAX <= 8 ? 3 : 2;
  // table slices in flight: a slot is reused once the panel kPanels steps
  // back (whose rows the producers clear) is built
  static constexpr int kAhead = TABLES - kPanels - 1;
  static constexpr int kSmem = 1024 + kPanels * PANEL_BYTES +
                               STAGES * TILE_BYTES + 2 * STAGING_BYTES +
                               TABLES * kTableBytes +
                               (2 * kPanels + STAGES + 4) * 8;
};

// 4 bytes from global to shared memory, asynchronously
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// keep the accumulators in place across the asynchronous wgmma
__device__ __forceinline__ void pin(float (&d)[2][64]) {
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[b][i])::"memory");
}

// d[64 x 128] += A[64 x 16] * B[16 x 128], both from shared memory; A is
// K-major, B K-major (TRANS_B 0) or MN-major (1); d is the m64n128 f32
// fragment
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
}

// One TI x TN output tile of B = alpha * S @ A over the contraction steps of
// split blockIdx.z (`ks` steps each). grid.x walks the row tiles fastest:
// tile t is row tile t % row_tiles of column tile t / row_tiles. A's
// element (k, j) is a[k * sk + j * sn]; `amode` says whether the consumers
// load it directly or from what TMA (`map`) staged. The (m, k) tables hold
// slot s of data row c at c * k + s. KMAX (8 or 16) bounds k: the
// producers' loops unroll to it.
template <typename TA, int KMAX>
__global__ void __launch_bounds__(THREADS, 1)
saso_sketch_kernel(const TA* __restrict__ a, int64_t sk, int64_t sn,
                   const __grid_constant__ CUtensorMap map, int amode,
                   const int32_t* __restrict__ idx,
                   const float* __restrict__ sgn, int k,
                   int64_t ks, int row_tiles, float* __restrict__ out,
                   int64_t d,
                   int64_t m, int64_t n, float alpha) {
  constexpr int PANELS = Rings<KMAX>::kPanels;
  constexpr int AHEAD = Rings<KMAX>::kAhead;
  constexpr int LOADS = 2;
  constexpr int TABLE_BYTES = Rings<KMAX>::kTableBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  uint8_t* smem = smem_raw + (base - raw);
  uint8_t* tiles = smem + PANELS * PANEL_BYTES;
  uint8_t* staging_base = tiles + STAGES * TILE_BYTES;
  uint8_t* tables = staging_base + LOADS * STAGING_BYTES;
  const uint32_t bars = smem_u32(tables + TABLES * TABLE_BYTES);
  // per panel: full (the writers have built it) and empty (both consumer
  // warpgroups are done with it); per data tile: converted (both consumer
  // warpgroups have converted their halves); per staging tile and consumer
  // warpgroup: staged (TMA has landed its half of A's tile)
  auto full = [&](int p) { return bars + 8u * p; };
  auto empty = [&](int p) { return bars + 8u * (PANELS + p); };
  auto converted_bar = [&](int s) { return bars + 8u * (2 * PANELS + s); };
  auto staged = [&](int l, int w) {
    return bars + 8u * (2 * PANELS + STAGES + 2 * l + w);
  };

  const int tid = threadIdx.x;
  // the warpgroup, warp-uniform for the compiler (setmaxnreg needs it)
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
    for (int p = 0; p < PANELS; ++p) {
      mbar_init(full(p), 1);       // the writers
      mbar_init(empty(p), 2);      // both consumer warpgroups
    }
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(converted_bar(st), 2);  // both consumer warpgroups
    }
    for (int l = 0; l < LOADS; ++l) {
      mbar_init(staged(l, 0), 1);  // the TMA loads of A's tile halves
      mbar_init(staged(l, 1), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the panels start at zero: the producers then only touch the entries
  // they set
  for (int i = tid; i < PANELS * PANEL_BYTES / 16; i += THREADS) {
    *reinterpret_cast<uint4*>(smem + i * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int64_t i0 = (int64_t)(blockIdx.x % row_tiles) * TI;
  const int64_t n0 = (int64_t)(blockIdx.x / row_tiles) * TN;
  // split blockIdx.z of the contraction: steps s0 .. s0 + nk, its partial
  // sums into slice z of `out` (one slice when the grid has one split)
  const int64_t s0 = (int64_t)blockIdx.z * ks;
  const int64_t nk_all = (m + TK - 1) / TK;
  const int64_t nk = s0 < nk_all ? (nk_all - s0 < ks ? nk_all - s0 : ks) : 0;
  out += (int64_t)blockIdx.z * d * n;
  // the data tile is MN-major when A is row-major and staged by TMA (a
  // plain conversion, wgmma's transpose bit), else K-major
  const bool mn_tile = amode == kTmaRows;

  if (role < CONSUMERS / 128) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));
    const int wg = role;  // tile rows 128 * wg ..
    const int lt = tid & 127;
    // this warpgroup's half of the data tile of `step`, as bf16 and zero
    // past the ragged edges (TMA fills them with zeros): from the staging
    // tile four values at a time, or element by element from A
    auto convert = [&](int64_t step) {
      const int s = (int)(step % STAGES), l = (int)(step % LOADS);
      uint8_t* tile = tiles + s * TILE_BYTES;
      const TA* staging =
          reinterpret_cast<const TA*>(staging_base + l * STAGING_BYTES);
      constexpr int kFours = TK * TN / 4 / 2;  // four-value tasks per half
      if (amode != kLoadDirect) {
        mbar_wait(staged(l, wg), (uint32_t)(step / LOADS) & 1u);
      }
      if (amode == kTmaRows) {
        // staging [k][n] -> MN-major tile: four adjacent columns of a row
#pragma unroll 4
        for (int it = 0; it < kFours / 128; ++it) {
          const int t = wg * kFours + lt + it * 128;
          const int kk = t / (TN / 4), j = 4 * (t % (TN / 4));
          *reinterpret_cast<uint2*>(tile + mn_off<TK>(kk, j)) =
              four_bf16(staging + kk * TN + j);
        }
      } else if (amode == kTmaCols) {
        // staging [n][k] -> K-major tile: four adjacent k of a column
#pragma unroll 4
        for (int it = 0; it < kFours / 128; ++it) {
          const int t = wg * kFours + lt + it * 128;
          const int j = t / (TK / 4), kk = 4 * (t % (TK / 4));
          *reinterpret_cast<uint2*>(tile + swz(j, kk >> 3) + (kk & 7) * 2) =
              four_bf16(staging + j * TK + kk);
        }
      } else {
        // K-major tile row j: column n0 + j of A at k0 + 8 ch ..
        constexpr int kEights = TN * (TK / 8) / 2;
        const int64_t k0 = (s0 + step) * TK;
#pragma unroll 2
        for (int it = 0; it < kEights / 128; ++it) {
          const int t = wg * kEights + lt + it * 128;
          const int j = t % TN, ch = t / TN;
          const int64_t gn = n0 + j, gk = k0 + 8 * ch;
          __nv_bfloat16 w[8];
#pragma unroll
          for (int l = 0; l < 8; ++l) {
            w[l] = (gn < n && gk + l < m) ? to_bf16(a[(gk + l) * sk + gn * sn])
                                          : __float2bfloat16_rn(0.0f);
          }
          *reinterpret_cast<uint4*>(tile + swz(j, ch)) =
              make_uint4(pack_bf16(w[0], w[1]), pack_bf16(w[2], w[3]),
                         pack_bf16(w[4], w[5]), pack_bf16(w[6], w[7]));
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };
    // TMA of this warpgroup's half of A's tile of `step` (rows k of the
    // row-major staging tile, columns n of the column-major one)
    auto load_half = [&](int64_t step) {
      const int l = (int)(step % LOADS);
      constexpr uint32_t kBytes = TK * TN * sizeof(TA) / 2;
      const uint32_t dst =
          smem_u32(staging_base + l * STAGING_BYTES) + wg * kBytes;
      mbar_arrive_expect(staged(l, wg), kBytes);
      const int k0 = (int)((s0 + step) * TK);
      if (amode == kTmaRows) {
        tma_load(dst, &map, (int)n0, k0 + wg * (TK / 2), staged(l, wg));
      } else {
        tma_load(dst, &map, k0, (int)n0 + wg * (TN / 2), staged(l, wg));
      }
    };
    // the warpgroup's half of step's tile is in place: arrive on full, and
    // load the half tile of step + LOADS into the staging tile it read.
    // Called only once the warpgroup's products of the step before are
    // done, which frees the tile's stage
    auto converted = [&](int64_t step) {
      const int s = (int)(step % STAGES);
      asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
      if (lt == 0) {
        mbar_arrive(converted_bar(s));
        if (amode != kLoadDirect && step + LOADS < nk) {
          load_half(step + LOADS);
        }
      }
    };
    float acc[2][64];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[b][i] = 0.0f;
    if (amode != kLoadDirect && lt == 0) {
      for (int64_t step = 0; step < nk && step < LOADS; ++step) {
        load_half(step);
      }
    }
    if (nk > 0) {
      convert(0);
      converted(0);
    }
    for (int64_t step = 0; step < nk; ++step) {
      const int s = (int)(step % STAGES), pn = (int)(step % PANELS);
      mbar_wait(full(pn), (uint32_t)(step / PANELS) & 1u);
      mbar_wait(converted_bar(s), (uint32_t)(step / STAGES) & 1u);
      const uint32_t panel = base + pn * PANEL_BYTES;
      const uint32_t tile = smem_u32(tiles + s * TILE_BYTES);
      // k16 slice kk: 32 bytes along a K-major row, 16 rows of an
      // MN-major tile (descriptor units of 16 bytes)
      const uint64_t da0 =
          desc_sw128(panel + wg * 128 * ROW_BYTES, 16, 8 * ROW_BYTES);
      const uint64_t da1 =
          desc_sw128(panel + (wg * 128 + 64) * ROW_BYTES, 16, 8 * ROW_BYTES);
      pin(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      if (mn_tile) {
        const uint64_t db = desc_sw128(tile, TK * ROW_BYTES, 8 * ROW_BYTES);
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
          wgmma_m64n128k16<1>(acc[0], da0 + 2 * kk, db + 128 * kk);
          wgmma_m64n128k16<1>(acc[1], da1 + 2 * kk, db + 128 * kk);
        }
      } else {
        const uint64_t db = desc_sw128(tile, 16, 8 * ROW_BYTES);
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
          wgmma_m64n128k16<0>(acc[0], da0 + 2 * kk, db + 2 * kk);
          wgmma_m64n128k16<0>(acc[1], da1 + 2 * kk, db + 2 * kk);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // under the products: the next step's half tile (its stage was last
      // read by both warpgroups' products of the step before, done: the
      // tile's converted barrier counted their arrivals)
      if (step + 1 < nk) convert(step + 1);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin(acc);
      if (lt == 0) mbar_arrive(empty(pn));
      if (step + 1 < nk) converted(step + 1);
    }

    // epilogue: alpha once, masked stores of the ragged edges. Fragment of
    // m64n128: register 4 t + 2 h + e holds row 16 w + g + 8 h, column
    // 8 t + 2 q + e of the 64 x 128 tile of accumulator b
    const int w = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const bool pairs = (n % 2) == 0;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int64_t row0 = i0 + wg * 128 + b * 64 + w * 16 + g;
#pragma unroll
      for (int t = 0; t < TN / 8; ++t) {
        const int64_t c = n0 + 8 * t + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t r = row0 + 8 * h;
          if (r >= d) continue;
          const float x = alpha * acc[b][4 * t + 2 * h];
          const float y = alpha * acc[b][4 * t + 2 * h + 1];
          float* o = out + r * n + c;
          if (pairs && c + 1 < n) {
            *reinterpret_cast<float2*>(o) = make_float2(x, y);
          } else {
            if (c < n) o[0] = x;
            if (c + 1 < n) o[1] = y;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    // thread pt takes column pt % TK of each panel. Warps 8, 9 (writers)
    // add the signs; warps 10, 11 copy the tables' slices; all four clear.
    // Only the writers fence their stores for wgmma: a fence waits for
    // the thread's copies still in flight
    const int pt = tid - CONSUMERS;
    const int col = pt % TK, half = pt / TK;
    const bool writer = half == 0;
    // the table slice of `step` (idx, then sgn, [KMAX][TPITCH] each:
    // slot row sl, column c) is copied into table slot step % TABLES AHEAD
    // steps before its panel, 4 bytes a copy, read in the tables' order
    // (coalesced) and written transposed. Columns past m are not copied:
    // the producers skip them
    // (entry e of a slice is slot e % k of column e / k; a copier starts at
    // e = col and steps by TK)
    const int sl_step = TK % k, c_step = TK / k;
    const int sl_first = col % k, c_first = col / k;
    auto fetch = [&](int64_t step) {
      if (step < nk) {
        uint8_t* dst = tables + (step % TABLES) * TABLE_BYTES;
        const int64_t c0 = (s0 + step) * TK;
        const int have = (int)((m - c0 < TK ? m - c0 : TK) * k);
#pragma unroll
        for (int which = 0; which < 2; ++which) {  // idx, then sgn
          const int32_t* src = which ? reinterpret_cast<const int32_t*>(sgn)
                                     : idx;
          int sl = sl_first, c = c_first;
          for (int e = col; e < have; e += TK) {
            cp_async4(dst + which * (TABLE_BYTES / 2) + (sl * TPITCH + c) * 4,
                      src + c0 * k + e);
            sl += sl_step;
            c += c_step;
            if (sl >= k) {
              sl -= k;
              ++c;
            }
          }
        }
      }
      cp_async_commit();  // one group per step, empty past the last
    };
    auto slot_idx = [&](int64_t step) {
      return reinterpret_cast<const int32_t*>(tables +
                                              (step % TABLES) * TABLE_BYTES);
    };
    // the byte offset of (output row, col) in the panel, or -1 outside the
    // tile (32-bit: i0 < 4096 + TI, and -1 - i0 wraps past TI)
    const int i0i = (int)i0;
    const uint32_t col_bytes = (uint32_t)(col & 7) * 2, chunk = col >> 3;
    auto offset = [&](int32_t row) {
      const uint32_t r = (uint32_t)(row - i0i);
      return r < (uint32_t)TI
                 ? (int)(r * ROW_BYTES + ((chunk ^ (r & 7u)) << 4) + col_bytes)
                 : -1;
    };
    if (!writer) {
      for (int64_t step = 0; step < AHEAD; ++step) fetch(step);
    }
    for (int64_t step = 0; step < nk; ++step) {
      const int pn = (int)(step % PANELS);
      uint8_t* panel = smem + pn * PANEL_BYTES;
      if (!writer) cp_async_wait<AHEAD - 1>();
      mbar_wait(empty(pn), ((uint32_t)(step / PANELS) & 1u) ^ 1u);
      // the step's slice is in place, and the panel is free
      asm volatile("bar.sync 1, %0;\n" :: "n"(PRODUCERS) : "memory");
      // clear the rows the column took when the panel last held a step
      // (slots of parity `half`)
      if (step >= PANELS) {
        const int32_t* old = slot_idx(step - PANELS);
        const bool was = (s0 + step - PANELS) * TK + col < m;
#pragma unroll
        for (int i = 0; i < KMAX / 2; ++i) {
          const int sl = 2 * i + half;
          const int o = sl < k && was ? offset(old[sl * TPITCH + col]) : -1;
          if (o >= 0) {
            *reinterpret_cast<__nv_bfloat16*>(panel + o) =
                __float2bfloat16_rn(0.0f);
          }
        }
      }
      // every clear lands before any add
      asm volatile("bar.sync 1, %0;\n" :: "n"(PRODUCERS) : "memory");
      if (!writer) {
        // into the slot of step + AHEAD - TABLES, which the producers read
        // last at the step before this one
        fetch(step + AHEAD);
        continue;
      }
      // each slot's sign, in slot order, so repeated rows add up
      const int32_t* now = slot_idx(step);
      const float* sg = reinterpret_cast<const float*>(now + KMAX * TPITCH);
      const bool is = (s0 + step) * TK + col < m;
#pragma unroll
      for (int sl = 0; sl < KMAX; ++sl) {
        const int o = sl < k && is ? offset(now[sl * TPITCH + col]) : -1;
        if (o >= 0) {
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(panel + o);
          *e = __float2bfloat16_rn(
              __fadd_rn(__bfloat162float(*e), sg[sl * TPITCH + col]));
        }
      }
      // make the stores visible to wgmma, then count the writers in
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 4, %0;\n" :: "n"(TK) : "memory");
      if (pt == 0) mbar_arrive(full(pn));
    }
    cp_async_wait<0>();
  }
}

// The launch plan of K4, computed by ops/saso_sketch.py::launch_plan and
// checked here: the compiled tile sizes, row_tiles x col_tiles tiles on
// grid.x that cover the output, and the contraction split into `splits`
// ranges of `ks` steps on grid.z.
struct Plan {
  int ti, tn, tk, row_tiles, col_tiles, splits, ks;
};

bool plan_ok(const Plan& p, int64_t d, int64_t m, int64_t n) {
  return p.ti == TI && p.tn == TN && p.tk == TK && p.row_tiles >= 1 &&
         p.col_tiles >= 1 && (int64_t)p.row_tiles * TI >= d &&
         (int64_t)p.col_tiles * TN >= n &&
         (int64_t)p.row_tiles * p.col_tiles <= 0x7fffffff && p.splits >= 1 &&
         p.splits <= 65535 && p.ks >= 1 && (int64_t)p.splits * p.ks * TK >= m;
}

template <typename TA>
cudaError_t launch(const void* a, int64_t sk, int64_t sn, const int32_t* idx,
                   const float* sgn, int k, float* ws,
                   float* out, int64_t d,
                   int64_t m, int64_t n, float alpha, const Plan& p,
                   cudaStream_t stream) {
  auto kernel = k <= 8 ? saso_sketch_kernel<TA, 8> : saso_sketch_kernel<TA, 16>;
  const int smem = k <= 8 ? Rings<8>::kSmem : Rings<16>::kSmem;
  cudaError_t e = prepare(kernel, smem, 1);
  if (e != cudaSuccess) return e;
  CUtensorMap map = {};
  const int amode = a_map<TA, TN, TK>(a, sk, sn, m, n, &map);
  const dim3 grid((unsigned)(p.row_tiles * p.col_tiles), 1, (unsigned)p.splits);
  auto run = [&](float* dst, float scale) {
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const TA*>(a), sk, sn, map, amode, idx, sgn, k, p.ks,
        p.row_tiles, dst, d, m, n, scale);
    return cudaGetLastError();
  };
  return launch_split(run, p.splits, ws, out, d * n, alpha, stream);
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py). A's element (c, j)
// is at a[c * sk + j * sn]; the tables are (m, k), contiguous (slot s of
// data row c at c * k + s); plan holds
// TI, TN, TK, the row tiles, the column tiles, the splits of the
// contraction and the steps per split of ops/saso_sketch.py's launch_plan;
// ws holds splits x d x n floats when splits > 1 (else it may be null).
// Only enqueues on `stream` and returns the launch's error code.
extern "C" int rbt_saso_sketch(const void* a, int a_bf16, int64_t sk,
                               int64_t sn, const int32_t* idx,
                               const float* sgn, int k,
                               float* ws, float* out,
                               int64_t d, int64_t m, int64_t n, float alpha,
                               const int32_t* plan, void* stream) {
  if (d <= 0 || n <= 0) return (int)cudaSuccess;
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6]};
  if (k < 1 || k > MAX_K || m < 1 || m * k > 0x7fffffff ||
      !plan_ok(p, d, m, n) ||
      (p.splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      a_bf16 ? launch<__nv_bfloat16>(a, sk, sn, idx, sgn, k, ws, out, d, m,
                                     n, alpha, p, s)
             : launch<float>(a, sk, sn, idx, sgn, k, ws, out, d, m, n, alpha,
                             p, s);
  return (int)e;
}

// cudaOccupancyMaxActiveClusters of K4's launch shape (THREADS threads,
// the shared memory of k <= 8, clusters of one CTA): how many CTAs the
// current device runs at once
extern "C" int rbt_saso_max_ctas(int* count) {
  return max_active_clusters(saso_sketch_kernel<float, 8>, THREADS,
                             Rings<8>::kSmem, 1, count);
}
