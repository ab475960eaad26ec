// Hand-written Hopper (sm_90a) kernels of the dense Gaussian/Uniform sketch.
//
// K1 fused_sketch_kernel replaces randblas_tpu/ops/fused_sketch.py::_kernel
// (the Pallas RNG-in-GEMM kernel reached through _fused_call). It computes
//   B = alpha * S[ro:ro+d, co:co+m] @ A
// for a RowMajor-natural operator S whose element (i, c) is lane c % 4 of
// Philox4x32-10 (or Threefry4x32-20) at counter seed + i * ctr_stride + c / 4
// (the wrapper folds ro and co into the seed). S is generated panel by panel
// into shared memory and fed to bf16 wgmma with float32 accumulation; no
// operator element is ever written to global memory.
//
// K2 fused_sketch_T_kernel replaces randblas_tpu/ops/fused_sketch.py:366
// ::_kernel_T (reached through _fused_call_T / fused_sketch_colmajor): the
// same product for a ColMajor-natural operator, whose element (i, c) is lane
// i % 4 at counter seed + c * ctr_stride + i / 4 (ctr_stride from the true
// parent height). It is K1 with another panel generator: one counter block
// yields four consecutive ROWS of one operator column, stored as four 2-byte
// stores; a warp covers 32 adjacent columns of one row quad, so each store
// instruction writes 64 bytes of one 128-byte panel row and meets no bank
// conflict. The pipeline, the data tile and the epilogue are K1's. An
// unaligned row offset arrives as `shift` = ro % 4: the tile rows count from
// the previous counter boundary and the epilogue stores tile row r at output
// row r - shift (the TPU kernel generated extra rows and sliced them off
// outside). K2 carries the ColMajor-natural left sketch, the left-Trans
// sketch onto a ColMajor-natural transposed operator, and the backward pass
// of K1.
//
// K3 fill_block_kernel and fill_block_T_kernel replace
// randblas_tpu/ops/fused_sketch.py:446 ::_kernel_fill (reached through
// _fill_call / pallas_fill_block): generation only, a (rows, cols) block of
// S in its natural orientation, or in the math layout of a ColMajor-natural
// block (the natural block transposed), with the TPU kernel's Gaussian
// transform or the staged fill's. Its design is in the K3 section below.
//
// All share one counter-based generator, words4 of random123.cuh (K7's
// too), and the same arithmetic as the plain PyTorch versions in
// ops/fused_sketch.py and ops/dense_fill.py (every multiply and add is
// rounded on its own, with __fmul_rn / __fadd_rn, so nothing is contracted
// into an FMA; logf, sqrtf, sinf, cosf and sincosf are the accurate
// versions: build without --use_fast_math). The Hopper plumbing that K1, K2
// share with K4 (bf16 packing, the swizzle, mbarriers, TMA, the split sum)
// is hopper.cuh.
//
// What bounds K1 and K2 on the H100, and what this design does about it:
// - Generation. The product alone is tensor-core work (2 d m n flops); the
//   operator costs a Philox (or Threefry) block and two Box-Muller
//   transforms (logf, sqrtf, the sincospi polynomial) per four elements on
//   the integer and FP32 pipes. A CTA owns one TI x TN output tile and walks
//   its range of the contraction, so a panel generated by one CTA alone
//   would be generated again for every TN columns of the output. Here the
//   CTAs of a thread-block cluster of C CTAs along n share each TI x PK
//   panel: every CTA generates TI / C of its rows into its own shared
//   memory, and one bulk copy per peer (cp.async.bulk shared::cta ->
//   shared::cluster) places them in every other CTA of the cluster. S is
//   generated ceil(ceil(n / TN) / C) times in all (once at n = 4096 with
//   TN = 256 and C = 16).
// - Overlap. Each CTA is warp-specialised. One producer warpgroup
//   generates the panel rows. Two consumer warpgroups run
//   wgmma.m64n256k16 (bf16 in, f32 accumulate, 64 operator rows each);
//   while a step's products run on the tensor cores, each consumer
//   warpgroup converts its half of the next step's data tile to bf16, and
//   TMA then loads its half of the step after into the staging tile it has
//   just read. setmaxnreg moves registers from the producers to the
//   consumers' 128 accumulators.
// - Two rings. The panel ring, which the cluster shares, steps PK = 128 of
//   the contraction: a stage's full barrier completes on the producers'
//   arrival and the peers' bulk-copy bytes; its empty barrier on one
//   arrival from each consumer warpgroup of every CTA of the cluster (a
//   CTA overwrites its share of the panel in every peer). A's ring stays
//   in the CTA and steps TK = 64: two bf16 data tiles, each ready once both
//   consumer warpgroups have converted their halves, and one float32
//   staging tile. A step multiplies one half of a panel stage; consumers
//   wait for the panel once every two steps. The ring alone (its barriers
//   and bulk copies, no other work) takes as long at a step of 128 as at
//   64: it is bound by the panel's bytes between SMs, not by its handoffs.
//   But at 128 the producers' generation hides under the products, where
//   at 64 it added a seventh of K1's time at the main shape
//   (fused_ablation.py, PERF.md).
// - A's bytes. A is read once per output row tile (d / TI times) and
//   reaches shared memory as float32 (or bf16) by TMA, from L2 for all but
//   the first row tile to read it. The loads are bound by L2's bandwidth:
//   more staging in flight, or the same in smaller boxes, made K1 slower
//   on the card (PERF.md). One staging tile, in two boxes of half a tile,
//   refilled a step ahead, was the fastest measured, and it fits beside a
//   panel ring of 2 x 128.
// - Layouts. A panel stage is K-major with the 128-byte swizzle that the
//   wgmma descriptors read: a row of PK bf16 is two 128-byte rows, one in
//   each 1024-byte atom of a pair (k 0-63, k 64-127) per eight rows, so a
//   CTA's share of rows (a multiple of eight) is one contiguous run for its
//   bulk copy, and a step's half is every other atom (a stride of 2048
//   bytes between atoms). The data tile is MN-major for row-major A
//   (wgmma's transpose bit, so converting it is element-wise) and K-major
//   for column-major A (the right route's A^T, read in place through its
//   strides). A whose strides TMA cannot take is loaded element by
//   element.
// - Rounds. Clusters of 8 or 16 fill only 120 or 112 of the 132 SMs, and a
//   grid of a few rounds of clusters leaves the card part idle in the last
//   one. The launch plan (ops/fused_sketch.py::launch_plan: TI, TN, TK, PK,
//   C, the grid, the splits) then cuts the contraction into ranges on
//   grid.z, each starting on a panel step; split_reduce_kernel (hopper.cuh)
//   adds their partial sums in split order. The launcher only checks the
//   plan.
// - A CTA whose columns lie past n still generates its share and joins
//   every barrier: the cluster would deadlock otherwise.
// Sums are deterministic: no atomics, a fixed k order inside each CTA and a
// fixed split order.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "random123.cuh"

namespace {

using r123::kPhilox4x32;
using r123::kThreefry4x32;
using r123::Seed;
using r123::words4;

// float32 constants as exact bit patterns: the JAX package rounds the same
// decimal values to float32 (rng/transforms.py)
constexpr float kPi = 0x1.921fb6p+1f;
constexpr float kSqrt3 = 0x1.bb67aep+0f;
constexpr float kSinpiC0 = 0x1.921fb4p+1f;
constexpr float kSinpiC1 = -0x1.4abbbap+2f;
constexpr float kSinpiC2 = 0x1.466812p+1f;
constexpr float kSinpiC3 = -0x1.32423ep-1f;
constexpr float kSinpiC4 = 0x1.3d395ep-4f;

// uneg11 on the signed view of a word: s * 2^-31 + 2^-32
__device__ __forceinline__ float uneg11_i32(int32_t s) {
  return __fadd_rn(__fmul_rn(__int2float_rn(s), 0x1p-31f), 0x1p-32f);
}

// u01 on the signed view: s * 2^-32 + 2^-33 + [s < 0]
__device__ __forceinline__ float u01_i32(int32_t s) {
  const float base =
      __fadd_rn(__fmul_rn(__int2float_rn(s), 0x1p-32f), 0x1p-33f);
  return __fadd_rn(base, s < 0 ? 1.0f : 0.0f);
}

// sin(pi * w) for w in [-1/2, 1/2] (degree-9 odd polynomial)
__device__ __forceinline__ float sinpi_half(float w) {
  const float w2 = __fmul_rn(w, w);
  float p = kSinpiC4;
  p = __fadd_rn(__fmul_rn(p, w2), kSinpiC3);
  p = __fadd_rn(__fmul_rn(p, w2), kSinpiC2);
  p = __fadd_rn(__fmul_rn(p, w2), kSinpiC1);
  p = __fadd_rn(__fmul_rn(p, w2), kSinpiC0);
  return __fmul_rn(w, p);
}

// Box-Muller on two words with the polynomial sincospi (K1, K2)
__device__ __forceinline__ void boxmul_fast(uint32_t a, uint32_t b, float& x,
                                            float& y) {
  const float u = uneg11_i32((int32_t)a);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u01_i32((int32_t)b))));
  const float au = fabsf(u);
  const float ws =
      au > 0.5f ? (u >= 0.0f ? __fsub_rn(1.0f, au) : __fsub_rn(au, 1.0f)) : u;
  x = __fmul_rn(sinpi_half(ws), r);
  y = __fmul_rn(sinpi_half(__fsub_rn(0.5f, au)), r);
}

// the four values of the counter block at seed + off, as K1 and K2 use
// them
template <int RNG, bool GAUSS>
__device__ __forceinline__ void gen4(const Seed& seed, uint64_t off,
                                     float v[4]) {
  uint32_t x[4];
  words4<RNG>(seed, off, x);
  if (GAUSS) {
    boxmul_fast(x[0], x[1], v[0], v[1]);
    boxmul_fast(x[2], x[3], v[2], v[3]);
  } else {
#pragma unroll
    for (int l = 0; l < 4; ++l) v[l] = __fmul_rn(uneg11_i32((int32_t)x[l]), kSqrt3);
  }
}

// ----------------------------------------------------------- K1, K2 ----

constexpr int TI = 128;         // operator rows (output rows) per CTA
constexpr int TN = 256;         // output columns per CTA
constexpr int TK = 64;          // A's step: one 128-byte bf16 row
constexpr int PK = 2 * TK;      // the panel's step: one cluster handoff
constexpr int KSTEPS = PK / TK; // A's steps per panel step
constexpr int PANEL_STAGES = 2; // the cluster's ring of operator panels
constexpr int TILES = 2;        // bf16 data tiles
constexpr int CONSUMERS = 256;  // warpgroups 0, 1: wgmma, 64 rows each
constexpr int PRODUCERS = 128;  // warpgroup 2: the operator panel
constexpr int THREADS = CONSUMERS + PRODUCERS;
// registers per thread: 168 at entry (65536 / 384); 2 x 216 + 72 = 3 x 168
constexpr int CONSUMER_REGS = 216;
constexpr int PRODUCER_REGS = 72;
constexpr int MAX_CLUSTER = 16;
constexpr int ROW_BYTES = TK * 2;                   // 128
constexpr int ATOM_BYTES = 8 * ROW_BYTES;           // a swizzle atom
constexpr int PANEL_BYTES = TI * PK * 2;            // 32 KB
constexpr int TILE_BYTES = TN * ROW_BYTES;          // 32 KB
constexpr int STAGING_BYTES = TK * TN * 4;   // A's tile as TMA lands it
// full, empty per panel stage; ready per tile; staged per consumer
// warpgroup
constexpr int BARRIERS = 2 * PANEL_STAGES + TILES + 2;
// 1024 bytes of slack to align the swizzle atoms, the panels, the tiles,
// the staging tile, then the barriers: 197,696 of the 232,448 bytes a CTA
// may have
constexpr int SMEM_BYTES = 1024 + PANEL_STAGES * PANEL_BYTES +
                           TILES * TILE_BYTES + STAGING_BYTES + 8 * BARRIERS;
// byte offset of 16-byte chunk `chunk` (0 to 8 KSTEPS - 1) of row `row` in
// a panel stage: chunks 0-7 in the first atom of the row's KSTEPS atoms,
// 8-15 in the second
__device__ __forceinline__ uint32_t panel_off(int row, int chunk) {
  return (uint32_t)(row >> 3) * (KSTEPS * ATOM_BYTES) +
         (uint32_t)(chunk >> 3) * ATOM_BYTES + swz(row & 7, chunk & 7);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// the same shared-memory offset in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t peer(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// arrive on a barrier of any CTA of the cluster (a shared::cluster address)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// copy `bytes` of this CTA's shared memory into a peer's (shared::cluster
// addresses dst and bar); completes `bytes` on the peer's barrier
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, uint32_t src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

// keep the accumulators in place across the asynchronous wgmma
__device__ __forceinline__ void pin(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] += A[64 x 16] * B[16 x 256], both from shared memory; A is
// K-major, B K-major (TRANS_B 0) or MN-major (1); d is the m64n256 f32
// fragment
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
}

// One TI x TN tile of B = alpha * S_blk @ A. COLMAJOR selects the panel
// generator (K2's when true). The tile's operator rows count from `shift`
// rows above output row 0: output row r is tile row r + shift (K1: 0).
// A's element (k, j) is a[k * sk + j * sn]; `amode` says whether the
// consumers load it directly or from what TMA (`map`) staged. The
// contraction splits into gridDim.z ranges of `ks` steps of TK (a multiple
// of KSTEPS where there are several: each range starts on a panel step).
template <typename TA, int RNG, bool GAUSS, bool COLMAJOR>
__device__ __forceinline__ void sketch_tile(const TA* __restrict__ a,
                                            int64_t sk, int64_t sn,
                                            const CUtensorMap* map, int amode,
                                            int64_t ks,
                                            float* __restrict__ out,
                                            int64_t d, int64_t m, int64_t n,
                                            int shift, uint64_t ctr_stride,
                                            const Seed& seed, float alpha) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  uint8_t* smem = smem_raw + (base - raw);
  uint8_t* tiles = smem + PANEL_STAGES * PANEL_BYTES;
  uint8_t* staging = tiles + TILES * TILE_BYTES;
  const uint32_t bars = base + PANEL_STAGES * PANEL_BYTES +
                        TILES * TILE_BYTES + STAGING_BYTES;
  // per panel stage: full (the panel is in place) and empty (every
  // consumer warpgroup of the cluster is done with it); per data tile:
  // ready (both consumer warpgroups converted their halves); per consumer
  // warpgroup: staged (TMA has landed its half of A's tile)
  auto full = [&](int p) { return bars + 8u * p; };
  auto empty = [&](int p) { return bars + 8u * (PANEL_STAGES + p); };
  auto ready = [&](int t) { return bars + 8u * (2 * PANEL_STAGES + t); };
  auto staged = [&](int w) {
    return bars + 8u * (2 * PANEL_STAGES + TILES + w);
  };

  const int tid = threadIdx.x;
  // the warpgroup, warp-uniform for the compiler (setmaxnreg needs it)
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  const uint32_t csize = cluster_size(), crank = cluster_rank();
  if (tid == 0) {
    for (int p = 0; p < PANEL_STAGES; ++p) {
      mbar_init(full(p), 1);           // the producers (+ the peers' bytes)
      mbar_init(empty(p), 2 * csize);  // each consumer warpgroup of each CTA
    }
    for (int t = 0; t < TILES; ++t) mbar_init(ready(t), 2);
    mbar_init(staged(0), 1);           // the TMA loads of A's tile halves
    mbar_init(staged(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every barrier of the cluster is set before any use

  const int64_t i0 = (int64_t)blockIdx.y * TI;  // first tile row (shifted)
  const int64_t n0 = (int64_t)blockIdx.x * TN;
  // split blockIdx.z of the contraction: steps s0 .. s0 + nk of TK, its
  // partial sums into slice z of `out` (one slice when the grid has one
  // split); its panel steps cover them KSTEPS at a time
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
    const int wg = role;  // tile rows 64 * wg ..
    const int lt = tid & 127;
    // this warpgroup's half of A's tile in the staging tile: k rows of the
    // row-major staging, n columns of the column-major one
    const TA* a_half =
        reinterpret_cast<const TA*>(staging) + wg * (TK * TN / 2);
    // TMA of this warpgroup's half of A's tile of `step`
    auto load_half = [&](int64_t step) {
      constexpr uint32_t kBytes = TK * TN * sizeof(TA) / 2;
      mbar_arrive_expect(staged(wg), kBytes);
      const int k0 = (int)((s0 + step) * TK);
      if (amode == kTmaRows) {
        tma_load(smem_u32(a_half), map, (int)n0, k0 + wg * (TK / 2),
                 staged(wg));
      } else {
        tma_load(smem_u32(a_half), map, k0, (int)n0 + wg * (TN / 2),
                 staged(wg));
      }
    };
    // this warpgroup's half of the data tile of `step`, as bf16 and zero
    // past the ragged edges (TMA fills them with zeros): from the staging
    // tile four values at a time, which TMA refills with the next step's
    // half as soon as the warpgroup has read it; or element by element
    // from A
    auto convert = [&](int64_t step) {
      uint8_t* tile = tiles + (int)(step % TILES) * TILE_BYTES;
      if (amode != kLoadDirect) {
        constexpr int kFours = TK * TN / 4 / 2;  // four-value tasks a half
        mbar_wait(staged(wg), (uint32_t)step & 1u);
        if (amode == kTmaRows) {
          // staging [k][n] -> MN-major tile: four adjacent columns of a row
#pragma unroll 4
          for (int it = 0; it < kFours / 128; ++it) {
            const int t = lt + it * 128;
            const int k = t / (TN / 4), j = 4 * (t % (TN / 4));
            *reinterpret_cast<uint2*>(
                tile + mn_off<TK>(wg * (TK / 2) + k, j)) =
                four_bf16(a_half + k * TN + j);
          }
        } else {
          // staging [n][k] -> K-major tile: four adjacent k of a column
#pragma unroll 4
          for (int it = 0; it < kFours / 128; ++it) {
            const int t = lt + it * 128;
            const int j = t / (TK / 4), k = 4 * (t % (TK / 4));
            *reinterpret_cast<uint2*>(tile + swz(wg * (TN / 2) + j, k >> 3) +
                                      (k & 7) * 2) =
                four_bf16(a_half + j * TK + k);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
        if (lt == 0 && step + 1 < nk) load_half(step + 1);
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
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
    };
    // the warpgroup's half of step's tile is in place: arrive on ready.
    // Called only once the warpgroup's products of the step before are
    // done, which frees the tile
    auto converted = [&](int64_t step) {
      asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
      if (lt == 0) mbar_arrive(ready((int)(step % TILES)));
    };
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    if (amode != kLoadDirect && lt == 0 && nk > 0) load_half(0);
    if (nk > 0) {
      convert(0);
      converted(0);
    }
    for (int64_t step = 0; step < nk; ++step) {
      const int64_t p = step / KSTEPS;  // the panel step
      // and the atom of its rows that this step multiplies
      const int ps = (int)(p % PANEL_STAGES), atom = (int)(step % KSTEPS);
      if (atom == 0) mbar_wait(full(ps), (uint32_t)(p / PANEL_STAGES) & 1u);
      mbar_wait(ready((int)(step % TILES)), (uint32_t)(step / TILES) & 1u);
      const uint32_t panel = base + ps * PANEL_BYTES + atom * ATOM_BYTES;
      const uint32_t tile = base + PANEL_STAGES * PANEL_BYTES +
                            (int)(step % TILES) * TILE_BYTES;
      // k16 slice kk: 32 bytes along a K-major row, 16 rows of an
      // MN-major tile (descriptor units of 16 bytes); the warpgroup's 64
      // panel rows are eight such atoms, KSTEPS atoms apart
      const uint64_t da = desc_sw128(panel + wg * 8 * (KSTEPS * ATOM_BYTES),
                                     16, KSTEPS * ATOM_BYTES);
      pin(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      if (mn_tile) {
        const uint64_t db = desc_sw128(tile, TK * ROW_BYTES, 8 * ROW_BYTES);
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
          wgmma_m64n256k16<1>(acc, da + 2 * kk, db + 128 * kk);
        }
      } else {
        const uint64_t db = desc_sw128(tile, 16, 8 * ROW_BYTES);
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
          wgmma_m64n256k16<0>(acc, da + 2 * kk, db + 2 * kk);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // under the products: the next step's half tile (its tile was last
      // read by both warpgroups' products of the step before, done: ready
      // counted their arrivals)
      if (step + 1 < nk) convert(step + 1);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin(acc);
      // after the panel's last part (or the split's last step), release
      // it in every CTA of the cluster at once (thread r of the warpgroup
      // signals rank r)
      if ((atom == KSTEPS - 1 || step + 1 == nk) && lt < (int)csize) {
        mbar_arrive_cluster(peer(empty(ps), lt));
      }
      if (step + 1 < nk) converted(step + 1);
    }

    // epilogue: alpha once, masked stores of the ragged edges. Fragment of
    // m64n256: register 4 t + 2 h + e holds row 16 w + g + 8 h, column
    // 8 t + 2 q + e of the warpgroup's 64 x 256 tile
    const int w = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const int64_t row0 = i0 - shift + wg * 64 + w * 16 + g;
    const bool pairs = (n % 2) == 0;
#pragma unroll
    for (int t = 0; t < TN / 8; ++t) {
      const int64_t c = n0 + 8 * t + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = row0 + 8 * h;
        if (r < 0 || r >= d) continue;
        const float x = alpha * acc[4 * t + 2 * h];
        const float y = alpha * acc[4 * t + 2 * h + 1];
        float* o = out + r * n + c;
        if (pairs && c + 1 < n) {
          *reinterpret_cast<float2*>(o) = make_float2(x, y);
        } else {
          if (c < n) o[0] = x;
          if (c + 1 < n) o[1] = y;
        }
      }
    }
    cluster_sync();  // no peer signals or copies into an exited CTA
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    const int pt = tid - CONSUMERS;
    const int share = TI / (int)csize;   // panel rows this CTA generates
    const int r0 = (int)crank * share;
    // panel steps: the last may be part used (its phantom columns zero)
    const int64_t np = (nk + KSTEPS - 1) / KSTEPS;
    for (int64_t p = 0; p < np; ++p) {
      const int ps = (int)(p % PANEL_STAGES);
      const int64_t k0 = (s0 + KSTEPS * p) * TK;
      mbar_wait(empty(ps), ((uint32_t)(p / PANEL_STAGES) & 1u) ^ 1u);
      uint8_t* panel = smem + ps * PANEL_BYTES;
      // 1. this CTA's rows r0 .. r0 + share of the operator panel
      if constexpr (!COLMAJOR) {
        // a counter block is four adjacent columns of one row
#pragma unroll 2
        for (int t = pt; t < share * (PK / 4); t += PRODUCERS) {
          const int i = r0 + t / (PK / 4), b = t % (PK / 4);
          const int64_t gi = i0 + i, gc = k0 + 4 * b;
          float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (gi < d && gc < m) {
            gen4<RNG, GAUSS>(
                seed, (uint64_t)gi * ctr_stride + (uint64_t)(gc >> 2), v);
          }
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            if (gc + l >= m) v[l] = 0.0f;  // phantom columns multiply nothing
          }
          *reinterpret_cast<uint2*>(panel + panel_off(i, b >> 1) +
                                    (b & 1) * 8) =
              make_uint2(pack_bf16(to_bf16(v[0]), to_bf16(v[1])),
                         pack_bf16(to_bf16(v[2]), to_bf16(v[3])));
        }
      } else {
        // a counter block is four adjacent rows of one column; lanes walk
        // the columns
#pragma unroll 2
        for (int t = pt; t < (share / 4) * PK; t += PRODUCERS) {
          const int b = r0 / 4 + t / PK, c = t % PK;
          const int64_t gc = k0 + c;
          const int64_t rr = i0 + 4 * b - shift;  // output row of lane 0
          float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (gc < m && rr + 3 >= 0 && rr < d) {
            gen4<RNG, GAUSS>(
                seed, (uint64_t)gc * ctr_stride + (uint64_t)((i0 >> 2) + b),
                v);
          }
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            const int row = 4 * b + l;
            const float x = (rr + l < 0 || rr + l >= d) ? 0.0f : v[l];
            *reinterpret_cast<__nv_bfloat16*>(panel + panel_off(row, c >> 3) +
                                              (c & 7) * 2) = to_bf16(x);
          }
        }
      }
      // 2. make the stores visible to wgmma and the bulk copies, then send
      //    this CTA's panel rows, one contiguous run, to every peer (thread
      //    r copies to rank r)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" :: "n"(PRODUCERS) : "memory");
      const uint32_t bytes = (uint32_t)share * (PK * 2);
      const uint32_t src = smem_u32(panel) + (uint32_t)r0 * (PK * 2);
      if (pt == 0) mbar_arrive_expect(full(ps), (csize - 1) * bytes);
      if (pt < (int)csize && pt != (int)crank) {
        bulk_to_peer(peer(src, pt), src, bytes, peer(full(ps), pt));
      }
    }
    cluster_sync();
  }
}

template <typename TA, int RNG, bool GAUSS>
__global__ void __launch_bounds__(THREADS, 1)
fused_sketch_kernel(const TA* __restrict__ a, int64_t sk, int64_t sn,
                    const __grid_constant__ CUtensorMap map, int amode,
                    int64_t ks, float* __restrict__ out, int64_t d, int64_t m,
                    int64_t n, uint64_t ctr_stride, Seed seed, float alpha) {
  sketch_tile<TA, RNG, GAUSS, false>(a, sk, sn, &map, amode, ks, out, d, m,
                                     n, 0, ctr_stride, seed, alpha);
}

// ---------------------------------------------------------------- K2 ----

template <typename TA, int RNG, bool GAUSS>
__global__ void __launch_bounds__(THREADS, 1)
fused_sketch_T_kernel(const TA* __restrict__ a, int64_t sk, int64_t sn,
                      const __grid_constant__ CUtensorMap map, int amode,
                      int64_t ks, float* __restrict__ out, int64_t d,
                      int64_t m, int64_t n, int shift, uint64_t ctr_stride,
                      Seed seed, float alpha) {
  sketch_tile<TA, RNG, GAUSS, true>(a, sk, sn, &map, amode, ks, out, d, m, n,
                                    shift, ctr_stride, seed, alpha);
}

// ---------------------------------------------------------------- K3 ----
//
// The block's natural element (r, c), 0 <= r < rows, 0 <= c < cols, is lane
// (c + shift) % 4 of the counter block at seed + r * ctr_stride +
// (c + shift) / 4. K3 writes it to out[r * cols + c] (the natural
// orientation, fill_block_kernel) or to out[c * rows + r]
// (fill_block_T_kernel: the math layout of a ColMajor-natural block, whose
// natural rows are the operator's columns).
//
// What bounds K3 on the H100, and what this design does about it:
// - Bytes. It reads nothing and writes rows * cols floats once: 0.080 ms
//   for 1024 x 65536 at 3.35 TB/s.
// - Operations. A Philox4x32-10 (or Threefry4x32-20) block per four values
//   on the integer pipe, and for Gaussian values two Box-Muller transforms
//   with the accurate logf and sqrtf and one sincosf (one argument
//   reduction for both values, and the same bits as sinf and cosf). At
//   1024 x 65536 this work alone takes about as long as the stores, so
//   the two have to overlap.
// - Natural orientation: no shared memory and no barrier, so generation
//   and stores interleave freely across warps. A warp generates 32
//   consecutive counter blocks of a row. Output quad q (columns 4q to
//   4q + 3) holds lanes shift..3 of block q and lanes 0..shift-1 of block
//   q + 1, which one shuffle brings from the next lane; so a warp stores
//   the 31 quads (32 when shift == 0) whose blocks it holds: 512 contiguous
//   bytes per warp and row, as 16-byte stores where the rows allow them
//   (cols % 4 == 0, a 16-byte aligned `out`) and 4-byte stores otherwise.
//   Each thread generates FILL_ROWS blocks, one per row, whose independent
//   chains the scheduler interleaves; their counter offsets are 64-bit adds
//   of ctr_stride (no division or modulo per block).
// - Transposed orientation: a CTA stages a tile of TR natural rows x SEG
//   counter blocks in shared memory (32 x 32, or 4 x 256 for a block of
//   fewer than 32 natural rows), the value of natural column c at slot
//   c - (4 b0 - 4) (b0 the tile's first counter block). A tile's column is
//   an output row of TR values (128 bytes for TR = 32), written four rows a
//   thread (rows % 4 == 0) or one; the tile's row stride of 4 SEG + 5
//   floats (5 mod 32 banks) keeps these column reads free of bank
//   conflicts.
// - The grid: runs of counter blocks on grid.x, rows (or row tiles) on
//   grid.y; each CTA loops gridDim.y apart past 65535.
// The Gaussian transform is a template argument: the TPU kernel's
// (kBoxmulI32, u01 on the signed view of the word) or the staged fill's
// (kBoxmul, u01 on the unsigned word). `scale` multiplies Uniform values by
// sqrt(3) in float32; without it the caller scales in its own dtype.

constexpr int FILL_THREADS = 256;
constexpr int FILL_WARPS = FILL_THREADS / 32;
constexpr int FILL_ROWS = 4;   // rows a thread generates (natural)
constexpr int FILL_BPT = 4;    // counter blocks a thread generates (T)
constexpr int FILL_TILE = FILL_THREADS * FILL_BPT;  // counter blocks a tile
constexpr int kBoxmulI32 = 0;
constexpr int kBoxmul = 1;

// u01 on the unsigned word: w * 2^-32 + 2^-33
__device__ __forceinline__ float u01_u32(uint32_t w) {
  return __fadd_rn(__fmul_rn(__uint2float_rn(w), 0x1p-32f), 0x1p-33f);
}

// Box-Muller on two words: sin and cos of pi * u from one sincosf
template <int XFORM>
__device__ __forceinline__ void boxmul_fill(uint32_t a, uint32_t b, float& x,
                                            float& y) {
  const float u = uneg11_i32((int32_t)a);
  const float w = XFORM == kBoxmul ? u01_u32(b) : u01_i32((int32_t)b);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(w)));
  float s, c;
  sincosf(__fmul_rn(kPi, u), &s, &c);
  x = __fmul_rn(s, r);
  y = __fmul_rn(c, r);
}

// the four values of the counter block at seed + off under K3's transform
template <int RNG, bool GAUSS, int XFORM>
__device__ __forceinline__ void fill4(const Seed& seed, uint64_t off,
                                      int scale, float v[4]) {
  uint32_t x[4];
  words4<RNG>(seed, off, x);
  if (GAUSS) {
    boxmul_fill<XFORM>(x[0], x[1], v[0], v[1]);
    boxmul_fill<XFORM>(x[2], x[3], v[2], v[3]);
  } else {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      v[l] = uneg11_i32((int32_t)x[l]);
      if (scale) v[l] = __fmul_rn(v[l], kSqrt3);
    }
  }
}

// the output quad of a lane: lanes shift..3 of its block, then lanes
// 0..shift-1 of the next lane's (every lane of the warp takes part)
__device__ __forceinline__ void realign(const float v[4], int shift,
                                        float w[4]) {
  float a[8];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    a[l] = v[l];
    a[4 + l] = __shfl_down_sync(0xFFFFFFFFu, v[l], 1);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = (shift & 2) ? ((shift & 1) ? a[i + 3] : a[i + 2])
                       : ((shift & 1) ? a[i + 1] : a[i]);
  }
}

template <int RNG, bool GAUSS, int XFORM>
__global__ void __launch_bounds__(FILL_THREADS)
fill_block_kernel(float* __restrict__ out, int64_t rows, int64_t cols,
                  int shift, uint64_t ctr_stride, Seed seed, int scale,
                  int vec) {
  const int lane = threadIdx.x % 32;
  const int per_warp = shift ? 31 : 32;  // output quads a warp stores
  // this lane's counter block, and the output quad it stores
  const int64_t q =
      ((int64_t)blockIdx.x * FILL_WARPS + threadIdx.x / 32) * per_warp +
      lane;
  const int64_t c0 = 4 * q;
  const bool stores = lane < per_warp && c0 < cols;
  for (int64_t r0 = (int64_t)blockIdx.y * FILL_ROWS; r0 < rows;
       r0 += (int64_t)gridDim.y * FILL_ROWS) {
    float v[FILL_ROWS][4];
    uint64_t off = (uint64_t)r0 * ctr_stride + (uint64_t)q;
#pragma unroll
    for (int k = 0; k < FILL_ROWS; ++k, off += ctr_stride) {
      fill4<RNG, GAUSS, XFORM>(seed, off, scale, v[k]);  // rows past the
    }                                                    // edge: never stored
#pragma unroll
    for (int k = 0; k < FILL_ROWS; ++k) {
      float w[4] = {v[k][0], v[k][1], v[k][2], v[k][3]};
      if (shift) realign(v[k], shift, w);
      const int64_t r = r0 + k;
      if (!stores || r >= rows) continue;
      float* o = out + r * cols + c0;
      if (vec) {
        *reinterpret_cast<float4*>(o) = make_float4(w[0], w[1], w[2], w[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (c0 + i < cols) o[i] = w[i];
        }
      }
    }
  }
}

// a tile of TR rows x SEG counter blocks, staged as TR rows of STRIDE
// floats: SLOTS = 4 SEG values and one quad of slack for the shift
template <int SEG_>
struct FillTile {
  static constexpr int SEG = SEG_;
  static constexpr int TR = FILL_TILE / SEG;
  static constexpr int SLOTS = 4 * SEG + 4;
  static constexpr int STRIDE = SLOTS + 1;
};

template <int RNG, bool GAUSS, int XFORM, int SEG>
__global__ void __launch_bounds__(FILL_THREADS)
fill_block_T_kernel(float* __restrict__ out, int64_t rows, int64_t cols,
                    int shift, uint64_t ctr_stride, Seed seed, int scale,
                    int vec) {
  using T = FillTile<SEG>;
  constexpr int kRowStep = FILL_THREADS / T::SEG;  // rows between blocks
  __shared__ __align__(16) float tile[T::TR * T::STRIDE];
  const int tid = threadIdx.x;
  const int j = tid % T::SEG, rl0 = tid / T::SEG;
  const int64_t b0 = (int64_t)blockIdx.x * T::SEG;
  const int64_t cb = 4 * b0 - 4;  // the natural column of slot 0
  // this tile's values fill slots [lo, hi); natural columns from 0 to cols
  const int lo = 4 - shift, hi = 4 * T::SEG + 4 - shift;
  const int64_t row_tiles = (rows + T::TR - 1) / T::TR;
  for (int64_t rt = blockIdx.y; rt < row_tiles; rt += gridDim.y) {
    const int64_t r0 = rt * T::TR;
    // 1. block b0 + j of rows r0 + rl0 + k kRowStep into the tile (rows and
    //    blocks past the block's edges too: their slots are never stored)
    uint64_t off = (uint64_t)(r0 + rl0) * ctr_stride + (uint64_t)(b0 + j);
    const uint64_t step = (uint64_t)kRowStep * ctr_stride;
#pragma unroll
    for (int k = 0; k < FILL_BPT; ++k, off += step) {
      float v[4];
      fill4<RNG, GAUSS, XFORM>(seed, off, scale, v);
      float* dst = tile + (rl0 + k * kRowStep) * T::STRIDE + 4 * j + lo;
#pragma unroll
      for (int l = 0; l < 4; ++l) dst[l] = v[l];
    }
    __syncthreads();
    // 2. output row c = cb + s is the tile's column s
    if (vec) {  // four rows a thread: rows % 4 == 0, so r + 4 <= rows
      for (int t = tid; t < T::SLOTS * (T::TR / 4); t += FILL_THREADS) {
        const int q = t % (T::TR / 4), s = t / (T::TR / 4);
        const int64_t c = cb + s, r = r0 + 4 * q;
        if (r >= rows || s < lo || s >= hi || c < 0 || c >= cols) continue;
        const float* src = tile + 4 * q * T::STRIDE + s;
        *reinterpret_cast<float4*>(out + c * rows + r) =
            make_float4(src[0], src[T::STRIDE], src[2 * T::STRIDE],
                        src[3 * T::STRIDE]);
      }
    } else {
      for (int t = tid; t < T::SLOTS * T::TR; t += FILL_THREADS) {
        const int rl = t % T::TR, s = t / T::TR;
        const int64_t c = cb + s, r = r0 + rl;
        if (r < rows && s >= lo && s < hi && c >= 0 && c < cols) {
          out[c * rows + r] = tile[rl * T::STRIDE + s];
        }
      }
    }
    __syncthreads();  // the next row tile rewrites the tile
  }
}

// The launch plan of K1 and K2, computed by ops/fused_sketch.py::launch_plan
// and checked here: the compiled tile sizes and panel step, a cluster of 1,
// 2, 4, 8 or 16 CTAs along n that divides grid.x, a grid that covers the
// output, and the contraction split into `splits` ranges of `ks` steps of
// TK on grid.z, each range a whole number of panel steps where there are
// several.
struct Plan {
  int ti, tn, tk, pk, cluster;
  unsigned gx, gy;
  int splits, ks;
};

bool plan_ok(const Plan& p, int64_t rows, int64_t m, int64_t n) {
  const int c = p.cluster;
  return p.ti == TI && p.tn == TN && p.tk == TK && p.pk == PK && c >= 1 &&
         c <= MAX_CLUSTER && (c & (c - 1)) == 0 && p.gx % c == 0 &&
         (int64_t)p.gx * TN >= n && (int64_t)p.gy * TI >= rows &&
         p.gy <= 65535 && p.splits >= 1 && p.splits <= 65535 && p.ks >= 1 &&
         (p.splits == 1 || p.ks % KSTEPS == 0) &&
         (int64_t)p.splits * p.ks * TK >= m;
}

// K1's or K2's `kernel` on the plan's grid and clusters
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, const Plan& p, cudaStream_t stream,
                           Args... args) {
  cudaError_t e = prepare(kernel, SMEM_BYTES, p.cluster);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(p.gx, p.gy, (unsigned)p.splits), THREADS,
                     SMEM_BYTES, p.cluster, stream, &attr);
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// K1 (COLMAJOR false) or K2 on A of type TA with generator RNG
template <bool COLMAJOR, typename TA, int RNG>
cudaError_t launch_fused(const void* a, int64_t sk, int64_t sn, float* ws,
                         float* out, int64_t d, int64_t m, int64_t n,
                         int shift, uint64_t ctr_stride, Seed seed,
                         int gaussian, float alpha, const Plan& p,
                         cudaStream_t stream) {
  const TA* ap = static_cast<const TA*>(a);
  CUtensorMap map = {};
  const int amode = a_map<TA, TN, TK>(a, sk, sn, m, n, &map);
  const int64_t ks = p.ks;
  auto run = [&](float* dst, float scale) {
    if constexpr (COLMAJOR) {
      auto kernel = gaussian ? fused_sketch_T_kernel<TA, RNG, true>
                             : fused_sketch_T_kernel<TA, RNG, false>;
      return launch_cluster(kernel, p, stream, ap, sk, sn, map, amode, ks,
                            dst, d, m, n, shift, ctr_stride, seed, scale);
    } else {
      auto kernel = gaussian ? fused_sketch_kernel<TA, RNG, true>
                             : fused_sketch_kernel<TA, RNG, false>;
      return launch_cluster(kernel, p, stream, ap, sk, sn, map, amode, ks,
                            dst, d, m, n, ctr_stride, seed, scale);
    }
  };
  return launch_split(run, p.splits, ws, out, d * n, alpha, stream);
}

// K3 in the natural orientation: grid.x over the output quads, 8 warps of
// 31 (or 32) quads a CTA; grid.y over the rows, FILL_ROWS a thread
template <int RNG, bool GAUSS, int XFORM>
cudaError_t launch_fill(float* out, int64_t rows, int64_t cols, int shift,
                        uint64_t ctr_stride, Seed seed, int scale,
                        cudaStream_t stream) {
  const int64_t per_cta = FILL_WARPS * (shift ? 31 : 32);
  const int64_t runs = ((cols + 3) / 4 + per_cta - 1) / per_cta;
  const int64_t row_runs = (rows + FILL_ROWS - 1) / FILL_ROWS;
  if (runs > 0x7FFFFFFF) return cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((unsigned)runs,
                  (unsigned)(row_runs < 65535 ? row_runs : 65535));
  fill_block_kernel<RNG, GAUSS, XFORM><<<grid, FILL_THREADS, 0, stream>>>(
      out, rows, cols, shift, ctr_stride, seed, scale,
      aligned && cols % 4 == 0);
  return cudaGetLastError();
}

// K3 in the transposed orientation: a CTA per SEG counter blocks of a row
// tile, 32 rows of 32 blocks, or 4 rows of 256 for a block of fewer than
// 32 rows (so that few rows waste little)
template <int RNG, bool GAUSS, int XFORM, int SEG>
cudaError_t launch_fill_T_tile(float* out, int64_t rows, int64_t cols,
                               int shift, uint64_t ctr_stride, Seed seed,
                               int scale, cudaStream_t stream) {
  using T = FillTile<SEG>;
  const int64_t runs = ((shift + cols + 3) / 4 + T::SEG - 1) / T::SEG;
  const int64_t row_tiles = (rows + T::TR - 1) / T::TR;
  if (runs > 0x7FFFFFFF) return cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((unsigned)runs,
                  (unsigned)(row_tiles < 65535 ? row_tiles : 65535));
  fill_block_T_kernel<RNG, GAUSS, XFORM, SEG>
      <<<grid, FILL_THREADS, 0, stream>>>(out, rows, cols, shift, ctr_stride,
                                          seed, scale,
                                          aligned && rows % 4 == 0);
  return cudaGetLastError();
}

template <int RNG, bool GAUSS, int XFORM>
cudaError_t launch_fill_T(float* out, int64_t rows, int64_t cols, int shift,
                          uint64_t ctr_stride, Seed seed, int scale,
                          cudaStream_t stream) {
  if (rows < 32) {
    return launch_fill_T_tile<RNG, GAUSS, XFORM, 256>(
        out, rows, cols, shift, ctr_stride, seed, scale, stream);
  }
  return launch_fill_T_tile<RNG, GAUSS, XFORM, 32>(
      out, rows, cols, shift, ctr_stride, seed, scale, stream);
}

// the instantiation for the generator, the family, the transform (Uniform
// values take none of their own) and the orientation
template <int RNG>
cudaError_t fill_dispatch(float* out, int64_t rows, int64_t cols, int shift,
                          uint64_t ctr_stride, Seed seed, int gaussian,
                          int transform, int transposed, int scale,
                          cudaStream_t stream) {
  auto run = [&](auto natural, auto trans) {
    return transposed ? trans(out, rows, cols, shift, ctr_stride, seed, scale,
                              stream)
                      : natural(out, rows, cols, shift, ctr_stride, seed,
                                scale, stream);
  };
  if (!gaussian) {
    return run(&launch_fill<RNG, false, kBoxmulI32>,
               &launch_fill_T<RNG, false, kBoxmulI32>);
  }
  if (transform == kBoxmul) {
    return run(&launch_fill<RNG, true, kBoxmul>,
               &launch_fill_T<RNG, true, kBoxmul>);
  }
  return run(&launch_fill<RNG, true, kBoxmulI32>,
             &launch_fill_T<RNG, true, kBoxmulI32>);
}

Plan make_plan(const int32_t* v) {
  return Plan{v[0], v[1], v[2], v[3], v[4], (unsigned)v[5], (unsigned)v[6],
              v[7], v[8]};
}

// K1 and K2 share this dispatch: the data type and the generator select
// the instantiation
template <bool COLMAJOR>
int fused_entry(const void* a, int a_bf16, int64_t sk, int64_t sn,
                float* ws, float* out, int64_t d, int64_t m, int64_t n,
                int shift, uint64_t ctr_stride, const uint32_t* seed_words,
                int rng, int gaussian, float alpha, const int32_t* plan_words,
                void* stream) {
  if (d <= 0 || n <= 0) return (int)cudaSuccess;
  if (rng != kPhilox4x32 && rng != kThreefry4x32) return (int)cudaErrorInvalidValue;
  if (shift < 0 || shift > 3 || m < 0) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(plan_words);
  if (!plan_ok(p, d + shift, m, n) || (p.splits > 1 && ws == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Seed seed = r123::make_seed(seed_words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the instantiation for the data type and the generator
  auto go = [&](auto ta, auto rng_code) {
    return launch_fused<COLMAJOR, decltype(ta), decltype(rng_code)::value>(
        a, sk, sn, ws, out, d, m, n, shift, ctr_stride, seed, gaussian, alpha,
        p, s);
  };
  using Philox = std::integral_constant<int, kPhilox4x32>;
  using Threefry = std::integral_constant<int, kThreefry4x32>;
  const bool philox = rng == kPhilox4x32;
  const cudaError_t e =
      a_bf16 ? (philox ? go(__nv_bfloat16(), Philox())
                       : go(__nv_bfloat16(), Threefry()))
             : (philox ? go(0.0f, Philox()) : go(0.0f, Threefry()));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py). seed_words holds the
// four counter words, then four key words (zero-padded); plan holds TI, TN,
// TK, PK, the cluster size, grid.x, grid.y, the splits of the contraction
// and the steps of TK per split of ops/fused_sketch.py's launch_plan; ws
// holds splits x d x n floats when splits > 1 (else it may be null). A's
// element (k, j) is at a[k * sk + j * sn]. Each launcher only enqueues on
// `stream` and returns the launch's error code.

extern "C" int rbt_fused_sketch(const void* a, int a_bf16, int64_t sk,
                                int64_t sn, float* ws, float* out, int64_t d,
                                int64_t m, int64_t n, uint64_t ctr_stride,
                                const uint32_t* seed_words, int rng,
                                int gaussian, float alpha,
                                const int32_t* plan, void* stream) {
  return fused_entry<false>(a, a_bf16, sk, sn, ws, out, d, m, n, 0,
                            ctr_stride, seed_words, rng, gaussian, alpha,
                            plan, stream);
}

extern "C" int rbt_fused_sketch_T(const void* a, int a_bf16, int64_t sk,
                                  int64_t sn, float* ws, float* out,
                                  int64_t d, int64_t m, int64_t n, int shift,
                                  uint64_t ctr_stride,
                                  const uint32_t* seed_words, int rng,
                                  int gaussian, float alpha,
                                  const int32_t* plan, void* stream) {
  return fused_entry<true>(a, a_bf16, sk, sn, ws, out, d, m, n, shift,
                           ctr_stride, seed_words, rng, gaussian, alpha, plan,
                           stream);
}

// cudaOccupancyMaxActiveClusters of K1's and K2's launch shape (THREADS
// threads, SMEM_BYTES of shared memory) for clusters of `cluster` CTAs: how
// many such clusters the current device runs at once
extern "C" int rbt_fused_max_clusters(int cluster, int* count) {
  if (cluster < 1 || cluster > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  return max_active_clusters(fused_sketch_kernel<float, kPhilox4x32, true>,
                             THREADS, SMEM_BYTES, cluster, count);
}

// K3: the (rows, cols) natural block whose row r, counter block b lives at
// seed + offset + r * ctr_stride + b, its first `shift` values skipped,
// into `out`: natural (transposed 0) or transposed (1, out is cols x rows).
// transform 0 is the TPU kernel's Gaussian transform, 1 the staged fill's;
// scale 1 multiplies Uniform values by sqrt(3).
extern "C" int rbt_fill_block(float* out, int64_t rows, int64_t cols,
                              int shift, uint64_t ctr_stride, uint64_t offset,
                              const uint32_t* seed_words, int rng,
                              int gaussian, int transform, int transposed,
                              int scale, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaSuccess;
  if ((rng != kPhilox4x32 && rng != kThreefry4x32) || shift < 0 ||
      shift > 3 || (transform != kBoxmulI32 && transform != kBoxmul)) {
    return (int)cudaErrorInvalidValue;
  }
  // the block's first counter, carried across all four words (RNGState.incr)
  Seed seed = r123::make_seed(seed_words);
  r123::counter4(seed, offset, seed.c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(rng == kPhilox4x32
                   ? fill_dispatch<kPhilox4x32>(out, rows, cols, shift,
                                                ctr_stride, seed, gaussian,
                                                transform, transposed, scale,
                                                s)
                   : fill_dispatch<kThreefry4x32>(out, rows, cols, shift,
                                                  ctr_stride, seed, gaussian,
                                                  transform, transposed,
                                                  scale, s));
}

extern "C" const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
