// Hand-written Hopper (sm_90a) kernel of the BlockedELL sparse x dense product.
//
// K5 ell_spmm_kernel replaces randblas_tpu/ops/ell_spmm.py:209::_kernel (the
// Pallas kernel reached through _call / blocked_ell_matmul). It computes
//   C = alpha * E @ B
// for a BlockedELL matrix E (m x k): for each row and each column block of
// kb columns, bw slots (local column, value), padding slots with column -1,
// stored slot-major as (n_kblocks * bw, m_pad) tables. B is bf16; the values
// are rounded to bf16 as well, so each product is exact in float32, and each
// output row sums its terms in float32 in (column block, slot) order. The COO
// overflow of a bw_cap table stays outside the kernel, in PyTorch.
//
// With word_major = W > 0 the tables index B in word-major storage order, and
// the kernel reads natural-order B through the map: storage row s holds
// natural row (s % nblk) * W + s / nblk, nblk = ceil(k / W). The TPU kernel
// needed B in storage order (a Mosaic relayout workaround); here the map is
// applied once per entry, when the entry is compacted.
//
// The TPU kernel densifies one-hot panels for the MXU. At the density of
// benchmarks/run_all.py config 4b (20000 x 10000, 1e6 entries, 0.5%) that
// would be 207 GFLOP; a gather touches about 1 GB, so this kernel gathers.
//
// What bounds it on the H100, and what this design does about it:
// - The tables' bytes, once. At config 4b they are 103.5 MB, padded about
//   12x over the entries (632 slots per row for about 50 entries); B is
//   10 MB (bf16) and stays in the 50 MB L2; the output is 41 MB: about
//   0.05 ms at 3.35 TB/s. Each block reads the tables of its 32 rows in
//   chunks of kSlots slots, coalesced (one lane per row), for up to 512
//   output columns; the next chunk's tables load while a chunk is walked.
// - Compaction. Each row's non-empty slots of a chunk are compacted, in
//   (block, slot) order, into a list in shared memory: the B row (after
//   the word-major map, applied once per entry) and the bf16-rounded
//   value. A count per (warp, row) and a prefix over the warps place each
//   entry. The walking warps then visit the entries only, not the 12x more
//   slots.
// - The gathers through L2: about 1 GB of B-row reads at config 4b (each
//   entry reads 512 bf16), 0.15-0.2 ms at L2's rate (an estimate), which
//   is this kernel's floor. A warp gathers the entries of its four rows as
//   one stream, lanes across the columns (16 bytes a lane, coalesced):
//   cp.async copies entry j's B-row segment into slot j % kRing of the
//   warp's ring in shared memory kRing entries before its FMAs, so each
//   warp keeps kRing KB of L2 reads in flight without holding them in
//   registers. Two blocks share an SM (82 KB of shared memory each, at
//   most 128 registers a thread: chunks of 128 slots spill).
// - No atomics: each output element belongs to one thread, which sums in
//   list order, the (block, slot) order. Launching twice gives the same
//   bits, and the plain version's bits.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerBlock = 32;                      // one lane per row
constexpr int kRowsPerWarp = kRowsPerBlock / kWarps;   // 4
constexpr int kVec = 8;                                // bf16 per 16-byte load
constexpr int kGroups = 2;                             // loads per lane per row
constexpr int kGroupCols = 32 * kVec;                  // 256
constexpr int kTN = kGroupCols * kGroups;              // 512 columns per block
constexpr int kSlots = 64;                             // slots per staged chunk
constexpr int kSlotsPerWarp = kSlots / kWarps;         // 8
constexpr int kRing = 8;               // a warp's entries in flight
constexpr int kListLd = kSlots + 1;    // padded list row: fewer bank conflicts
// dynamic shared memory: the rows' entry lists, then each warp's ring of
// B-row segments (kRing x kTN bf16)
constexpr int kListBytes = kRowsPerBlock * kListLd * 8;
constexpr int kRingBytes = kWarps * kRing * kTN * 2;
constexpr int kSmemBytes = kListBytes + kRingBytes;

// 16 bytes from global to shared memory, asynchronously (L2 only)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's newest groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__global__ void __launch_bounds__(kThreads, 2)
ell_spmm_kernel(const int32_t* __restrict__ ci, const float* __restrict__ v,
                int64_t tab_ld, int64_t n_slots, int bw, int kb,
                const __nv_bfloat16* __restrict__ b, int64_t ldb,
                int64_t b_rows, float* __restrict__ out, int64_t m, int64_t n,
                int word_major, int nblk, float alpha) {
  extern __shared__ uint4 smem[];
  // row rl's entries of the chunk: (B row, value bits), in slot order
  int2 (*s_list)[kListLd] = reinterpret_cast<int2 (*)[kListLd]>(smem);
  uint4* ring = reinterpret_cast<uint4*>(
      reinterpret_cast<uint8_t*>(smem) + kListBytes);
  // entries per (warp's slots, row); row kWarps: per row, the chunk's total
  __shared__ int s_cnt[kWarps + 1][kRowsPerBlock];

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int64_t r0 = (int64_t)blockIdx.x * kRowsPerBlock;
  const int64_t c0 = (int64_t)blockIdx.y * kTN;
  // this warp's ring: entry slot q, column group g, lane l at
  // wring[(q * kGroups + g) * 32 + l]
  uint4* wring = ring + warp * kRing * kGroups * 32;

  float acc[kRowsPerWarp][kGroups][kVec];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[rr][g][e] = 0.0f;

  // the tables of this thread's slots of a chunk: lane = row, warp w takes
  // slots s0 + 8 w .. + 8, so each load is 128 contiguous bytes
  const int64_t r = r0 + lane;
  int32_t cis[kSlotsPerWarp];
  float vals[kSlotsPerWarp];
  auto fetch = [&](int64_t s0) {
#pragma unroll
    for (int i = 0; i < kSlotsPerWarp; ++i) {
      const int64_t slot = s0 + warp * kSlotsPerWarp + i;
      const bool in = slot < n_slots && r < tab_ld;
      cis[i] = in ? __ldg(ci + slot * tab_ld + r) : -1;
      vals[i] = in ? __ldg(v + slot * tab_ld + r) : 0.0f;
    }
  };
  if (n_slots > 0) fetch(0);

  for (int64_t s0 = 0; s0 < n_slots; s0 += kSlots) {
    // 1. map each non-empty slot to its B row and count them (32-bit: the
    //    launcher checks that slots and B rows fit)
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < kSlotsPerWarp; ++i) {
      const uint32_t slot = (uint32_t)(s0 + warp * kSlotsPerWarp + i);
      if (cis[i] >= 0) {
        const uint32_t sc = (slot / (uint32_t)bw) * (uint32_t)kb + cis[i];
        const uint32_t br =
            word_major ? (sc % (uint32_t)nblk) * (uint32_t)word_major +
                             sc / (uint32_t)nblk
                       : sc;
        cis[i] = br < (uint64_t)b_rows ? (int32_t)br : -1;
      }
      cnt += cis[i] >= 0;
    }
    __syncthreads();  // the previous chunk's lists are no longer read
    s_cnt[warp][lane] = cnt;
    __syncthreads();
    // 2. compact: this thread's entries go after those of the warps before
    int pos = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) pos += w < warp ? s_cnt[w][lane] : 0;
#pragma unroll
    for (int i = 0; i < kSlotsPerWarp; ++i) {
      if (cis[i] >= 0) {
        s_list[lane][pos] = make_int2(
            cis[i], __float_as_int(__bfloat162float(__float2bfloat16_rn(vals[i]))));
        ++pos;
      }
    }
    if (warp == kWarps - 1) s_cnt[kWarps][lane] = pos;
    __syncthreads();
    // the next chunk's tables load while this one is walked
    if (s0 + kSlots < n_slots) fetch(s0 + kSlots);

    // 3. walk: warp w gathers for rows 4 w .. 4 w + 3, in list order. Its
    //    entries form one stream; entry j's B-row segment is copied into
    //    ring slot j % kRing kRing entries ahead of its FMAs
    int cnt4[kRowsPerWarp];
    int total = 0;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      cnt4[rr] = s_cnt[kWarps][warp * kRowsPerWarp + rr];  // warp-uniform
      total += cnt4[rr];
    }
    auto prefetch_entry = [&](int j) {
      if (j < total) {
        int rr = 0, e = j;
#pragma unroll
        for (int q = 0; q < kRowsPerWarp - 1; ++q) {
          if (rr == q && e >= cnt4[q]) {
            e -= cnt4[q];
            rr = q + 1;
          }
        }
        const int br = s_list[warp * kRowsPerWarp + rr][e].x;
        const __nv_bfloat16* src = b + (int64_t)br * ldb;
        uint4* dst = wring + (j % kRing) * kGroups * 32 + lane;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const int64_t col = c0 + (int64_t)g * kGroupCols + lane * kVec;
          if (col < ldb) cp_async16(dst + g * 32, src + col);
        }
      }
      cp_async_commit();  // one group per entry, empty past the stream
    };
#pragma unroll
    for (int j = 0; j < kRing; ++j) prefetch_entry(j);
    int j = 0;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int rl = warp * kRowsPerWarp + rr;
      for (int e = 0; e < cnt4[rr]; ++e, ++j) {
        cp_async_wait<kRing - 1>();  // entry j has landed
        const float x = __int_as_float(s_list[rl][e].y);
        const uint4* src = wring + (j % kRing) * kGroups * 32 + lane;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const uint4 raw = src[g * 32];
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int q = 0; q < kVec / 2; ++q) {
            const float2 f = __bfloat1622float2(h[q]);
            // x * f is exact (two bf16 values), so this equals add(mul)
            acc[rr][g][2 * q] = __fmaf_rn(x, f.x, acc[rr][g][2 * q]);
            acc[rr][g][2 * q + 1] = __fmaf_rn(x, f.y, acc[rr][g][2 * q + 1]);
          }
        }
        prefetch_entry(j + kRing);  // into the slot this thread just read
      }
    }
  }
  cp_async_wait<0>();

  const bool quads = n % 4 == 0;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int64_t row = r0 + warp * kRowsPerWarp + rr;
    if (row >= m) continue;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int64_t col = c0 + (int64_t)g * kGroupCols + lane * kVec;
      float* o = out + row * n + col;
      if (quads && col + kVec <= n) {
        reinterpret_cast<float4*>(o)[0] =
            make_float4(alpha * acc[rr][g][0], alpha * acc[rr][g][1],
                        alpha * acc[rr][g][2], alpha * acc[rr][g][3]);
        reinterpret_cast<float4*>(o)[1] =
            make_float4(alpha * acc[rr][g][4], alpha * acc[rr][g][5],
                        alpha * acc[rr][g][6], alpha * acc[rr][g][7]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          if (col + e < n) o[e] = alpha * acc[rr][g][e];
      }
    }
  }
}

}  // namespace

extern "C" int rbt_ell_spmm(const int32_t* ci, const float* v, int64_t tab_ld,
                            int64_t n_slots, int bw, int kb,
                            const void* b, int64_t ldb, int64_t b_rows,
                            float* out, int64_t m, int64_t n, int word_major,
                            int64_t nblk, float alpha, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaSuccess;
  // the kernel maps slots to B rows in 32-bit arithmetic
  if (bw < 1 || kb < 1 || ldb % kVec != 0 || ldb < n || m > tab_ld ||
      n_slots + kSlots > 0x7fffffff ||
      (n_slots / bw + 1) * (int64_t)kb > 0x7fffffff || b_rows > 0x7fffffff ||
      (word_major && (nblk < 1 || nblk > 0x7fffffff)) ||
      (m + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffff ||
      (ldb + kTN - 1) / kTN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ell_spmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((m + kRowsPerBlock - 1) / kRowsPerBlock),
            (unsigned)((ldb + kTN - 1) / kTN));
  ell_spmm_kernel<<<grid, kThreads, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      ci, v, tab_ld, n_slots, bw, kb, static_cast<const __nv_bfloat16*>(b),
      ldb, b_rows, out, m, n, word_major, (int)nblk, alpha);
  return (int)cudaGetLastError();
}
