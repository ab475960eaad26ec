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
// one integer division per slot.
//
// What bounds it on the H100, and what this design does about it:
// - Bytes of the tables. At benchmarks/run_all.py config 4b (20000 x 10000,
//   1e6 entries, B 10000 x 512) the tables are 103.5 MB, padded about 12x
//   over the entries; B is 10 MB (bf16) and stays in the 50 MB L2; the
//   output is 41 MB. That is about 0.05 ms at 3.35 TB/s. So each block reads
//   the tables of its 32 rows once, coalesced (one lane per row), for up to
//   512 output columns, and keeps its sums in registers.
// - The TPU kernel built one-hot panels because Mosaic has no gather; here a
//   warp walks each of its 4 rows' slots in order, skips the empty ones
//   (warp-uniform branch) and gathers the slot's row of B with lanes across
//   the columns: 16 bytes (8 bf16) per lane per load, so each B row read is
//   coalesced. The row reads hit L2, not device memory: about 1 GB of them
//   at config 4b, which is this simple kernel's likely limit.
// - No atomics: each output element belongs to one thread, which sums in a
//   fixed order. Launching twice gives the same bits.

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

__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const int32_t* __restrict__ ci, const float* __restrict__ v,
                int64_t tab_ld, int64_t n_slots, int bw, int kb,
                const __nv_bfloat16* __restrict__ b, int64_t ldb,
                int64_t b_rows, float* __restrict__ out, int64_t m, int64_t n,
                int word_major, int64_t nblk, float alpha) {
  __shared__ int64_t s_row[kSlots][kRowsPerBlock];  // B row, -1 = empty slot
  __shared__ float s_val[kSlots][kRowsPerBlock];

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int64_t r0 = (int64_t)blockIdx.x * kRowsPerBlock;
  const int64_t c0 = (int64_t)blockIdx.y * kTN;

  float acc[kRowsPerWarp][kGroups][kVec];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[rr][g][e] = 0.0f;

  for (int64_t s0 = 0; s0 < n_slots; s0 += kSlots) {
    __syncthreads();  // the previous chunk is no longer read
    // stage the chunk: lane = row, so each table load is 128 contiguous bytes
#pragma unroll
    for (int i = 0; i < kSlots / kWarps; ++i) {
      const int sl = warp + i * kWarps;
      const int64_t slot = s0 + sl;
      const int64_t r = r0 + lane;
      int64_t row = -1;
      float val = 0.0f;
      if (slot < n_slots && r < tab_ld) {
        const int32_t c = ci[slot * tab_ld + r];
        if (c >= 0) {
          const int64_t s = (slot / bw) * kb + c;  // storage column
          row = word_major ? (s % nblk) * word_major + s / nblk : s;
          if (row >= b_rows) row = -1;
          val = __bfloat162float(__float2bfloat16_rn(v[slot * tab_ld + r]));
        }
      }
      s_row[sl][lane] = row;
      s_val[sl][lane] = val;
    }
    __syncthreads();
    const int nsl = (int)(n_slots - s0 < kSlots ? n_slots - s0 : kSlots);
    for (int sl = 0; sl < nsl; ++sl) {
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int rl = warp * kRowsPerWarp + rr;
        const int64_t row = s_row[sl][rl];  // the same for the whole warp
        if (row < 0) continue;
        const float val = s_val[sl][rl];
        const __nv_bfloat16* bp = b + row * ldb + c0;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const int64_t col = (int64_t)g * kGroupCols + lane * kVec;
          if (c0 + col >= ldb) continue;
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(bp + col));
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int e = 0; e < kVec / 2; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            // val * f is exact (two bf16 values), so this equals add(mul)
            acc[rr][g][2 * e] = __fmaf_rn(val, f.x, acc[rr][g][2 * e]);
            acc[rr][g][2 * e + 1] = __fmaf_rn(val, f.y, acc[rr][g][2 * e + 1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int64_t r = r0 + warp * kRowsPerWarp + rr;
    if (r >= m) continue;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int64_t col = c0 + (int64_t)g * kGroupCols + lane * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (col + e < n) out[r * n + col + e] = alpha * acc[rr][g][e];
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
  if (bw < 1 || kb < 1 || ldb % kVec != 0 || ldb < n || m > tab_ld ||
      (word_major && nblk < 1) || (m + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffff ||
      (ldb + kTN - 1) / kTN > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((m + kRowsPerBlock - 1) / kRowsPerBlock),
            (unsigned)((ldb + kTN - 1) / kTN));
  ell_spmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ci, v, tab_ld, n_slots, bw, kb, static_cast<const __nv_bfloat16*>(b),
      ldb, b_rows, out, m, n, word_major, nblk, alpha);
  return (int)cudaGetLastError();
}
