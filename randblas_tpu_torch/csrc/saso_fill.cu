// Hand-written Hopper (sm_90a) kernel K7: the fill of a sparse-sign
// operator (SASO or LASO) by repeated Fisher-Yates, in one launch.
//
// K7 replaces no Pallas kernel: the JAX package samples the operator with
// jnp ops under vmap (randblas_tpu/sparse.py:82 repeated_fisher_yates),
// which never reach pallas_call. The port's plain version
// (randblas_tpu_torch/sparse.py repeated_fisher_yates_reference) runs one
// batched generator call and a Python loop over the vec_nnz steps, about 380
// small PyTorch launches for vec_nnz = 8, which the host's enqueues pace.
//
// What it computes (sparse.py's docstring): for each minor-axis vector i,
// 0 <= i < dim_minor, the k = vec_nnz steps j of a Fisher-Yates shuffle of
// the identity work vector V over {0..dim_major-1}. Step j reads the counter
// block at seed + i * k + j (rv = its first two words), picks
// ell = j + rv[0] % (dim_major - j) in unsigned 32-bit arithmetic, emits
// V[ell] before the swap as index (i, j) with the sign + for even rv[1],
// and swaps V[j] and V[ell]. Entry e = i * k + j of the outputs is
// major[e] = V[ell], minor[e] = i and vals[e] = +-1: the canonical
// minor-vector-major order. SparseSkOp.filled (sparse.py) takes major and
// minor as rows and cols, or cols and rows, by the operator's orientation.
//
// V is never built. A thread keeps a log of the writes that later steps can
// read: step j writes V[ell] = V[j] and V[j] = V[ell]; steps after j read
// only positions >= j + 1, so the write to position j is never read again
// and only (ell, old V[j]) is logged, one entry a step. A read of position
// p takes the newest entry at p, or p itself where none was logged: the
// plain version's values exactly (it logs both writes and reads the same
// positions). For k <= 16 the log lives in registers: the steps are
// unrolled up to the compile-time LOG = 16, each behind the uniform guard
// j < k, so every log slot has a fixed register and a read is a chain of
// compares and selects. k = 1 (CountSketch) runs LOG = 1: 18 registers
// against 50, and 5.13 against 6.26 us at 1024 x 524288 on an H100 80GB
// HBM3 (at k = 8 LOG = 8 and 16 both take 18.2 us). For
// larger k (LASO) the log is a scratch tensor of k entries a vector that
// the wrapper allocates, laid out entry-major so that a warp's reads of one
// entry are contiguous.
//
// What bounds K7 on the H100: its integer operations. At the benchmark's
// saso_k8_f32 shape (dim_major = 1024, dim_minor = 65536, k = 8) it writes
// 524288 entries of 4 + 4 + 4 bytes, 6.3 MB, 1.9 us at 3.35 TB/s, and runs
// 524288 Philox4x32-10 blocks: the SASS census of the LOG = 16 kernel with
// k fixed at 8 (kernel_variants.k7_census) counts 1924 ALU and 1157 IMAD
// instructions a vector, 7.5 us on the ALU pipe at 1980 MHz. The design
// is one launch of one thread a vector, nothing staged: a thread's k
// entries are contiguous in each output, so a warp's stores of one step land
// in 32 * k * 4 contiguous bytes that L2 merges. Measured on an H100 80GB
// HBM3: 0.0196 ms of device time at that shape, 38% of the operations
// bound, against 1.15 ms of device time and 6.1 ms of host time for the
// plain version's ~380 launches. 65536 threads are about 15 warps an SM,
// which likely hide too little of the dependent Philox rounds to reach the
// bound; at 2% of the benchmark's call that is left as it is.

#include <cuda_runtime.h>

#include <cstdint>

#include "random123.cuh"

namespace {

constexpr int kThreads = 256;
// the register log's steps: vec_nnz up to this keeps the log in registers
constexpr int kRegisterLog = 16;

struct Out {
  void* major;   // V[ell], int32 or int64
  void* minor;   // i, the same type
  void* vals;    // +-1 as `val_bytes`-byte words
  int idx64;
  int val_bytes;
  uint64_t plus;   // the bit patterns of +1 and -1 in the value type
  uint64_t minus;
};

__device__ __forceinline__ void store(const Out& o, uint64_t e,
                                      uint32_t idx, int64_t i, uint32_t r1) {
  if (o.idx64) {
    static_cast<int64_t*>(o.major)[e] = idx;
    static_cast<int64_t*>(o.minor)[e] = i;
  } else {
    static_cast<int32_t*>(o.major)[e] = (int32_t)idx;
    static_cast<int32_t*>(o.minor)[e] = (int32_t)i;
  }
  const uint64_t bits = (r1 & 1u) ? o.minus : o.plus;
  switch (o.val_bytes) {
    case 1: static_cast<uint8_t*>(o.vals)[e] = (uint8_t)bits; break;
    case 2: static_cast<uint16_t*>(o.vals)[e] = (uint16_t)bits; break;
    case 4: static_cast<uint32_t*>(o.vals)[e] = (uint32_t)bits; break;
    default: static_cast<uint64_t*>(o.vals)[e] = bits; break;
  }
}

// LOG > 0: the log in registers, k <= LOG; LOG == 0: in `scratch`
// (k * dim_minor entries of two words), any k
template <int RNG, int LOG>
__global__ void __launch_bounds__(kThreads)
    saso_fill_kernel(Out out, r123::Seed seed, int64_t dim_minor, int k,
                     uint32_t dim_major, uint2* __restrict__ scratch) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= dim_minor) return;
  const uint64_t base = (uint64_t)i * (uint64_t)k;
  if constexpr (LOG > 0) {
    uint32_t pos[LOG], val[LOG];
#pragma unroll
    for (int j = 0; j < LOG; ++j) {
      if (j < k) {
        uint32_t r0, r1;
        r123::words2<RNG>(seed, base + j, r0, r1);
        const uint32_t ell = (uint32_t)j + r0 % (dim_major - (uint32_t)j);
        uint32_t at_ell = ell, at_j = (uint32_t)j;
#pragma unroll
        for (int t = 0; t < j; ++t) {   // oldest first: the newest wins
          at_ell = pos[t] == ell ? val[t] : at_ell;
          at_j = pos[t] == (uint32_t)j ? val[t] : at_j;
        }
        pos[j] = ell;
        val[j] = at_j;
        store(out, base + j, at_ell, i, r1);
      }
    }
  } else {
    for (int j = 0; j < k; ++j) {
      uint32_t r0, r1;
      r123::words2<RNG>(seed, base + j, r0, r1);
      const uint32_t ell = (uint32_t)j + r0 % (dim_major - (uint32_t)j);
      uint32_t at_ell = ell, at_j = (uint32_t)j;
      bool need_ell = true, need_j = true;
      for (int t = j - 1; t >= 0 && (need_ell || need_j); --t) {  // newest
        const uint2 w = scratch[(int64_t)t * dim_minor + i];
        if (need_ell && w.x == ell) {
          at_ell = w.y;
          need_ell = false;
        }
        if (need_j && w.x == (uint32_t)j) {
          at_j = w.y;
          need_j = false;
        }
      }
      scratch[(int64_t)j * dim_minor + i] = make_uint2(ell, at_j);
      store(out, base + j, at_ell, i, r1);
    }
  }
}

template <int RNG>
cudaError_t launch(const Out& out, const r123::Seed& seed, int64_t dim_minor,
                   int k, uint32_t dim_major, uint2* scratch,
                   cudaStream_t s) {
  const dim3 grid((unsigned)((dim_minor + kThreads - 1) / kThreads));
  if (k == 1) {   // CountSketch: one step, a third of the registers
    saso_fill_kernel<RNG, 1><<<grid, kThreads, 0, s>>>(out, seed, dim_minor,
                                                       k, dim_major, scratch);
  } else if (k <= kRegisterLog) {
    saso_fill_kernel<RNG, kRegisterLog><<<grid, kThreads, 0, s>>>(
        out, seed, dim_minor, k, dim_major, scratch);
  } else {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    saso_fill_kernel<RNG, 0><<<grid, kThreads, 0, s>>>(out, seed, dim_minor,
                                                       k, dim_major, scratch);
  }
  return cudaGetLastError();
}

}  // namespace

// words: the seed's counter words 0-3, then its key words 0-3 (unused
// words 0); rng: r123::kPhilox4x32 .. kThreefry2x32. Returns a CUDA error
// code (0: launched).
extern "C" int rbt_saso_fill(void* major, void* minor, void* vals,
                             void* scratch, int64_t dim_minor, int64_t k,
                             int64_t dim_major, const uint32_t* words,
                             int rng, int idx64, int val_bytes,
                             uint64_t plus_bits, uint64_t minus_bits,
                             void* stream) {
  if (k < 1 || k > dim_major || dim_major >= (int64_t(1) << 31) ||
      dim_minor < 0 ||
      (val_bytes != 1 && val_bytes != 2 && val_bytes != 4 && val_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if (dim_minor == 0) return (int)cudaSuccess;
  if (major == nullptr || minor == nullptr || vals == nullptr)
    return (int)cudaErrorInvalidValue;
  const r123::Seed seed = r123::make_seed(words);
  const Out out{major, minor, vals, idx64, val_bytes, plus_bits, minus_bits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint2* log = static_cast<uint2*>(scratch);
  switch (rng) {
    case r123::kPhilox4x32:
      return (int)launch<r123::kPhilox4x32>(out, seed, dim_minor, (int)k,
                                            (uint32_t)dim_major, log, s);
    case r123::kPhilox2x32:
      return (int)launch<r123::kPhilox2x32>(out, seed, dim_minor, (int)k,
                                            (uint32_t)dim_major, log, s);
    case r123::kThreefry4x32:
      return (int)launch<r123::kThreefry4x32>(out, seed, dim_minor, (int)k,
                                              (uint32_t)dim_major, log, s);
    case r123::kThreefry2x32:
      return (int)launch<r123::kThreefry2x32>(out, seed, dim_minor, (int)k,
                                              (uint32_t)dim_major, log, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
