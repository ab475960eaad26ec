// Hand-written Hopper (sm_90a) kernel of the sparse-sign (SASO) sketch.
//
// K4 saso_sketch_kernel replaces randblas_tpu/ops/saso_sketch.py:67::_kernel
// (the Pallas one-hot kernel reached through _call / saso_sketch). It computes
//   B = alpha * S @ A
// for a wide SASO S (d x m) with exactly k <= 16 entries +-1 in each column,
// given as (k, m) tables: idx[s, c] is the output row of slot s of data row
// c (-1 for a padding column), sgn[s, c] its sign. A (m x n) is float32 or
// bf16, row-major or column-major (the right sketch hands in a transposed
// view); each value is rounded to bf16, as the JAX package pre-casts A, and
// the sums run in float32.
//
// What bounds it on the H100, and what this design does about it:
// - Bytes, not operations. The work is 2 k m n, a few GFLOP; A is read once
//   (537 MB as float32 at d=1024, m=65536, n=2048, k=8), the tables and the
//   output are small: about 0.16 ms at 3.35 TB/s. So A must be read once.
//   The TPU kernel built one-hot panels because Mosaic has no scatter; here
//   each block owns ALL d output rows of a 32-column strip and accumulates
//   them in shared memory (d x 32 float32: 128 KB at d = 1024, hence the
//   dynamic shared memory and the wrapper's d limit), streaming its strip of
//   A once, tile by tile.
// - Determinism without atomics. Lane j owns column j of the strip; warp w
//   owns the output rows r with r % 8 == w. Each warp scans the tile's
//   (data row, slot) pairs in order, 32 at a time, picks its own with a
//   ballot and adds sgn * A[c, j] into acc[r][j]. No two threads ever write
//   one address, and every output row sums its terms in (data row, slot)
//   order. Launching twice gives the same bits.
// - Filling 132 SMs. With 128 KB per block one block fits an SM, and n / 32
//   strips are too few blocks, so the rows of A are split into `split`
//   ranges, each block writes its partial (d x 32) sums, and a second
//   kernel adds the partials in range order (alpha applied there).
// - Latency. The next tile of A and of the tables is loaded into registers
//   while the warps work on the current one.
// Instruction count, not bytes, is then the likely limit of this simple
// kernel: about ten instructions per (data row, slot, column) update.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTN = 32;                 // output columns per block, one per lane
constexpr int kWarps = 8;               // each owns the output rows r % 8 == w
constexpr int kThreads = kTN * kWarps;  // 256
constexpr int kRows = 128;              // data rows per staged tile
constexpr int kTileLd = kTN + 1;        // padded tile row: no bank conflicts
constexpr int kMaxK = 16;
constexpr int kAPerThread = kRows * kTN / kThreads;       // 16
constexpr int kTabPerThread = kRows * kMaxK / kThreads;   // 8
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}

__device__ __forceinline__ float rounded(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float rounded(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One block: output rows 0..d-1, columns j0..j0+31; data rows
// [r_begin, r_end). dst is the output (split == 1, scaled by alpha) or this
// range's slice of the partial sums.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
saso_sketch_kernel(const T* __restrict__ a, int64_t stride_row,
                   int64_t stride_col, int colmajor,
                   const int32_t* __restrict__ idx,
                   const float* __restrict__ sgn, int64_t tab_ld,
                   float* __restrict__ dst, int d, int64_t m, int64_t n,
                   int k, int64_t rows_per_split, float alpha) {
  extern __shared__ float smem[];
  float* acc = smem;                                   // d x kTN
  float* tile = acc + (int64_t)d * kTN;                // kRows x kTileLd
  int32_t* tidx = reinterpret_cast<int32_t*>(tile + kRows * kTileLd);
  float* tsgn = reinterpret_cast<float*>(tidx + kRows * k);

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int64_t j0 = (int64_t)blockIdx.x * kTN;
  const int64_t r_begin = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r_end = min64(m, r_begin + rows_per_split);

  for (int64_t e = t; e < (int64_t)d * kTN; e += kThreads) acc[e] = 0.0f;

  float a_reg[kAPerThread];
  int32_t i_reg[kTabPerThread];
  float s_reg[kTabPerThread];
  const int pairs_max = kRows * k;

  // element e of this thread's share of the tile at row c0: its (row,
  // column) in the tile, in the order that keeps global loads coalesced
  auto a_pos = [&](int e, int& r, int& jj) {
    if (colmajor) {  // consecutive threads walk down a column
      r = t % kRows;
      jj = t / kRows + e * (kThreads / kRows);
    } else {         // consecutive threads walk along a row
      r = t / kTN + e * kWarps;
      jj = lane;
    }
  };
  auto load = [&](int64_t c0) {
    const int rows = (int)min64(kRows, r_end - c0);
#pragma unroll
    for (int e = 0; e < kAPerThread; ++e) {
      int r, jj;
      a_pos(e, r, jj);
      const int64_t j = j0 + jj;
      a_reg[e] = (r < rows && j < n)
                     ? rounded(a[(c0 + r) * stride_row + j * stride_col])
                     : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kTabPerThread; ++e) {
      const int p = t + e * kThreads;  // pair p = (row p / k, slot p % k)
      const int r = p / k, s = p % k;
      const bool ok = p < pairs_max && r < rows;
      i_reg[e] = ok ? idx[s * tab_ld + c0 + r] : -1;
      s_reg[e] = ok ? sgn[s * tab_ld + c0 + r] : 0.0f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int e = 0; e < kAPerThread; ++e) {
      int r, jj;
      a_pos(e, r, jj);
      tile[r * kTileLd + jj] = a_reg[e];
    }
#pragma unroll
    for (int e = 0; e < kTabPerThread; ++e) {
      const int p = t + e * kThreads;
      if (p < pairs_max) {
        tidx[p] = i_reg[e];
        tsgn[p] = s_reg[e];
      }
    }
  };

  if (r_begin < r_end) load(r_begin);
  for (int64_t c0 = r_begin; c0 < r_end; c0 += kRows) {
    __syncthreads();  // the previous tile is no longer read
    store();
    __syncthreads();
    if (c0 + kRows < r_end) load(c0 + kRows);  // in flight during the scan
    const int pairs = (int)min64(kRows, r_end - c0) * k;
    for (int p0 = 0; p0 < pairs; p0 += 32) {
      const int p = p0 + lane;
      const int32_t r_out = p < pairs ? tidx[p] : -1;
      const float s = p < pairs ? tsgn[p] : 0.0f;
      const bool mine = r_out >= 0 && r_out < d && (r_out % kWarps) == warp;
      unsigned mask = __ballot_sync(kFull, mine);
      while (mask) {  // warp-uniform: lowest pair first
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const int row = __shfl_sync(kFull, r_out, src);
        const float sg = __shfl_sync(kFull, s, src);
        const int r_data = (p0 + src) / k;
        float* cell = &acc[row * kTN + lane];
        *cell = __fadd_rn(*cell, __fmul_rn(sg, tile[r_data * kTileLd + lane]));
      }
    }
  }
  __syncthreads();
  if (gridDim.y > 1) dst += (int64_t)blockIdx.y * d * n;
  const int64_t j = j0 + lane;
  if (j < n) {
    for (int r = warp; r < d; r += kWarps) {
      const float v = acc[r * kTN + lane];
      dst[(int64_t)r * n + j] = gridDim.y == 1 ? alpha * v : v;
    }
  }
}

// out[e] = alpha * sum over p of partial[p][e], p in order
__global__ void saso_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int64_t count,
                                   int split, float alpha) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < count; e += (int64_t)gridDim.x * blockDim.x) {
    float s = partial[e];
    for (int p = 1; p < split; ++p) s = __fadd_rn(s, partial[p * count + e]);
    out[e] = alpha * s;
  }
}

template <typename T>
cudaError_t launch(const void* a, int64_t stride_row, int64_t stride_col,
                   int colmajor, const int32_t* idx, const float* sgn,
                   int64_t tab_ld, float* out, float* partial, int d,
                   int64_t m, int64_t n, int k, int split,
                   int64_t rows_per_split, float alpha, size_t smem,
                   cudaStream_t s) {
  auto kernel = saso_sketch_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((n + kTN - 1) / kTN), (unsigned)split);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(a), stride_row, stride_col, colmajor, idx, sgn,
      tab_ld, split == 1 ? out : partial, d, m, n, k, rows_per_split, alpha);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  const int64_t count = (int64_t)d * n;
  const int64_t blocks = min64((count + 255) / 256, 65535);
  saso_reduce_kernel<<<(unsigned)blocks, 256, 0, s>>>(partial, out, count,
                                                      split, alpha);
  return cudaGetLastError();
}

// Dynamic shared memory of one block: the d x 32 sums, the staged tile of
// A and the tile's tables (ops/saso_sketch.py::_smem_bytes).
size_t smem_bytes(int64_t d, int k) {
  return (size_t)(d * kTN * 4 + kRows * kTileLd * 4 + (int64_t)kRows * k * 8);
}

}  // namespace

extern "C" int rbt_saso_sketch(const void* a, int a_bf16, int64_t stride_row,
                               int64_t stride_col, const int32_t* idx,
                               const float* sgn, int64_t tab_ld, float* out,
                               float* partial, int64_t d, int64_t m, int64_t n,
                               int k, int split, int64_t rows_per_split,
                               float alpha, void* stream) {
  if (d <= 0 || n <= 0) return (int)cudaSuccess;
  if (k < 1 || k > kMaxK || split < 1 || split > 65535 || d > (1 << 30) ||
      (n + kTN - 1) / kTN > 0x7fffffff || rows_per_split % kRows != 0 ||
      (split > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  // column-major A: consecutive rows are adjacent (the right sketch's view)
  const int colmajor = stride_row == 1 && stride_col != 1;
  const size_t smem = smem_bytes(d, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      a_bf16 ? launch<__nv_bfloat16>(a, stride_row, stride_col, colmajor, idx,
                                     sgn, tab_ld, out, partial, (int)d, m, n,
                                     k, split, rows_per_split, alpha, smem, s)
             : launch<float>(a, stride_row, stride_col, colmajor, idx, sgn,
                             tab_ld, out, partial, (int)d, m, n, k, split,
                             rows_per_split, alpha, smem, s);
  return (int)err;
}
