// Hand-written Hopper (sm_90a) kernels of the dense Gaussian/Uniform sketch.
//
// K1 fused_sketch_kernel replaces randblas_tpu/ops/fused_sketch.py::_kernel
// (the Pallas RNG-in-GEMM kernel reached through _fused_call). It computes
//   B = alpha * S[ro:ro+d, co:co+m] @ A
// for a RowMajor-natural operator S whose element (i, c) is lane c % 4 of
// Philox4x32-10 (or Threefry4x32-20) at counter seed + i * ctr_stride + c / 4
// (the wrapper folds ro and co into the seed). S is generated panel by panel
// into shared memory and fed to bf16 mma.sync with float32 accumulation; no
// operator element is ever written to global memory.
//
// K2 fused_sketch_T_kernel replaces randblas_tpu/ops/fused_sketch.py:366
// ::_kernel_T (reached through _fused_call_T / fused_sketch_colmajor): the
// same product for a ColMajor-natural operator, whose element (i, c) is lane
// i % 4 at counter seed + c * ctr_stride + i / 4 (ctr_stride from the true
// parent height). It is K1 with another panel generator: one counter block
// yields four consecutive ROWS of one operator column, stored into the
// row-major shared panel as four 2-byte stores; a warp covers 32 adjacent
// columns of one row quad, so each store instruction writes 64 contiguous
// bytes of one panel row and meets no bank conflict. The mma fragments, the
// data tile and the epilogue are K1's. An unaligned row offset arrives as
// `shift` = ro % 4: the tile rows count from the previous counter boundary
// and the epilogue stores row g at output row g - shift (the TPU kernel
// generated extra rows and sliced them off outside). K2 carries the
// ColMajor-natural left sketch, the left-Trans sketch onto a
// ColMajor-natural transposed operator, and the backward pass of K1.
//
// K3 fill_block_kernel replaces randblas_tpu/ops/fused_sketch.py::_kernel_fill
// (reached through _fill_call / pallas_fill_block): generation only, a
// (rows, cols) natural-orientation block of S written in natural row order.
//
// All share one device generator, gen4: (seed, counter offset) -> four
// float32 values, the same arithmetic as the plain PyTorch versions in
// ops/fused_sketch.py (every multiply and add is rounded on its own, with
// __fmul_rn / __fadd_rn, so nothing is contracted into an FMA; logf, sqrtf,
// sinf and cosf are the accurate versions: build without --use_fast_math).
//
// What bounds K1 and K2 on the H100, and what this design does about it:
// - Generation, not the product. Each thread block owns one TI x TN output
//   tile and loops over the whole contraction, so every block regenerates
//   its TI x m operator panel: generation work is n / TN times the size of S
//   (32x at n = 4096, TN = 128). Philox rounds, Box-Muller (logf, sqrtf and
//   the sincospi polynomial) and counter carries are integer/FP32 pipe work
//   that this simple kernel does not overlap with the tensor cores beyond
//   what two resident blocks per SM give. Removing the regeneration (a wider
//   TN, or generating each panel once and sharing it across a cluster) is
//   later work. K2 does the same generation work per panel as K1 (TI x TK / 4
//   counter blocks per step), yet measured 12-22% slower than K1 at equal
//   flops on an H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md), with
//   more spills under the same 128-register cap.
// - The product runs on mma.sync m16n8k16 (bf16 in, f32 accumulate), not on
//   wgmma/TMA; operands come from padded shared memory without ldmatrix.
// - A is streamed once per output row tile (d / TI times); A's bytes are
//   not the bound. K2's backward-pass shape (65536 output rows) rides 512
//   row tiles on grid.y.
// Sums are deterministic: no atomics, a fixed k order inside each block.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPhilox4x32 = 0;
constexpr int kThreefry4x32 = 1;

struct Seed {
  uint32_t c[4];  // counter words, little-endian
  uint32_t k[4];  // key words (Philox uses k[0], k[1])
};

// float32 constants as exact bit patterns: the JAX package rounds the same
// decimal values to float32 (rng/transforms.py)
constexpr float kPi = 0x1.921fb6p+1f;
constexpr float kSqrt3 = 0x1.bb67aep+0f;
constexpr float kSinpiC0 = 0x1.921fb4p+1f;
constexpr float kSinpiC1 = -0x1.4abbbap+2f;
constexpr float kSinpiC2 = 0x1.466812p+1f;
constexpr float kSinpiC3 = -0x1.32423ep-1f;
constexpr float kSinpiC4 = 0x1.3d395ep-4f;

// seed counter + a 64-bit offset, carried across all four words
__device__ __forceinline__ void counter_at(const Seed& s, uint64_t off,
                                           uint32_t x[4]) {
  const uint64_t lo = ((uint64_t)s.c[1] << 32) | s.c[0];
  const uint64_t sum = lo + off;
  const uint32_t carry = sum < off ? 1u : 0u;
  x[0] = (uint32_t)sum;
  x[1] = (uint32_t)(sum >> 32);
  x[2] = s.c[2] + carry;
  x[3] = s.c[3] + ((x[2] < carry) ? 1u : 0u);
}

__device__ __forceinline__ void philox4x32_10(uint32_t x[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, x[0]);
    const uint32_t lo0 = 0xD2511F53u * x[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, x[2]);
    const uint32_t lo1 = 0xCD9E8D57u * x[2];
    const uint32_t y0 = hi1 ^ x[1] ^ k0;
    const uint32_t y2 = hi0 ^ x[3] ^ k1;
    x[0] = y0;
    x[1] = lo1;
    x[2] = y2;
    x[3] = lo0;
  }
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// one Threefry round: even rounds mix (0,1),(2,3), odd rounds (0,3),(2,1)
template <int RA, int RB, bool ODD>
__device__ __forceinline__ void tf_round(uint32_t x[4]) {
  if (!ODD) {
    x[0] += x[1];
    x[1] = rotl32(x[1], RA) ^ x[0];
    x[2] += x[3];
    x[3] = rotl32(x[3], RB) ^ x[2];
  } else {
    x[0] += x[3];
    x[3] = rotl32(x[3], RA) ^ x[0];
    x[2] += x[1];
    x[1] = rotl32(x[1], RB) ^ x[2];
  }
}

// four rounds then key injection S; odd S uses rotations 0-3, even S 4-7
template <int S>
__device__ __forceinline__ void tf_four(uint32_t x[4], const uint32_t ks[5]) {
  if (S % 2 == 1) {
    tf_round<10, 26, false>(x);
    tf_round<11, 21, true>(x);
    tf_round<13, 27, false>(x);
    tf_round<23, 5, true>(x);
  } else {
    tf_round<6, 20, false>(x);
    tf_round<17, 11, true>(x);
    tf_round<25, 10, false>(x);
    tf_round<18, 20, true>(x);
  }
  x[0] += ks[S % 5];
  x[1] += ks[(S + 1) % 5];
  x[2] += ks[(S + 2) % 5];
  x[3] += ks[(S + 3) % 5] + (uint32_t)S;
}

__device__ __forceinline__ void threefry4x32_20(uint32_t x[4],
                                                const uint32_t k[4]) {
  const uint32_t ks[5] = {k[0], k[1], k[2], k[3],
                          0x1BD11BDAu ^ k[0] ^ k[1] ^ k[2] ^ k[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] += ks[i];
  tf_four<1>(x, ks);
  tf_four<2>(x, ks);
  tf_four<3>(x, ks);
  tf_four<4>(x, ks);
  tf_four<5>(x, ks);
}

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

// Box-Muller on two words. FAST: the polynomial sincospi (K1); otherwise
// sinf/cosf of pi * u (K3).
template <bool FAST>
__device__ __forceinline__ void boxmul(uint32_t a, uint32_t b, float& x,
                                       float& y) {
  const float u = uneg11_i32((int32_t)a);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u01_i32((int32_t)b))));
  float s, c;
  if (FAST) {
    const float au = fabsf(u);
    const float ws =
        au > 0.5f ? (u >= 0.0f ? __fsub_rn(1.0f, au) : __fsub_rn(au, 1.0f))
                  : u;
    s = sinpi_half(ws);
    c = sinpi_half(__fsub_rn(0.5f, au));
  } else {
    const float ang = __fmul_rn(kPi, u);
    s = sinf(ang);
    c = cosf(ang);
  }
  x = __fmul_rn(s, r);
  y = __fmul_rn(c, r);
}

// the four values of the counter block at seed + off
template <int RNG, bool GAUSS, bool FAST>
__device__ __forceinline__ void gen4(const Seed& seed, uint64_t off,
                                     float v[4]) {
  uint32_t x[4];
  counter_at(seed, off, x);
  if (RNG == kPhilox4x32) {
    philox4x32_10(x, seed.k[0], seed.k[1]);
  } else {
    threefry4x32_20(x, seed.k);
  }
  if (GAUSS) {
    boxmul<FAST>(x[0], x[1], v[0], v[1]);
    boxmul<FAST>(x[2], x[3], v[2], v[3]);
  } else {
#pragma unroll
    for (int l = 0; l < 4; ++l) v[l] = __fmul_rn(uneg11_i32((int32_t)x[l]), kSqrt3);
  }
}

// ----------------------------------------------------------- K1, K2 ----

constexpr int TI = 128;      // operator rows (output rows) per block
constexpr int TN = 128;      // output columns per block
constexpr int TK = 32;       // contraction step
constexpr int THREADS = 256; // 8 warps: 2 (rows) x 4 (columns)
constexpr int PAD = 8;       // bf16 padding per shared row (bank spread)

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) { return x; }

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One TI x TN tile of B = alpha * S_blk @ A. COLMAJOR selects the panel
// generator (K2's when true). The tile's operator rows count from `shift`
// rows above output row 0: output row r is tile row r + shift (K1: 0).
template <typename TA, int RNG, bool GAUSS, bool COLMAJOR>
__device__ __forceinline__ void sketch_tile(const TA* __restrict__ a,
                                            float* __restrict__ out,
                                            int64_t d, int64_t m, int64_t n,
                                            int shift, uint64_t ctr_stride,
                                            const Seed& seed, float alpha) {
  // operator panel S[i0:i0+TI, k0:k0+TK] and data tile A[k0:k0+TK, n0:n0+TN]
  __shared__ __align__(16) __nv_bfloat16 s_op[TI][TK + PAD];
  __shared__ __align__(16) __nv_bfloat16 s_a[TK][TN + PAD];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;   // mma group / thread in group
  const int wm = warp >> 2, wn = warp & 3;   // warp's 64 x 32 output slice
  const int64_t i0 = (int64_t)blockIdx.y * TI;  // first tile row (shifted)
  const int64_t n0 = (int64_t)blockIdx.x * TN;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  for (int64_t k0 = 0; k0 < m; k0 += TK) {
    // 1. generate the panel: TI x TK / 4 counter blocks
    if constexpr (!COLMAJOR) {
      // a block is four adjacent columns of one row
#pragma unroll
      for (int j = 0; j < TI * (TK / 4) / THREADS; ++j) {
        const int idx = tid + j * THREADS;
        const int i = idx / (TK / 4), b = idx % (TK / 4);
        const int64_t gi = i0 + i, gc = k0 + 4 * b;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (gi < d) {
          gen4<RNG, GAUSS, true>(seed, (uint64_t)gi * ctr_stride + (uint64_t)(gc >> 2), v);
        }
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          if (gc + l >= m) v[l] = 0.0f;  // phantom columns multiply nothing
        }
        uint32_t* dst = reinterpret_cast<uint32_t*>(&s_op[i][4 * b]);
        dst[0] = pack_bf16(to_bf16(v[0]), to_bf16(v[1]));
        dst[1] = pack_bf16(to_bf16(v[2]), to_bf16(v[3]));
      }
    } else {
      // a block is four adjacent rows of one column; lanes walk columns
#pragma unroll
      for (int j = 0; j < (TI / 4) * TK / THREADS; ++j) {
        const int idx = tid + j * THREADS;
        const int c = idx % TK, b = idx / TK;
        const int64_t gc = k0 + c;
        const int64_t r0 = i0 + 4 * b - shift;  // output row of lane 0
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (gc < m && r0 + 3 >= 0 && r0 < d) {
          gen4<RNG, GAUSS, true>(seed, (uint64_t)gc * ctr_stride + (uint64_t)((i0 >> 2) + b), v);
        }
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          if (r0 + l < 0 || r0 + l >= d) v[l] = 0.0f;  // phantom rows
          s_op[4 * b + l][c] = to_bf16(v[l]);
        }
      }
    }
    // 2. stage the data tile as bf16, zero past the ragged edges
#pragma unroll
    for (int j = 0; j < TK * (TN / 4) / THREADS; ++j) {
      const int idx = tid + j * THREADS;
      const int r = idx / (TN / 4), c4 = idx % (TN / 4);
      const int64_t gk = k0 + r, gn = n0 + 4 * c4;
      __nv_bfloat16 w[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        w[l] = (gk < m && gn + l < n) ? to_bf16(a[gk * n + gn + l])
                                      : __float2bfloat16_rn(0.0f);
      }
      uint32_t* dst = reinterpret_cast<uint32_t*>(&s_a[r][4 * c4]);
      dst[0] = pack_bf16(w[0], w[1]);
      dst[1] = pack_bf16(w[2], w[3]);
    }
    __syncthreads();
    // 3. the warp's 64 x 32 slice: 4 x 4 tiles of m16n8k16
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int row = wm * 64 + mt * 16 + g;
        const int col = kk + 2 * tig;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&s_op[row][col]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&s_op[row + 8][col]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&s_op[row][col + 8]);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(&s_op[row + 8][col + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn * 32 + nt * 8 + g;
        const int k = kk + 2 * tig;
        bfr[nt][0] = pack_bf16(s_a[k][col], s_a[k + 1][col]);
        bfr[nt][1] = pack_bf16(s_a[k + 8][col], s_a[k + 9][col]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt]);
    }
    __syncthreads();
  }

  // epilogue: alpha once, masked stores of the ragged edges
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int64_t row = i0 - shift + wm * 64 + mt * 16 + g;
      const int64_t col = n0 + wn * 32 + nt * 8 + 2 * tig;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t r = row + (e >= 2 ? 8 : 0);
        const int64_t c = col + (e & 1);
        if (r >= 0 && r < d && c < n) out[r * n + c] = alpha * acc[mt][nt][e];
      }
    }
  }
}

template <typename TA, int RNG, bool GAUSS>
__global__ void __launch_bounds__(THREADS, 2)
fused_sketch_kernel(const TA* __restrict__ a, float* __restrict__ out,
                    int64_t d, int64_t m, int64_t n, uint64_t ctr_stride,
                    Seed seed, float alpha) {
  sketch_tile<TA, RNG, GAUSS, false>(a, out, d, m, n, 0, ctr_stride, seed,
                                     alpha);
}

// ---------------------------------------------------------------- K2 ----

template <typename TA, int RNG, bool GAUSS>
__global__ void __launch_bounds__(THREADS, 2)
fused_sketch_T_kernel(const TA* __restrict__ a, float* __restrict__ out,
                      int64_t d, int64_t m, int64_t n, int shift,
                      uint64_t ctr_stride, Seed seed, float alpha) {
  sketch_tile<TA, RNG, GAUSS, true>(a, out, d, m, n, shift, ctr_stride, seed,
                                    alpha);
}

// ---------------------------------------------------------------- K3 ----

// out[r, c] = natural-orientation element (r, c + shift) of the block whose
// row r, counter block b lives at seed + r * ctr_stride + b
template <int RNG, bool GAUSS>
__global__ void fill_block_kernel(float* __restrict__ out, int64_t rows,
                                  int64_t cols, int shift,
                                  uint64_t ctr_stride, Seed seed) {
  const int64_t nblk = (shift + cols + 3) / 4;
  const int64_t total = rows * nblk;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = t / nblk, b = t % nblk;
    float v[4];
    gen4<RNG, GAUSS, false>(seed, (uint64_t)r * ctr_stride + (uint64_t)b, v);
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int64_t c = 4 * b + l - shift;
      if (c >= 0 && c < cols) out[r * cols + c] = v[l];
    }
  }
}

Seed make_seed(const uint32_t* words) {
  Seed s;
  for (int i = 0; i < 4; ++i) {
    s.c[i] = words[i];
    s.k[i] = words[4 + i];
  }
  return s;
}

template <typename TA, int RNG>
void launch_fused(const void* a, float* out, int64_t d, int64_t m, int64_t n,
                  uint64_t ctr_stride, Seed seed, int gaussian, float alpha,
                  cudaStream_t stream) {
  const dim3 grid((unsigned)((n + TN - 1) / TN), (unsigned)((d + TI - 1) / TI));
  const TA* ap = static_cast<const TA*>(a);
  if (gaussian) {
    fused_sketch_kernel<TA, RNG, true><<<grid, THREADS, 0, stream>>>(
        ap, out, d, m, n, ctr_stride, seed, alpha);
  } else {
    fused_sketch_kernel<TA, RNG, false><<<grid, THREADS, 0, stream>>>(
        ap, out, d, m, n, ctr_stride, seed, alpha);
  }
}

template <typename TA, int RNG>
void launch_fused_T(const void* a, float* out, int64_t d, int64_t m,
                    int64_t n, int shift, uint64_t ctr_stride, Seed seed,
                    int gaussian, float alpha, cudaStream_t stream) {
  const dim3 grid((unsigned)((n + TN - 1) / TN),
                  (unsigned)((d + shift + TI - 1) / TI));
  const TA* ap = static_cast<const TA*>(a);
  if (gaussian) {
    fused_sketch_T_kernel<TA, RNG, true><<<grid, THREADS, 0, stream>>>(
        ap, out, d, m, n, shift, ctr_stride, seed, alpha);
  } else {
    fused_sketch_T_kernel<TA, RNG, false><<<grid, THREADS, 0, stream>>>(
        ap, out, d, m, n, shift, ctr_stride, seed, alpha);
  }
}

template <int RNG>
void launch_fill(float* out, int64_t rows, int64_t cols, int shift,
                 uint64_t ctr_stride, Seed seed, int gaussian,
                 cudaStream_t stream) {
  const int64_t nblk = (shift + cols + 3) / 4;
  const int64_t want = (rows * nblk + 255) / 256;
  const unsigned blocks = (unsigned)(want < 132 * 64 ? want : 132 * 64);
  if (gaussian) {
    fill_block_kernel<RNG, true><<<blocks, 256, 0, stream>>>(
        out, rows, cols, shift, ctr_stride, seed);
  } else {
    fill_block_kernel<RNG, false><<<blocks, 256, 0, stream>>>(
        out, rows, cols, shift, ctr_stride, seed);
  }
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py). seed_words holds the
// four counter words, then four key words (zero-padded). Each launcher only
// enqueues on `stream` and returns cudaGetLastError().

extern "C" int rbt_fused_sketch(const void* a, int a_bf16, float* out,
                                int64_t d, int64_t m, int64_t n,
                                uint64_t ctr_stride,
                                const uint32_t* seed_words, int rng,
                                int gaussian, float alpha, void* stream) {
  if (d <= 0 || n <= 0) return (int)cudaSuccess;
  if (rng != kPhilox4x32 && rng != kThreefry4x32) return (int)cudaErrorInvalidValue;
  const Seed seed = make_seed(seed_words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_bf16) {
    if (rng == kPhilox4x32)
      launch_fused<__nv_bfloat16, kPhilox4x32>(a, out, d, m, n, ctr_stride, seed, gaussian, alpha, s);
    else
      launch_fused<__nv_bfloat16, kThreefry4x32>(a, out, d, m, n, ctr_stride, seed, gaussian, alpha, s);
  } else {
    if (rng == kPhilox4x32)
      launch_fused<float, kPhilox4x32>(a, out, d, m, n, ctr_stride, seed, gaussian, alpha, s);
    else
      launch_fused<float, kThreefry4x32>(a, out, d, m, n, ctr_stride, seed, gaussian, alpha, s);
  }
  return (int)cudaGetLastError();
}

extern "C" int rbt_fused_sketch_T(const void* a, int a_bf16, float* out,
                                  int64_t d, int64_t m, int64_t n, int shift,
                                  uint64_t ctr_stride,
                                  const uint32_t* seed_words, int rng,
                                  int gaussian, float alpha, void* stream) {
  if (d <= 0 || n <= 0) return (int)cudaSuccess;
  if (rng != kPhilox4x32 && rng != kThreefry4x32) return (int)cudaErrorInvalidValue;
  if (shift < 0 || shift > 3) return (int)cudaErrorInvalidValue;
  const Seed seed = make_seed(seed_words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_bf16) {
    if (rng == kPhilox4x32)
      launch_fused_T<__nv_bfloat16, kPhilox4x32>(a, out, d, m, n, shift, ctr_stride, seed, gaussian, alpha, s);
    else
      launch_fused_T<__nv_bfloat16, kThreefry4x32>(a, out, d, m, n, shift, ctr_stride, seed, gaussian, alpha, s);
  } else {
    if (rng == kPhilox4x32)
      launch_fused_T<float, kPhilox4x32>(a, out, d, m, n, shift, ctr_stride, seed, gaussian, alpha, s);
    else
      launch_fused_T<float, kThreefry4x32>(a, out, d, m, n, shift, ctr_stride, seed, gaussian, alpha, s);
  }
  return (int)cudaGetLastError();
}

extern "C" int rbt_fill_block(float* out, int64_t rows, int64_t cols,
                              int shift, uint64_t ctr_stride,
                              const uint32_t* seed_words, int rng,
                              int gaussian, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaSuccess;
  if (rng != kPhilox4x32 && rng != kThreefry4x32) return (int)cudaErrorInvalidValue;
  const Seed seed = make_seed(seed_words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rng == kPhilox4x32)
    launch_fill<kPhilox4x32>(out, rows, cols, shift, ctr_stride, seed, gaussian, s);
  else
    launch_fill<kThreefry4x32>(out, rows, cols, shift, ctr_stride, seed, gaussian, s);
  return (int)cudaGetLastError();
}

extern "C" const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
