// Hand-written Hopper (sm_90a) kernel K6: blocks of an operator seeded with
// a 64-bit-counter generator (Philox2x64-10, Philox4x64-10, Threefry2x64-20,
// Threefry4x64-20; an "x64 seed"), whose values are float64.
//
// K6 replaces no Pallas kernel: the JAX package fills these operators on the
// host, in randblas_tpu/rng/x64.py:248 ::fill_rowmajor64 and its C++ engine
// native/randblas_host.cpp:389 ::rbt_fill_rowmajor64_g (reached from
// randblas_tpu/dense.py:159 through _fill_submat_x64), because a TPU has no
// 64-bit integer lanes (randblas_tpu/rng/x64.py:7-9). Hopper has 64-bit adds
// with carry, a 64-bit multiply-high (__umul64hi) and float64 arithmetic on
// its CUDA cores, so the port makes the block on the card.
//
// The block's natural element (r, c), 0 <= r < rows, 0 <= c < cols, is lane
// (c + shift) % W of the counter block at first + r * ctr_stride +
// (c + shift) / W, W = 2 or 4 counter words, the sums carried across the W
// words (Random123's ctr.incr); `first` is the seed's counter advanced to the
// block's first counter by the wrapper (ops/x64_fill.py), `shift` the first
// value skipped in each row (rng/x64.py's fbs). fill_block64_kernel writes
// it to out[r * cols + c] (a RowMajor-natural block), fill_block64_T_kernel
// to out[c * rows + r] (a ColMajor-natural block in math orientation).
//
// The values are rng/x64.py's (Random123 uniform.hpp and boxmuller.hpp, the
// 64-bit row): uneg11(u) = (int64) u * 2^-63 + 2^-64, times sqrt(3) for
// Uniform operators; u01(u) = u * 2^-64 + 2^-65; Gaussian values from the
// word pairs (2i, 2i + 1) of a block: r sin(a), r cos(a) with a = pi *
// uneg11(u0), r = sqrt(-2 log(u01(u1))). Every multiply and add is rounded
// on its own (__dmul_rn, __dadd_rn), so nothing is contracted into an FMA,
// and sin, cos, log and sqrt are CUDA's float64 functions, the ones that
// torch.sin, torch.cos, torch.log and torch.sqrt run on a CUDA tensor: the
// plain version on the card gives the same bits. Against the host engines
// (glibc's or numpy's libm) Gaussian values differ by a few ulp. Build
// without --use_fast_math.
//
// What bounds K6 on the H100, and what this design does about it
// (x64_ablation.py: the census of this source's SASS by pipe class,
// NVIDIA's published per-SM rates, 132 SMs at the maximum SM clock, 1980
// MHz; moves count in no pipe):
// - Bytes. It reads nothing and writes rows * cols doubles once: 0.160 ms
//   for 1024 x 65536 at 3.35 TB/s. This bounds the natural kernel's
//   Gaussian and Uniform fills: a Philox4x64 Gaussian value takes 35.75
//   integer ALU, 28.25 IMAD and 33.5 FP64 operations in the main loop,
//   0.143 ms on the busiest pipe (the ALU); a Uniform value 27.9 ALU and
//   26 IMAD, 0.112 ms.
// - The ALU pipe. The Threefry2x64 T kernel's 64-bit adds, rotates and
//   xors, with its compares and address arithmetic: 85.5 a value, 0.343
//   ms, its bound.
// - What holds it back: issue. A Gaussian value takes 163 instructions,
//   22 moves and 25 uniform-datapath moves (UMOV: the transform's float64
//   constants, materialised at each use inside the math library) among
//   them, so the four schedulers of an SM need 0.327 ms for the block
//   (T kernel: 192.5, 0.386 ms). That is a property of this code, not a
//   bound of the function: the generator's and the transform's
//   instructions share the issue slots, so their times add. Generating
//   alone (no stores) takes 0.236 ms for Uniform, above its 73
//   instructions' 0.146 ms to issue: the 64-bit products (IMAD.WIDE,
//   about 21 a value) appear to hold the IMAD pipe for two cycles, which
//   the census' one-a-cycle rate does not count.
// - So the design cuts instructions and keeps more independent work in
//   flight: one sincos a Box-Muller pair in place of sin and cos, which
//   share the argument reduction (bit for bit the two calls: 11 FP64 and
//   19 other instructions less a pair); two counter blocks a thread in the
//   T kernel, X64_TY apart, four chains where it had two. Measured and not
//   kept (x64_ablation.py's exact variants): Philox's 128-bit product from
//   four explicit 32 x 32 -> 64-bit products (more instructions than
//   __umul64hi beside the low product), one, three or four rows a thread
//   in the natural kernel (two is fastest), 128-thread CTAs (within 1%),
//   a register cap that spills, and four-word rows staged through shared memory
//   (each warp store 512 contiguous bytes: slower when generating sets
//   the pace, though it made a store-bound variant 3x faster).
// - Natural orientation: threads run along the counter blocks of a row, so
//   a warp writes 32 W consecutive values of one row. Lane pairs (0, 1) and
//   (2, 3) are 16-byte stores where they land on 16-byte boundaries (shift
//   and cols even, `out` aligned), 8-byte stores otherwise. X64_ROWS rows
//   a thread.
// - Transposed orientation: threads run along the natural rows. A block's W
//   values go to W output rows at one column r, and the 32 lanes of a warp
//   hold 64 consecutive natural rows, so each store instruction writes 512
//   contiguous bytes of one output row: rows r and r + 1 as one 16-byte
//   store where rows is even, two 8-byte ones otherwise. Unlike K3's float32
//   tile (four rows a thread to make a 16-byte store), no shared-memory
//   transpose is needed.
// - The grid: the contiguous direction on grid.x, the other on grid.y, each
//   CTA looping gridDim.y apart past 65535.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPhilox2x64 = 0;
constexpr int kPhilox4x64 = 1;
constexpr int kThreefry2x64 = 2;
constexpr int kThreefry4x64 = 3;

constexpr int X64_THREADS = 256;
constexpr int X64_ROWS = 2;                     // rows a thread (natural)
constexpr int X64_TX = 32;                      // T: lanes along row pairs
constexpr int X64_TY = X64_THREADS / X64_TX;    // T: counter blocks a step
constexpr int X64_T_BLOCKS = 2;                 // T: blocks a thread
constexpr int64_t MAX_GRID_Y = 65535;
constexpr double kPi64 = 3.141592653589793;     // the double nearest pi
constexpr double kSqrt3_64 = 1.7320508075688772;

__host__ __device__ constexpr int width(int gen) {
  return gen == kPhilox2x64 || gen == kThreefry2x64 ? 2 : 4;
}

// Threefry's rotation constants (Random123 threefry.h), by round % 8
__host__ __device__ constexpr int tf2_rot(int i) {
  return i == 0 ? 16 : i == 1 ? 42 : i == 2 ? 12 : i == 3 ? 31
       : i == 4 ? 16 : i == 5 ? 32 : i == 6 ? 24 : 21;
}
__host__ __device__ constexpr int tf4_rot0(int i) {
  return i == 0 ? 14 : i == 1 ? 52 : i == 2 ? 23 : i == 3 ? 5
       : i == 4 ? 25 : i == 5 ? 46 : i == 6 ? 58 : 32;
}
__host__ __device__ constexpr int tf4_rot1(int i) {
  return i == 0 ? 16 : i == 1 ? 57 : i == 2 ? 40 : i == 3 ? 37
       : i == 4 ? 33 : i == 5 ? 12 : i == 6 ? 22 : 32;
}

constexpr uint64_t kPhiloxW0 = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kPhiloxW1 = 0xBB67AE8584CAA73Bull;
constexpr uint64_t kPhilox2M = 0xD2B74407B1CE6E93ull;
constexpr uint64_t kPhilox4M0 = 0xD2E7470EE14C6C93ull;
constexpr uint64_t kPhilox4M1 = 0xCA5A826395121157ull;
constexpr uint64_t kThreefryParity = 0x1BD11BDAA9FC1A22ull;

// the block's first counter and the key, zero-padded to four words
struct Seed64 {
  uint64_t c[4];
  uint64_t k[4];
};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

template <int GEN>
__device__ __forceinline__ void block64(const uint64_t c[], const Seed64& s,
                                        uint64_t x[]) {
  if constexpr (GEN == kPhilox2x64) {
    uint64_t x0 = c[0], x1 = c[1], k0 = s.k[0];
#pragma unroll
    for (int r = 0; r < 10; ++r) {
      if (r > 0) k0 += kPhiloxW0;
      const uint64_t hi = __umul64hi(kPhilox2M, x0);
      const uint64_t lo = kPhilox2M * x0;
      x0 = hi ^ k0 ^ x1;
      x1 = lo;
    }
    x[0] = x0;
    x[1] = x1;
  } else if constexpr (GEN == kPhilox4x64) {
    uint64_t x0 = c[0], x1 = c[1], x2 = c[2], x3 = c[3];
    uint64_t k0 = s.k[0], k1 = s.k[1];
#pragma unroll
    for (int r = 0; r < 10; ++r) {
      if (r > 0) {
        k0 += kPhiloxW0;
        k1 += kPhiloxW1;
      }
      const uint64_t hi0 = __umul64hi(kPhilox4M0, x0);
      const uint64_t lo0 = kPhilox4M0 * x0;
      const uint64_t hi1 = __umul64hi(kPhilox4M1, x2);
      const uint64_t lo1 = kPhilox4M1 * x2;
      x0 = hi1 ^ x1 ^ k0;
      x1 = lo1;
      x2 = hi0 ^ x3 ^ k1;
      x3 = lo0;
    }
    x[0] = x0;
    x[1] = x1;
    x[2] = x2;
    x[3] = x3;
  } else if constexpr (GEN == kThreefry2x64) {
    const uint64_t ks[3] = {s.k[0], s.k[1], kThreefryParity ^ s.k[0] ^ s.k[1]};
    uint64_t x0 = c[0] + ks[0], x1 = c[1] + ks[1];
#pragma unroll
    for (int r = 0; r < 20; ++r) {
      x0 += x1;
      x1 = rotl64(x1, tf2_rot(r % 8)) ^ x0;
      if ((r + 1) % 4 == 0) {
        const int q = (r + 1) / 4;
        x0 += ks[q % 3];
        x1 += ks[(q + 1) % 3] + (uint64_t)q;
      }
    }
    x[0] = x0;
    x[1] = x1;
  } else {
    const uint64_t ks[5] = {s.k[0], s.k[1], s.k[2], s.k[3],
                            kThreefryParity ^ s.k[0] ^ s.k[1] ^ s.k[2] ^
                                s.k[3]};
    uint64_t y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = c[i] + ks[i];
#pragma unroll
    for (int r = 0; r < 20; ++r) {
      const int r0 = tf4_rot0(r % 8), r1 = tf4_rot1(r % 8);
      if (r % 2 == 0) {
        y[0] += y[1];
        y[1] = rotl64(y[1], r0) ^ y[0];
        y[2] += y[3];
        y[3] = rotl64(y[3], r1) ^ y[2];
      } else {
        y[0] += y[3];
        y[3] = rotl64(y[3], r0) ^ y[0];
        y[2] += y[1];
        y[1] = rotl64(y[1], r1) ^ y[2];
      }
      if ((r + 1) % 4 == 0) {
        const int q = (r + 1) / 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) y[i] += ks[(q + i) % 5];
        y[3] += (uint64_t)q;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = y[i];
  }
}

// u01 and uneg11 of a 64-bit word: the conversion rounds once (to nearest),
// the scale by a power of two is exact, the add rounds once
__device__ __forceinline__ double u01_64(uint64_t u) {
  return __dadd_rn(__dmul_rn(__ull2double_rn(u), 0x1p-64), 0x1p-65);
}

__device__ __forceinline__ double uneg11_64(uint64_t u) {
  return __dadd_rn(__dmul_rn(__ll2double_rn((long long)u), 0x1p-63),
                   0x1p-64);
}

__device__ __forceinline__ void boxmul64(uint64_t a, uint64_t b, double& x,
                                         double& y) {
  const double ang = __dmul_rn(kPi64, uneg11_64(a));
  const double r = sqrt(__dmul_rn(-2.0, log(u01_64(b))));
  double s, c;
  sincos(ang, &s, &c);
  x = __dmul_rn(s, r);
  y = __dmul_rn(c, r);
}

// the W values of the counter block at seed.c + off (carried across words)
template <int GEN, bool GAUSS>
__device__ __forceinline__ void values64(const Seed64& s, uint64_t off,
                                         double v[]) {
  constexpr int W = width(GEN);
  uint64_t c[W], x[W];
  c[0] = s.c[0] + off;
  uint64_t carry = c[0] < off ? 1u : 0u;
#pragma unroll
  for (int i = 1; i < W; ++i) {
    c[i] = s.c[i] + carry;
    carry = c[i] < carry ? 1u : 0u;
  }
  block64<GEN>(c, s, x);
  if constexpr (GAUSS) {
#pragma unroll
    for (int i = 0; i < W; i += 2) boxmul64(x[i], x[i + 1], v[i], v[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = __dmul_rn(uneg11_64(x[i]), kSqrt3_64);
  }
}

template <int GEN, bool GAUSS>
__global__ void __launch_bounds__(X64_THREADS)
fill_block64_kernel(double* __restrict__ out, int64_t rows, int64_t cols,
                    int shift, uint64_t ctr_stride, Seed64 seed, int vec) {
  constexpr int W = width(GEN);
  const int64_t b = (int64_t)blockIdx.x * X64_THREADS + threadIdx.x;
  const int64_t c0 = b * W - shift;  // the output column of lane 0
  if (c0 >= cols) return;
  for (int64_t r0 = X64_ROWS * (int64_t)blockIdx.y; r0 < rows;
       r0 += X64_ROWS * (int64_t)gridDim.y) {
    double v[X64_ROWS][W];
    const uint64_t off = (uint64_t)r0 * ctr_stride + (uint64_t)b;
#pragma unroll
    for (int k = 0; k < X64_ROWS; ++k)  // a row past the edge: never stored
      values64<GEN, GAUSS>(seed, off + (uint64_t)k * ctr_stride, v[k]);
#pragma unroll
    for (int k = 0; k < X64_ROWS; ++k) {
      if (r0 + k >= rows) break;
      double* o = out + (r0 + k) * cols;
      if (vec) {  // c even, cols even: a pair is all in or all out
#pragma unroll
        for (int l = 0; l < W; l += 2) {
          const int64_t c = c0 + l;
          if (c >= 0 && c < cols) {
            *reinterpret_cast<double2*>(o + c) =
                make_double2(v[k][l], v[k][l + 1]);
          }
        }
      } else {
#pragma unroll
        for (int l = 0; l < W; ++l) {
          const int64_t c = c0 + l;
          if (c >= 0 && c < cols) o[c] = v[k][l];
        }
      }
    }
  }
}

template <int GEN, bool GAUSS>
__global__ void __launch_bounds__(X64_THREADS)
fill_block64_T_kernel(double* __restrict__ out, int64_t rows, int64_t cols,
                      int shift, uint64_t ctr_stride, Seed64 seed, int vec) {
  constexpr int W = width(GEN);
  constexpr int64_t STEP = X64_TY * X64_T_BLOCKS;  // counter blocks a CTA
  const int64_t r0 = 2 * ((int64_t)blockIdx.x * X64_TX + threadIdx.x);
  if (r0 >= rows) return;
  for (int64_t b0 = (int64_t)blockIdx.y * STEP + threadIdx.y;
       b0 * W - shift < cols; b0 += (int64_t)gridDim.y * STEP) {
    double v[2 * X64_T_BLOCKS][W];  // row r0 + k of block b0 + j TY: 2 j + k
#pragma unroll
    for (int i = 0; i < 2 * X64_T_BLOCKS; ++i)  // a block past the edge:
      values64<GEN, GAUSS>(                    // never stored
          seed, (uint64_t)(r0 + i % 2) * ctr_stride
          + (uint64_t)(b0 + i / 2 * X64_TY), v[i]);
#pragma unroll
    for (int j = 0; j < X64_T_BLOCKS; ++j) {
      const int64_t c0 = (b0 + j * X64_TY) * W - shift;
#pragma unroll
      for (int l = 0; l < W; ++l) {
        const int64_t c = c0 + l;
        if (c < 0 || c >= cols) continue;
        double* o = out + c * rows + r0;
        if (vec) {  // rows even: r0 + 1 < rows
          *reinterpret_cast<double2*>(o) = make_double2(v[2 * j][l],
                                                        v[2 * j + 1][l]);
        } else {
          o[0] = v[2 * j][l];
          if (r0 + 1 < rows) o[1] = v[2 * j + 1][l];
        }
      }
    }
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <int GEN, bool GAUSS>
cudaError_t launch64(double* out, int64_t rows, int64_t cols, int shift,
                     uint64_t ctr_stride, const Seed64& seed, int transposed,
                     cudaStream_t stream) {
  constexpr int W = width(GEN);
  const int64_t nblk = ceil_div(shift + cols, W);
  const bool aligned = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (!transposed) {
    const int64_t gx = ceil_div(nblk, X64_THREADS);
    const int64_t gy = ceil_div(rows, X64_ROWS);
    if (gx > 0x7FFFFFFF) return cudaErrorInvalidValue;
    const int vec = aligned && shift % 2 == 0 && cols % 2 == 0;
    const dim3 grid((unsigned)gx,
                    (unsigned)(gy < MAX_GRID_Y ? gy : MAX_GRID_Y));
    fill_block64_kernel<GEN, GAUSS><<<grid, X64_THREADS, 0, stream>>>(
        out, rows, cols, shift, ctr_stride, seed, vec);
  } else {
    const int64_t gx = ceil_div(ceil_div(rows, 2), X64_TX);
    const int64_t gy = ceil_div(nblk, X64_TY * X64_T_BLOCKS);
    if (gx > 0x7FFFFFFF) return cudaErrorInvalidValue;
    const int vec = aligned && rows % 2 == 0;
    const dim3 grid((unsigned)gx,
                    (unsigned)(gy < MAX_GRID_Y ? gy : MAX_GRID_Y));
    fill_block64_T_kernel<GEN, GAUSS><<<grid, dim3(X64_TX, X64_TY), 0,
                                        stream>>>(
        out, rows, cols, shift, ctr_stride, seed, vec);
  }
  return cudaGetLastError();
}

template <int GEN>
cudaError_t dispatch64(double* out, int64_t rows, int64_t cols, int shift,
                       uint64_t ctr_stride, const Seed64& seed, int gaussian,
                       int transposed, cudaStream_t stream) {
  if (shift < 0 || shift >= width(GEN)) return cudaErrorInvalidValue;
  return gaussian ? launch64<GEN, true>(out, rows, cols, shift, ctr_stride,
                                        seed, transposed, stream)
                  : launch64<GEN, false>(out, rows, cols, shift, ctr_stride,
                                         seed, transposed, stream);
}

}  // namespace

// K6 into `out`: the natural (rows, cols) block (transposed 0), or its
// transpose (transposed 1, out is cols x rows), of the generator `gen`
// (0 Philox2x64-10, 1 Philox4x64-10, 2 Threefry2x64-20, 3 Threefry4x64-20)
// with the block's first counter in words[0:4] and the key in words[4:8]
// (zero-padded); Gaussian (1) or Uniform (0, scaled by sqrt(3)) values.
extern "C" int rbt_fill_block64(double* out, int64_t rows, int64_t cols,
                                int shift, uint64_t ctr_stride,
                                const uint64_t* words, int gen, int gaussian,
                                int transposed, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaSuccess;
  Seed64 seed;
  for (int i = 0; i < 4; ++i) {
    seed.c[i] = words[i];
    seed.k[i] = words[4 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (gen) {
    case kPhilox2x64:
      return (int)dispatch64<kPhilox2x64>(out, rows, cols, shift, ctr_stride,
                                          seed, gaussian, transposed, s);
    case kPhilox4x64:
      return (int)dispatch64<kPhilox4x64>(out, rows, cols, shift, ctr_stride,
                                          seed, gaussian, transposed, s);
    case kThreefry2x64:
      return (int)dispatch64<kThreefry2x64>(out, rows, cols, shift,
                                            ctr_stride, seed, gaussian,
                                            transposed, s);
    case kThreefry4x64:
      return (int)dispatch64<kThreefry4x64>(out, rows, cols, shift,
                                            ctr_stride, seed, gaussian,
                                            transposed, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
