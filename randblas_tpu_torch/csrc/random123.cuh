// The four 32-bit-counter Random123 generators on the device, with
// RandBLAS's default rounds: Philox4x32-10, Philox2x32-10, Threefry4x32-20
// and Threefry2x32-20, bit for bit rng/philox.py and rng/threefry.py (which
// the Random123 known-answer vectors check), and the counter of a block at a
// 64-bit offset from a seed's counter, carried across every counter word
// (Random123's ctr.incr, rng/bits.py ctr_add_words).
//
// Included by fused_sketch.cu (K1, K2, K3: the 4x32 generators) and
// saso_fill.cu (K7: all four). The codes below are the launchers' `rng`
// argument, and ops/_build.py's GEN_CODES.

#pragma once

#include <cstdint>

namespace r123 {

constexpr int kPhilox4x32 = 0;
constexpr int kPhilox2x32 = 1;
constexpr int kThreefry4x32 = 2;
constexpr int kThreefry2x32 = 3;

// counter words (little-endian) and key words of a seed; unused words 0
struct Seed {
  uint32_t c[4];
  uint32_t k[4];
};

// a seed from the launchers' eight words: counter words 0-3, then key words
// 0-3
inline Seed make_seed(const uint32_t* words) {
  Seed s;
  for (int i = 0; i < 4; ++i) {
    s.c[i] = words[i];
    s.k[i] = words[4 + i];
  }
  return s;
}

// The four-word counter of the block at the seed's counter plus `off`: the
// offset's low and high halves add to counter words 0 and 1 and the carry
// runs up through words 2 and 3
__host__ __device__ __forceinline__ void counter4(const Seed& s, uint64_t off,
                                                  uint32_t x[4]) {
  const uint64_t lo = ((uint64_t)s.c[1] << 32) | s.c[0];
  const uint64_t sum = lo + off;
  const uint32_t carry = sum < off ? 1u : 0u;
  x[0] = (uint32_t)sum;
  x[1] = (uint32_t)(sum >> 32);
  x[2] = s.c[2] + carry;
  x[3] = s.c[3] + ((x[2] < carry) ? 1u : 0u);
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
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

__device__ __forceinline__ void philox2x32_10(uint32_t x[2], uint32_t k0) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) k0 += 0x9E3779B9u;
    const uint32_t hi = __umulhi(0xD256D193u, x[0]);
    const uint32_t lo = 0xD256D193u * x[0];
    x[0] = hi ^ k0 ^ x[1];
    x[1] = lo;
  }
}

// one Threefry4x32 round: even rounds mix (0,1),(2,3), odd rounds (0,3),(2,1)
template <int RA, int RB, bool ODD>
__device__ __forceinline__ void tf4_round(uint32_t x[4]) {
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
__device__ __forceinline__ void tf4_four(uint32_t x[4], const uint32_t ks[5]) {
  if (S % 2 == 1) {
    tf4_round<10, 26, false>(x);
    tf4_round<11, 21, true>(x);
    tf4_round<13, 27, false>(x);
    tf4_round<23, 5, true>(x);
  } else {
    tf4_round<6, 20, false>(x);
    tf4_round<17, 11, true>(x);
    tf4_round<25, 10, false>(x);
    tf4_round<18, 20, true>(x);
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
  tf4_four<1>(x, ks);
  tf4_four<2>(x, ks);
  tf4_four<3>(x, ks);
  tf4_four<4>(x, ks);
  tf4_four<5>(x, ks);
}

// four Threefry2x32 rounds (rotations R0..R3), then key injection S
template <int S, int R0, int R1, int R2, int R3>
__device__ __forceinline__ void tf2_four(uint32_t x[2], const uint32_t ks[3]) {
  x[0] += x[1];
  x[1] = rotl32(x[1], R0) ^ x[0];
  x[0] += x[1];
  x[1] = rotl32(x[1], R1) ^ x[0];
  x[0] += x[1];
  x[1] = rotl32(x[1], R2) ^ x[0];
  x[0] += x[1];
  x[1] = rotl32(x[1], R3) ^ x[0];
  x[0] += ks[S % 3];
  x[1] += ks[(S + 1) % 3] + (uint32_t)S;
}

__device__ __forceinline__ void threefry2x32_20(uint32_t x[2],
                                                const uint32_t k[2]) {
  const uint32_t ks[3] = {k[0], k[1], 0x1BD11BDAu ^ k[0] ^ k[1]};
  x[0] += ks[0];
  x[1] += ks[1];
  tf2_four<1, 13, 15, 26, 6>(x, ks);
  tf2_four<2, 17, 29, 16, 24>(x, ks);
  tf2_four<3, 13, 15, 26, 6>(x, ks);
  tf2_four<4, 17, 29, 16, 24>(x, ks);
  tf2_four<5, 13, 15, 26, 6>(x, ks);
}

// The four output words of 4x32 generator RNG's block at the seed's
// counter plus `off`
template <int RNG>
__device__ __forceinline__ void words4(const Seed& s, uint64_t off,
                                       uint32_t x[4]) {
  counter4(s, off, x);
  if (RNG == kPhilox4x32) {
    philox4x32_10(x, s.k[0], s.k[1]);
  } else {
    threefry4x32_20(x, s.k);
  }
}

// The first two output words of generator RNG's block at the seed's counter
// plus `off`: counter4's carry for a four-word counter; a two-word counter
// wraps at its top, as Random123's ctr.incr does.
template <int RNG>
__device__ __forceinline__ void words2(const Seed& s, uint64_t off,
                                       uint32_t& w0, uint32_t& w1) {
  if (RNG == kPhilox4x32 || RNG == kThreefry4x32) {
    uint32_t x[4];
    words4<RNG>(s, off, x);
    w0 = x[0];
    w1 = x[1];
  } else {
    const uint64_t sum = (((uint64_t)s.c[1] << 32) | s.c[0]) + off;
    uint32_t x[2] = {(uint32_t)sum, (uint32_t)(sum >> 32)};
    if (RNG == kPhilox2x32) {
      philox2x32_10(x, s.k[0]);
    } else {
      threefry2x32_20(x, s.k);
    }
    w0 = x[0];
    w1 = x[1];
  }
}

}  // namespace r123
