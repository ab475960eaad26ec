"""The 64-bit-counter CBRNGs and the native-float64 dense fill: a numpy
copy of randblas_tpu/rng/x64.py, and the same block functions on tensors.

The reference's fill engine, instantiated with a 64-bit-counter generator,
produces native double streams: the float width is deduced from the counter
word size (RandBLAS/random_gen.hh:121-173; dense_skops.hh:97-170). The JAX
package keeps the x64 generators (Philox2x64/4x64, Threefry2x64/4x64) on
the host, since a TPU has no 64-bit integer lanes. The port makes a block
of such an operator on the card with the kernel K6 (ops/x64_fill.py); on
the CPU it keeps the host engines: this vectorised numpy version (always
available) and the OpenMP C++ engine of native/randblas_host.cpp, loaded
by ``randblas_tpu_torch.native``. The tensor section at the end holds the
block functions and transforms of K6's plain PyTorch version.

Counter and key representation: ``RNGState`` stores 32-bit words. An x64
state's counter is the little-endian uint32 limb view of its uint64 words
(word i -> limbs 2i (low), 2i+1 (high)), so the state's multiword ``incr``
over the limbs is bitwise Random123's ``ctr.incr`` over the uint64 words.

Float transforms (Random123 uniform.hpp / boxmuller.hpp, 64-bit row):

    u01(u64)    = u * 2^-64 + 2^-65
    uneg11(u64) = (int64) u * 2^-63 + 2^-64
    boxmuller(u0, u1) = r*sin(pi*uneg11(u0)), r*cos(pi*uneg11(u0)),
                        r = sqrt(-2 log(u01(u1)))
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .bits import MASK32, mulhilo32, to_signed

# ---------------------------------------------------------------------------
# uint64 block functions (vectorized over leading axes; all arithmetic
# wraps mod 2^64, numpy semantics)
# ---------------------------------------------------------------------------

_U64 = np.uint64
_M32 = _U64(0xFFFFFFFF)

_P2x64_M = _U64(0xD2B74407B1CE6E93)
_P64_W0 = _U64(0x9E3779B97F4A7C15)
_P64_W1 = _U64(0xBB67AE8584CAA73B)
_P4x64_M0 = _U64(0xD2E7470EE14C6C93)
_P4x64_M1 = _U64(0xCA5A826395121157)

_TF64_PARITY = _U64(0x1BD11BDAA9FC1A22)
_TF64_2_ROT = (16, 42, 12, 31, 16, 32, 24, 21)
_TF64_4_R0 = (14, 52, 23, 5, 25, 46, 58, 32)
_TF64_4_R1 = (16, 57, 40, 37, 33, 12, 22, 32)


def _mul64_wide(a, b):
    """Full 64x64 -> 128 multiply as (hi, lo) uint64 (schoolbook on
    32-bit halves; numpy has no uint128)."""
    a = a.astype(_U64)
    b = b.astype(_U64)
    al = a & _M32
    ah = a >> _U64(32)
    bl = b & _M32
    bh = b >> _U64(32)
    t = al * bl
    u = ah * bl + (t >> _U64(32))
    v = al * bh + (u & _M32)
    hi = ah * bh + (u >> _U64(32)) + (v >> _U64(32))
    lo = a * b
    return hi, lo


def _rotl64(x, r):
    r = _U64(r)
    return (x << r) | (x >> (_U64(64) - r))


def philox2x64(ctr, key, rounds: int = 10):
    """ctr: uint64[..., 2], key: uint64[..., 1] -> uint64[..., 2]."""
    ctr = np.asarray(ctr, _U64)
    key = np.asarray(key, _U64)
    x0, x1 = ctr[..., 0].copy(), ctr[..., 1].copy()
    k0 = np.broadcast_to(key[..., 0], x0.shape).copy()
    for r in range(rounds):
        if r > 0:
            k0 = k0 + _P64_W0
        hi, lo = _mul64_wide(_P2x64_M, x0)
        x0 = hi ^ k0 ^ x1
        x1 = lo
    return np.stack([x0, x1], axis=-1)


def philox4x64(ctr, key, rounds: int = 10):
    """ctr: uint64[..., 4], key: uint64[..., 2] -> uint64[..., 4]."""
    ctr = np.asarray(ctr, _U64)
    key = np.asarray(key, _U64)
    x0, x1 = ctr[..., 0].copy(), ctr[..., 1].copy()
    x2, x3 = ctr[..., 2].copy(), ctr[..., 3].copy()
    k0 = np.broadcast_to(key[..., 0], x0.shape).copy()
    k1 = np.broadcast_to(key[..., 1], x0.shape).copy()
    for r in range(rounds):
        if r > 0:
            k0 = k0 + _P64_W0
            k1 = k1 + _P64_W1
        hi0, lo0 = _mul64_wide(_P4x64_M0, x0)
        hi1, lo1 = _mul64_wide(_P4x64_M1, x2)
        x0 = hi1 ^ x1 ^ k0
        x1 = lo1
        x2 = hi0 ^ x3 ^ k1
        x3 = lo0
    return np.stack([x0, x1, x2, x3], axis=-1)


def threefry2x64(ctr, key, rounds: int = 20):
    """ctr: uint64[..., 2], key: uint64[..., 2] -> uint64[..., 2]."""
    ctr = np.asarray(ctr, _U64)
    key = np.asarray(key, _U64)
    ks = [key[..., 0], key[..., 1],
          _TF64_PARITY ^ key[..., 0] ^ key[..., 1]]
    x0 = ctr[..., 0] + ks[0]
    x1 = ctr[..., 1] + ks[1]
    for r in range(rounds):
        x0 = x0 + x1
        x1 = _rotl64(x1, _TF64_2_ROT[r % 8]) ^ x0
        if (r + 1) % 4 == 0:
            s = (r + 1) // 4
            x0 = x0 + ks[s % 3]
            x1 = x1 + ks[(s + 1) % 3] + _U64(s)
    return np.stack([x0, x1], axis=-1)


def threefry4x64(ctr, key, rounds: int = 20):
    """ctr: uint64[..., 4], key: uint64[..., 4] -> uint64[..., 4]."""
    ctr = np.asarray(ctr, _U64)
    key = np.asarray(key, _U64)
    ks = [key[..., i] for i in range(4)]
    ks.append(_TF64_PARITY ^ ks[0] ^ ks[1] ^ ks[2] ^ ks[3])
    x = [ctr[..., i] + ks[i] for i in range(4)]
    for r in range(rounds):
        r0, r1 = _TF64_4_R0[r % 8], _TF64_4_R1[r % 8]
        if r % 2 == 0:
            x[0] = x[0] + x[1]
            x[1] = _rotl64(x[1], r0) ^ x[0]
            x[2] = x[2] + x[3]
            x[3] = _rotl64(x[3], r1) ^ x[2]
        else:
            x[0] = x[0] + x[3]
            x[3] = _rotl64(x[3], r0) ^ x[0]
            x[2] = x[2] + x[1]
            x[1] = _rotl64(x[1], r1) ^ x[2]
        if (r + 1) % 4 == 0:
            s = (r + 1) // 4
            for i in range(4):
                x[i] = x[i] + ks[(s + i) % 5]
            x[3] = x[3] + _U64(s)
    return np.stack(x, axis=-1)


# name -> (block fn, ctr words, key words, rounds)
GENERATORS_X64 = {
    "philox2x64": (philox2x64, 2, 1, 10),
    "philox4x64": (philox4x64, 4, 2, 10),
    "threefry2x64": (threefry2x64, 2, 2, 20),
    "threefry4x64": (threefry4x64, 4, 4, 20),
}


# ---------------------------------------------------------------------------
# limb <-> word views (RNGState stores uint32 limbs)
# ---------------------------------------------------------------------------

def limbs_to_words(limbs) -> np.ndarray:
    """uint32[2w] little-endian limbs -> uint64[w] words."""
    limbs = np.asarray(limbs, np.uint32).astype(_U64)
    lo = limbs[..., 0::2]
    hi = limbs[..., 1::2]
    return lo | (hi << _U64(32))


def words_to_limbs(words) -> np.ndarray:
    """uint64[w] words -> uint32[2w] little-endian limbs."""
    words = np.asarray(words, _U64)
    out = np.empty(words.shape[:-1] + (2 * words.shape[-1],), np.uint32)
    out[..., 0::2] = (words & _M32).astype(np.uint32)
    out[..., 1::2] = (words >> _U64(32)).astype(np.uint32)
    return out


# ---------------------------------------------------------------------------
# double transforms
# ---------------------------------------------------------------------------

def u01_f64(u) -> np.ndarray:
    return np.asarray(u, _U64).astype(np.float64) * 2.0 ** -64 + 2.0 ** -65


def uneg11_f64(u) -> np.ndarray:
    return (np.asarray(u, _U64).astype(np.int64).astype(np.float64)
            * 2.0 ** -63 + 2.0 ** -64)


def block_values_f64(blocks: np.ndarray, transform: str) -> np.ndarray:
    """uint64[..., w] raw blocks -> float64[..., w] values.

    'uneg11' maps each word; 'boxmul' maps word pairs (2i, 2i+1) to
    (r sin, r cos) exactly as r123ext::boxmulall does for x64 counters
    (random_gen.hh:81-110: pairwise over the block, width deduced from
    the counter element size).
    """
    if transform == "uneg11":
        return uneg11_f64(blocks)
    if transform != "boxmul":
        raise ValueError(f"unknown transform {transform!r}")
    u0 = blocks[..., 0::2]
    u1 = blocks[..., 1::2]
    ang = np.pi * uneg11_f64(u0)
    r = np.sqrt(-2.0 * np.log(u01_f64(u1)))
    out = np.empty(blocks.shape, np.float64)
    out[..., 0::2] = np.sin(ang) * r
    out[..., 1::2] = np.cos(ang) * r
    return out


# ---------------------------------------------------------------------------
# counter-addressed f64 fill (host)
# ---------------------------------------------------------------------------

def _ctr_offsets(words: np.ndarray, n) -> np.ndarray:
    """words (w,) uint64 + integer offsets n (any shape, python-int-safe)
    -> (..., w) counters, with multiword little-endian carries. Offsets
    are < 2^63 in practice (they are element counts)."""
    n = np.asarray(n, _U64)
    out = np.broadcast_to(words, n.shape + words.shape).copy()
    lo = out[..., 0] + n
    carry = (lo < n).astype(_U64)
    out[..., 0] = lo
    for i in range(1, words.shape[-1]):
        s = out[..., i] + carry
        carry = (s < carry).astype(_U64)
        out[..., i] = s
        if not carry.any():
            break
    return out


def fill_rowmajor64(n_cols_parent: int, n_srows: int, n_scols: int,
                    ptr: int, state, transform: str) -> np.ndarray:
    """Native-f64 counter-addressed row-major submatrix fill.

    Mirrors ops/dense_fill.py::fill_rowmajor (and the reference's
    fill_dense_submat_impl, dense_skops.hh:97-170) with the x64 CBRNG
    named by ``state.rng``: element (r, c) of the submatrix reads lane
    (fbs + c) % w of counter base + ctr_mat_start + r*stride +
    (fbs + c)//w, where w is the counter width in WORDS (4 for the 4x64
    generators — the same padding math as x32, so submatrix/next_state
    semantics are identical across widths).

    ``state`` is an x64 RNGState (uint32 limb words). Returns a float64
    numpy array; 'uneg11' values are unscaled (dense.py applies sqrt(3)
    for the Uniform family).
    """
    fn, w, _, rounds = GENERATORS_X64[state.rng]
    ctr_words = limbs_to_words(np.asarray(state.counter))
    key_words = limbs_to_words(np.asarray(state.key))

    pad = (-n_cols_parent) % w
    ptr_padded = ptr + (ptr // n_cols_parent) * pad
    ctr_mat_start = ptr_padded // w
    fbs = ptr_padded % w
    stride = (n_cols_parent + pad) // w
    nblk = (fbs + n_scols - 1) // w + 1

    # (n_srows, nblk) block offsets -> counters -> raw blocks -> values
    offs = (ctr_mat_start
            + np.arange(n_srows, dtype=np.uint64)[:, None] * np.uint64(stride)
            + np.arange(nblk, dtype=np.uint64)[None, :])
    ctrs = _ctr_offsets(ctr_words, offs)              # (R, B, w)
    vals = block_values_f64(fn(ctrs, key_words, rounds), transform)
    flat = vals.reshape(n_srows, nblk * w)
    return np.ascontiguousarray(flat[:, fbs:fbs + n_scols])


def fill_next_state64(n_cols_parent: int, n_rows_parent: int, state):
    """State advanced past a full natural-row-major parent fill: incr by
    ceil(n_cols_parent / w) * n_rows_parent (compute_next_state,
    dense_skops.hh:173-191 — identical arithmetic to the x32 path with w
    in counter WORDS)."""
    _, w, _, _ = GENERATORS_X64[state.rng]
    per_row = -(-n_cols_parent // w)
    return state.incr(per_row * n_rows_parent)


# ---------------------------------------------------------------------------
# the block functions and transforms on tensors (the plain version of K6,
# ops/x64_fill.py). A uint64 word is a pair (lo, hi) of int64 tensors
# holding its 32-bit limbs, as RNGState stores it: int64 cannot hold a
# 64x64 product and torch's unsigned types lack the arithmetic, so products
# are built from bits.mulhilo32 on the limbs. Keys and constants are Python
# ints. The same code runs on CUDA tensors.
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def _pair(c: int):
    return c & MASK32, c >> 32


def _xor64(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def _add64(a, b):
    lo = a[0] + b[0]
    return lo & MASK32, (a[1] + b[1] + (lo >> 32)) & MASK32


def _mulhilo64(a, m: int):
    """(hi, lo) words of the 128-bit product of the word ``a`` and the
    constant ``m``: four 32x32 products, their halves summed with carries."""
    m0, m1 = _pair(m)
    h00, l00 = mulhilo32(a[0], m0)
    h01, l01 = mulhilo32(a[0], m1)
    h10, l10 = mulhilo32(a[1], m0)
    h11, l11 = mulhilo32(a[1], m1)
    t1 = h00 + l01 + l10
    t2 = h01 + h10 + l11 + (t1 >> 32)
    return ((t2 & MASK32, (h11 + (t2 >> 32)) & MASK32),
            (l00, t1 & MASK32))


def _rotl64_t(x, r: int):
    lo, hi = x
    if r >= 32:
        lo, hi, r = hi, lo, r - 32
    if r == 0:
        return lo, hi
    return (((lo << r) | (hi >> (32 - r))) & MASK32,
            ((hi << r) | (lo >> (32 - r))) & MASK32)


def philox2x64_t(ctr, key, rounds: int = 10):
    """ctr: 2 words, key: 1 int -> 2 words."""
    x0, x1 = ctr
    k0 = key[0]
    for r in range(rounds):
        if r > 0:
            k0 = (k0 + int(_P64_W0)) & _M64
        hi, lo = _mulhilo64(x0, int(_P2x64_M))
        x0 = _xor64(_xor64(hi, _pair(k0)), x1)
        x1 = lo
    return [x0, x1]


def philox4x64_t(ctr, key, rounds: int = 10):
    """ctr: 4 words, key: 2 ints -> 4 words."""
    x0, x1, x2, x3 = ctr
    k0, k1 = key
    for r in range(rounds):
        if r > 0:
            k0 = (k0 + int(_P64_W0)) & _M64
            k1 = (k1 + int(_P64_W1)) & _M64
        hi0, lo0 = _mulhilo64(x0, int(_P4x64_M0))
        hi1, lo1 = _mulhilo64(x2, int(_P4x64_M1))
        x0 = _xor64(_xor64(hi1, x1), _pair(k0))
        x1 = lo1
        x2 = _xor64(_xor64(hi0, x3), _pair(k1))
        x3 = lo0
    return [x0, x1, x2, x3]


def threefry2x64_t(ctr, key, rounds: int = 20):
    """ctr: 2 words, key: 2 ints -> 2 words."""
    ks = [key[0], key[1], int(_TF64_PARITY) ^ key[0] ^ key[1]]
    x0 = _add64(ctr[0], _pair(ks[0]))
    x1 = _add64(ctr[1], _pair(ks[1]))
    for r in range(rounds):
        x0 = _add64(x0, x1)
        x1 = _xor64(_rotl64_t(x1, _TF64_2_ROT[r % 8]), x0)
        if (r + 1) % 4 == 0:
            s = (r + 1) // 4
            x0 = _add64(x0, _pair(ks[s % 3]))
            x1 = _add64(x1, _pair((ks[(s + 1) % 3] + s) & _M64))
    return [x0, x1]


def threefry4x64_t(ctr, key, rounds: int = 20):
    """ctr: 4 words, key: 4 ints -> 4 words."""
    ks = list(key) + [int(_TF64_PARITY) ^ key[0] ^ key[1] ^ key[2] ^ key[3]]
    x = [_add64(ctr[i], _pair(ks[i])) for i in range(4)]
    for r in range(rounds):
        r0, r1 = _TF64_4_R0[r % 8], _TF64_4_R1[r % 8]
        if r % 2 == 0:
            x[0] = _add64(x[0], x[1])
            x[1] = _xor64(_rotl64_t(x[1], r0), x[0])
            x[2] = _add64(x[2], x[3])
            x[3] = _xor64(_rotl64_t(x[3], r1), x[2])
        else:
            x[0] = _add64(x[0], x[3])
            x[3] = _xor64(_rotl64_t(x[3], r0), x[0])
            x[2] = _add64(x[2], x[1])
            x[1] = _xor64(_rotl64_t(x[1], r1), x[2])
        if (r + 1) % 4 == 0:
            s = (r + 1) // 4
            for i in range(4):
                x[i] = _add64(x[i], _pair(ks[(s + i) % 5]))
            x[3] = _add64(x[3], _pair(s))
    return x


# name -> tensor block fn (ctr words, key words as ints, rounds)
GENERATORS_X64_T = {"philox2x64": philox2x64_t, "philox4x64": philox4x64_t,
                    "threefry2x64": threefry2x64_t,
                    "threefry4x64": threefry4x64_t}


def _f64_t(word, signed: bool):
    """A word as float64, one rounding: hi * 2^32 is exact, so adding lo
    rounds the exact value once (round-to-nearest of the word)."""
    lo, hi = word
    if signed:
        hi = to_signed(hi)
    return hi.to(torch.float64) * 2.0 ** 32 + lo.to(torch.float64)


def u01_f64_t(word) -> torch.Tensor:
    return _f64_t(word, False) * 2.0 ** -64 + 2.0 ** -65


def uneg11_f64_t(word) -> torch.Tensor:
    return _f64_t(word, True) * 2.0 ** -63 + 2.0 ** -64


def block_values_f64_t(words, transform: str) -> list:
    """w words -> w float64 tensors, as ``block_values_f64``: 'uneg11' maps
    each word, 'boxmul' the pairs (2i, 2i+1) to (r sin, r cos)."""
    if transform == "uneg11":
        return [uneg11_f64_t(w) for w in words]
    if transform != "boxmul":
        raise ValueError(f"unknown transform {transform!r}")
    out = []
    for u0, u1 in zip(words[0::2], words[1::2]):
        ang = uneg11_f64_t(u0) * math.pi
        r = torch.sqrt(torch.log(u01_f64_t(u1)) * -2.0)
        out += [torch.sin(ang) * r, torch.cos(ang) * r]
    return out
