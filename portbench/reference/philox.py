"""Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32) on int64
tensors that hold 32-bit words, and the counter arithmetic of RandBLAS.

A counter is a 128-bit little-endian integer of four words; a key has two.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
MUL = (0xD2511F53, 0xCD9E8D57)
BUMP = (0x9E3779B9, 0xBB67AE85)
ROUNDS = 10


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) words of the 64-bit product a * m, a a word tensor, m a
    32-bit int: a is cut into 16-bit halves so every partial product fits
    in 48 bits."""
    t = (a & 0xFFFF) * m
    u = (a >> 16) * m
    low = t + ((u & 0xFFFF) << 16)
    return (u >> 16) + (low >> 32), low & MASK


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """The four output words of Philox4x32-10 at counter (c0..c3)."""
    x = [c0, c1, c2, c3]
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + BUMP[0]) & MASK, (k1 + BUMP[1]) & MASK
        hi0, lo0 = _mulhilo(x[0], MUL[0])
        hi1, lo1 = _mulhilo(x[2], MUL[1])
        x = [hi1 ^ x[1] ^ k0, lo1, hi0 ^ x[3] ^ k1, lo0]
    return x


def counter_words(base, offset: torch.Tensor):
    """The four words of the 128-bit counter ``base`` (four ints) plus the
    int64 tensor ``offset`` (0 <= offset < 2**63), with carries."""
    out, carry = [], 0
    add = [offset & MASK, offset >> 32, 0, 0]
    for w, a in zip(base, add):
        s = w + a + carry
        out.append(s & MASK)
        carry = s >> 32
    return out


def words_at(key: int, offset: torch.Tensor, base=(0, 0, 0, 0)):
    """Philox4x32-10 words at counters ``base + offset`` under the key
    (key, 0), RandBLAS's ``RNGState.from_key``."""
    return philox4x32(*counter_words(base, offset), key & MASK, 0)
