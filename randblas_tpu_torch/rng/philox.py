"""Philox counter-based RNGs (Philox4x32, Philox2x32) on int64 word tensors.

Counterpart of randblas_tpu/rng/philox.py (Salmon et al., SC'11), checked
bit for bit against the Random123 known-answer vectors. Words follow
rng/bits.py: int64 tensors holding values in ``[0, 2**32)``; keys may be
Python ints or word tensors.
"""

from __future__ import annotations

import torch

from .bits import MASK32, mulhilo32, u32

PHILOX_M4x32_0 = 0xD2511F53
PHILOX_M4x32_1 = 0xCD9E8D57
PHILOX_M2x32_0 = 0xD256D193
PHILOX_W32_0 = 0x9E3779B9
PHILOX_W32_1 = 0xBB67AE85


def philox4x32_words(x0, x1, x2, x3, k0, k1, rounds: int = 10):
    """Philox-4x32 on four separate word tensors; returns four words."""
    for r in range(rounds):
        if r > 0:
            k0 = (k0 + PHILOX_W32_0) & MASK32
            k1 = (k1 + PHILOX_W32_1) & MASK32
        hi0, lo0 = mulhilo32(x0, PHILOX_M4x32_0)
        hi1, lo1 = mulhilo32(x2, PHILOX_M4x32_1)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
    return x0, x1, x2, x3


def philox2x32_words(x0, x1, k0, rounds: int = 10):
    """Philox-2x32 on two separate word tensors; returns two words."""
    for r in range(rounds):
        if r > 0:
            k0 = (k0 + PHILOX_W32_0) & MASK32
        hi, lo = mulhilo32(x0, PHILOX_M2x32_0)
        x0, x1 = hi ^ k0 ^ x1, lo
    return x0, x1


def philox4x32(ctr, key, rounds: int = 10) -> torch.Tensor:
    """ctr: words (..., 4), key: words (..., 2). Returns words (..., 4)."""
    ctr, key = u32(ctr), u32(key)
    out = philox4x32_words(ctr[..., 0], ctr[..., 1], ctr[..., 2],
                           ctr[..., 3], key[..., 0], key[..., 1], rounds)
    return torch.stack(torch.broadcast_tensors(*out), dim=-1)


def philox2x32(ctr, key, rounds: int = 10) -> torch.Tensor:
    """ctr: words (..., 2), key: words (..., 1). Returns words (..., 2)."""
    ctr, key = u32(ctr), u32(key)
    out = philox2x32_words(ctr[..., 0], ctr[..., 1], key[..., 0], rounds)
    return torch.stack(torch.broadcast_tensors(*out), dim=-1)
