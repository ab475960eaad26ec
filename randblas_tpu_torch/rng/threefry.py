"""Threefry counter-based RNGs (Threefry4x32, Threefry2x32) on int64 word
tensors.

Counterpart of randblas_tpu/rng/threefry.py, checked against the Random123
known-answer vectors. Words follow rng/bits.py.
"""

from __future__ import annotations

import torch

from .bits import MASK32, rotl32, u32

_PARITY32 = 0x1BD11BDA

_R_2x32 = (13, 15, 26, 6, 17, 29, 16, 24)
_R_4x32 = ((10, 26), (11, 21), (13, 27), (23, 5),
           (6, 20), (17, 11), (25, 10), (18, 20))


def threefry2x32_words(x0, x1, k0, k1, rounds: int = 20):
    """Threefry-2x32 on two separate word tensors; returns two words."""
    ks = [k0, k1, _PARITY32 ^ k0 ^ k1]
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for r in range(rounds):
        x0 = (x0 + x1) & MASK32
        x1 = rotl32(x1, _R_2x32[r % 8]) ^ x0
        if (r + 1) % 4 == 0:
            s = (r + 1) // 4
            x0 = (x0 + ks[s % 3]) & MASK32
            x1 = (x1 + ks[(s + 1) % 3] + s) & MASK32
    return x0, x1


def threefry4x32_words(x0, x1, x2, x3, k0, k1, k2, k3, rounds: int = 20):
    """Threefry-4x32 on four separate word tensors; returns four words."""
    ks = [k0, k1, k2, k3, _PARITY32 ^ k0 ^ k1 ^ k2 ^ k3]
    x = [(x0 + k0) & MASK32, (x1 + k1) & MASK32,
         (x2 + k2) & MASK32, (x3 + k3) & MASK32]
    for r in range(rounds):
        r0, r2 = _R_4x32[r % 8]
        if r % 2 == 0:
            x[0] = (x[0] + x[1]) & MASK32
            x[1] = rotl32(x[1], r0) ^ x[0]
            x[2] = (x[2] + x[3]) & MASK32
            x[3] = rotl32(x[3], r2) ^ x[2]
        else:
            x[0] = (x[0] + x[3]) & MASK32
            x[3] = rotl32(x[3], r0) ^ x[0]
            x[2] = (x[2] + x[1]) & MASK32
            x[1] = rotl32(x[1], r2) ^ x[2]
        if (r + 1) % 4 == 0:
            s = (r + 1) // 4
            for i in range(4):
                x[i] = (x[i] + ks[(s + i) % 5]) & MASK32
            x[3] = (x[3] + s) & MASK32
    return tuple(x)


def threefry4x32(ctr, key, rounds: int = 20) -> torch.Tensor:
    """ctr: words (..., 4), key: words (..., 4). Returns words (..., 4)."""
    ctr, key = u32(ctr), u32(key)
    out = threefry4x32_words(*(ctr[..., i] for i in range(4)),
                             *(key[..., i] for i in range(4)), rounds)
    return torch.stack(torch.broadcast_tensors(*out), dim=-1)


def threefry2x32(ctr, key, rounds: int = 20) -> torch.Tensor:
    """ctr: words (..., 2), key: words (..., 2). Returns words (..., 2)."""
    ctr, key = u32(ctr), u32(key)
    out = threefry2x32_words(ctr[..., 0], ctr[..., 1], key[..., 0],
                             key[..., 1], rounds)
    return torch.stack(torch.broadcast_tensors(*out), dim=-1)
