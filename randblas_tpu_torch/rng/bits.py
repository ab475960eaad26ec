"""32-bit word arithmetic on int64 tensors (counterpart of
randblas_tpu/rng/bits.py).

PyTorch on the CPU has no uint32 add, shift or compare, so a word lives in
an int64 tensor holding a value in ``[0, 2**32)`` and every add or multiply
is masked back into that range. A full 32x32 product needs 64 unsigned bits,
which int64 cannot hold, so ``mulhilo32`` splits one operand into 16-bit
halves (each partial product stays below 2**48). The same code runs on CUDA
tensors: it is the plain version the CUDA kernels are checked against.

Scalars (seed words, strides) stay Python ints, so handing a seed to a
kernel never needs a device sync.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def u32(x, device=None) -> torch.Tensor:
    """An int64 word tensor from ints, numpy arrays or tensors."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK32


def mulhilo32(a, b):
    """(hi, lo) 32-bit halves of the 64-bit product of two words.

    ``b`` may be a Python int (the Philox multipliers) or a word tensor.
    """
    if isinstance(b, int):
        b_lo, b_hi = b & 0xFFFF, (b >> 16) & 0xFFFF
    else:
        b_lo, b_hi = b & 0xFFFF, b >> 16
    p_lo = a * b_lo                      # < 2**48
    p_hi = a * b_hi                      # < 2**48
    t = p_lo + ((p_hi & 0xFFFF) << 16)   # < 2**49
    return (p_hi >> 16) + (t >> 32), t & MASK32


def mul32_wide(a, b):
    """(hi, lo) 32-bit halves of the 64-bit product of two words (ints,
    arrays or tensors), as ``mulhilo32``."""
    return mulhilo32(u32(a), b if isinstance(b, int) else u32(b))


def mul32_hi(a, b):
    """The high word of the 64-bit product a * b (Philox's mulhi)."""
    return mul32_wide(a, b)[0]


def rotl32(x, r: int):
    """Rotate a word left by ``r`` bits (Threefry)."""
    r = int(r)
    return ((x << r) | (x >> (32 - r))) & MASK32


def to_signed(x):
    """Two's-complement view of a word as a signed value in int64."""
    return x - ((x >> 31) << 32)


def _add_limbs(words, lo, hi):
    """Little-endian multiword ``words`` + (lo, hi) << 0 and << 32, each
    word masked to 32 bits and the carry passed up; wraps at the top."""
    out = []
    carry = 0
    for i, w in enumerate(words):
        s = w + carry
        if i == 0:
            s = s + lo
        elif i == 1:
            s = s + hi
        out.append(s & MASK32)
        carry = s >> 32
    return out


def ctr_add_words(words, offset):
    """Add a nonnegative int64 ``offset`` (< 2**63, scalar or tensor) to a
    little-endian multiword counter given as Python ints, carrying across
    every word (Random123 ``ctr.incr`` semantics, wrapping at the top).

    Returns one int64 word tensor (or int) per counter word, broadcast to
    the offset's shape."""
    return _add_limbs(words, offset & MASK32, offset >> 32)


def ctr_add64(ctr, lo, hi=0) -> torch.Tensor:
    """Add the 64-bit amount given as words ``lo``, ``hi`` (ints or word
    tensors) to the little-endian multiword counter ``ctr`` (words along
    the last axis), carrying across every word and wrapping at the top (the
    JAX package's ``ctr_add64``). Returns the word tensor, the counter's
    words along the last axis broadcast against lo and hi."""
    ctr = u32(ctr)
    words = _add_limbs([ctr[..., i] for i in range(ctr.shape[-1])],
                       u32(lo, ctr.device), u32(hi, ctr.device))
    return torch.stack(torch.broadcast_tensors(*words), dim=-1)
