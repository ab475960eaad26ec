"""Transforms from 32-bit words to float32 samples (counterpart of
randblas_tpu/rng/transforms.py).

Words are int64 tensors holding values in ``[0, 2**32)`` (rng/bits.py).
The uniform maps are exact float arithmetic, so they agree bit for bit with
the JAX package and with the CUDA kernels. The Gaussian map goes through
log/sqrt/sin/cos, whose float32 results depend on the math library, so
Gaussian values agree across platforms only to about 1e-3 relative.

Three Box-Muller variants exist, as in the JAX package:

- ``boxmul_pair``: unsigned ``u01`` and sin/cos. The staged fill.
- ``boxmul_pair_i32(fast_cos=False)``: the signed-view ``u01_i32`` and
  sin/cos. The fill kernel (K3).
- ``boxmul_pair_i32(fast_cos=True)``: ``u01_i32`` and the polynomial
  ``_sincospi_fast``. The fused sketch kernel (K1).

Every step is its own float32 multiply or add, never a fused multiply-add,
so the CUDA kernels (which use ``__fmul_rn``/``__fadd_rn``) round the same.
"""

from __future__ import annotations

import torch

from .bits import to_signed

_F32 = torch.float32
_U01_FACTOR = 2.0 ** -32
_U01_HALF = 2.0 ** -33
_UNEG11_FACTOR = 2.0 ** -31
_UNEG11_HALF = 2.0 ** -32
_PI = 3.1415926535897932

# odd polynomial for sin(pi*w) on [-1/2, 1/2], the JAX package's
# coefficients (rounded to float32 where they are used)
_SINPI_C0 = 3.1415925995
_SINPI_C1 = -5.1677080835
_SINPI_C2 = 2.5500510188
_SINPI_C3 = -0.59816166147
_SINPI_C4 = 0.077447286579


def _c(x: float) -> torch.Tensor:
    """A float32 0-dim constant. It stays on the CPU: PyTorch passes a CPU
    0-dim tensor to a CUDA kernel as a scalar, and each product is then a
    float32 product of float32 operands."""
    return torch.tensor(x, dtype=_F32)


def u01(bits):
    """word -> float32 uniform on (0, 1): u * 2^-32 + 2^-33."""
    f = bits.to(_F32)
    return f * _c(_U01_FACTOR) + _c(_U01_HALF)


def uneg11(bits):
    """word -> float32 uniform on (-1, 1): int32(u) * 2^-31 + 2^-32."""
    return uneg11_i32(to_signed(bits))


def uneg11_i32(signed):
    """uneg11 on the signed view of the word."""
    f = signed.to(_F32)
    return f * _c(_UNEG11_FACTOR) + _c(_UNEG11_HALF)


def u01_i32(signed):
    """u01 on the signed view: s * 2^-32 + 2^-33 + [s < 0]. Can differ from
    ``u01`` by one ulp (double rounding)."""
    f = signed.to(_F32)
    base = f * _c(_U01_FACTOR) + _c(_U01_HALF)
    return base + (signed < 0).to(_F32)


def _sinpi_half(w):
    """sin(pi*w) for w in [-1/2, 1/2] (degree-9 odd polynomial)."""
    w2 = w * w
    p = w2 * _c(_SINPI_C4) + _c(_SINPI_C3)
    for c in (_SINPI_C2, _SINPI_C1, _SINPI_C0):
        p = p * w2 + _c(c)
    return w * p


def _sincospi_fast(u):
    """(sin(pi*u), cos(pi*u)) for u in (-1, 1) from folds of one
    polynomial: cos(pi*u) == sin(pi*(1/2 - |u|))."""
    au = u.abs()
    one = _c(1.0)
    folded = torch.where(u >= 0, one - au, au - one)
    w_s = torch.where(au > _c(0.5), folded, u)
    return _sinpi_half(w_s), _sinpi_half(_c(0.5) - au)


def boxmul_pair_i32(s_even, s_odd, fast_cos: bool = False):
    """Box-Muller on the signed views of two words -> two float32 normals."""
    u = uneg11_i32(s_even)
    r = torch.sqrt(_c(-2.0) * torch.log(u01_i32(s_odd)))
    if fast_cos:
        s, c = _sincospi_fast(u)
    else:
        ang = _c(_PI) * u
        s, c = torch.sin(ang), torch.cos(ang)
    return s * r, c * r


def boxmul_pair(u_even, u_odd):
    """Box-Muller on two words (r123::boxmuller):
    x = sin(pi*uneg11(u0)) * r, y = cos(pi*uneg11(u0)) * r,
    r = sqrt(-2 ln u01(u1))."""
    u = uneg11(u_even)
    ang = _c(_PI) * u
    r = torch.sqrt(_c(-2.0) * torch.log(u01(u_odd)))
    return torch.sin(ang) * r, torch.cos(ang) * r


def boxmul_block(block):
    """Box-Muller over the pairs of the last axis of a word block (...,
    W), W even (r123ext::boxmulall): words 2i and 2i + 1 give normals 2i
    and 2i + 1 (``boxmul_pair``). Returns float32 of the block's shape."""
    w = block.shape[-1]
    if w % 2:
        raise ValueError("boxmul_block needs an even number of words")
    x, y = boxmul_pair(block[..., 0::2], block[..., 1::2])
    return torch.stack([x, y], dim=-1).reshape(block.shape)


def uneg11_block(block):
    """``uneg11`` over every word of a block (r123::uneg11all)."""
    return uneg11(block)
