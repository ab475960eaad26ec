"""RandBLAS's dense Gaussian operator, regenerated block by block.

A DenseDist(d, m) with d < m and MajorAxis.Long fills row-major: element
(r, c) is lane c % 4 of the counter r * ceil(m / 4) + c // 4. The four
words of a counter become four values by r123's Box-Muller on the pairs
(w0, w1) and (w2, w3): u = int32(w_even) * 2^-31 + 2^-32, v = w_odd *
2^-32 + 2^-33 (float32), x = sin(pi u) sqrt(-2 ln v), y = cos(pi u)
sqrt(-2 ln v). The uniforms are made in float32 as the standard makes
them; the sine, cosine and logarithm are taken in float64, so the values
are the exact Gaussians of those uniforms.
"""

from __future__ import annotations

import math

import torch

from . import philox


def _uneg11(w: torch.Tensor) -> torch.Tensor:
    signed = w - ((w >> 31) << 32)
    return (signed.to(torch.float32) * 2.0 ** -31 + 2.0 ** -32)


def _u01(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.float32) * 2.0 ** -32 + 2.0 ** -33


def box_muller(w_even, w_odd):
    """(x, y) float64 normals of a pair of word tensors."""
    u = _uneg11(w_even).to(torch.float64)
    r = torch.sqrt(-2.0 * torch.log(_u01(w_odd).to(torch.float64)))
    return torch.sin(math.pi * u) * r, torch.cos(math.pi * u) * r


def dense_block(key: int, d: int, m: int, c0: int, cols: int,
                device) -> torch.Tensor:
    """float64 (d, cols): columns c0 .. c0 + cols of the Gaussian
    DenseDist(d, m) operator (d < m, MajorAxis.Long) keyed ``key``."""
    stride = -(-m // 4)
    b0, b1 = c0 // 4, (c0 + cols - 1) // 4 + 1
    rows = torch.arange(d, dtype=torch.int64, device=device)[:, None]
    blocks = torch.arange(b0, b1, dtype=torch.int64, device=device)[None, :]
    w = philox.words_at(key, rows * stride + blocks)
    x0, y0 = box_muller(w[0], w[1])
    x1, y1 = box_muller(w[2], w[3])
    vals = torch.stack([x0, y0, x1, y1], dim=-1).reshape(d, -1)
    first = c0 - 4 * b0
    return vals[:, first:first + cols]
