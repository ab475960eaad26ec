"""Total least squares: classical and sketch-and-solve (counterpart of
randblas_tpu/linalg/tls.py; the reference's tls_dense_skop.cc:101-203).
Sketch [A b] down to d ~ 2(n+1) rows, then solve the small TLS problem by
SVD."""

from __future__ import annotations

import torch

from ..base import require
from ..skge import sketch_general


def tls_via_svd(ab: torch.Tensor) -> torch.Tensor:
    """Classical TLS on the stacked (m, n+1) matrix [A b]: x = -v[:n] / v[n]
    for v the right singular vector of the smallest singular value."""
    v = torch.linalg.svd(ab, full_matrices=False)[2][-1]
    return -v[:-1] / v[-1]


def sketched_tls(S, ab: torch.Tensor) -> torch.Tensor:
    """Sketch-and-solve TLS: compress [A b] (m, n+1) with an operator of
    n+1 <= d << m rows, then classical TLS on the sketch
    (tls_dense_skop.cc:139-186)."""
    m, n1 = ab.shape
    require(S.n_cols == m, "operator width must match data height")
    require(S.n_rows >= n1, "sketch dimension must be at least n+1")
    return tls_via_svd(sketch_general(S, ab))
