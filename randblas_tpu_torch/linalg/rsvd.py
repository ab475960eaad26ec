"""Randomized truncated SVD (Halko–Martinsson–Tropp) on top of QB
(counterpart of randblas_tpu/linalg/rsvd.py; the reference's
svd_rank1_plus_noise.cc:217-300 pipeline as one call). Dense and sparse
(COO/CSR/CSC) data."""

from __future__ import annotations

from typing import Tuple

import torch

from ..base import require
from ..rng.state import RNGState
from .qb import _apply_t, _is_sparse, _matmul, adaptive_rangefinder, \
    qb_decompose, qb_to_svd


def rsvd(a, rank: int, state: RNGState, oversample: int = 8,
         power_iters: int = 2, dtype=torch.float32,
         operator: str = "gaussian", orth: str = "cholqr"
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-``rank`` approximate SVD: (u (m, rank), s (rank,), vt (rank,
    n)). ``oversample`` extra sketch columns and ``power_iters`` subspace
    iterations sharpen the tail; ``operator`` is the rangefinder's
    embedding ('gaussian' | 'saso' | 'srht') and ``orth`` its
    orthonormalizer ('cholqr' | 'qr')."""
    n_rows, n_cols = a.shape
    k = rank + oversample
    require(rank >= 1, "rank must be >= 1")
    require(k <= min(n_rows, n_cols),
            "rank + oversample must be <= min(A.shape)")
    q, b = qb_decompose(a, k, state, power_iters=power_iters, dtype=dtype,
                        operator=operator, orth=orth)
    u, s, vt = qb_to_svd(q, b)
    return u[:, :rank], s[:rank], vt[:rank, :]


def rsvd_adaptive(a, tol: float, state: RNGState, *, block: int = 16,
                  max_rank: int = None, dtype=torch.float32):
    """Truncated SVD at an error target: grow the basis with
    ``adaptive_rangefinder`` until its certificate clears ``tol``, then
    compress. Returns ``(u, s, vt, bound, next_state)``; the rank is
    ``len(s)``."""
    q, bound, nxt = adaptive_rangefinder(a, tol, state, block=block,
                                         max_rank=max_rank, dtype=dtype)
    if q.shape[1] == 0:
        m, n = a.shape
        return (q.new_zeros((m, 0)), q.new_zeros((0,)), q.new_zeros((0, n)),
                bound, nxt)
    b = _apply_t(a, q).T if _is_sparse(a) else _matmul(q.T, a, dtype)
    u, s, vt = qb_to_svd(q, b)
    return u, s, vt, bound, nxt
