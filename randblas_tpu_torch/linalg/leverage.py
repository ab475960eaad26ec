"""Sketched leverage-score estimation (Drineas-Magdon-Ismail-Mahoney-
Woodruff 2012; counterpart of randblas_tpu/linalg/leverage.py).

Leverage scores l_i = ||Q[i, :]||^2 (Q an orthonormal basis of range(A))
from two sketches instead of a full QR:

  1. embed: R from qr(S A), S a (d, m) embedding with d = O(n), so A R^-1
     has nearly orthonormal columns;
  2. JL:    G (n, r) Gaussian, r << n: the row norms of (A R^-1) G estimate
     those of A R^-1 at O(mnr) instead of O(mn^2).

On the card the default 'saso' embedding runs the SASO kernel K4.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..base import require
from ..dense import DenseDist, DenseSkOp, isometry_scale_factor
from ..rng.state import RNGState
from ..skge import sketch_general
from .embed import make_embedding


def exact_leverage_scores(a: torch.Tensor) -> torch.Tensor:
    """l_i = ||Q[i, :]||^2 by a dense QR (the reference for checks)."""
    q = torch.linalg.qr(a).Q
    return (q * q).sum(dim=1)


def leverage_scores(a: torch.Tensor, state: RNGState, embed_factor: int = 4,
                    jl_dim: int = 0, operator: str = "saso",
                    dtype=torch.float32) -> Tuple[torch.Tensor, RNGState]:
    """Estimated leverage scores of tall ``a`` (m x n, m >= n).

    ``embed_factor``: embedding rows d = embed_factor * n. ``jl_dim``:
    columns of the second (JL) sketch; 0 computes the exact row norms of
    A R^-1. ``operator``: the stage-1 embedding, 'saso' (vec_nnz 8),
    'gaussian' or 'srht'. Returns (scores (m,), next_state)."""
    m, n = a.shape
    require(m >= n, "leverage_scores expects a tall matrix (m >= n)")
    require(jl_dim < n, "jl_dim must be < n (a JL sketch must reduce the "
                        "column count; use jl_dim=0 for exact row norms)")
    d = min(embed_factor * n, m)
    require(d >= n, "embedding dimension must be >= n")

    a = a.to(dtype)
    S = make_embedding(operator, d, m, state, vec_nnz=8, dtype=dtype)
    # the scores scale as 1/c^2 under S -> cS, so S must satisfy
    # E[S^T S] = I
    sa = sketch_general(S, a, alpha=isometry_scale_factor(S.dist))  # (d, n)
    r = torch.linalg.qr(sa, mode="r").R                              # (n, n)
    if jl_dim:
        G = DenseSkOp(DenseDist(n, jl_dim), S.next_state, dtype=dtype)
        # A (R^-1 G): the small solve first, then one m x n product
        rg = torch.linalg.solve_triangular(
            r, G.materialize(device=a.device) / math.sqrt(jl_dim),
            upper=True)
        return ((a @ rg) ** 2).sum(dim=1), G.next_state
    ar = torch.linalg.solve_triangular(r, a, upper=True, left=False)
    return (ar * ar).sum(dim=1), S.next_state
