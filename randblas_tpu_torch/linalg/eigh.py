"""Randomized eigendecomposition of symmetric (possibly indefinite)
matrices and of symmetric-definite pencils by Rayleigh-Ritz on a sketched
range basis (counterpart of randblas_tpu/linalg/eigh.py; HMT 2011 alg. 5.3,
Martinsson-Tropp 2020 section 11.7)."""

from __future__ import annotations

from typing import Tuple

import torch

from ..base import require
from ..dense import DenseDist, DenseSkOp
from ..rng.state import RNGState
from .distributed import cholqr
from .qb import _apply, _cholesky, _matmul, rangefinder


def _ritz(q: torch.Tensor, aq: torch.Tensor, dtype):
    """(w ascending, q v): the eigenpairs of the Rayleigh quotient
    q^T aq (symmetrized) lifted back by q."""
    t = _matmul(q.T, aq, dtype)
    w, v = torch.linalg.eigh(0.5 * (t + t.T))
    return w, _matmul(q, v, dtype)


def rand_eigh(a, k: int, state: RNGState, power_iters: int = 2,
              dtype=torch.float32, operator: str = "gaussian"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-k randomized symmetric eigendecomposition A ~= u diag(w) u^T
    with signed eigenvalues. ``a`` is symmetric (n, n), dense or sparse
    (symmetry is assumed, not checked). Returns ``(w, u)``, ``w`` (k,)
    ascending and ``u`` (n, k) orthonormal. ``operator`` is the
    rangefinder's embedding ('gaussian' | 'saso' | 'srht')."""
    n, n2 = a.shape
    require(n == n2, "rand_eigh needs a square symmetric A")
    require(1 <= k <= n, "rank must be in [1, n]")
    q = rangefinder(a, k, state, power_iters, dtype, operator)
    return _ritz(q, _apply(a, q), dtype)


def rand_geigh(a, b, k: int, state: RNGState, power_iters: int = 2,
               dtype=torch.float32, operator: str = "gaussian"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-k randomized generalized symmetric-definite eigensolver: the k
    dominant-|theta| pairs of ``A x = theta B x``, A symmetric and B
    symmetric positive definite (both dense (n, n)).

    With B = L L^T the pencil is the symmetric problem C y = theta y,
    C = L^-1 A L^-T, x = L^-T y (Golub & Van Loan section 8.7). C is never
    formed: each product is C X = L^-1 (A (L^-T X)), two triangular solves
    against the k-column block and one product with A. Returns ``(theta,
    x)``, ``theta`` (k,) ascending and ``x`` (n, k) B-orthonormal."""
    n, n2 = a.shape
    require(n == n2, "rand_geigh needs a square symmetric A")
    require(tuple(b.shape) == (n, n), "B must match A's shape")
    require(1 <= k <= n, "rank must be in [1, n]")
    require(operator == "gaussian",
            "rand_geigh supports only the 'gaussian' probe family "
            "(the whitened operator is implicit)")
    ell = _cholesky(b.to(dtype))                       # B = L L^T

    def cmat(x):                                       # C @ X, (n, k)
        x = torch.linalg.solve_triangular(ell.T, x, upper=True)
        x = _apply(a, x).to(dtype)
        return torch.linalg.solve_triangular(ell, x, upper=False)

    def orth(y):
        return cholqr(y)[0]

    probe = DenseSkOp(DenseDist(k, n), state, dtype=dtype)
    y = cmat(probe.materialize(device=a.device).T)     # C @ Omega
    for _ in range(power_iters):
        # the rangefinder's passes for C^T == C: stabilize between applies
        y = cmat(orth(cmat(orth(y))))
    q = orth(y)
    w, u = _ritz(q, cmat(q), dtype)
    return w, torch.linalg.solve_triangular(ell.T, u, upper=True)
