"""Randomized Nystrom approximation of PSD matrices, and CG preconditioned
by it (counterpart of randblas_tpu/linalg/nystrom.py).

Single-pass sketch-based low-rank eigendecomposition A ~= U diag(L) U^T
for symmetric positive semidefinite A, with the shifted-Cholesky
stabilization of Tropp-Yurtsever-Udell-Cevher (SIAM J. Matrix Anal. 2017,
alg. 16). The (n, d) sketch Y = A Omega of a dense A goes through
``sketch_general`` (on the card the fused kernels); the d x d Cholesky,
triangular solve and SVD are small.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..base import require
from ..dense import DenseDist, DenseSkOp
from ..rng.state import RNGState
from ..skge import sketch_general
from .qb import _apply, _cholesky, _device_of, _is_sparse, _mm_precise, safe_svd


def nystrom(a, d: int, state: RNGState, dtype=torch.float32, *,
            n: int = None, device=None
            ) -> Tuple[torch.Tensor, torch.Tensor, RNGState]:
    """Rank-d Nystrom approximation of PSD ``a`` (n x n).

    ``a`` may be a callable ``a(X) -> A @ X`` (pass ``n``; its sketch is
    made on ``device``, the card by default). Returns ``(u, lam,
    next_state)`` with ``u`` (n, d) orthonormal and ``lam`` (d,)
    nonnegative, A ~= u diag(lam) u^T. A failed Cholesky of the shifted
    Gram gives NaN, as in the JAX package."""
    if callable(a):
        require(n is not None, "callable a needs an explicit n")
    else:
        n = a.shape[0]
        require(a.shape[0] == a.shape[1], "nystrom needs a square PSD A")
    require(1 <= d <= n, "sketch size d must be in [1, n]")

    S = DenseSkOp(DenseDist(n, d), state, dtype=dtype)
    omega = S.materialize(device=_device_of(a, device))
    if callable(a):
        y = a(omega)
    elif _is_sparse(a):
        y = _apply(a, omega)
    else:
        y = sketch_general(S, a.to(dtype), side="right", op_s="N")

    # shifted Cholesky: nu at the machine-eps scale of Y keeps the Gram
    # factor positive definite when A is numerically rank-deficient
    nu = (torch.finfo(dtype).eps * math.sqrt(n)) * torch.linalg.norm(y)
    y_nu = y + nu * omega
    gram = _mm_precise(omega.T, y_nu)            # (d, d), symmetric PD
    c = _cholesky(0.5 * (gram + gram.T))
    # B = Y_nu C^-T
    b = torch.linalg.solve_triangular(c.T, y_nu, upper=True, left=False)
    u, s, _ = safe_svd(b, full_matrices=False)
    return u, torch.clamp(s * s - nu, min=0.0), S.next_state


def nystrom_apply(u: torch.Tensor, lam: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """(u diag(lam) u^T) @ x."""
    return u @ (lam[:, None] * (u.T @ x))


def _preconditioner(u: torch.Tensor, lam: torch.Tensor, mu: float):
    """(pinv, inv_head) of the Frangella-Tropp-Udell preconditioner
    P^-1 v = U diag((lam_d + mu)/(lam + mu)) U^T v + (v - U U^T v) of the
    rank-d approximation U diag(lam) U^T, in its effective-rank form:
    directions with lam + mu at or below eps (lam_0 + mu) are dropped (scale
    1), and lam_d is the smallest kept regularized eigenvalue; ``inv_head``
    is diag(1/(lam + mu)) on the kept directions, 0 elsewhere."""
    lam_reg = lam + mu
    finfo = torch.finfo(lam.dtype)
    cutoff = torch.clamp(finfo.eps * lam_reg[0], min=finfo.tiny)
    kept = lam_reg > cutoff
    lam_d = torch.where(kept, lam_reg, torch.inf).min()
    lam_d = torch.where(torch.isfinite(lam_d), lam_d, 1.0)
    safe = torch.maximum(lam_reg, cutoff)
    scale = torch.where(kept, lam_d / safe, 1.0)[:, None]
    inv_head = torch.where(kept, 1.0 / safe, 0.0)[:, None]

    def pinv(v):
        w = u.T @ v                                   # (d, k)
        return u @ (scale * w) + (v - u @ w)

    return pinv, inv_head


def nystrom_pcg(a, b: torch.Tensor, state: RNGState, *, d: int,
                mu: float = 0.0, tol: float = None, maxiter: int = 500,
                dtype=None) -> Tuple[torch.Tensor, int, RNGState]:
    """Solve ``(A + mu I) x = b`` by CG with a randomized Nystrom
    preconditioner (Frangella-Tropp-Udell 2021).

    ``a`` is a dense tensor, a sparse container or a callable
    ``a(X) -> A @ X``; ``b`` is (n,) or (n, k), and the sketch follows b's
    device. Returns ``(x, iterations, next_state)``."""
    vec = b.dim() == 1
    bb = b[:, None] if vec else b
    n = bb.shape[0]
    require(1 <= d <= n, "sketch size d must be in [1, n]")
    matvec = a if callable(a) else (lambda x: _apply(a, x))
    u, lam, nxt = nystrom(a, d, state, dtype or bb.dtype, n=n,
                          device=bb.device)
    lam = lam.to(bb.dtype)
    u = u.to(bb.dtype)
    pinv, inv_head = _preconditioner(u, lam, mu)
    op = (lambda x: matvec(x) + mu * x) if mu else matvec
    if tol is None:
        tol = 100.0 * torch.finfo(bb.dtype).eps
    # warm start at the Nystrom head solve x0 = U diag(1/(lam + mu)) U^T b
    # over the kept directions
    x0 = u @ (inv_head * (u.T @ bb))
    from .lstsq import _pcg
    x, k = _pcg(op, bb, pinv=pinv, x0=x0, tol=tol, maxiter=maxiter)
    return (x[:, 0] if vec else x), k, nxt
