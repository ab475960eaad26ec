"""Randomized spectral estimation: power method, extremal eigenvalues,
spectral norm, and sketched Rayleigh-Ritz eigenpairs (counterpart of
randblas_tpu/linalg/spectral.py; the reference's handrolled_lapack.hh
:214-303 power-method machinery as a library).

The iteration counts come from the same Kuczynski-Wozniakowski-style
bounds, the start vector is a counter-addressed Gaussian probe, and the
loops run on the host over matvec-shaped products of dense, sparse or
callable operators. A callable holds no tensor: its probe is made on
``device``, the card unless the caller asks for the CPU.

lambda_min of a dense positive definite A is the reference's path (one
Cholesky, the power method on inv(A): relative accuracy ~tol). Sparse and
callable operators, and dense ones whose Cholesky fails, power the PSD
complement (sigma I - A), whose lambda_min error is absolute,
~tol * lambda_max.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

from ..base import require
from ..dense import DenseDist, DenseSkOp, default_device
from ..rng.state import RNGState
from .qb import (_apply, _apply_t, _device_of, _is_sparse, _mm_precise,
                 make_matvec, safe_svd)


def required_power_iters(n: int, p_fail: float, tol: float) -> int:
    """Iterations for the power method on an n x n PSD matrix to reach
    relative accuracy ``tol`` with failure probability ``p_fail`` from a
    Gaussian start: the max of the expectation bound and the min of two
    probability bounds (handrolled_lapack.hh:214-231). Like the JAX
    package it divides before it truncates (the stated bound), where the
    C++ truncates the log first, so it may return a few more iterations."""
    require(0 < tol < 1 and 0 < p_fail < 1, "need 0 < tol, p_fail < 1")
    expectation_bound = math.ceil(
        (1.0 + math.log(math.sqrt(math.pi * n))) / tol)
    t0 = 1.0 - tol
    t1 = math.log(1.0 / t0)
    t2 = tol * p_fail * p_fail
    prob1 = int(math.log(math.e + 0.27 * t0 * t1 / t2) / t1)
    prob2 = int(math.log(math.sqrt(n) / p_fail) / t1)
    return max(expectation_bound, min(prob1, prob2))


def _probe(n: int, state: RNGState, dtype, device=None
           ) -> Tuple[torch.Tensor, RNGState]:
    """Counter-addressed Gaussian start vector (n,) on ``device`` (the card
    by default), and the chained state."""
    S = DenseSkOp(DenseDist(1, n), state, dtype=dtype)
    return S.materialize(device=default_device(device))[0], S.next_state


def power_method(matvec: Callable, n: int, state: RNGState, *,
                 tol: float = 1e-2, p_fail: float = 1e-6,
                 iters: int = None, dtype=torch.float32, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, RNGState]:
    """Dominant eigenpair of the PSD operator ``matvec`` (n -> n) by
    ``iters`` power steps (default ``required_power_iters``), from a probe
    on ``device`` (the card by default). Returns ``(lam, v, next_state)``,
    ``lam`` the Rayleigh quotient and ``v`` the unit iterate."""
    if iters is None:
        iters = required_power_iters(n, p_fail, tol)
    v, nxt = _probe(n, state, dtype, device)
    v = v / torch.linalg.norm(v)
    tiny = torch.finfo(dtype).tiny
    for _ in range(iters):
        w = matvec(v)
        v = w / torch.clamp(torch.linalg.norm(w), min=tiny)
    return torch.dot(v, matvec(v)), v, nxt


def extremal_eigs(a, state: RNGState, *, tol: float = 1e-2,
                  p_fail: float = 1e-6, iters: int = None,
                  dtype=torch.float32, n: int = None, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, RNGState]:
    """(lambda_min, lambda_max, next_state) of the PSD operator ``a`` (a
    dense tensor, a sparse container, or a callable matvec with explicit
    ``n``). A dense positive definite A takes the inverse path: one
    Cholesky (``cholesky_ex``, one host read of its status), then the power
    method on inv(A). Otherwise the shifted complement (sigma I - A) is
    powered, with absolute error ~tol * lambda_max on lambda_min."""
    if callable(a):
        require(n is not None, "callable a needs an explicit n")
        matvec = a
    else:
        require(a.shape[0] == a.shape[1], "extremal_eigs needs square A")
        n = a.shape[0]
        matvec = lambda v: _apply(a, v[:, None])[:, 0]     # noqa: E731
    dev = _device_of(a, device)
    lam_max, _, st = power_method(matvec, n, state, tol=tol, p_fail=p_fail,
                                  iters=iters, dtype=dtype, device=dev)
    tiny = torch.finfo(dtype).tiny
    if not callable(a) and not _is_sparse(a):
        chol, info = torch.linalg.cholesky_ex(a.to(dtype))
        if int(info) == 0 and bool(torch.isfinite(chol).all()):
            eye = torch.eye(n, dtype=dtype, device=dev)
            inv_a = torch.cholesky_solve(eye, chol)
            inv_a = 0.5 * (inv_a + inv_a.T)
            mu, _, nxt = power_method(
                lambda v: _apply(inv_a, v[:, None])[:, 0], n, st, tol=tol,
                p_fail=p_fail, iters=iters, dtype=dtype, device=dev)
            return 1.0 / torch.clamp(mu, min=tiny), lam_max, nxt
        # a singular or indefinite-at-rounding PSD matrix: the complement
        # path gives a finite lambda_min ~ 0
    sigma = lam_max * (1.0 + tol)
    mu, _, nxt = power_method(lambda v: sigma * v - matvec(v), n, st,
                              tol=tol, p_fail=p_fail, iters=iters,
                              dtype=dtype, device=dev)
    return torch.clamp(sigma - mu, min=0.0), lam_max, nxt


def spectral_norm(a, state: RNGState, *, tol: float = 1e-2,
                  p_fail: float = 1e-6, iters: int = None,
                  dtype=torch.float32) -> Tuple[torch.Tensor, RNGState]:
    """sigma_max(A) of a rectangular dense or sparse A by the power method
    on A^T A. Returns ``(sigma_max, next_state)``."""
    m, n = a.shape
    gram = lambda v: _apply_t(a, _apply(a, v[:, None]))[:, 0]  # noqa: E731
    lam, _, nxt = power_method(gram, n, state, tol=tol, p_fail=p_fail,
                               iters=iters, dtype=dtype, device=a.device)
    return torch.sqrt(torch.clamp(lam, min=0.0)), nxt


def _order(theta, which: str):
    """Indices of ``theta`` by 'LM' (largest magnitude) or 'LR' (largest
    real part) first, stable."""
    key = -theta.abs() if which == "LM" else -theta.real
    return torch.argsort(key, stable=True)


def sketched_eigs(a, k: int, state: RNGState, *, basis: int = None,
                  trunc: int = 4, d: int = None, operator: str = "saso",
                  vec_nnz: int = 8, which: str = "LM", sym: bool = False,
                  n: int = None, dtype=torch.float32, device=None):
    """Approximate eigenpairs of square A by sketched Rayleigh-Ritz
    (Nakatsukasa-Tropp 2021, alg. 2): an m-dimensional k-truncated Arnoldi
    basis Q from a Gaussian start vector, whitened through a d ~ 2m
    sketching operator, then the Ritz pairs of pinv(S Q) (S A Q).

    ``a`` is (n, n) dense, sparse, or a callable matvec (pass ``n``; its
    start vector is made on ``device``, the card by default); ``basis``
    defaults to ``min(n, max(4k, 2k + 10))``; ``which`` is 'LM' or 'LR'.

    ``sym=False``: the m x m Ritz problem is nonsymmetric and is solved on
    the host in float64 numpy (``np.linalg.eig``), as the JAX package does.
    Returns complex ``(theta (k,), x (n, k), resid (k,), next_state)`` on
    the data's device, resid the sketched relative residuals
    ||S(A x - theta x)|| / (|theta| ||S x||).

    ``sym=True`` (symmetric A): direct Rayleigh-Ritz on the
    SVD-orthonormalized basis on the device (``torch.linalg.eigh``), real
    output, no sketch drawn (next_state advances past the start vector
    only)."""
    from .embed import make_embedding
    from .rgs import _precise_sketch
    from .sgmres import _truncated_arnoldi, _warn_thin_embedding
    if callable(a):
        require(n is not None, "callable a needs an explicit n")
    else:
        require(a.shape[0] == a.shape[1], "sketched_eigs needs square A")
        n = a.shape[0]
    m = min(n, max(4 * k, 2 * k + 10)) if basis is None else min(basis, n)
    require(1 <= k <= m, "need 1 <= k <= basis")
    d_was_default = d is None
    d = min(n, 2 * m + 8) if d is None else d
    require(d >= m, "embedding dimension d must be >= basis")
    if not sym:
        _warn_thin_embedding(d, m, n, d_was_default)

    matvec = make_matvec(a)
    v0, st = _probe(n, state, dtype, _device_of(a, device))
    q, aq = _truncated_arnoldi(matvec, v0, m, min(trunc, m))
    finfo = torch.finfo(dtype)

    if sym:
        # q = U S V^T: the orthonormal basis is U, and A U = aq V S^+
        # exactly (aq = A q), so h = U^T A U needs no further matvec. The
        # sqrt(eps) clip bounds the 1/s growth of rounding noise in aq V
        # S^+ and drops the numerically repeated directions.
        u, s, vt = safe_svd(q, full_matrices=False)
        cutoff = math.sqrt(finfo.eps) * torch.clamp(s[0], min=finfo.tiny)
        keep = s > cutoff
        s_inv = torch.where(keep, 1.0 / torch.maximum(s, cutoff), 0.0)
        au = _mm_precise(aq, vt.T * s_inv[None, :])           # A U, (n, m)
        h = _mm_precise(u.T, au)
        h = torch.where(keep[:, None] & keep[None, :], 0.5 * (h + h.T), 0.0)
        theta_all, w_all = torch.linalg.eigh(h)
        sel = _order(theta_all, which)[:k]
        theta, w = theta_all[sel], w_all[:, sel]
        x = _mm_precise(u, w)
        num = torch.linalg.norm(_mm_precise(au, w) - x * theta[None, :],
                                dim=0)
        return theta, x, num / torch.clamp(theta.abs(), min=finfo.tiny), st

    # the pencil's sketches at float32 precision (rgs._precise_sketch),
    # never through the bf16-operand kernels: K4 rounds Q and AQ to bf16
    # separately, so bf16(AQ) != A bf16(Q) and the pencil's eigenpairs
    # move by that rounding times the whitening's 1/s (13% on a planted
    # spectrum at n = 8192, basis 64), where float32 sketches agree to 1e-6
    S = make_embedding(operator, d, n, st, vec_nnz=vec_nnz, dtype=dtype)
    sq = _precise_sketch(S, q, 1.0)                            # (d, m)
    saq = _precise_sketch(S, aq, 1.0)                          # (d, m)
    # the whitened pencil: with sq = U S V^T (clipped: breakdown columns
    # make sq exactly rank-deficient), y = (V S^+) z turns saq y = theta
    # sq y into M_w z = theta z, M_w = U^T saq (V S^+); converged Ritz
    # pairs are exact eigenpairs of the pencil for any injective S
    u, s, vt = safe_svd(sq, full_matrices=False)
    cutoff = finfo.eps * m * torch.clamp(s[0], min=finfo.tiny)
    s_inv = torch.where(s > cutoff, 1.0 / torch.maximum(s, cutoff), 0.0)
    white = vt.T * s_inv[None, :]                              # V S^+
    mw = u.T @ (saq @ white)                                   # (m, m)

    def host(t):
        return t.detach().cpu().numpy().astype(np.float64)

    theta_all, w_all = np.linalg.eig(host(mw))
    order = np.argsort(-np.abs(theta_all) if which == "LM"
                       else -theta_all.real)
    sel = order[:k]
    theta = theta_all[sel]
    y = host(white) @ w_all[:, sel]
    sq_np = host(sq)
    x = host(q) @ y
    x = x / np.maximum(np.linalg.norm(x, axis=0, keepdims=True),
                       np.finfo(np.float64).tiny)
    num = np.linalg.norm(host(saq) @ y - (sq_np @ y) * theta[None, :], axis=0)
    den = np.maximum(np.abs(theta) * np.linalg.norm(sq_np @ y, axis=0),
                     np.finfo(np.float64).tiny)
    dev = q.device
    return (torch.from_numpy(theta).to(dev), torch.from_numpy(x).to(dev),
            torch.from_numpy(num / den).to(dev), S.next_state)
