"""Randomly pivoted (partial) Cholesky for PSD low-rank approximation
(counterpart of randblas_tpu/linalg/rpcholesky.py).

Block RPCholesky (Chen-Epperly-Tropp-Webber 2022, alg. 3): draw a block of
pivot columns with probability proportional to the residual diagonal, form
the residual columns G = A[:, S] - F F[S, :]^T, and absorb them through the
inverse square root of the pivot Gram block. A ~= F F^T touches only
``rank`` columns of A. Pivots come from ``util.sample_indices_iid`` on the
cdf of the residual diagonal (float64 on the tensor's device), so runs are
deterministic in the RNGState and seed-chained.

The block loop runs on the host. The downdates are products at float32
with TF32 off (``qb._mm_precise``): the residual diagonal feeds the pivot
distribution and the Gram clipping, and a reduced-precision product floors
the factorization error far above float32's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..base import require
from ..rng.state import RNGState
from ..util import sample_indices_iid
from .nystrom import _preconditioner
from .qb import _mm_precise, safe_svd


def _inv_sqrt_psd(h: torch.Tensor) -> torch.Tensor:
    """Pseudo inverse square root of a (b, b) PSD block by eigh with
    relative eigenvalue clipping: duplicate pivots make the block exactly
    rank-deficient, and the clipped directions give zero columns of F."""
    b = h.shape[0]
    w, v = torch.linalg.eigh(0.5 * (h + h.T))
    finfo = torch.finfo(h.dtype)
    cutoff = finfo.eps * b * torch.clamp(w.max(), min=finfo.tiny)
    inv_root = torch.where(w > cutoff,
                           1.0 / torch.sqrt(torch.maximum(w, cutoff)), 0.0)
    return _mm_precise(v * inv_root[None, :], v.T)


def rpcholesky(a, rank: int, state: RNGState, *, block: int = None,
               n: int = None, diag=None
               ) -> Tuple[torch.Tensor, torch.Tensor, RNGState]:
    """Rank-``rank`` partial Cholesky A ~= F @ F.T of PSD ``a`` with
    randomly chosen pivots.

    ``a`` is a dense (n, n) PSD tensor, or a column oracle
    ``a(idx) -> A[:, idx]`` (pass ``n`` and ``diag``, a tensor whose device
    the factor follows). ``block`` pivots are drawn per step (default
    ``min(rank, 64)``). Returns ``(f, pivots, next_state)``: ``f`` (n,
    rank), ``pivots`` int32 (rank,) (a pivot drawn twice in one block adds
    a zero column), and the chained state."""
    if callable(a):
        require(n is not None and diag is not None,
                "a column-oracle a needs explicit n and diag")
        d0 = torch.as_tensor(diag)
        require(tuple(d0.shape) == (n,), "diag must have shape (n,)")
        cols_of = a
    else:
        require(a.dim() == 2 and a.shape[0] == a.shape[1],
                "rpcholesky needs a square PSD matrix or a column oracle")
        n = a.shape[0]
        d0 = torch.diagonal(a)
        cols_of = lambda idx: a[:, idx.long()]     # noqa: E731
    require(1 <= rank <= n, "rank must be in [1, n]")
    b = min(rank, 64) if block is None else min(block, rank)
    require(b >= 1, "block must be >= 1")

    dtype, dev = d0.dtype, d0.device
    f = torch.zeros((n, rank), dtype=dtype, device=dev)
    pivots = torch.zeros((rank,), dtype=torch.int32, device=dev)
    d_res = torch.clamp(d0, min=0.0).to(dtype)
    tiny = torch.finfo(dtype).tiny
    st = state
    lo = 0
    while lo < rank:
        bt = min(b, rank - lo)
        # once the residual is numerically zero the approximation is exact:
        # sample uniformly so the cdf stays well formed (the extra pivots'
        # directions are shed by the Gram clipping)
        w = torch.clamp(d_res, min=0.0)
        w = torch.where(w.sum() > tiny, w, torch.ones_like(w))
        cdf = torch.cumsum(w, dim=0)
        idx, st = sample_indices_iid(cdf / cdf[-1], bt, st)
        rows = idx.long()
        g = cols_of(idx).to(dtype)                               # (n, bt)
        g = g - _mm_precise(f[:, :lo], f[rows, :lo].T)
        fb = _mm_precise(g, _inv_sqrt_psd(g[rows]))              # (n, bt)
        f[:, lo:lo + bt] = fb
        pivots[lo:lo + bt] = idx
        d_res = torch.clamp(d_res - (fb * fb).sum(dim=1), min=0.0)
        d_res = d_res.index_fill(0, rows, 0.0)
        lo += bt
    return f, pivots, st


def rpcholesky_pcg(a, bvec: torch.Tensor, state: RNGState, *, rank: int,
                   mu: float = 0.0, block: int = None, tol: float = None,
                   maxiter: int = 500
                   ) -> Tuple[torch.Tensor, int, RNGState]:
    """Solve ``(A + mu I) x = b`` by CG preconditioned with an RPCholesky
    approximation of PSD ``a``: ``nystrom_pcg``'s preconditioner built from
    ``rank`` columns of A instead of a sketch. ``a`` is a dense (n, n) PSD
    tensor; ``bvec`` is (n,) or (n, k). Returns ``(x, iterations,
    next_state)``."""
    require(not callable(a),
            "rpcholesky_pcg needs a dense A for the CG matvecs; build "
            "the preconditioner from rpcholesky() directly for operator A")
    vec = bvec.dim() == 1
    bb = bvec[:, None] if vec else bvec
    f, _, nxt = rpcholesky(a, rank, state, block=block)
    # F = U S V^T gives A ~= U diag(S^2) U^T, nystrom's (u, lam) form
    u, s, _ = safe_svd(f.to(bb.dtype), full_matrices=False)
    pinv, _ = _preconditioner(u, s * s, mu)
    op = (lambda x: a @ x + mu * x) if mu else (lambda x: a @ x)
    if tol is None:
        tol = 100.0 * torch.finfo(bb.dtype).eps
    from .lstsq import _pcg
    x, k = _pcg(op, bb, pinv=pinv, tol=tol, maxiter=maxiter)
    return (x[:, 0] if vec else x), k, nxt
