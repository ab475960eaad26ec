"""Sketch-based column-pivoted QR, column interpolative decomposition (ID)
and CUR (counterpart of randblas_tpu/linalg/qrcp.py; the reference's
qrcp_matrixmarket.cc:220-283 pipeline).

A randomized rangefinder compresses A to a k x n factor, column-pivoted QR
of that small factor picks a well-conditioned column subset, and the ID and
CUR factors follow from small solves. The pivoted QR (LAPACK geqp3) runs on
the host through SciPy, as in the JAX package: column pivoting is
sequential and the factor is small. Its pivots then index the data on its
device. A is touched only through products, so dense and sparse
(COO/CSR/CSC) data both work.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..base import require
from ..rng.state import RNGState
from .qb import _apply, _apply_t, _is_sparse, rangefinder


def sketch_qrcp(a, k: int, state: RNGState, power_iters: int = 2,
                dtype=torch.float32, operator: str = "gaussian",
                stabilizer: str = None
                ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Rank-k sketched column-pivoted QR. Returns ``(q, b, piv)``: ``q``
    (m, k) orthonormal from the rangefinder, ``b = q^T A`` (k, n), and
    ``piv`` (n,) LAPACK's pivot order of b's columns (a numpy array), so
    ``piv[:k]`` indexes a well-conditioned rank-k column subset of A.
    ``stabilizer`` is the power iteration's between-pass scheme ('cholqr' |
    'qr' | 'lu' | 'none', ``qb._stabilize``)."""
    import scipy.linalg
    q = rangefinder(a, k, state, power_iters, dtype, operator,
                    stabilizer=stabilizer)
    b = _apply_t(a, q).T                        # (k, n) = q^T A
    _, _, piv = scipy.linalg.qr(b.cpu().numpy(), pivoting=True,
                                mode="economic")
    return q, b, piv


def _take(x: torch.Tensor, idx: np.ndarray, dim: int) -> torch.Tensor:
    """x's slices along ``dim`` at the host indices ``idx``."""
    return x.index_select(dim, torch.as_tensor(idx, device=x.device))


def column_id(a, k: int, state: RNGState, power_iters: int = 2,
              dtype=torch.float32, operator: str = "gaussian"
              ) -> Tuple[np.ndarray, torch.Tensor]:
    """Column interpolative decomposition A ~= A[:, J] @ Z. Returns
    ``(J, Z)``: ``J`` (k,) the selected columns (numpy), ``Z`` (k, n) with
    Z[:, J] = I_k up to roundoff. With A ~= Q B, Z solves the k x k system
    B[:, J] Z = B."""
    _, b, piv = sketch_qrcp(a, k, state, power_iters, dtype, operator)
    j = np.asarray(piv[:k])
    return j, torch.linalg.solve(_take(b, j, 1), b)


def _onehot(idx, length: int, dtype, device=None) -> torch.Tensor:
    """(length, k) selection matrix with columns e_{idx[t]}."""
    idx = torch.as_tensor(idx, device=device)
    return (torch.arange(length, device=idx.device)[:, None]
            == idx[None, :]).to(dtype)


def cur(a, k: int, state: RNGState, power_iters: int = 2,
        dtype=torch.float32, operator: str = "gaussian"
        ) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """CUR decomposition A ~= C U R with C = A[:, J], R = A[I, :], U (k, k).

    Columns from ``sketch_qrcp`` on A; rows from the same pipeline on A^T,
    with the state chained past the column stage's embedding, so one seed
    reproduces the whole factorization. U = pinv(C) A pinv(R) through
    k-sized normal equations. Returns ``(I, J, U)``."""
    require(k >= 1, "rank must be >= 1")
    m, n = a.shape
    _, _, piv_c = sketch_qrcp(a, k, state, power_iters, dtype, operator)
    j = np.asarray(piv_c[:k])
    # the row stage starts where the column stage's embedding ends: the
    # rangefinder draws DenseDist(n, k) for 'gaussian' and for sparse data,
    # make_embedding(operator, k, n) otherwise
    if operator == "gaussian" or _is_sparse(a):
        from ..dense import DenseDist, compute_next_state
        chained = compute_next_state(DenseDist(n, k), state)
    else:
        from .embed import make_embedding
        chained = make_embedding(operator, k, n, state,
                                 dtype=dtype).next_state
    if _is_sparse(a):
        from ..sparse_data.conversions import to_coo
        at = to_coo(a).transpose()
    else:
        at = a.T
    _, _, piv_r = sketch_qrcp(at, k, chained, power_iters, dtype, operator)
    i = np.asarray(piv_r[:k])

    if _is_sparse(a):
        # the sparse containers take no fancy indexing: the skeletons as
        # one-hot products (two thin SpMMs)
        c = _apply(a, _onehot(j, n, dtype, a.device))        # A[:, J]
        r = _apply_t(a, _onehot(i, m, dtype, a.device)).T    # A[I, :]
    else:
        out_dt = torch.promote_types(a.dtype, dtype)
        c = _take(a, j, 1).to(out_dt)
        r = _take(a, i, 0).to(out_dt)
    # W = pinv(C) A from (C^T C) W = C^T A, C^T A = (A^T C)^T
    cta = _apply_t(a, c).T                                   # (k, n)
    w = torch.linalg.solve(c.T @ c, cta)
    # U = W pinv(R) = W R^T (R R^T)^-1
    u = torch.linalg.solve(r @ r.T, (w @ r.T).T).T
    return i, j, u
