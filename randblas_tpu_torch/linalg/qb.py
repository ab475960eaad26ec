"""QB decomposition / randomized rangefinder with power iteration
(counterpart of randblas_tpu/linalg/qb.py; the reference's
svd_rank1_plus_noise.cc:217-300 and qrcp_matrixmarket.cc:220-283).

Sketch the range of A, re-stabilize between power-iteration passes, then
compress. Dense tensors and sparse (COO/CSR/CSC) data; everything runs on
the data's device.

Precision: a float32 product here is a plain float32 ``torch.matmul``.
The products that certificates and adaptive loops rest on
(``_mm_precise``) and ``cholqr`` switch TF32 off for their own products
and restore the caller's setting, so a caller who allows TF32 does not
floor their residuals at TF32's 1e-3.
"""

from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch

from ..base import require
from ..dense import DenseDist, DenseSkOp
from ..rng.state import RNGState
from ..skge import sketch_general
from ..sparse_data.spmm import left_spmm


def _is_sparse(a) -> bool:
    from ..sparse_data import COOMatrix, CSCMatrix, CSRMatrix
    return isinstance(a, (COOMatrix, CSRMatrix, CSCMatrix))


def _device_of(a, device=None) -> torch.device:
    """``device`` if given, else the device of the data ``a`` (a tensor or a
    sparse container), else the card: an operator given as a callable holds
    no tensor, and then its probes are made on the card unless the caller
    asks for the CPU (``dense.default_device``)."""
    from ..dense import default_device
    if device is None and not callable(a):
        return a.device
    return default_device(device)


def _cholesky(g: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of ``g`` (or of each matrix of a batch),
    NaN where the factorization fails (as JAX returns it), with no host
    synchronisation."""
    c, info = torch.linalg.cholesky_ex(g)
    return torch.where((info == 0)[..., None, None], c,
                       torch.full_like(c, float("nan")))


def _matmul(a, b, dtype):
    """a @ b in the operands' promoted dtype, cast to ``dtype`` (the JAX
    package's ``preferred_element_type``)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt)).to(dtype)


def _apply(a, x):
    """a @ x for dense or sparse a."""
    if _is_sparse(a):
        return left_spmm(a, x)
    return _matmul(a, x, x.dtype)


def _apply_t(a, x):
    """a.T @ x for dense or sparse a."""
    if _is_sparse(a):
        return left_spmm(a, x, op_a="T")
    return _matmul(a.T, x, x.dtype)


@contextlib.contextmanager
def _ieee_f32():
    """Float32 matmuls without TF32 inside, the caller's setting restored
    on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _mm_precise(x, y):
    """x @ y accurate to float32 even where the caller allows TF32: the
    certificate and adaptive paths measure residuals far below TF32's
    1e-3, and a TF32 product would floor them there."""
    with _ieee_f32():
        return _matmul(x, y, y.dtype)


def _apply_precise(a, x):
    """a @ x at certificate precision: dense float32/bf16 products through
    ``_mm_precise``; float64 and sparse products are already exact
    enough."""
    if _is_sparse(a) or x.dtype == torch.float64:
        return _apply(a, x)
    return _mm_precise(a, x)


def make_matvec(a):
    """``v -> A @ v`` on (n,) vectors for dense, sparse or callable A, dense
    sub-float64 products through ``_mm_precise`` (a matvec reads A once,
    so the exact product costs nothing, and a TF32 one corrupts Krylov
    bases)."""
    if callable(a):
        return a
    if _is_sparse(a) or a.dtype == torch.float64:
        return lambda v: _apply(a, v[:, None])[:, 0]
    return lambda v: _mm_precise(a, v)


def safe_svd(x: torch.Tensor, full_matrices: bool = False):
    """The SVD of a 2-D tensor, ``(u, s, vt)``, accurate to x's precision on
    the card as on the CPU.

    On a CUDA tensor ``torch.linalg.svd`` runs cuSOLVER's Jacobi solver,
    whose float32 singular vectors are orthonormal to only ~1e-4 (and
    reconstruct a random 8192 x 512 matrix to ~8e-4 of its largest entry;
    PERF.md, on an H100). So a thin SVD reduces x by Householder QR along
    its long side and decomposes the small square factor in float64; the
    long factor is the QR factor times the small one's. The JAX package's
    version scopes its x64 mode off around the SVD to step round a TPU
    compiler crash, which has no counterpart here."""
    if full_matrices:
        return torch.linalg.svd(x, full_matrices=True)
    if x.shape[0] < x.shape[1]:
        v, s, ut = safe_svd(x.T)
        return ut.T, s, v.T
    q, r = torch.linalg.qr(x)
    ur, s, vt = torch.linalg.svd(r.to(torch.float64), full_matrices=False)
    return q @ ur.to(x.dtype), s.to(x.dtype), vt.to(x.dtype)


def _clip_diagonal(r: torch.Tensor) -> torch.Tensor:
    """r with |diag(r)| floored at eps * ||r||_F, the sign kept, so a
    triangular solve with it stays finite on a rank-deficient r."""
    dr = torch.diagonal(r)
    floor = torch.clamp(torch.finfo(r.dtype).eps * torch.linalg.norm(r),
                        min=torch.finfo(r.dtype).tiny)
    dr_c = torch.where(dr.abs() < floor, torch.where(dr < 0, -floor, floor),
                       dr)
    return r + torch.diag(dr_c - dr)


def _solve_upper(r, v):
    """r^-1 v for upper-triangular r and v of shape (n,) or (n, k)."""
    if v.dim() == 1:
        return torch.linalg.solve_triangular(r, v[:, None], upper=True)[:, 0]
    return torch.linalg.solve_triangular(r, v, upper=True)


def qr_clipped_lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least-squares solve of a tall ``a @ y = b`` by Tikhonov-damped
    Householder QR: ``min || [a; lam I] y - [b; 0] ||`` with
    ``lam = max(eps * m * ||a||_F, tiny)``. Directions with singular value
    sigma >> lam get the exact LS coefficient, directions with sigma <<
    lam (exact-zero columns, numerically dependent ones) are clipped
    smoothly toward 0, and the damped system is full rank, so the
    triangular solve never divides by ~0. The floor ``tiny`` on the
    product (the smallest normal float) makes an all-zero system solve to
    y = 0. ``b`` may be a vector or a matrix of right-hand sides."""
    m = a.shape[1]
    lam = torch.clamp(torch.finfo(a.dtype).eps * m * torch.linalg.norm(a),
                      min=torch.finfo(a.dtype).tiny)
    aug = torch.cat([a, lam * torch.eye(m, dtype=a.dtype, device=a.device)])
    rhs = torch.cat([b, b.new_zeros((m,) + tuple(b.shape[1:]))])
    q, r = torch.linalg.qr(aug)
    return _solve_upper(r, q.T @ rhs)


def _orth(y: torch.Tensor, how: str) -> torch.Tensor:
    """Tall-skinny orthonormalization: 'cholqr' (rescued CholQR2, all
    matrix products) or 'qr' (Householder, stable at any conditioning)."""
    if how == "cholqr":
        from .distributed import cholqr
        return cholqr(y)[0]
    require(how == "qr", "orth must be 'cholqr' or 'qr'")
    return torch.linalg.qr(y).Q


def _lu_span(y: torch.Tensor) -> torch.Tensor:
    """P L for y = P L U by partially pivoted LU: spans y's columns (U is
    k x k and nonsingular for generic y) with bounded conditioning. The
    permutation is applied as a gather of L's rows, never formed."""
    m, k = y.shape
    lu, pivots = torch.linalg.lu_factor(y)
    l = torch.tril(lu, -1)[:, :k] + torch.eye(m, k, dtype=y.dtype,
                                               device=y.device)
    # LAPACK's row swaps, in order, give perm with y[perm] == L U; row
    # perm[i] of y is row i of L U, so P L is L's rows in the inverse order
    perm = list(range(m))
    for i, p in enumerate(pivots.tolist()):
        perm[i], perm[p - 1] = perm[p - 1], perm[i]
    inv = torch.empty(m, dtype=torch.int64)
    inv[torch.tensor(perm)] = torch.arange(m)
    return l[inv.to(y.device)]


def _stabilize(y: torch.Tensor, how: str) -> torch.Tensor:
    """Between-pass stabilization of the power iteration, the schemes of
    the reference's QRCP example (qrcp_matrixmarket.cc:220-283): full
    orthonormalization ('qr' / 'cholqr'), pivoted-LU span extraction
    ('lu': P L spans the same space as y at about half the cost of QR),
    or nothing ('none'). The final basis always comes from ``_orth``."""
    if how == "none":
        return y
    if how == "lu":
        return _lu_span(y)
    return _orth(y, how)


def rangefinder(a, k: int, state: RNGState, power_iters: int = 2,
                dtype=torch.float32, operator: str = "gaussian",
                orth: str = "cholqr", stabilizer: str = None
                ) -> torch.Tensor:
    """Orthonormal Q (m x k) approximating range(A), by a sketch and power
    iteration with re-stabilization each pass.

    ``operator`` is the embedding ('gaussian' | 'saso' | 'srht'; the last
    two for dense data only): 'gaussian' fills the thin (n, k) operator
    (on the card, through the fill kernel K3) and multiplies; the others
    sketch A @ S^T through ``sketch_general``. ``orth`` picks the final
    orthonormalizer, ``stabilizer`` the between-pass scheme ('cholqr' |
    'qr' | 'lu' | 'none', by default ``orth``)."""
    n_rows, n_cols = a.shape
    require(k <= min(n_rows, n_cols), "rank must be <= min dim")
    stabilizer = orth if stabilizer is None else stabilizer
    if operator == "gaussian" or _is_sparse(a):
        require(operator == "gaussian",
                "sparse data supports only the 'gaussian' rangefinder "
                "(materialized thin operator through the SpMM dispatcher)")
        S = DenseSkOp(DenseDist(n_cols, k), state, dtype=dtype)
        y = _apply(a, S.materialize(device=a.device))        # (m, k)
    else:
        from .embed import make_embedding
        S = make_embedding(operator, k, n_cols, state, dtype=dtype)
        y = sketch_general(S, a.to(dtype), side="right", op_s="T")
    for _ in range(power_iters):
        z = _apply_t(a, _stabilize(y, stabilizer))
        y = _apply(a, _stabilize(z, stabilizer))
    return _orth(y, orth)


def qb_decompose(a, k: int, state: RNGState, power_iters: int = 2,
                 dtype=torch.float32, operator: str = "gaussian",
                 orth: str = "cholqr") -> Tuple[torch.Tensor, torch.Tensor]:
    """A ~= Q @ B with Q (m x k) orthonormal and B = Q^T A (k x n)."""
    q = rangefinder(a, k, state, power_iters, dtype, operator, orth=orth)
    b = _apply_t(a, q).T if _is_sparse(a) else _matmul(q.T, a, dtype)
    return q, b


def qb_to_svd(q: torch.Tensor, b: torch.Tensor):
    """SVD of A from its QB factorization (svd_rank1_plus_noise.cc:264-300):
    the SVD of the small k x n factor B, then U = Q Ub."""
    ub, s, vt = safe_svd(b, full_matrices=False)
    return q @ ub, s, vt


def adaptive_rangefinder(a, tol: float, state: RNGState, *,
                         block: int = 16, max_rank: int = None,
                         alpha: float = 10.0, dtype=torch.float32
                         ) -> Tuple[torch.Tensor, torch.Tensor, RNGState]:
    """Grow an orthonormal basis Q until ``||(I - Q Q^T) A||_2 <= tol`` is
    certified (probability >= 1 - alpha**(-block) per check): HMT 2011
    alg. 4.2, blocked. Each round draws ``block`` Gaussian probe columns;
    their residuals against the basis are both the certificate (as in
    ``range_error_estimate``) and, while it exceeds ``tol``, the next basis
    block. Returns ``(q, bound, next_state)``.

    The loop runs on the host (the basis width depends on the data).
    ``max_rank`` caps the basis (default min(A.shape)). The certificate
    overestimates the spectral norm by up to ~||E||_F / ||E||_2, so set
    ``tol`` at the Frobenius level of the residual you will accept.
    """
    m, n = a.shape
    require(tol > 0, "tol must be > 0")
    require(block >= 1, "block must be >= 1")
    limit = min(m, n) if max_rank is None else min(max_rank, min(m, n))
    scale = alpha * math.sqrt(2.0 / math.pi)
    dev = a.device
    q = torch.zeros((m, 0), dtype=dtype, device=dev)
    st = state
    a_scale = None
    while True:
        S = DenseSkOp(DenseDist(n, block), st, dtype=dtype)
        y = _apply_precise(a, S.materialize(device=dev))     # (m, block)
        st = S.next_state
        r = y - _mm_precise(q, _mm_precise(q.T, y))
        mx = float(torch.linalg.norm(r, dim=0).max())
        bound = scale * mx
        if a_scale is None:
            a_scale = mx                          # first round: r == y
        if bound <= tol or q.shape[1] >= limit:
            return q, torch.tensor(bound, dtype=dtype, device=dev), st
        r = r - _mm_precise(q, _mm_precise(q.T, r))   # second GS pass
        # orthonormalize by SVD with a rank cutoff: once most of the range
        # is captured the residual block goes rank-deficient, and QR would
        # turn its numerically zero columns into junk that destroys the
        # basis; zero survivors mean the range is captured
        ur, sr, _ = safe_svd(r, full_matrices=False)
        cut = 20.0 * torch.finfo(dtype).eps * math.sqrt(m) * a_scale
        keep = min(int((sr > cut).sum()), limit - q.shape[1])
        if keep == 0:
            return q, torch.tensor(bound, dtype=dtype, device=dev), st
        q = torch.cat([q, ur[:, :keep]], dim=1)


def range_error_estimate(a, q: torch.Tensor, state: RNGState, *,
                         probes: int = 10, alpha: float = 10.0,
                         dtype=None) -> Tuple[torch.Tensor, RNGState]:
    """A bound on ``||(I - Q Q^T) A||_2`` that holds with probability at
    least ``1 - alpha**(-probes)`` (HMT 2011, alg. 4.3):
    alpha sqrt(2/pi) max_j ||(I - Q Q^T) A w_j|| over ``probes`` Gaussian
    probes. Returns ``(bound, next_state)``."""
    m, n = a.shape
    require(q.shape[0] == m, "q must have A's row count")
    require(probes >= 1, "probes must be >= 1")
    dtype = dtype or q.dtype
    W = DenseSkOp(DenseDist(n, probes), state, dtype=dtype)
    y = _apply_precise(a, W.materialize(device=q.device))    # (m, probes)
    r = y - _mm_precise(q, _mm_precise(q.T, y))
    bound = alpha * math.sqrt(2.0 / math.pi) * torch.linalg.norm(r, dim=0).max()
    return bound.to(dtype), W.next_state
