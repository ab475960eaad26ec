"""Sketched overdetermined least squares: sketch-and-solve and
sketch-and-precondition, Blendenpik / LSRN family (counterpart of
randblas_tpu/linalg/lstsq.py).

- sketch-and-solve: min ||S A x - S b|| on a d ~ 2n row sketch, one small
  QR, a residual within (1 + delta) of the optimum.
- sketch-and-precondition: R from qr(S A) right-preconditions CGLS on the
  full problem; cond(A R^-1) = O(1) with high probability, so it converges
  in a few dozen steps whatever cond(A) is, to solver accuracy.

The sketch goes through ``sketch_general`` / ``sketch_sparse``, so on the
card a Gaussian embedding runs K1 and a SASO one the Fisher–Yates fill and
K4. The iterations are Python loops on the host, one convergence test (a
device sync) per step, with the JAX package's stopping rules.

Spans (``profiling.span``; no-ops unless a ``recording()`` is on):
``sketch_and_precondition`` (args ``operator``, ``d``) holds
``precondition`` (the sketch pair, the QR and the warm start; no
synchronize at its end) and ``cgls``; ``cgls`` (every ``_cgls`` caller:
``cgls``, ``sketch_and_precondition``, ``ridge_lsq``) holds the initial
residual and one ``cgls.step`` (arg ``j``) a step, each ended once its
convergence test has returned, and records the count it returns as
``steps``.

``mesh=`` (a ('model', 'data') DeviceMesh of ``randblas_tpu_torch.parallel``)
shards A's rows over 'data': the sketch runs through the distributed layer
('gaussian' through ``distributed_sketch``, 'saso' through
``distributed_sparse_sketch``, sparse data through
``distributed_sketch_sparse_data``) and is gathered, as it is small, and
the iterations run on each rank's rows of a dense A (and of b), with an
all-reduce over 'data' of every product that contracts over the rows.
Sparse data stays replicated for the iterations.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .. import profiling
from ..base import require
from ..rng.state import RNGState
from ..skge import sketch_general
from ..sksp import sketch_sparse
from .embed import make_embedding
from .qb import _apply, _apply_t, _is_sparse, _solve_upper


class _Rows:
    """The data a solver iterates on: this rank's rows of a dense A and of
    b on a mesh, with the 'data' group that sums a product over the rows;
    all of A and b (gathered where they are DTensors) and no group
    otherwise."""

    def __init__(self, a, b, mesh):
        from ..parallel.distributed import data_chunk, gathered
        self.group = None
        if mesh is None or _is_sparse(a):
            self.a, self.b = gathered(a), gathered(b)
            return
        self.a = data_chunk(a, mesh, 0)[0]
        self.b = data_chunk(b, mesh, 0)[0]
        self.group = mesh.get_group("data")

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the row shards."""
        from ..parallel.distributed import _all_reduce
        return _all_reduce(t, self.group)

    def apply(self, x):
        """This rank's rows of A @ x."""
        return _apply(self.a, x)

    def apply_t(self, r):
        """A^T @ r for r this rank's rows of an m-vector."""
        return self.reduce(_apply_t(self.a, r))

    def sumsq(self, q):
        """Column sums of squares of an m-sized q held by rows."""
        return self.reduce((q * q).sum(dim=0))


def _solvers(r):
    """(v -> R^-1 v, v -> R^-T v) for upper-triangular R."""
    return (lambda v: _solve_upper(r, v),
            lambda v: torch.linalg.solve_triangular(r.T, v, upper=False))


def _keep_going(gamma, thresh, best, k, maxiter) -> bool:
    """The loops' stopping rule: some column is above its threshold and
    still within 1e4 of its own best (past working precision CG amplifies
    rounding noise instead of converging), and k < maxiter."""
    unconverged = gamma > thresh
    progressing = gamma <= 1e4 * best
    return k < maxiter and bool((unconverged & progressing).any())


def _ratio(num, den):
    """num / den where den > 0, else 0 (per column)."""
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, 1.0), 0.0)


def cgls(matvec: Callable, rmatvec: Callable, b: torch.Tensor, n: int, *,
         x0: Optional[torch.Tensor] = None, tol: Optional[float] = None,
         maxiter: int = 100) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Conjugate gradient on the normal equations (CGLS).

    Solves min ||M x - b|| for the operator given by ``matvec`` (n -> m)
    and ``rmatvec`` (m -> n). ``b`` is (m,) or (m, k); block right-hand
    sides get per-column step sizes. Stops when every column's
    normal-equation residual ||M^T r|| is below ``tol * ||M^T b||``
    (relative to the zero-start residual even with ``x0``), after
    ``maxiter`` iterations, or when every unconverged column sits 1e4
    above its own best (divergence guard). ``tol`` defaults to 100 eps.

    Returns ``(x, iterations, gamma)``: the best iterate per column, the
    iteration count and the best squared normal residual per column.
    """
    return _cgls(matvec, rmatvec, b, n, x0=x0, tol=tol, maxiter=maxiter,
                 sumsq=lambda q: (q * q).sum(dim=0))


def _cgls(matvec, rmatvec, b, n, *, x0, tol, maxiter, sumsq):
    """``cgls`` with the column sums of squares of matvec's m-sized
    results taken by ``sumsq`` (on a mesh each rank holds their rows)."""
    vec = b.dim() == 1
    bb = b[:, None] if vec else b
    if tol is None:
        tol = 100.0 * torch.finfo(bb.dtype).eps
    with profiling.span("cgls") as span:
        x = (bb.new_zeros((n, bb.shape[1])) if x0 is None
             else (x0[:, None] if vec else x0))
        r = bb - matvec(x)
        s = rmatvec(r)
        gamma = (s * s).sum(dim=0)
        if x0 is None:
            gamma_ref = gamma
        else:
            sb = rmatvec(bb)
            gamma_ref = (sb * sb).sum(dim=0)
        thresh = torch.clamp(tol * tol * gamma_ref,
                             min=torch.finfo(bb.dtype).tiny)
        p, x_best, gamma_best, k = s, x, gamma, 0
        go = _keep_going(gamma, thresh, gamma_best, k, maxiter)
        while go:
            # a step's span ends once its convergence test (a device
            # sync) has returned, so it holds the step's device time
            with profiling.span("cgls.step", j=k):
                q = matvec(p)
                alpha = _ratio(gamma, sumsq(q))
                x = x + alpha * p
                r = r - alpha * q
                s = rmatvec(r)
                gamma_new = (s * s).sum(dim=0)
                improved = gamma_new < gamma_best
                x_best = torch.where(improved[None, :], x, x_best)
                gamma_best = torch.where(improved, gamma_new, gamma_best)
                p = s + _ratio(gamma_new, gamma) * p
                gamma, k = gamma_new, k + 1
                go = _keep_going(gamma, thresh, gamma_best, k, maxiter)
        span.set(steps=k)
    return (x_best[:, 0] if vec else x_best), k, gamma_best


def _pcg(op: Callable, bb: torch.Tensor, *, pinv: Optional[Callable] = None,
         x0: Optional[torch.Tensor] = None, tol: float, maxiter: int
         ) -> Tuple[torch.Tensor, int]:
    """CG on the SPD system ``op(x) = bb`` (bb (n, k)), optionally
    preconditioned by ``pinv`` and warm-started at ``x0``, per-column step
    sizes. It stops on the unpreconditioned residual ||r|| relative to the
    zero-start ||b||, with the divergence guard of ``cgls``, and returns
    ``(x, iterations)``, x the best iterate per column."""
    x = torch.zeros_like(bb) if x0 is None else x0
    r = bb if x0 is None else bb - op(x)
    z = r if pinv is None else pinv(r)
    gamma = (r * z).sum(dim=0)
    rho = (r * r).sum(dim=0)
    thresh = torch.clamp(tol * tol * (bb * bb).sum(dim=0),
                         min=torch.finfo(bb.dtype).tiny)
    p, x_best, rho_best, k = z, x, rho, 0
    while _keep_going(rho, thresh, rho_best, k, maxiter):
        q = op(p)
        alpha = _ratio(gamma, (p * q).sum(dim=0))
        x = x + alpha * p
        r = r - alpha * q
        z = r if pinv is None else pinv(r)
        gamma_new = (r * z).sum(dim=0)
        rho = (r * r).sum(dim=0)
        improved = rho < rho_best
        x_best = torch.where(improved[None, :], x, x_best)
        rho_best = torch.where(improved, rho, rho_best)
        p = z + _ratio(gamma_new, gamma) * p
        gamma, k = gamma_new, k + 1
    return x_best, k


def _sketch_pair(a, b, d: int, state: RNGState, operator: str,
                 vec_nnz: int, dtype, mesh=None):
    """(S A, S b, next_state) with one operator for A and b; b = None skips
    the right-hand side's sketch (sb = None). With ``mesh``, the sketch
    runs distributed (``_sketch_pair_distributed``)."""
    if mesh is not None:
        return _sketch_pair_distributed(a, b, d, state, operator, vec_nnz,
                                        dtype, mesh)
    m = a.shape[0]
    if dtype is None and operator != "saso":
        dtype = a.dtype if not _is_sparse(a) else (
            b.dtype if b is not None else torch.float32)
    S = make_embedding(operator, d, m, state, vec_nnz=vec_nnz,
                       dtype=dtype or torch.float32)
    bb = None if b is None else (b[:, None] if b.dim() == 1 else b)
    if _is_sparse(a):
        require(operator != "srht",
                "the SRHT embedding needs dense data (the Hadamard transform "
                "has no sparse apply); use 'saso' or 'gaussian' for sparse a")
        if operator == "saso":
            # a sparse operator times sparse data has no library core: the
            # (d, m) operator is densified and rides the sparse-data SpMM,
            # S A = (A^T S^T)^T
            st = S.materialize(device=a.device).to(
                a.vals.dtype if bb is None else bb.dtype)
            sa = _apply_t(a, st.T).T
            sb = None if bb is None else st @ bb
        else:
            sa = sketch_sparse(S, a)
            sb = None if bb is None else sketch_general(S, bb)
    else:
        sa = sketch_general(S, a.to(dtype) if dtype is not None else a)
        sb = None if bb is None else sketch_general(S, bb.to(sa.dtype))
    return sa, None if sb is None else sb.to(sa.dtype), S.next_state


def _sketch_pair_distributed(a, b, d: int, state: RNGState, operator: str,
                             vec_nnz: int, dtype, mesh):
    """Mesh-sharded ``_sketch_pair``: A's rows over 'data', the sketches
    gathered (each is d x n)."""
    from ..parallel.distributed import (distributed_sketch,
                                        distributed_sketch_sparse_data,
                                        distributed_sparse_sketch, gathered)
    require(operator in ("saso", "gaussian"),
            "mesh-distributed sketching supports the 'saso' and "
            "'gaussian' families (SRHT is column-sharded only; see "
            "parallel/distributed.py)")
    m = a.shape[0]
    bb = None if b is None else (b[:, None] if b.dim() == 1 else b)
    if _is_sparse(a):
        require(operator == "gaussian",
                "sparse data on a mesh rides the dense-operator "
                "distributed lsksp3 (use operator='gaussian')")
        S = make_embedding("gaussian", d, m, state,
                           dtype=dtype or (bb.dtype if bb is not None
                                           else torch.float32))
        sa = gathered(distributed_sketch_sparse_data(S, a, mesh))
        sb = None if bb is None else gathered(
            distributed_sketch(S, bb.to(sa.dtype), mesh))
        return sa, sb, S.next_state
    if dtype is None and operator != "saso":
        dtype = a.dtype
    S = make_embedding(operator, d, m, state, vec_nnz=vec_nnz,
                       dtype=dtype or torch.float32)
    sketch = (distributed_sparse_sketch if operator == "saso"
              else distributed_sketch)
    adt = a.to(dtype) if dtype is not None else a
    sa = gathered(sketch(S, adt, mesh))
    sb = None if bb is None else gathered(sketch(S, bb.to(sa.dtype), mesh))
    return sa, None if sb is None else sb.to(sa.dtype), S.next_state


def sketch_and_solve_lsq(a, b, d: int, state: RNGState, *,
                         operator: str = "saso", vec_nnz: int = 8,
                         dtype=None, mesh=None
                         ) -> Tuple[torch.Tensor, RNGState]:
    """Delta-accurate least squares: x = argmin ||S A x - S b||.

    ``a`` is tall (m, n), dense or sparse (COO/CSR/CSC); ``b`` is (m,) or
    (m, k); ``d`` the sketch size (2n..4n gives the classic (1 + delta)
    residual guarantee); ``operator`` the embedding ('saso' | 'gaussian' |
    'srht'). Returns (x, next_state).
    """
    m, n = a.shape
    require(m >= n, "sketch_and_solve_lsq expects a tall system (m >= n)")
    require(n <= d <= m, "sketch size d must satisfy n <= d <= m")
    sa, sb, nxt = _sketch_pair(a, b, d, state, operator, vec_nnz, dtype,
                               mesh=mesh)
    q, r = torch.linalg.qr(sa)
    x = _solve_upper(r, q.T @ sb)
    return (x[:, 0] if b.dim() == 1 else x), nxt


def sketch_and_precondition(a, b, state: RNGState, *, d: Optional[int] = None,
                            operator: str = "saso", vec_nnz: int = 8,
                            tol: Optional[float] = None, maxiter: int = 200,
                            warm_start: bool = True, dtype=None, mesh=None
                            ) -> Tuple[torch.Tensor, int, RNGState]:
    """Solver-accurate least squares by sketched preconditioning.

    Sketch A to d ~ 2n rows (``operator``: 'saso' | 'gaussian' | 'srht',
    the last Blendenpik's transform), QR the sketch, run CGLS on the full
    problem in y = R x (cond(A R^-1) = O(1) whp). ``warm_start`` starts
    from the sketch-and-solve solution, which the sketch and its QR have
    already paid for. Returns ``(x, cgls_iterations, next_state)``. Run
    ill-conditioned systems in float64.
    """
    m, n = a.shape
    require(m >= n, "sketch_and_precondition expects a tall system")
    d = min(2 * n if d is None else d, m)
    require(d >= n, "sketch size d must be >= n")
    with profiling.span("sketch_and_precondition", operator=operator, d=d):
        with profiling.span("precondition"):
            if warm_start:
                sa, sb, nxt = _sketch_pair(a, b, d, state, operator,
                                           vec_nnz, dtype, mesh=mesh)
                q, r = torch.linalg.qr(sa)
                y0 = q.T @ sb               # R x_sketched, in y variables
            else:
                # a cold start needs only R: no sketch of b, no Q
                sa, _, nxt = _sketch_pair(a, None, d, state, operator,
                                          vec_nnz, dtype, mesh=mesh)
                r = torch.linalg.qr(sa, mode="r")[1]
                y0 = None
        solve_r, solve_rt = _solvers(r)
        rows = _Rows(a, b, mesh)
        bb = rows.b if b.dim() > 1 else rows.b[:, None]
        y, iters, _ = _cgls(lambda v: rows.apply(solve_r(v)),
                            lambda rr: solve_rt(rows.apply_t(rr)),
                            bb.to(sa.dtype), n, x0=y0, tol=tol,
                            maxiter=maxiter, sumsq=rows.sumsq)
        x = solve_r(y)
    return (x[:, 0] if b.dim() == 1 else x), iters, nxt


def min_norm_lsq(a, b, state: RNGState, *, d: Optional[int] = None,
                 operator: str = "saso", vec_nnz: int = 8,
                 tol: Optional[float] = None, maxiter: int = 200,
                 dtype=None) -> Tuple[torch.Tensor, int, RNGState]:
    """Minimum-norm solution of the wide consistent system ``A x = b``
    (m < n): ``x = A^T (A A^T)^+ b``, the underdetermined counterpart of
    ``sketch_and_precondition``.

    R from the QR of the sketched dual S A^T (d, m) gives cond(A^T R^-1) =
    O(1), so CG on (A^T R^-1)^T (A^T R^-1) z = R^-T b, x = A^T R^-1 z,
    converges in O(1) iterations whatever cond(A) is. ``b`` is (m,) or
    (m, k). Returns ``(x, iterations, next_state)``. The solution error
    reaches ~100 eps; the residual holds only to ~cond(A) eps.
    """
    m, n = a.shape
    require(m <= n, "min_norm_lsq expects a wide system (m <= n); "
                    "use sketch_and_precondition for tall systems")
    d = min(2 * m if d is None else d, n)
    require(d >= m, "sketch size d must be >= m")
    if _is_sparse(a):
        require(operator != "srht", "the SRHT embedding needs dense data")
        sdtype = dtype or b.dtype
        S = make_embedding(operator, d, n, state, vec_nnz=vec_nnz,
                           dtype=sdtype)
        if operator == "gaussian":
            # the implicit operator on the transposed data: the (d, n)
            # operator is never materialized
            from ..sparse_data.conversions import to_coo
            sb = sketch_sparse(S, to_coo(a).transpose())     # (d, m)
        else:
            st = S.materialize(device=a.device).to(sdtype)
            sb = _apply(a, st.T).T                          # (d, m)
    else:
        S = make_embedding(operator, d, n, state, vec_nnz=vec_nnz,
                           dtype=dtype or a.dtype)
        adt = a.to(dtype) if dtype is not None else a
        sb = sketch_general(S, adt, side="right", op_s="T").T   # (d, m)
    r = torch.linalg.qr(sb, mode="r")[1]
    solve_r, solve_rt = _solvers(r)
    bb = (b[:, None] if b.dim() == 1 else b).to(sb.dtype)

    def gmat(z):
        # R^-T A A^T R^-1 z: one A^T and one A product
        return solve_rt(_apply(a, _apply_t(a, solve_r(z))))

    if tol is None:
        tol = 100.0 * torch.finfo(bb.dtype).eps
    z, iters = _pcg(gmat, solve_rt(bb), tol=tol, maxiter=maxiter)
    x = _apply_t(a, solve_r(z))
    return (x[:, 0] if b.dim() == 1 else x), iters, S.next_state


def ridge_lsq(a, b, mu: float, state: RNGState, *,
              d: Optional[int] = None, operator: str = "saso",
              vec_nnz: int = 8, tol: Optional[float] = None,
              maxiter: int = 200, warm_start: bool = True,
              dtype=None, mesh=None
              ) -> Tuple[torch.Tensor, int, RNGState]:
    """Sketch-and-precondition ridge regression,
    x = argmin ||A x - b||^2 + mu ||x||^2, for tall ``a`` (m, n), dense or
    sparse: CGLS on ``[A; sqrt(mu) I] x ~= [b; 0]`` preconditioned by R
    from ``qr([S A; sqrt(mu) I])`` (only A's rows are embedded), so the
    iteration count depends on neither cond(A) nor mu. ``mu = 0`` is
    ``sketch_and_precondition`` (the same sketch). ``warm_start`` starts
    from the sketched ridge solution. Returns
    ``(x, cgls_iterations, next_state)``.
    """
    m, n = a.shape
    require(m >= n, "ridge_lsq expects a tall system (m >= n); for wide "
                    "systems solve the dual or use nystrom_pcg on the "
                    "Gram operator")
    require(mu >= 0.0, "mu must be >= 0")
    d = min(2 * n if d is None else d, m)
    require(d >= n, "sketch size d must be >= n")
    sa, sb, nxt = _sketch_pair(a, b if warm_start else None, d, state,
                               operator, vec_nnz, dtype, mesh=mesh)
    dt = sa.dtype
    root_mu = torch.sqrt(torch.tensor(mu, dtype=dt))
    eye = torch.eye(n, dtype=dt, device=sa.device)
    r = torch.linalg.qr(torch.cat([sa, root_mu * eye]), mode="r")[1]
    solve_r, solve_rt = _solvers(r)
    rows = _Rows(a, b, mesh)
    bb = (rows.b[:, None] if b.dim() == 1 else rows.b).to(dt)
    m_loc = bb.shape[0]

    # the augmented residual is the data block (A's rows) and the
    # regularization block (n rows, sqrt(mu) x, on every rank): A is never
    # stacked
    def matvec(y):
        x = solve_r(y)
        return torch.cat([rows.apply(x), root_mu * x])

    def rmatvec(rr):
        return solve_rt(rows.apply_t(rr[:m_loc]) + root_mu * rr[m_loc:])

    def sumsq(q):
        return rows.sumsq(q[:m_loc]) + (q[m_loc:] * q[m_loc:]).sum(dim=0)

    b_aug = torch.cat([bb, bb.new_zeros((n, bb.shape[1]))])
    # the sketched ridge solution solves (R^T R) x = (SA)^T Sb
    y0 = solve_rt(sa.T @ sb) if warm_start else None
    y, iters, _ = _cgls(matvec, rmatvec, b_aug, n, x0=y0, tol=tol,
                        maxiter=maxiter, sumsq=sumsq)
    x = solve_r(y)
    return (x[:, 0] if b.dim() == 1 else x), iters, nxt


def ihs_lsq(a, b, state: RNGState, *, d: Optional[int] = None,
            iters: int = 24, operator: str = "saso", vec_nnz: int = 8,
            dtype=None, mesh=None) -> Tuple[torch.Tensor, RNGState]:
    """Iterative Hessian sketch least squares with heavy-ball momentum
    (Pilanci–Wainwright 2016; Lacotte–Pilanci 2020):

        u_t     = ((S A)^T (S A))^{-1} A^T (A x_t - b)
        x_{t+1} = x_t - alpha u_t + beta (x_t - x_{t-1})

    with one isometry-scaled sketch, alpha = (1 - n/d)^2 and beta = n/d
    (the Marchenko–Pastur optimum), contracting by sqrt(n/d) per step: 1/2
    at the default d = 4 n. The solution error, not just the residual,
    reaches working precision (~cond(A) eps). The gradients go through
    ``_mm_precise``. ``a`` is strictly tall (m > n), dense or sparse;
    ``b`` is (m,) or (m, k). Returns ``(x, next_state)``.
    """
    m, n = a.shape
    # d must exceed n and is capped at m, so m <= n can never work: say so
    # before the cap turns it into a misleading complaint about d
    require(m > n, f"ihs_lsq needs a strictly tall system (m > n); got "
                   f"{m} x {n}: the sketch size d must exceed n and "
                   "cannot exceed m")
    require(iters >= 1, "ihs_lsq needs at least one iteration")
    d = min(4 * n if d is None else d, m)
    require(d > n, "sketch size d must exceed n (d ~ 4n recommended)")

    from ..dense import isometry_scale_factor
    from .qb import _apply_precise, _mm_precise

    # the sketched Hessian must be an unbiased Gram estimate for the
    # Marchenko–Pastur bounds behind (alpha, beta): apply the isometry scale
    sa, _, st = _sketch_pair(a, None, d, state, operator, vec_nnz, dtype,
                             mesh=mesh)
    c = isometry_scale_factor(
        make_embedding(operator, d, m, state, vec_nnz=vec_nnz).dist)
    r = torch.linalg.qr(c * sa, mode="r")[1]
    xi = n / d
    alpha, beta = (1.0 - xi) ** 2, xi
    rows = _Rows(a, b, mesh)
    bb = (rows.b[:, None] if b.dim() == 1 else rows.b).to(r.dtype)
    solve_r, solve_rt = _solvers(r)

    def grad(x):
        res = _apply_precise(rows.a, x) - bb
        if _is_sparse(rows.a):
            return rows.apply_t(res)
        return rows.reduce(_mm_precise(rows.a.T, res))

    x = xp = bb.new_zeros((n, bb.shape[1]))
    for _ in range(iters):
        u = solve_r(solve_rt(grad(x)))
        x, xp = x - alpha * u + beta * (x - xp), x
    return (x[:, 0] if b.dim() == 1 else x), st
