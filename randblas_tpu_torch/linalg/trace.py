"""Stochastic trace and diagonal estimation: Girard-Hutchinson, Hutch++,
XTrace, and the diagonal estimators BKS and XDiag (counterpart of
randblas_tpu/linalg/trace.py).

Probe vectors are Rademacher signs of the counter-addressed Uniform stream,
so estimates are reproducible and seed-chainable like every operator. Every
estimator takes a dense tensor, a sparse container (COO/CSR/CSC) or a
callable ``matvec(X) -> A @ X`` on (n, k) blocks. With a tensor or a
container the probes follow its device; a callable holds no tensor, so its
probes are made on ``device``, the card unless the caller asks for the CPU.

Precision: the leave-one-out corrections of XTrace and XDiag and the
projector corrections of Hutch++ are differences of n-length contractions
(cancellation chains). Their products run in float32 with TF32 off
(``qb._mm_precise``), and the columnwise dots (``_ddot``) are elementwise
float32 products summed.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..base import require
from ..dense import DenseDist, DenseDistName, DenseSkOp, default_device
from ..rng.state import RNGState
from .qb import (_apply, _apply_t, _clip_diagonal, _device_of, _is_sparse,
                 _mm_precise)


def _as_matvec(a, n: int):
    """A as a block matvec X -> A @ X on (n, k) blocks."""
    if callable(a):
        return a
    require(tuple(a.shape) == (n, n), "trace estimation needs a square A")
    return lambda x: _apply(a, x)


def _as_matvec_pair(a, n: int, rmatvec=None):
    """(X -> A @ X, X -> A^T @ X) for dense, sparse or callable A. A
    callable with no ``rmatvec`` is taken as symmetric. Dense float32 and
    bf16 products run through ``_mm_precise``: the leave-one-out terms are
    differences of n-length contractions."""
    if callable(a):
        return a, (rmatvec if rmatvec is not None else a)
    require(tuple(a.shape) == (n, n), "trace/diag estimation needs a square A")
    if rmatvec is not None:
        return (lambda x: _apply(a, x)), rmatvec
    if _is_sparse(a):
        return (lambda x: _apply(a, x)), (lambda x: _apply_t(a, x))
    if a.dtype == torch.float64:
        return (lambda x: _apply(a, x)), (lambda x: _apply(a.T, x))
    return (lambda x: _mm_precise(a, x)), (lambda x: _mm_precise(a.T, x))


def _ddot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """diag(X^T Y) as a columnwise dot."""
    return (x * y).sum(dim=0)


def _loo_directions(r: torch.Tensor) -> torch.Tensor:
    """Column-normalized R^-T, the leave-one-out downdate directions.

    With Y = QR and s_i the normalized i-th column of R^-T, the projector
    onto range(Y without column i) is QQ^T - (Q s_i)(Q s_i)^T. The diagonal
    of R is floored at eps ||R||_F before the solve (``_clip_diagonal``):
    an exactly rank-deficient A makes trailing diag(R) ~ 0."""
    m = r.shape[0]
    eye = torch.eye(m, dtype=r.dtype, device=r.device)
    s = torch.linalg.solve_triangular(_clip_diagonal(r).T, eye, upper=False)
    return s / torch.linalg.norm(s, dim=0, keepdim=True)


def rademacher_probes(n: int, k: int, state: RNGState, dtype=torch.float32,
                      device=None) -> Tuple[torch.Tensor, RNGState]:
    """(n, k) block of i.i.d. +-1 probes, the signs of the Uniform stream,
    on ``device`` (the card by default). Returns (probes, next_state)."""
    S = DenseSkOp(DenseDist(n, k, family=DenseDistName.Uniform), state,
                  dtype=dtype)
    u = S.materialize(device=default_device(device))
    one = torch.ones((), dtype=dtype, device=u.device)
    return torch.where(u >= 0, one, -one), S.next_state


def hutchinson(a, n: int, num_probes: int, state: RNGState,
               dtype=torch.float32, device=None
               ) -> Tuple[torch.Tensor, RNGState]:
    """Girard-Hutchinson estimate of tr(A): mean_j v_j^T A v_j over
    Rademacher probes. Returns (estimate, next_state)."""
    require(num_probes >= 1, "need at least one probe")
    mv = _as_matvec(a, n)
    v, nxt = rademacher_probes(n, num_probes, state, dtype,
                               _device_of(a, device))
    return (v * mv(v)).sum() / num_probes, nxt


def hutchpp(a, n: int, num_matvecs: int, state: RNGState,
            dtype=torch.float32, device=None
            ) -> Tuple[torch.Tensor, RNGState]:
    """Hutch++ (Meyer-Musco-Musco-Woodruff 2021) with a budget of
    ``num_matvecs`` applications of A, split 1/3 sketch, 1/3 range
    projection, 1/3 residual Hutchinson: tr(A) = tr(Q^T A Q) +
    E[v^T (I-QQ^T) A (I-QQ^T) v], Q = orth(A S). Returns (estimate,
    next_state)."""
    require(num_matvecs >= 3, "hutchpp needs a budget of >= 3 matvecs")
    k = num_matvecs // 3
    mv = _as_matvec(a, n)
    dev = _device_of(a, device)

    s, st1 = rademacher_probes(n, k, state, dtype, dev)
    q = torch.linalg.qr(mv(s)).Q                   # (n, k) orthonormal
    t_low = torch.trace(_mm_precise(q.T, mv(q)))

    g, nxt = rademacher_probes(n, k, st1, dtype, dev)
    g = g - _mm_precise(q, _mm_precise(q.T, g))    # project out range(Q)
    ag = mv(g)
    t_resid = (g * (ag - _mm_precise(q, _mm_precise(q.T, ag)))).sum() / k
    return t_low + t_resid, nxt


def xtrace(a, n: int, num_matvecs: int, state: RNGState,
           dtype=torch.float32, device=None
           ) -> Tuple[torch.Tensor, torch.Tensor, RNGState]:
    """XTrace (Epperly-Tropp-Webber 2023), the leave-one-out trace estimate
    with a budget of ``num_matvecs`` applications of A, half for the probe
    image Y = A Omega and half for the basis image Z = A Q. For each probe
    i the other probes' range is the low-rank part and probe i the
    residual; every per-probe term is a diagonal of an m x m product.
    Returns ``(estimate, stderr, next_state)``, stderr the sample standard
    error over the m leave-one-out estimates."""
    require(num_matvecs >= 4, "xtrace needs a budget of >= 4 matvecs")
    m = num_matvecs // 2
    mv = _as_matvec(a, n)

    om, nxt = rademacher_probes(n, m, state, dtype, _device_of(a, device))
    y = mv(om)
    q, r = torch.linalg.qr(y)
    z = mv(q)

    w = _mm_precise(q.T, om)
    h = _mm_precise(q.T, z)
    t = _mm_precise(z.T, om)
    s = _loo_directions(r)
    hw = _mm_precise(h, w)
    hs = _mm_precise(h, s)

    # w_i^T (I-P_i) A (I-P_i) w_i expanded around u_i = (I-QQ^T) w_i and
    # the put-back direction qhat_i = Q s_i (alpha_i = qhat_i^T w_i)
    d_oy = _ddot(om, y)                         # w_i^T A w_i
    u_au = d_oy - _ddot(t, w) - _ddot(w, r) + _ddot(w, hw)
    u_aq = _ddot(t, s) - _ddot(w, hs)           # u_i^T A qhat_i
    q_au = _ddot(s, r) - _ddot(s, hw)           # qhat_i^T A u_i
    q_aq = _ddot(s, hs)                         # qhat_i^T A qhat_i
    alpha = _ddot(s, w)

    ests = (torch.trace(h) - q_aq               # tr(P_i A)
            + u_au + alpha * (u_aq + q_au) + alpha * alpha * q_aq)
    stderr = torch.std(ests, correction=1) / torch.sqrt(
        torch.tensor(m, dtype=dtype, device=ests.device))
    return ests.mean(), stderr, nxt


def diag_hutchinson(a, n: int, num_probes: int, state: RNGState,
                    dtype=torch.float32, device=None
                    ) -> Tuple[torch.Tensor, RNGState]:
    """Bekas-Kurbel-Saad diagonal estimate: mean_j w_j o (A w_j) over
    Rademacher probes. Returns ``(diag_estimate, next_state)``."""
    require(num_probes >= 1, "need at least one probe")
    mv = _as_matvec(a, n)
    v, nxt = rademacher_probes(n, num_probes, state, dtype,
                               _device_of(a, device))
    return (v * mv(v)).sum(dim=1) / num_probes, nxt


def xdiag(a, n: int, num_matvecs: int, state: RNGState, *, rmatvec=None,
          dtype=torch.float32, device=None
          ) -> Tuple[torch.Tensor, RNGState]:
    """XDiag (Epperly-Tropp-Webber 2023), the leave-one-out diagonal
    estimate with a budget of ``num_matvecs`` applications, half with A
    (Y = A Omega) and half with A^T (Z = A^T Q). A callable with no
    ``rmatvec`` is taken as symmetric. Returns ``(diag_estimate,
    next_state)``."""
    require(num_matvecs >= 4, "xdiag needs a budget of >= 4 matvecs")
    m = num_matvecs // 2
    mv, rmv = _as_matvec_pair(a, n, rmatvec)

    om, nxt = rademacher_probes(n, m, state, dtype, _device_of(a, device))
    y = mv(om)
    q, r = torch.linalg.qr(y)
    z2 = rmv(q)                                 # A^T Q

    s = _loo_directions(r)
    qs = _mm_precise(q, s)                      # columns Q s_i
    z2s = _mm_precise(z2, s)                    # columns A^T (Q s_i)

    d_full = (q * z2).sum(dim=1)                # diag(QQ^T A)
    d_down = (qs * z2s).sum(dim=1) / m
    c = _ddot(s, r)                             # c_i = s_i^T R e_i
    d_resid = (om * (qs * c[None, :])).sum(dim=1) / m
    return d_full - d_down + d_resid, nxt


def exact_trace(a) -> torch.Tensor:
    """tr(A) for a dense tensor or a sparse container (for checks)."""
    if _is_sparse(a):
        from ..sparse_data.conversions import to_coo
        coo = to_coo(a)
        return torch.where(coo.rows == coo.cols, coo.vals,
                           torch.zeros((), dtype=coo.vals.dtype,
                                       device=coo.vals.device)).sum()
    return torch.trace(a)
