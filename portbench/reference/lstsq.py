"""The exact least-squares solution a timed solve is judged against, and
its control.

``exact`` is x* = argmin ||A x - b|| in float64: a Householder QR of A
(``factor``; a caller that solves many right-hand sides against one A
computes it once and passes it), then x* = R^-1 (Q^T b). ``residual`` is
||b - A x|| in float64, in blocks of A's rows.

``control`` is a plain sketch-and-precondition one precision below the
call's (Blendenpik, LSRN): the SASO of the call's key, regenerated by
``fisher_yates``, sketches A and b in that precision
(``sketch.control``), the sketch's QR and the warm start are float64,
and CGLS runs on min ||A R^-1 y - b|| with every product over A
computed on operands rounded to that precision's mantissa (float32
sums), under the stopping rule the call's solver states. It is the step
a later change might be tempted to take, which the comparison has to
reject.

Plain PyTorch only: nothing here imports the measured program. TF32 is
off in every product here, except that the control's sketch asks for it
where the card has it.
"""

from __future__ import annotations

import contextlib

import torch

from . import sketch

BLOCK = 16384          # rows of A a float64 product takes at once


@contextlib.contextmanager
def _no_tf32():
    """float32 products in float32, the caller's settings restored."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def factor(a: torch.Tensor):
    """(Q, R): the float64 reduced Householder QR of ``a`` (m, n)."""
    with _no_tf32():
        return torch.linalg.qr(a.to(torch.float64))


def exact(a: torch.Tensor, b: torch.Tensor, qr=None) -> torch.Tensor:
    """float64 x* = argmin ||a x - b|| for a vector ``b`` (m,), from
    ``qr`` = ``factor(a)`` where given."""
    q, r = factor(a) if qr is None else qr
    with _no_tf32():
        qtb = q.T @ b.to(torch.float64)[:, None]
        return torch.linalg.solve_triangular(r, qtb, upper=True)[:, 0]


def residual(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> float:
    """||b - a x|| in float64."""
    x = x.to(torch.float64)
    total = 0.0
    with _no_tf32():
        for r0 in range(0, a.shape[0], BLOCK):
            blk = a[r0:r0 + BLOCK].to(torch.float64)
            res = b[r0:r0 + BLOCK].to(torch.float64) - blk @ x
            total += float((res * res).sum())
    return total ** 0.5


def _cgls(matvec, rmatvec, b, y0, tol: float, maxiter: int):
    """CGLS on min ||M y - b|| from ``y0`` (all (n, 1) float64), stopped
    as the port's solver states it: below ``tol`` times the zero-start
    normal residual ||M^T b||, at ``maxiter`` steps, or where the normal
    residual sits 1e4 above its best; the best iterate."""
    y = y0
    r = b - matvec(y)
    s = rmatvec(r)
    sb = rmatvec(b)
    gamma = float((s * s).sum())
    thresh = tol * tol * float((sb * sb).sum())
    p, best, gamma_best, k = s, y, gamma, 0
    while k < maxiter and gamma > thresh and gamma <= 1e4 * gamma_best:
        q = matvec(p)
        alpha = gamma / float((q * q).sum())
        y = y + alpha * p
        r = r - alpha * q
        s = rmatvec(r)
        gamma_new = float((s * s).sum())
        if gamma_new < gamma_best:
            best, gamma_best = y, gamma_new
        p = s + (gamma_new / gamma) * p
        gamma, k = gamma_new, k + 1
    return best


def control(a: torch.Tensor, b: torch.Tensor, key: int, precision: str, *,
            d: int, vec_nnz: int, tol: float, maxiter: int) -> torch.Tensor:
    """float64 x of the plain sketch-and-precondition in ``precision``,
    with the SASO ``SparseDist(d, m, vec_nnz)`` keyed ``key``."""
    m = a.shape[0]
    op = {"kind": "saso", "d": d, "m": m, "vec_nnz": vec_nnz}
    sa = sketch.control(op, key, a, precision).to(torch.float64)
    sb = sketch.control(op, key, b[:, None], precision).to(torch.float64)
    with _no_tf32():
        q, r = torch.linalg.qr(sa)
        y0 = q.T @ sb
        low = sketch._round(a, precision)

        def solve_r(y):
            return torch.linalg.solve_triangular(r, y, upper=True)

        def matvec(y):
            x = sketch._round(solve_r(y), precision)
            return (low @ x).to(torch.float64)

        def rmatvec(v):
            atv = (low.T @ sketch._round(v, precision)).to(torch.float64)
            return torch.linalg.solve_triangular(r.T, atv, upper=False)

        y = _cgls(matvec, rmatvec, b.to(torch.float64)[:, None], y0, tol,
                  maxiter)
        return solve_r(y)[:, 0]
