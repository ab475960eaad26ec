"""Stochastic Lanczos quadrature: tr(f(A)) for spectral functions, and
f(A) b (counterpart of randblas_tpu/linalg/quadrature.py).

Ubaru-Chen-Saad 2017: for symmetric A and a probe v, v^T f(A) v equals
||v||^2 e1^T f(T) e1 with T the Lanczos tridiagonal of A started at
v/||v||, a Gauss quadrature rule whose nodes and weights come from the
eigendecomposition of the small (steps x steps) T. Averaging over probes
gives tr(f(A)); the quadrature error decays geometrically in the depth for
f smooth on the spectrum.

All probes run the recurrence together as one (n, p) block matvec a step,
in a host loop over a preallocated basis. Full reorthogonalization (two
passes) against each probe's stored basis runs in float32 with TF32 off
(the JAX package's ``Precision.HIGHEST``): without it float32 Lanczos loses
orthogonality by step ~20 and the quadrature grows ghost nodes. The
tridiagonals of all probes are decomposed by one batched
``torch.linalg.eigh`` in float64 (``_tridiag_eigh``).

``f`` is a torch function (``torch.log``, ``torch.exp``, a lambda), applied
elementwise to the nodes. A callable operator holds no tensor: its probes
are made on ``device``, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..base import require
from ..dense import DenseDist, DenseSkOp
from ..rng.state import RNGState
from .qb import _apply, _device_of, _ieee_f32


def _block_lanczos_tridiag(matvec, v0: torch.Tensor, steps: int):
    """Run ``steps`` Lanczos iterations for every column of ``v0`` (n, p)
    at once (p independent single-vector recurrences batched as block
    matvecs), each probe fully reorthogonalized against its own basis.
    Returns (alphas (p, steps), betas (p, steps-1), ||v0|| by column,
    basis (steps, n, p)). The basis is stored probe-major, (p, steps, n),
    so each pass of the reorthogonalization is two batched products with
    no copy; the returned (steps, n, p) is a view of it."""
    n, p = v0.shape
    tiny = torch.finfo(v0.dtype).tiny
    nrm = torch.linalg.norm(v0, dim=0)
    q = v0 / torch.clamp(nrm, min=tiny)
    basis = v0.new_zeros((p, steps, n))
    q_prev = torch.zeros_like(q)
    beta_prev = v0.new_zeros((p,))
    alphas, betas = [], []
    for i in range(steps):
        # a user-supplied matvec may compute in a wider dtype than the
        # probes: the recurrence stays in one type
        w = matvec(q).to(v0.dtype)                     # (n, p)
        alpha = (q * w).sum(dim=0)                     # (p,)
        w = w - alpha * q - beta_prev * q_prev
        basis[:, i] = q.T
        # two passes: coeffs[j, k] = <basis[j, k, :], w[:, j]>
        with _ieee_f32():
            for _ in range(2):
                coeffs = torch.bmm(basis[:, :i + 1], w.T[:, :, None])
                w = w - torch.bmm(basis[:, :i + 1].transpose(1, 2),
                                  coeffs)[:, :, 0].T
        beta = torch.linalg.norm(w, dim=0)
        q_prev, q = q, w / torch.clamp(beta, min=tiny)
        beta_prev = beta
        alphas.append(alpha)
        betas.append(beta)
    # (steps, p) -> (p, steps); the last beta is unused
    return (torch.stack(alphas).T, torch.stack(betas)[:-1].T, nrm,
            basis.permute(1, 2, 0))


def _tridiag_eigh(alphas: torch.Tensor, betas: torch.Tensor):
    """Eigenvalues (p, steps) and eigenvectors (p, steps, steps) of the p
    symmetric tridiagonals with diagonals ``alphas`` and off-diagonals
    ``betas``, by one batched eigendecomposition in float64, cast back to
    the tridiagonals' dtype: on the card PyTorch hands float32 ones of 32
    to 512 rows to cuSOLVER's Jacobi solver, which put the nodes of 60-step
    tridiagonals 1.1e-5 (relative to the largest) from float64's (PERF.md,
    on an H100), and the quadratures rest on them."""
    dt = alphas.dtype
    a64, b64 = alphas.double(), betas.double()
    theta, vecs = torch.linalg.eigh(torch.diag_embed(a64)
                                    + torch.diag_embed(b64, 1)
                                    + torch.diag_embed(b64, -1))
    return theta.to(dt), vecs.to(dt)


def _matvec_of(a, n, what: str):
    """(block matvec, n) of a dense tensor, a sparse container or a
    callable (which needs ``n``)."""
    if callable(a) and not hasattr(a, "shape"):
        require(n is not None, "callable a needs an explicit n")
        return a, n
    require(a.shape[0] == a.shape[1], what)
    return (lambda x: _apply(a, x)), a.shape[0]


def slq(a, f: Callable, state: RNGState, *, probes: int = 8,
        steps: int = 30, dtype=torch.float32, n: int = None, device=None
        ) -> Tuple[torch.Tensor, RNGState]:
    """Estimate ``tr(f(A))`` for symmetric ``a`` by stochastic Lanczos
    quadrature. ``a`` is a dense tensor, a sparse container or a callable
    block matvec (pass ``n``). ``steps`` is the Lanczos depth; ``probes``
    Gaussian probes (one fill of a DenseDist(n, probes)) control the
    Hutchinson-type variance. Returns ``(estimate, next_state)``."""
    matvec, n = _matvec_of(a, n, "slq needs a square symmetric A")
    require(probes >= 1, "probes must be >= 1")
    require(1 <= steps <= n, "steps must be in [1, n]")

    S = DenseSkOp(DenseDist(n, probes), state, dtype=dtype)
    v0 = S.materialize(device=_device_of(a, device))   # (n, probes)
    alphas, betas, nrm, _ = _block_lanczos_tridiag(matvec, v0, steps)
    theta, vecs = _tridiag_eigh(alphas, betas)
    tau2 = vecs[:, 0, :] ** 2                          # e1 weights
    # Lanczos breakdown (Krylov space exhausted before `steps`) parks
    # spurious nodes at 0 with ~0 weight; f may be singular there (log),
    # and -inf * 0 = nan: mask before f is evaluated
    live = tau2 > torch.finfo(tau2.dtype).eps
    one = torch.ones((), dtype=theta.dtype, device=theta.device)
    vals = torch.where(live, f(torch.where(live, theta, one)),
                       torch.zeros_like(theta))
    quads = (tau2 * vals).sum(dim=-1)                  # (probes,)
    est = torch.mean(nrm.to(quads.dtype) ** 2 * quads)
    return est, S.next_state


def logdet(a, state: RNGState, *, probes: int = 8, steps: int = 30,
           dtype=torch.float32, n: int = None, device=None
           ) -> Tuple[torch.Tensor, RNGState]:
    """``log det(A)`` = tr(log A) for symmetric positive definite ``a`` by
    :func:`slq`: probes * steps matvecs, for sparse and implicit operators
    too. Accuracy degrades as cond(A) grows (raise ``steps``). Returns
    ``(estimate, next_state)``."""
    return slq(a, torch.log, state, probes=probes, steps=steps, dtype=dtype,
               n=n, device=device)


def lanczos_fn_apply(a, f: Callable, b, *, steps: int = 30, dtype=None,
                     n: int = None) -> torch.Tensor:
    """``f(A) @ b`` for symmetric ``a`` without forming f(A), by the
    Lanczos relation f(A) b ~= ||b|| V f(T) e1 with (V, T) the Lanczos
    basis and tridiagonal started at b/||b|| (Higham ch. 13): exp(t A) v,
    A^{-1/2} b, log(A) b at ``steps`` matvecs a column. ``b`` is (n,) or
    (n, k); the columns run batched as block matvecs on b's device. ``f``
    maps eigenvalues elementwise."""
    vec = b.dim() == 1
    bb = b[:, None] if vec else b
    matvec, n = _matvec_of(a, n, "lanczos_fn_apply needs a square "
                                 "symmetric A")
    require(bb.shape[0] == n, "b must have A's dimension")
    require(1 <= steps <= n, "steps must be in [1, n]")
    if dtype is not None:
        bb = bb.to(dtype)
    alphas, betas, nrm, basis = _block_lanczos_tridiag(matvec, bb, steps)
    theta, vecs = _tridiag_eigh(alphas, betas)
    e1 = vecs[:, 0, :]                                 # (p, steps)
    live = e1.abs() > torch.finfo(theta.dtype).eps
    one = torch.ones((), dtype=theta.dtype, device=theta.device)
    vals = torch.where(live, f(torch.where(live, theta, one)),
                       torch.zeros_like(theta))
    # f(T) e1 = vecs @ (vals * e1), (p, steps), as float32 products summed
    ft_e1 = (vecs * (vals * e1)[:, None, :]).sum(dim=-1)
    # x_j = ||b_j|| * sum_k basis[k, :, j] * ft_e1[j, k], one batched
    # product over the probe-major storage
    with _ieee_f32():
        x = torch.bmm(basis.permute(2, 1, 0), ft_e1[:, :, None])[:, :, 0].T
    x = x * nrm[None, :].to(x.dtype)
    return x[:, 0] if vec else x
