"""Spectral density (DOS) estimation: stochastic Lanczos quadrature and the
Kernel Polynomial Method, plus interval eigenvalue counting (counterpart
of randblas_tpu/linalg/density.py; Lin-Saad-Yang 2016).

The eigenvalue distribution phi(t) = sum_i delta(t - l_i) of a symmetric A
is estimated from block matvecs only, with Rademacher probes of the
counter-addressed Uniform stream (one fill, on the card through the fill
kernel K3):

- ``spectral_density`` (SLQ): per probe, the Lanczos tridiagonal's
  eigenpairs give Gauss-quadrature nodes and weights; averaging probes and
  smearing the nodes with a Gaussian kernel gives the DOS. The nodes adapt
  to the spectrum.
- ``kpm_density``: the Jackson-damped Chebyshev-moment expansion, a
  three-term recurrence that keeps two (n, p) blocks and needs no
  reorthogonalization; resolution ~ (spectrum width) / degree everywhere.

All probes advance together as (n, p) block matvecs, in host loops. The
kernel sums (grid x nodes, grid x degree) run in float32 with TF32 off,
where the JAX package asks for ``Precision.HIGHEST``. A callable operator
holds no tensor: its probes are made on ``device``, the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..base import require
from ..rng.state import RNGState
from .qb import _device_of, _is_sparse, _mm_precise
from .quadrature import _block_lanczos_tridiag, _matvec_of, _tridiag_eigh
from .trace import rademacher_probes


_SQUARE = "spectral density needs a square symmetric A"


def _slq_nodes_weights(a, state: RNGState, probes: int, steps: int, dtype,
                       n: Optional[int], device=None):
    """Gauss-quadrature (nodes, weights) per probe, weights scaled so that
    sum(weights) estimates n (each Rademacher probe's measure integrates to
    ||v||^2 = n)."""
    matvec, n = _matvec_of(a, n, _SQUARE)
    require(probes >= 1, "probes must be >= 1")
    require(1 <= steps <= n, "steps must be in [1, n]")
    v0, nxt = rademacher_probes(n, probes, state, dtype,
                                _device_of(a, device))
    alphas, betas, nrm, _ = _block_lanczos_tridiag(matvec, v0, steps)
    nodes, vecs = _tridiag_eigh(alphas, betas)
    tau2 = vecs[:, 0, :] ** 2
    # Lanczos breakdown parks ghost nodes at ~0 weight; zero them so they
    # cannot smear mass into the density
    live = tau2 > torch.finfo(tau2.dtype).eps
    weights = (torch.where(live, tau2, torch.zeros_like(tau2))
               * nrm.to(dtype)[:, None] ** 2)
    return nodes, weights / probes, nxt, n


def spectral_density(a, state: RNGState, *, probes: int = 16,
                     steps: int = 60, npts: int = 401,
                     grid: Optional[torch.Tensor] = None,
                     sigma: Optional[float] = None, dtype=torch.float32,
                     n: Optional[int] = None, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, RNGState]:
    """Smoothed eigenvalue density of symmetric ``a`` by SLQ.

    Returns ``(grid, density, next_state)`` with counting normalization:
    ``trapezoid(density, grid) ~= n``. ``a`` is a dense tensor, a sparse
    container or a callable block matvec (pass ``n``).

    ``grid`` defaults to ``npts`` points spanning the Ritz range padded by
    3 sigma; ``sigma`` (the Gaussian smearing width) defaults to 2% of the
    Ritz span. ``steps`` bounds how many distinct spectral clusters the
    quadrature can resolve (one node per cluster)."""
    nodes, weights, nxt, n = _slq_nodes_weights(
        a, state, probes, steps, dtype, n, device)
    lo = nodes.min()
    hi = nodes.max()
    span = torch.clamp(hi - lo, min=torch.finfo(dtype).tiny)
    sig = (span * 0.02 if sigma is None
           else torch.as_tensor(sigma, dtype=dtype, device=nodes.device))
    if grid is None:
        require(npts >= 2, "npts must be >= 2")
        grid = torch.linspace(float(lo - 3 * sig), float(hi + 3 * sig),
                              npts, dtype=dtype, device=nodes.device)
    grid = torch.as_tensor(grid, dtype=dtype).to(nodes.device)
    # density(t) = sum_nodes w * N(t; node, sigma)
    z = (grid[:, None] - nodes.reshape(-1)[None, :]) / sig
    kern = torch.exp(-0.5 * z * z) / (sig * math.sqrt(2 * math.pi))
    dens = _mm_precise(kern, weights.reshape(-1))
    return grid, dens, nxt


def eig_count(a, lo: float, hi: float, state: RNGState, *,
              probes: int = 16, steps: int = 60, dtype=torch.float32,
              n: Optional[int] = None, device=None
              ) -> Tuple[torch.Tensor, RNGState]:
    """Estimate the number of eigenvalues of symmetric ``a`` in [lo, hi],
    tr(indicator_[lo,hi](A)), by summing the SLQ quadrature mass whose
    nodes land inside the interval. Accurate when the endpoints fall in
    spectral gaps. Returns ``(count, next_state)``."""
    require(hi > lo, "need hi > lo")
    nodes, weights, nxt, _ = _slq_nodes_weights(
        a, state, probes, steps, dtype, n, device)
    inside = (nodes >= lo) & (nodes <= hi)
    return torch.where(inside, weights, torch.zeros_like(weights)).sum(), nxt


def _gershgorin(a, n: int):
    """(lmin, lmax) enclosing the spectrum of a dense or sparse ``a``: the
    union of [a_ii - r_i, a_ii + r_i], r_i the off-diagonal absolute row
    sum. Duplicate COO triplets are legal, so the sparse sums are
    index_add_ over all entries."""
    if _is_sparse(a):
        from ..sparse_data.conversions import to_coo
        c = to_coo(a)
        rows = c.rows.long()
        absv = c.vals.abs()
        ondiag = c.rows == c.cols
        zero = torch.zeros((), dtype=c.vals.dtype, device=c.vals.device)
        ri_all = absv.new_zeros((n,)).index_add_(0, rows, absv)
        di = c.vals.new_zeros((n,)).index_add_(
            0, rows, torch.where(ondiag, c.vals, zero))
        ri = ri_all - absv.new_zeros((n,)).index_add_(
            0, rows, torch.where(ondiag, absv, zero))
    else:
        di = torch.diagonal(a)
        ri = a.abs().sum(dim=1) - di.abs()
    return (di - ri).min(), (di + ri).max()


def kpm_density(a, state: RNGState, *, degree: int = 128,
                probes: int = 16, npts: int = 401,
                bounds: Optional[Tuple[float, float]] = None,
                grid: Optional[torch.Tensor] = None, dtype=torch.float32,
                n: Optional[int] = None, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor, RNGState]:
    """Eigenvalue density of symmetric ``a`` by the Kernel Polynomial
    Method: the Jackson-damped Chebyshev expansion of the DOS (Weisse et
    al. 2006).

    ``bounds = (lmin, lmax)`` must enclose the spectrum; it is required
    unless ``a`` is a dense tensor or a sparse container (then a Gershgorin
    enclosure is computed). Chebyshev iterates of an un-enclosed operator
    blow up exponentially. ``degree`` matvecs a probe, two live (n, p)
    blocks of state.

    Returns ``(grid, density, next_state)`` with counting normalization
    (integrates to ~n); resolution ~ span / degree."""
    matvec, n = _matvec_of(a, n, _SQUARE)
    require(probes >= 1, "probes must be >= 1")
    require(degree >= 2, "degree must be >= 2")
    dev = _device_of(a, device)
    if bounds is None:
        require(hasattr(a, "shape") and not callable(a),
                "kpm_density needs explicit spectrum bounds for "
                "callable operators (Chebyshev iterates of an "
                "un-enclosed operator diverge)")
        lmin, lmax = _gershgorin(a, n)
    else:
        lmin = torch.as_tensor(bounds[0], dtype=dtype, device=dev)
        lmax = torch.as_tensor(bounds[1], dtype=dtype, device=dev)
    # affine map to [-1 + pad, 1 - pad]: t = (l - c) / h
    pad = 0.01
    c = (lmax + lmin) / 2
    h = torch.clamp((lmax - lmin) / 2, min=torch.finfo(dtype).tiny) \
        / (1 - pad)

    v0, nxt = rademacher_probes(n, probes, state, dtype, dev)

    def amap(x):
        return (matvec(x).to(dtype) - c * x) / h

    t_prev, t_cur = v0, amap(v0)
    mus = [torch.ones((), dtype=dtype, device=dev),    # tr(T_0) / n
           (v0 * t_cur).sum(dtype=dtype) / (n * probes)]
    for _ in range(degree - 2):
        t_prev, t_cur = t_cur, 2 * amap(t_cur) - t_prev
        mus.append((v0 * t_cur).sum(dtype=dtype) / (n * probes))
    mu = torch.stack(mus)                              # (degree,)

    # Jackson damping: kills the Gibbs oscillation of the truncated series
    k = torch.arange(degree, dtype=dtype, device=dev)
    dd = torch.tensor(degree, dtype=dtype, device=dev)
    g = ((dd - k + 1) * torch.cos(math.pi * k / (dd + 1))
         + torch.sin(math.pi * k / (dd + 1))
         / torch.tan(math.pi / (dd + 1))) / (dd + 1)

    if grid is None:
        require(npts >= 2, "npts must be >= 2")
        grid = torch.linspace(float(lmin), float(lmax), npts, dtype=dtype,
                              device=dev)
    grid = torch.as_tensor(grid, dtype=dtype).to(dev)
    t = torch.clamp((grid - c) / h, -1 + 1e-6, 1 - 1e-6)
    # phi(t) = (g0 mu0 + 2 sum_k g_k mu_k T_k(t)) / (pi sqrt(1 - t^2))
    theta = torch.arccos(t)                            # T_k(t) = cos(k θ)
    tk = torch.cos(theta[:, None] * k[None, :])        # (npts, degree)
    coef = g * mu * torch.where(k == 0, 1.0, 2.0).to(dtype)
    phi_t = _mm_precise(tk, coef) / (math.pi * torch.sqrt(1 - t * t))
    # back to the lambda domain with counting normalization:
    # density(l) dl = n phi(t) dt, dt/dl = 1/h
    dens = torch.clamp(n * phi_t / h, min=0.0)
    return grid, dens, nxt
