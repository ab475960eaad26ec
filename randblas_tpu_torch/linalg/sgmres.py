"""Sketched GMRES for square (nonsymmetric) linear systems (Nakatsukasa-
Tropp 2021, alg. 1; counterpart of randblas_tpu/linalg/sgmres.py).

Build an m-dimensional Krylov basis by k-truncated Arnoldi (each new vector
is orthogonalized against the last k basis vectors only: O(nmk) instead of
O(nm^2)), then solve the projected problem y = argmin || S (A Q) y - S b ||
through a d ~ 2m row sketching operator S. The subspace embedding keeps the
sketched residual within (1 +- distortion) of the true one over the Krylov
subspace, so GMRES's quasi-optimality is recovered at truncated-Arnoldi
cost. The basis loop runs on the host, writing preallocated (n, m)
buffers; the default 'saso' embedding runs the SASO kernel K4 on the card.

A row-sharded A (a DTensor laid out [Replicate(), Shard(0)] over a mesh's
'data' axis; the JAX package takes it through XLA's sharding propagation)
keeps its rows on their ranks: a matvec is this rank's rows times v, then
one all-gather over 'data', so the Krylov vectors are plain tensors,
replicated on every rank, and the sketch, the small least-squares solves
and the refinement run unchanged on each. x comes back as a replicated
DTensor on A's mesh.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from ..base import mesh_of, require
from ..rng.state import RNGState
from ..skge import sketch_general
from .embed import make_embedding
from .qb import _mm_precise, make_matvec, qr_clipped_lstsq


def _warn_thin_embedding(d: int, m: int, n: int,
                         d_was_default: bool = False) -> None:
    """Warn when the embedding leaves fewer than 4 rows of oversampling
    over the basis: the ~sqrt(m/d) distortion bound, and with it the
    residual estimate and the quasi-optimality, is then void. The full
    basis d == m == n is exempt (GMRES is exact over all of R^n), and so is
    a default d = 2m + 8 that was only clamped to n."""
    if d < m + 4 and not (d == m == n):
        if d_was_default:
            return
        remedy = ("Use d >= 2*m (the default)"
                  if 2 * m <= n else
                  f"Reduce the basis size (d cannot exceed n={n} here)")
        warnings.warn(
            f"embedding dimension d={d} has <4 rows of oversampling over "
            f"basis m={m}; the ~sqrt(m/d) distortion bound (and with it "
            "the residual estimate and quasi-optimality) is void. "
            f"{remedy} unless you accept heuristic output.",
            stacklevel=3)


def _truncated_arnoldi(matvec, b: torch.Tensor, m: int, k: int):
    """(Q, AQ): an (n, m) k-truncated Arnoldi basis of span{b, Ab, ...} and
    its image under A, AQ[:, j] = A @ Q[:, j] as computed.

    A column whose norm after orthogonalization falls to the rounding floor
    (eps relative to ||A q_j||) is zeroed: exact invariance. Nearly
    invariant directions above it become normalized rounding noise, which
    every consumer's clipped solve suppresses."""
    n = b.shape[0]
    dtype = b.dtype
    finfo = torch.finfo(dtype)
    nrm0 = torch.linalg.norm(b)
    qbuf = b.new_zeros((n, m))
    abuf = b.new_zeros((n, m))
    qbuf[:, 0] = torch.where(nrm0 > 0, b / torch.where(nrm0 > 0, nrm0, 1.0),
                             b)
    for j in range(m):
        w = matvec(qbuf[:, j]).to(dtype)
        abuf[:, j] = w
        wnrm0 = torch.linalg.norm(w)
        # the window of the last k columns; columns not yet filled are zero
        # and give zero coefficients
        start = max(j - (k - 1), 0)
        win = qbuf[:, start:start + k]
        w = w - _mm_precise(win, _mm_precise(win.T, w))
        w = w - _mm_precise(win, _mm_precise(win.T, w))    # re-orth pass
        nrm = torch.linalg.norm(w)
        floor = finfo.eps * torch.clamp(wnrm0, min=finfo.tiny)
        if j + 1 < m:
            qbuf[:, j + 1] = torch.where(
                nrm > floor, w / torch.where(nrm > 0, nrm, 1.0),
                torch.zeros_like(w))
    return qbuf, abuf


def sgmres(a, b: torch.Tensor, state: RNGState, *, basis: int = 50,
           trunc: int = 4, d: Optional[int] = None,
           operator: str = "saso", vec_nnz: int = 8, dtype=None,
           refine: int = 1
           ) -> Tuple[torch.Tensor, torch.Tensor, RNGState]:
    """Solve the square system ``A x = b`` approximately over an
    m=``basis``-dimensional Krylov subspace by sketched GMRES.

    ``a`` is (n, n) dense, sparse (COO/CSR/CSC), or a callable
    ``a(v) -> A @ v`` on (n,) vectors; ``b`` is (n,). ``trunc`` is the
    Arnoldi window k; ``d`` the embedding dimension (default
    ``min(n, 2 * basis + 8)``); ``operator`` the embedding family ('saso' |
    'gaussian' | 'srht'). ``refine`` adds that many passes of iterative
    refinement over the same basis (sketch the true residual b - A x, solve
    the small problem again, correct x).

    ``a`` may also be a row-sharded DTensor, and ``b`` a DTensor (module
    notes).

    Returns ``(x, sketched_relative_residual, next_state)``, the residual
    estimate ||S(A x - b)|| / ||S b||."""
    require(b.dim() == 1, "sgmres expects a single right-hand side (n,)")
    n = b.shape[0]
    if not callable(a):
        require(tuple(a.shape) == (n, n), "sgmres needs a square A matching b")
    m = int(basis)
    require(1 <= m <= n, "basis size must be in [1, n]")
    require(trunc >= 1, "trunc must be >= 1")
    require(refine >= 0, "refine must be >= 0")
    k = min(trunc, m)
    d_was_default = d is None
    d = min(n, 2 * m + 8) if d is None else d
    require(d >= m, "embedding dimension d must be >= basis")
    _warn_thin_embedding(d, m, n, d_was_default)

    mesh = mesh_of(a, b)
    if mesh is None:
        matvec = make_matvec(a)
    else:
        from ..parallel import distributed as pd
        matvec, b = _sharded_matvec(a, mesh), pd.gathered(b)
    bb = b.to(dtype) if dtype is not None else b
    q, aq = _truncated_arnoldi(matvec, bb, m, k)

    S = make_embedding(operator, d, n, state, vec_nnz=vec_nnz,
                       dtype=dtype or bb.dtype)
    sc = sketch_general(S, aq)                                # (d, m)
    sb = sketch_general(S, bb[:, None])[:, 0]                 # (d,)
    sb_norm = torch.clamp(torch.linalg.norm(sb),
                          min=torch.finfo(sb.dtype).tiny)
    y = qr_clipped_lstsq(sc, sb)
    x = q @ y
    sr = sb - sc @ y
    for _ in range(int(refine)):
        r = bb - matvec(x).to(bb.dtype)
        sr = sketch_general(S, r[:, None])[:, 0]
        z = qr_clipped_lstsq(sc, sr)
        x = x + q @ z
        sr = sr - sc @ z
    if mesh is not None:
        x = pd.replicated_on(x, mesh)
    return x, torch.linalg.norm(sr) / sb_norm, S.next_state


def _sharded_matvec(a, mesh):
    """v -> A @ v for A row-sharded over ``mesh``'s 'data' axis: this
    rank's rows times v (``make_matvec``'s product), then the ranks' parts
    all-gathered into the full (n,) vector."""
    from ..parallel.distributed import all_gather_rows, data_chunk
    local = make_matvec(data_chunk(a, mesh, 0)[0])
    n, group = a.shape[0], mesh.get_group("data")
    return lambda v: all_gather_rows(local(v), n, group)
