"""Randomized block Krylov low-rank approximation (Musco & Musco 2015;
counterpart of randblas_tpu/linalg/krylov.py).

The block Krylov iteration keeps every intermediate block [AS, (AA^T)AS,
..., (AA^T)^q AS] in the basis, so it reaches subspace iteration's (1+eps)
spectral-norm guarantee in O(log(n)/sqrt(eps)) passes instead of
O(log(n)/eps). Each new block is orthogonalized against the basis by two
block Gram-Schmidt passes (float32 with TF32 off, ``qb._mm_precise``) and
absorbed through an SVD with a rank cutoff. The cutoff and the stopping
test read the singular values on the host, one synchronisation per depth
step: they decide how many columns the basis keeps.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..base import require
from ..dense import DenseDist, DenseSkOp
from ..rng.state import RNGState
from ..skge import sketch_general
from .qb import _apply, _apply_t, _is_sparse, _matmul, _mm_precise, safe_svd


def krylov_rangefinder(a, block: int, state: RNGState, *, depth: int = 2,
                       dtype=torch.float32, operator: str = "gaussian"
                       ) -> torch.Tensor:
    """Orthonormal basis (m, <= block*(depth+1)) of the block Krylov space
    K = [A S, (A A^T) A S, ..., (A A^T)^depth A S] for a (block)-column
    sketch S (Musco-Musco 2015 alg. 2). ``operator`` is the first sketch's
    embedding like ``rangefinder``'s ('gaussian' | 'saso' | 'srht'; sparse
    data 'gaussian' only). Late blocks become nearly dependent on earlier
    ones as the iteration converges, so each block keeps only its
    directions above a relative rank cutoff, and the basis stops growing
    once A's range is captured to working precision."""
    m, n = a.shape
    require(block >= 1, "block must be >= 1")
    require(depth >= 0, "depth must be >= 0")
    require(block * (depth + 1) <= min(m, n),
            "block * (depth+1) must be <= min(A.shape) — lower depth or "
            "the block size")
    if operator == "gaussian" or _is_sparse(a):
        require(operator == "gaussian",
                "sparse data supports only the 'gaussian' Krylov sketch "
                "(materialized thin operator through the SpMM dispatcher)")
        S = DenseSkOp(DenseDist(n, block), state, dtype=dtype)
        y = _apply(a, S.materialize(device=a.device))        # (m, block)
    else:
        from .embed import make_embedding
        S = make_embedding(operator, block, n, state, dtype=dtype)
        y = sketch_general(S, a.to(dtype), side="right", op_s="T")
    # scale-invariant cutoffs: each block is truncated relative to itself
    # (sr > rel * sr[0]), and the loop stops when a block's content past
    # the projection is a rounding ghost of its own scale
    rel = 20.0 * torch.finfo(dtype).eps * float(m) ** 0.5
    ur, sr, _ = safe_svd(y, full_matrices=False)
    keep = max(1, int((sr > rel * float(sr[0])).sum()))
    basis = prev = ur[:, :keep]
    for _ in range(depth):
        y = _apply(a, _apply_t(a, prev))
        pre_scale = float(torch.linalg.norm(y, dim=0).max())
        y = y - _mm_precise(basis, _mm_precise(basis.T, y))
        y = y - _mm_precise(basis, _mm_precise(basis.T, y))
        ur, sr, _ = safe_svd(y, full_matrices=False)
        if float(sr[0]) <= rel * pre_scale:
            break                                    # range captured
        keep = int((sr > rel * float(sr[0])).sum())
        prev = ur[:, :keep]
        basis = torch.cat([basis, prev], dim=1)
    return basis


def rsvd_krylov(a, rank: int, state: RNGState, *, block: int = None,
                depth: int = 2, dtype=torch.float32,
                operator: str = "gaussian"
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-``rank`` truncated SVD by the block Krylov rangefinder: returns
    ``(u, s, vt)``. ``block`` defaults to ``rank + 2``. Where A's numerical
    rank is below ``rank`` the factors are padded with zero singular values
    and vectors."""
    m, n = a.shape
    require(rank >= 1, "rank must be >= 1")
    b = (rank + 2) if block is None else block
    require(b >= 1, "block must be >= 1")
    q = krylov_rangefinder(a, b, state, depth=depth, dtype=dtype,
                           operator=operator)
    bb = (_apply_t(a, q).T if _is_sparse(a)
          else _matmul(q.T, a.to(dtype), dtype))
    ub, s, vt = safe_svd(bb, full_matrices=False)
    u = q @ ub[:, :rank]
    s, vt = s[:rank], vt[:rank, :]
    if q.shape[1] < rank:
        pad = rank - q.shape[1]
        u = torch.cat([u, u.new_zeros((m, pad))], dim=1)
        s = torch.cat([s, s.new_zeros((pad,))])
        vt = torch.cat([vt, vt.new_zeros((pad, n))], dim=0)
    return u, s, vt
