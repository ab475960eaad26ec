"""Randomized Tucker decomposition, sequentially truncated HOSVD
(counterpart of randblas_tpu/linalg/tucker.py).

X (n_1, ..., n_p) ~= core x_1 U_1 x_2 U_2 ... x_p U_p with orthonormal
factors U_k (n_k, r_k) and a dense core (r_1, ..., r_p): the
multilinear-rank counterpart of the TT tier (linalg/tt.py).

``tucker_from_dense`` is ST-HOSVD (Vannieuwenhoven et al. 2012) with each
per-mode SVD replaced by the rangefinder (oversample and power iteration)
on the mode-k unfolding of the already compressed core, so each mode's work
shrinks as earlier modes truncate. The error satisfies the ST-HOSVD
identity ||X - X_hat||^2 = sum_k eps_k^2.

Streams: one seed-chained Gaussian sketch a mode, filled on x's device (on
the card through the fill kernel K3); next_state = f(shape, ranks) only.
The products are plain float32.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..base import require
from ..dense import DenseDist, fill_dense
from ..rng.state import RNGState
from .qb import _orth, _stabilize, safe_svd


def tucker_full(core: torch.Tensor, factors: Sequence[torch.Tensor]
                ) -> torch.Tensor:
    """Contract (core, factors) back to the dense tensor."""
    require(core.dim() == len(factors), "need one factor per core mode")
    out = core
    for k, u in enumerate(factors):
        out = torch.movedim(torch.tensordot(u, out, dims=([1], [k])), 0, k)
    return out


def tucker_from_dense(x: torch.Tensor, ranks, state: RNGState, *,
                      oversample: int = 8, power_iters: int = 1,
                      dtype=torch.float32, orth: str = "cholqr"
                      ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                 RNGState]:
    """Randomized ST-HOSVD: returns ``(core, factors, next_state)``.

    For each mode in order, range-find the mode-k unfolding of the current
    core with an oversampled Gaussian sketch and ``power_iters`` subspace
    iterations, take U_k = the orthonormal basis truncated to r_k through
    the small factor's SVD, and replace the core by U_k^T x_k core.
    Requested ranks are clipped to each unfolding's feasible
    min(rows, cols)."""
    shape = tuple(int(n) for n in x.shape)
    p = len(shape)
    require(p >= 1, "tucker_from_dense needs ndim >= 1")
    if isinstance(ranks, int):
        rr = [ranks] * p
    else:
        rr = [int(r) for r in ranks]
        require(len(rr) == p, "ranks must be a scalar or length ndim")
    require(all(r >= 1 for r in rr), "Tucker ranks must be >= 1")

    core = x.to(dtype)
    factors: List[torch.Tensor] = []
    st = state
    for k in range(p):
        cur = core.shape
        rest = 1
        for i, n in enumerate(cur):
            if i != k:
                rest *= n
        mat = torch.movedim(core, k, 0).reshape(cur[k], rest)
        r_k = min(rr[k], cur[k], rest)
        rr[k] = r_k
        s = min(r_k + oversample, cur[k], rest)
        g, st = fill_dense(DenseDist(rest, s), st, dtype=dtype,
                           device=x.device)
        y = mat @ g
        for _ in range(power_iters):
            q = _stabilize(y, orth)
            z = mat.T @ q
            w = _stabilize(z, orth)
            y = mat @ w
        q = _orth(y, orth)                        # (n_k, s)
        b = q.T @ mat
        if s > r_k:                               # truncate via small SVD
            ub, sv, vt = safe_svd(b, full_matrices=False)
            q = q @ ub[:, :r_k]
            b = sv[:r_k, None] * vt[:r_k, :]
        factors.append(q)                         # (n_k, r_k)
        core = torch.movedim(
            b.reshape((r_k,) + tuple(cur[:k]) + tuple(cur[k + 1:])), 0, k)
    return core, factors, st
