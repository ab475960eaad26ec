"""Monte-Carlo approximate matrix multiplication and leverage-score row
sampling for least squares (counterpart of randblas_tpu/linalg/amm.py).

``amm`` (Drineas-Kannan-Mahoney 2006): approximate A @ B from ``s`` index
pairs (column i of A, row i of B) drawn with the variance-optimal
probabilities p_i ~ ||A[:, i]|| ||B[i, :]||, as one (m, s) x (s, p) product
of the gathered panels scaled by 1/sqrt(s p_i). Unbiased, with
E ||A B - amm||_F <= ||A||_F ||B||_F / sqrt(s). The indices come from the
counter-based cdf sampler (``util.sample_indices_iid``), so results are
reproducible and the state chains like every other consumer.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..base import require
from ..rng.state import RNGState
from ..util import sample_indices_iid, weights_to_cdf


def amm(a: torch.Tensor, b: torch.Tensor, s: int, state: RNGState
        ) -> Tuple[torch.Tensor, RNGState]:
    """Approximate ``A @ B`` from ``s`` sampled outer products. ``a`` (m, n)
    and ``b`` (n, p) dense. Returns ``(approx (m, p), next_state)``.
    Zero-norm indices get zero probability; when every weight is 0 (A B ==
    0) the estimate is 0 and the draw uniform. The guard tests the total
    for == 0, so a NaN total propagates."""
    require(a.dim() == 2 and b.dim() == 2, "amm takes matrices")
    require(a.shape[1] == b.shape[0],
            "inner dimensions must match (A (m, n), B (n, p))")
    require(s >= 1, "need at least one sample")
    w = torch.linalg.norm(a, dim=0) * torch.linalg.norm(b, dim=1)   # (n,)
    total = w.sum()
    degenerate = total == 0
    n = w.shape[0]
    safe_w = torch.where(degenerate, torch.ones_like(w), w)
    idx, next_state = sample_indices_iid(weights_to_cdf(safe_w), s, state)
    rows = idx.long()
    p_i = safe_w[rows] / torch.where(degenerate, float(n), total)
    scale = 1.0 / torch.sqrt(s * torch.clamp(p_i,
                                             min=torch.finfo(p_i.dtype).tiny))
    left = a[:, rows] * scale[None, :]                 # (m, s)
    right = b[rows, :] * scale[:, None]                # (s, p)
    approx = torch.matmul(left, right).to(a.dtype)
    return torch.where(degenerate, torch.zeros_like(approx),
                       approx), next_state


def sample_lsq(a: torch.Tensor, b: torch.Tensor, s: int, state: RNGState, *,
               scores: torch.Tensor = None, lam: float = 0.5
               ) -> Tuple[torch.Tensor, RNGState]:
    """Leverage-score row-sampling least squares: an approximate
    ``argmin ||A x - b||`` from ``s`` sampled rows (DMM06 / Mahoney 2011
    section 4). Rows are drawn with p_i = lam l_i / n + (1 - lam) / m,
    rescaled by 1/sqrt(s p_i), and the (s, n) subproblem is solved by
    ``qr_clipped_lstsq``. ``scores`` reuses precomputed leverage scores;
    otherwise ``leverage_scores`` estimates them (one sketched pass over
    A, state-chained). Returns ``(x, next_state)``."""
    require(a.dim() == 2, "sample_lsq takes a matrix A")
    m, n = a.shape
    require(m >= n, "sample_lsq expects a tall system (m >= n)")
    require(s >= n, "need at least n sampled rows")
    require(b.shape[0] == m, "b must have A's row count")
    require(0.0 <= lam <= 1.0, "lam must be in [0, 1]")
    from .leverage import leverage_scores
    from .qb import qr_clipped_lstsq
    if lam == 0.0:
        # uniform sampling: the scores would be multiplied by zero, so the
        # estimation (and its stream) is skipped
        scores = torch.zeros((m,), dtype=torch.float32, device=a.device)
    elif scores is None:
        scores, state = leverage_scores(a, state)
    stotal = scores.sum()
    tiny = torch.finfo(torch.float32).tiny
    # zero-sum scores fall back to uniform instead of a NaN cdf; the
    # `+ stotal * 0` keeps a NaN in the scores propagating
    lam_eff = torch.where(stotal > 0, lam, 0.0).to(torch.float32)
    p = (lam_eff * scores / torch.clamp(stotal, min=tiny)
         + (1.0 - lam_eff) / m) + stotal * 0
    idx, next_state = sample_indices_iid(weights_to_cdf(p), s, state)
    rows = idx.long()
    p_i = p[rows] / p.sum()
    scale = (1.0 / torch.sqrt(s * torch.clamp(p_i, min=tiny))).to(a.dtype)
    x = qr_clipped_lstsq(a[rows, :] * scale[:, None],
                         b[rows] * (scale if b.dim() == 1
                                    else scale[:, None]))
    return x, next_state
