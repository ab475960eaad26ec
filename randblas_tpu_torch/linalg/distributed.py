"""Tall-skinny QR by Cholesky QR (counterpart of ``cholqr`` in
randblas_tpu/linalg/distributed.py).

Only ``cholqr`` is here: the rest of that module, the mesh-distributed
rangefinder, QB and rSVD, is the distributed layer, which the port does
not have yet (ROADMAP.md Queue 1 item 12). CholQR is the tall-skinny QR
that distributes (its one collective is the k x k Gram), and the
rangefinder family orthonormalizes with it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..base import require
from .qb import _ieee_f32, _matmul


def cholqr(y: torch.Tensor, *, iters: int = 2, shift: float = 0.0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tall-skinny QR by iterated Cholesky QR: ``y = q @ r``.

    CholQR2 (``iters=2``) restores orthogonality to working precision for
    cond(y) up to ~1/sqrt(eps); one pass loses cond(y)^2 digits.
    ``shift`` > 0 adds ``shift * mean(diag(G)) * I`` to the Gram G before
    each factorization (shifted CholeskyQR, Fukaya et al. 2020).

    Rank-deficiency rescue (always on): where the plain Cholesky of the
    Gram fails (y of numerical rank < k), the factor of the Gram shifted by
    100 k eps mean(diag(G)) + tiny is taken instead, so null directions
    come out as small, finite columns.

    Float32 products run without TF32 whatever the caller allows
    (``torch.backends.cuda.matmul.allow_tf32``): with TF32 the Gram and the
    solve would lose orthogonality at the 1e-3 level.
    """
    require(y.dim() == 2, "cholqr takes a 2-D array")
    require(iters >= 1, "iters must be >= 1")
    k = y.shape[1]
    dtype = y.dtype
    eye = torch.eye(k, dtype=dtype, device=y.device)
    eps, tiny = torch.finfo(dtype).eps, torch.finfo(dtype).tiny
    r = None
    with _ieee_f32():
        for _ in range(iters):
            g = _matmul(y.T, y, dtype)
            g = 0.5 * (g + g.T)
            if shift:
                g = g + shift * (torch.trace(g) / k) * eye
            c, info = torch.linalg.cholesky_ex(g)
            mu_rescue = 100.0 * k * eps * (torch.trace(g) / k) + tiny
            c_rescue = torch.linalg.cholesky_ex(g + mu_rescue * eye)[0]
            ok = (info == 0) & torch.isfinite(c).all()
            c = torch.where(ok, c, c_rescue)
            # y <- y C^{-T}: solve C x = y^T from the left, transpose back
            y = torch.linalg.solve_triangular(c, y.T, upper=False).T
            r = c.T if r is None else c.T @ r
    return y, r
