"""sketch_symmetric: SYMM-like sketching (counterpart of
randblas_tpu/sksy.py).

A is a symmetric matrix stored as a general (n, n) tensor. The optional
symmetry check mirrors require_symmetric (util.hh:166-188) with the same
relative tolerance rule; it reads A on the host, as the reference's
validation does.
"""

from __future__ import annotations

from typing import Optional

import torch

from .base import require
from .skge import sketch_general


def require_symmetric(A: torch.Tensor, tol: float = 0.0):
    """Raise if |A - A^T| exceeds (|Aij| + |Aji| + 1) * tol elementwise.

    Counterpart of util.hh:166-188. tol < 0 skips the check."""
    if tol < 0:
        return
    a = torch.as_tensor(A).detach()
    if not a.is_floating_point() or a.element_size() < 4:
        a = a.to(torch.float32)
    viol = (a - a.T).abs()
    rel = (a.abs() + a.T.abs() + 1.0) * max(tol, 0.0)
    if bool((viol > rel).any()):
        i, j = divmod(int(torch.argmax(viol - rel)), a.shape[1])
        raise ValueError(
            f"symmetry check failed: |A({i},{j}) - A({j},{i})| = "
            f"{viol[i, j].cpu().numpy()} exceeds tolerance "
            f"{rel[i, j].cpu().numpy()}")


def sketch_symmetric(
    S,
    A: torch.Tensor,
    *,
    side="left",
    alpha=1.0,
    beta=0.0,
    out: Optional[torch.Tensor] = None,
    d: Optional[int] = None,
    ro_s: int = 0,
    co_s: int = 0,
    sym_check_tol: float = 0.0,
) -> torch.Tensor:
    """B = alpha * submat(S) @ A + beta * B (left) or A @ submat(S) (right),
    with A symmetric in general storage (sksy.hh:166-537).

    No op arguments: symmetry makes them redundant, exactly as in the
    reference (all four overloads pass NoTrans/NoTrans).
    """
    A = torch.as_tensor(A)
    require(A.dim() == 2 and A.shape[0] == A.shape[1],
            "A must be square (symmetric, general storage)")
    require_symmetric(A, sym_check_tol)
    return sketch_general(S, A, side=side, op_s="N", op_a="N", alpha=alpha,
                          beta=beta, out=out, d=d, ro_s=ro_s, co_s=co_s)
