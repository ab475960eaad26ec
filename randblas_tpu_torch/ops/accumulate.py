"""beta-accumulation with the reference's safe_scal semantics (counterpart
of randblas_tpu/ops/accumulate.py).

beta == 0 OVERWRITES the output, never multiplies it: 0 * NaN/Inf would
otherwise poison the result. A tensor beta zeroes ``out`` under a select
before the multiply, so beta == 0 cannot let non-finite values through.
"""

from __future__ import annotations

import torch


def accumulate(prod: torch.Tensor, beta, out):
    """prod + beta * out, except that beta == 0 returns prod exactly."""
    if out is None:
        return prod
    if isinstance(beta, (int, float)) and beta == 0:
        return prod
    beta = torch.as_tensor(beta, dtype=prod.dtype, device=prod.device)
    out = torch.as_tensor(out).to(dtype=prod.dtype, device=prod.device)
    safe_out = torch.where(beta == 0, torch.zeros_like(out), out)
    return prod + beta * safe_out
