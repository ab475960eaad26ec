"""The numbers a timed call's output is judged by, against the exact
product.

- ``rel_fro``: ||B - R||_F / ||R||_F, the error of the whole output.
- ``max_rel``: max |B - R| / rms(R), the worst single entry against the
  output's own scale: one entry altered where it is produced shows here
  even when the whole barely moves.
"""

from __future__ import annotations

import math

import torch

NAMES = ("rel_fro", "max_rel")


def gaps(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """``rel_fro`` and ``max_rel`` of ``out`` against ``ref``; a shape
    that differs, or a value that is not finite, reads infinite."""
    if tuple(out.shape) != tuple(ref.shape):
        return {name: math.inf for name in NAMES}
    diff = out.to(torch.float64) - ref
    norm = torch.linalg.vector_norm(ref).item()
    rms = norm / math.sqrt(ref.numel())
    rel_fro = torch.linalg.vector_norm(diff).item() / norm
    max_rel = diff.abs().max().item() / rms
    if not (math.isfinite(rel_fro) and math.isfinite(max_rel)):
        return {name: math.inf for name in NAMES}
    return {"rel_fro": rel_fro, "max_rel": max_rel}


def worst(readings) -> dict:
    """The largest of each number over a list of readings; none: every
    number infinite (nothing was checked)."""
    if not readings:
        return {name: math.inf for name in NAMES}
    return {name: max(r[name] for r in readings) for name in readings[0]}
