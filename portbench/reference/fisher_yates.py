"""RandBLAS's short-axis sparse-sign operator (SASO), regenerated.

For SparseDist(d, m, k) with d < m and MajorAxis.Short, column j of the
operator holds k nonzeros. They come from k steps of Fisher-Yates on a
work vector that starts as 0 .. d - 1: step t reads the counter j * k + t,
swaps positions t and ell = t + w0 % (d - t), and records the value that
lands at position t as the row; the sign is + for an even w1. Here the
work vectors of a block of columns are held whole, one row a column.
"""

from __future__ import annotations

import torch

from . import philox


def saso_columns(key: int, d: int, k: int, j0: int, cols: int, device):
    """(rows (cols, k) int64, signs (cols, k) float64) of columns j0 ..
    j0 + cols of the SASO keyed ``key``."""
    j = torch.arange(j0, j0 + cols, dtype=torch.int64, device=device)
    work = torch.arange(d, dtype=torch.int64,
                        device=device).repeat(cols, 1)
    rows = torch.empty((cols, k), dtype=torch.int64, device=device)
    signs = torch.empty((cols, k), dtype=torch.float64, device=device)
    for t in range(k):
        w = philox.words_at(key, j * k + t)
        ell = (t + w[0] % (d - t))[:, None]
        picked = work.gather(1, ell)
        work.scatter_(1, ell, work[:, t:t + 1].clone())
        work[:, t:t + 1] = picked
        rows[:, t] = picked[:, 0]
        signs[:, t] = 1.0 - 2.0 * (w[1] % 2).to(torch.float64)
    return rows, signs
