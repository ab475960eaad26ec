"""COO x dense products by gather and index_add_ (counterpart of
randblas_tpu/ops/coo_apply.py).

Where the JAX package reduces with ``segment_sum`` and ``.at[].add``, these
use ``index_add_`` and ``index_put_(accumulate=True)``. Submatrix selection
masks entries outside the window to zero, so the entry count never changes.

On CUDA tensors ``index_add_`` sums with atomics, in an order that changes
from run to run: these routes agree with themselves and with the kernels
to float32 rounding, not bit for bit. The kernels K4 and K5 sum in a fixed
order.

Not ported: ``onehot_panel_apply``, the JAX package's way around the TPU's
costly scatter (one-hot panels built by compares and fed to the matrix
unit); the card scatters and gathers natively.
"""

from __future__ import annotations

import torch

from .. import base

# Memory budget, in elements, of the one-shot densified operator of
# coo_left_apply_dense (2^28 float32 elements = 1 GiB); larger operators
# densify panel by panel.
_DENSE_BUDGET = 1 << 28


def _scaled(alpha, out: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(alpha, dtype=out.dtype) * out


def _window(rows, cols, vals, d, m, ro, co):
    """(r, c, w): indices shifted into the (d, m) window at (ro, co), with
    entries outside it set to (0, 0, 0)."""
    r = rows.long() - ro
    c = cols.long() - co
    mask = (r >= 0) & (r < d) & (c >= 0) & (c < m)
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    return (torch.where(mask, r, 0), torch.where(mask, c, 0),
            torch.where(mask, vals, zero))


def coo_left_apply(rows, cols, vals, b: torch.Tensor, d: int, m: int,
                   ro: int = 0, co: int = 0, alpha=1.0) -> torch.Tensor:
    """alpha * submat(Asp)[ro:ro+d, co:co+m] @ b as (d, n): gather the rows
    of b, scale them, and sum them into their output rows."""
    r, c, w = _window(rows, cols, vals, d, m, ro, co)
    contrib = w.to(b.dtype)[:, None] * b[c]
    out = torch.zeros((d, b.shape[1]), dtype=b.dtype, device=b.device)
    return _scaled(alpha, out.index_add_(0, r, contrib))


def coo_densify(rows, cols, vals, n_rows: int, n_cols: int, ro: int = 0,
                co: int = 0, dtype=None) -> torch.Tensor:
    """Dense (n_rows, n_cols) block of the COO matrix starting at
    (ro, co); repeated entries add."""
    dtype = vals.dtype if dtype is None else dtype
    r, c, w = _window(rows, cols, vals, n_rows, n_cols, ro, co)
    dense = torch.zeros((n_rows, n_cols), dtype=dtype, device=vals.device)
    return dense.index_put_((r, c), w.to(dtype), accumulate=True)


def coo_left_apply_dense(rows, cols, vals, b: torch.Tensor, d: int, m: int,
                         ro: int = 0, co: int = 0, alpha=1.0) -> torch.Tensor:
    """alpha * submat(Asp) @ b through one scatter into the full (d, m)
    densified operator and one matmul."""
    dense = coo_densify(rows, cols, vals, d, m, ro, co, dtype=b.dtype)
    return _scaled(alpha, torch.matmul(dense, b))


def coo_left_apply_panels(rows, cols, vals, b: torch.Tensor, d: int, m: int,
                          ro: int = 0, co: int = 0, alpha=1.0,
                          panel: int = 8192) -> torch.Tensor:
    """alpha * submat(Asp) @ b through densified operator panels of
    ``panel`` columns, each scattered and multiplied in turn."""
    r, c, w = _window(rows, cols, vals, d, m, ro, co)
    w = w.to(b.dtype)
    panel = min(panel, m)
    acc = torch.zeros((d, b.shape[1]), dtype=b.dtype, device=b.device)
    for c0 in range(0, m, panel):
        width = min(panel, m - c0)
        sel = (c >= c0) & (c < c0 + width) & (w != 0)
        s_panel = torch.zeros((d, width), dtype=b.dtype, device=b.device)
        s_panel.index_put_((r[sel], c[sel] - c0), w[sel], accumulate=True)
        acc = acc + torch.matmul(s_panel, b[c0:c0 + width])
    return _scaled(alpha, acc)


def fixed_nnz_left_apply(idxs_major, vals, b: torch.Tensor, d: int,
                         alpha=1.0) -> torch.Tensor:
    """Wide-SASO apply through the fixed-nnz structure: data row c adds
    into exactly k output rows, so S @ b is k reweighted passes over b,
    one ``index_add_`` per slot. idxs_major, vals: (m, k); b: (m, n)."""
    k = idxs_major.shape[1]
    acc = torch.zeros((d, b.shape[1]), dtype=b.dtype, device=b.device)
    for t in range(k):
        w = vals[:, t].to(b.dtype)
        contrib = torch.zeros_like(acc).index_add_(
            0, idxs_major[:, t].long(), w[:, None] * b)
        acc = acc + contrib
    return _scaled(alpha, acc)


def row_gather_apply(idxs_major, vals, b: torch.Tensor,
                     alpha=1.0) -> torch.Tensor:
    """Tall-SASO apply: output row r reads exactly k data rows, a pure
    gather and weighted sum. idxs_major, vals: (d, k); b: (m, n)."""
    d, k = idxs_major.shape
    acc = torch.zeros((d, b.shape[1]), dtype=b.dtype, device=b.device)
    for t in range(k):
        w = vals[:, t].to(b.dtype)
        acc = acc + w[:, None] * b[idxs_major[:, t].long()]
    return _scaled(alpha, acc)


# The densify route on the card (``densify_wins``), from gate_sweep.py's G6
# on an NVIDIA H100 80GB HBM3 at 700 W (d 64-4096, m 4096-65536, nnz
# 2^12-2^20, n 1-2048; two calls of two runs each; PERF.md "H100 gates"):
# an element gathered and added costs the time of about 384 multiply-adds
# of the densified product, and densifying about 48 columns' worth; below
# 2^23 elements gathered the gather stays near its launch floor. Of the 162
# points the rule disagrees with the runs at 4, by at most 0.36 ms (the JAX
# package's model, kept for CPU tensors, at 27).
CUDA_GATHER_COST = 384
CUDA_DENSIFY_COLUMNS = 48
CUDA_GATHER_FLOOR = 1 << 23


def densify_wins(nnz: int, n: int, d: int, m: int, cuda: bool) -> bool:
    """Whether ``coo_left_apply_auto`` densifies (d, m) COO data of nnz
    entries for a product of width n: on the card by the measured rule
    above, elsewhere by the JAX package's traffic model (nnz * n elements
    gathered against d * m scattered)."""
    if cuda:
        return (CUDA_GATHER_COST * nnz * n > d * m * (n + CUDA_DENSIFY_COLUMNS)
                and nnz * n > CUDA_GATHER_FLOOR)
    return nnz * n > 4 * d * m or (n >= 64 and nnz * n > (1 << 22))


def coo_left_apply_auto(rows, cols, vals, b: torch.Tensor, d: int, m: int,
                        ro: int = 0, co: int = 0, alpha=1.0) -> torch.Tensor:
    """Gather + index_add (``coo_left_apply``) or densify + matmul, as
    ``densify_wins`` decides; the densify route works panel by panel when
    the (d, m) operator exceeds the memory budget."""
    nnz = rows.shape[0]
    n = b.shape[1]
    if densify_wins(nnz, n, d, m, base.on_card(b)):
        if d * m <= _DENSE_BUDGET:
            return coo_left_apply_dense(rows, cols, vals, b, d, m, ro, co,
                                        alpha)
        return coo_left_apply_panels(rows, cols, vals, b, d, m, ro, co,
                                     alpha)
    return coo_left_apply(rows, cols, vals, b, d, m, ro, co, alpha)
