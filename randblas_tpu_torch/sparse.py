"""Sparse-sign sketching operators, SASO and LASO (counterpart of
randblas_tpu/sparse.py).

A SparseSkOp samples, per minor-axis vector, ``vec_nnz`` major-axis indices
without replacement by repeated Fisher-Yates, with +-1 values, consuming the
reference's counters exactly: one counter block per step, vector i starting
at counter offset i * vec_nnz.

Every vector starts from the identity permutation and touches at most
2 * vec_nnz positions, so the work vector is never built: reads are resolved
against a short chronological write log. The JAX package maps one vector's
loop over the minor axis with ``vmap``. On a CUDA device a whole fill is
one launch of the hand-written kernel K7 (``ops/saso_fill.py``), one thread
a vector. The plain version, ``repeated_fisher_yates_reference``, is the
only path on the CPU and K7's yardstick on the card: the counter words of
every (vector, step) come from one batched generator call, and the loop
over the vec_nnz steps runs once on tensors of one row per vector, one
generator call and about 20 * vec_nnz small tensor ops on the device that
holds it.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import torch

from . import profiling
from .base import MajorAxis, require
from .dense import default_device
from .ops import saso_fill
from .ops.dense_fill import _generator_words
from .rng.bits import ctr_add_words
from .rng.state import RNGState


@dataclasses.dataclass(frozen=True)
class SparseDist:
    """Distribution over sparse-sign operators.

    major_axis == Short (SASO): exactly vec_nnz nonzeros per short-axis
    vector. major_axis == Long (LASO): at most vec_nnz per long-axis vector.
    """
    n_rows: int
    n_cols: int
    vec_nnz: int
    major_axis: MajorAxis = MajorAxis.Short

    def __post_init__(self):
        require(self.n_rows > 0 and self.n_cols > 0,
                "SparseDist dimensions must be positive")
        require(self.vec_nnz > 0, "vec_nnz must be positive")
        require(self.major_axis in (MajorAxis.Short, MajorAxis.Long),
                "SparseDist major_axis must be Short or Long")
        require(self.vec_nnz <= _dims(self)[0],
                f"vec_nnz = {self.vec_nnz} exceeds the major-axis length "
                f"{_dims(self)[0]}: cannot sample that many indices without "
                "replacement")


def _dims(dist: SparseDist):
    """(dim_major, dim_minor) of the Fisher-Yates draw."""
    long_len = max(dist.n_rows, dist.n_cols)
    short_len = min(dist.n_rows, dist.n_cols)
    if dist.major_axis == MajorAxis.Short:
        return short_len, long_len
    return long_len, short_len


def sparse_nnz(dist: SparseDist) -> int:
    """Total stored nonzeros."""
    if dist.major_axis == MajorAxis.Short:
        return dist.vec_nnz * max(dist.n_rows, dist.n_cols)
    return dist.vec_nnz * min(dist.n_rows, dist.n_cols)


def compute_next_state(dist: SparseDist, state: RNGState) -> RNGState:
    """The reference's sparse next state, including its choice of min()
    for Short-major operators, which is part of the pinned stream
    contract."""
    if dist.major_axis == MajorAxis.Short:
        minor_len = min(dist.n_rows, dist.n_cols)
    else:
        minor_len = max(dist.n_rows, dist.n_cols)
    return state.incr(minor_len * dist.vec_nnz)


def _read(log_pos, log_val, p):
    """The work vector at positions ``p`` (one per vector): the latest
    logged write to p, or p itself where none was logged."""
    hit = log_pos == p[:, None]
    if hit.shape[1] == 0:
        return p
    order = torch.arange(1, hit.shape[1] + 1, device=p.device)
    last = (hit * order).argmax(dim=1, keepdim=True)
    return torch.where(hit.any(dim=1), log_val.gather(1, last)[:, 0], p)


def repeated_fisher_yates(state: RNGState, vec_nnz: int, dim_major: int,
                          dim_minor: int, dtype=torch.float32,
                          index_dtype=torch.int32, device=None):
    """Sample ``dim_minor`` independent draws of ``vec_nnz`` indices from
    {0..dim_major-1} without replacement, plus +-1 values, on ``device``
    (the card by default): by one K7 launch on a CUDA device, by the plain
    version elsewhere.

    Returns (idxs_major (dim_minor, vec_nnz), vals (dim_minor, vec_nnz)).
    Step j of vector i reads the counter block at state + i * vec_nnz + j
    (64-bit offset, carried into the higher counter words): the index is
    the pre-swap work-vector value at ell = j + rv[0] % (dim_major - j),
    the sign is + for even rv[1]. The first r vectors of a draw equal an
    r-vector draw.
    """
    idxs, _, vals = _fill_entries(state, vec_nnz, dim_major, dim_minor,
                                  dtype, index_dtype, device)
    return (idxs.reshape(dim_minor, vec_nnz),
            vals.reshape(dim_minor, vec_nnz))


def _fill_entries(state, vec_nnz, dim_major, dim_minor, dtype, index_dtype,
                  device):
    """(major, minor, vals) of a fill, flat in minor-vector-major order
    (minor: the minor-axis index of each entry), on ``device`` (the card by
    default): K7 on a CUDA device, the plain version elsewhere."""
    device = default_device(device)
    if device.type == "cuda":
        return saso_fill.saso_fill(state, vec_nnz, dim_major, dim_minor,
                                   dtype, index_dtype, device)
    idxs, vals = repeated_fisher_yates_reference(
        state, vec_nnz, dim_major, dim_minor, dtype, index_dtype, device)
    minor = torch.arange(dim_minor, dtype=index_dtype,
                         device=device).repeat_interleave(vec_nnz)
    return idxs.reshape(-1), minor, vals.reshape(-1)


def repeated_fisher_yates_reference(state: RNGState, vec_nnz: int,
                                    dim_major: int, dim_minor: int,
                                    dtype=torch.float32,
                                    index_dtype=torch.int32, device=None):
    """The plain PyTorch version of ``repeated_fisher_yates`` (and of K7)
    on ``device`` (the card by default), recorded as one
    ``fisher_yates.step`` span (arg ``j``) a step."""
    require(vec_nnz <= dim_major,
            "vec_nnz must be at most the major-axis length")
    require(dim_major < 2 ** 31, "dim_major must fit in int32")
    k = int(vec_nnz)
    device = default_device(device)
    # the random words do not depend on the swaps: one generator call for
    # all (vector, step) counters; only the log walk below is sequential
    offsets = torch.arange(dim_minor * k, dtype=torch.int64,
                           device=device).reshape(dim_minor, k)
    rv = _generator_words(state)(ctr_add_words(state.counter, offsets))
    ell = torch.arange(k, device=device) + rv[0] % (
        dim_major - torch.arange(k, device=device))
    log_pos = torch.empty((dim_minor, 0), dtype=torch.int64, device=device)
    log_val = torch.empty_like(log_pos)
    idxs = []
    for j in range(k):
        with profiling.span("fisher_yates.step", j=j):
            at_ell = _read(log_pos, log_val, ell[:, j])
            at_j = _read(log_pos, log_val, torch.full_like(ell[:, j], j))
            idxs.append(at_ell)
            log_pos = torch.cat([log_pos, ell[:, j, None],
                                 torch.full_like(ell[:, j, None], j)], dim=1)
            log_val = torch.cat([log_val, at_j[:, None], at_ell[:, None]],
                                dim=1)
    idxs = torch.stack(idxs, dim=1).to(index_dtype)
    vals = 1 - 2 * (rv[1] % 2)
    return idxs, vals.to(dtype)


class SparseSkOp:
    """A sample from a SparseDist, stored as COO triplets in the fill's
    minor-vector-major order (vec_nnz consecutive entries per minor-axis
    vector), lazily until ``filled()``.

    ``canonical`` marks triplets in that order; ``filled()`` sets it, and
    the fixed-nnz, kernel and row-gather routes of ``sketch_general`` take
    only canonical triplets. User-supplied triplets in any other order take
    the general COO route.
    """

    def __init__(self, dist: SparseDist, seed_state, *,
                 rows: Optional[torch.Tensor] = None,
                 cols: Optional[torch.Tensor] = None,
                 vals: Optional[torch.Tensor] = None,
                 next_state: Optional[RNGState] = None,
                 dtype=torch.float32, index_dtype=torch.int32,
                 canonical: bool = False):
        if isinstance(seed_state, int):
            seed_state = RNGState.from_key(seed_state)
        self.dist = dist
        self.seed_state = seed_state
        self.next_state = (next_state if next_state is not None
                           else compute_next_state(dist, seed_state))
        self.dtype = dtype
        self.index_dtype = index_dtype
        provided = [x is not None for x in (rows, cols, vals)]
        require(all(provided) or not any(provided),
                "rows/cols/vals must be given together")
        if all(provided):
            rows, cols, vals = (torch.as_tensor(x) for x in (rows, cols, vals))
            require(rows.shape == cols.shape == vals.shape and rows.dim() == 1,
                    "rows/cols/vals must be 1-D of equal length")
        self.rows = rows
        self.cols = cols
        self.vals = vals
        self.canonical = bool(canonical) and self.known_filled

    @property
    def known_filled(self) -> bool:
        return self.rows is not None

    @property
    def n_rows(self) -> int:
        return self.dist.n_rows

    @property
    def n_cols(self) -> int:
        return self.dist.n_cols

    @property
    def shape(self):
        return (self.dist.n_rows, self.dist.n_cols)

    @property
    def nnz(self) -> int:
        return sparse_nnz(self.dist)

    def _with(self, rows, cols, vals, dist=None, canonical=None):
        return SparseSkOp(self.dist if dist is None else dist,
                          self.seed_state, rows=rows, cols=cols, vals=vals,
                          next_state=self.next_state, dtype=self.dtype,
                          index_dtype=self.index_dtype,
                          canonical=(self.canonical if canonical is None
                                     else canonical))

    def filled(self, device=None) -> "SparseSkOp":
        """An operator with its COO triplets attached. A lazy operator is
        filled on ``device`` (the card by default), recorded as the span
        ``fill``: on a CUDA device one K7 launch (span ``K7.launch``),
        elsewhere the plain version (one ``fisher_yates.step`` span a
        step); a filled one is returned as it is, or moved to ``device``
        when one is given."""
        if self.known_filled:
            if device is None or self.rows.device == torch.device(device):
                return self
            device = torch.device(device)
            return self._with(self.rows.to(device), self.cols.to(device),
                              self.vals.to(device))
        with profiling.span("fill"):
            d = self.dist
            dim_major, dim_minor = _dims(d)
            idxs_major, idxs_minor, vals = _fill_entries(
                self.seed_state, d.vec_nnz, dim_major, dim_minor, self.dtype,
                self.index_dtype, device)
            # the sampling's major axis is the short axis for SASO, the
            # long axis for LASO
            is_wide = d.n_rows == min(d.n_rows, d.n_cols)
            if is_wide == (d.major_axis == MajorAxis.Short):
                rows, cols = idxs_major, idxs_minor
            else:
                rows, cols = idxs_minor, idxs_major
            return self._with(rows, cols, vals, canonical=True)

    def materialize(self, device=None) -> torch.Tensor:
        """Dense (n_rows, n_cols) tensor (for checks; no route uses it), on
        ``device`` as for ``filled``."""
        s = self.filled(device)
        dense = torch.zeros(self.shape, dtype=self.dtype, device=s.rows.device)
        return dense.index_put_((s.rows.long(), s.cols.long()),
                                s.vals.to(self.dtype), accumulate=True)

    def transpose(self, device=None) -> "SparseSkOp":
        """The transposed operator: index roles swap, and the minor-vector
        grouping (so canonical order) is kept. A lazy operator is filled
        first, on ``device`` as for ``filled``."""
        s = self.filled(device)
        dist_t = SparseDist(self.dist.n_cols, self.dist.n_rows,
                            self.dist.vec_nnz, self.dist.major_axis)
        return s._with(s.cols, s.rows, s.vals, dist=dist_t)

    def __repr__(self):
        kind = "SASO" if self.dist.major_axis == MajorAxis.Short else "LASO"
        return (f"SparseSkOp({self.dist.n_rows}x{self.dist.n_cols}, {kind}, "
                f"vec_nnz={self.dist.vec_nnz}, "
                f"{'filled' if self.known_filled else 'lazy'})")


def fill_sparse(S: SparseSkOp, device=None) -> SparseSkOp:
    """Functional fill: ``S.filled(device)``."""
    return S.filled(device)


def print_sparse(S: SparseSkOp, file=None, device=None) -> None:
    """Print the operator's kind (SASO/LASO), dimensions, then its row
    index, column index and value vectors, as the reference's printer
    does."""
    out = sys.stdout if file is None else file
    s = S.filled(device)
    kind = ("SASO: short-axis-sparse operator"
            if S.dist.major_axis == MajorAxis.Short
            else "LASO: long-axis-sparse operator")
    print("SparseSkOp information", file=out)
    print(f"\t{kind}", file=out)
    print(f"\tn_rows = {S.dist.n_rows}", file=out)
    print(f"\tn_cols = {S.dist.n_cols}", file=out)
    for label, arr in (("row indices", s.rows), ("column indices", s.cols),
                       ("values", s.vals)):
        body = ", ".join(str(v) for v in arr.cpu().tolist())
        print(f"\tvector of {label}\n\t\t{body}", file=out)
