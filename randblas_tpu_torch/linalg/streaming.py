"""Single-pass and streaming sketched SVD (Tropp-Yurtsever-Udell-Cevher
2017) and Frequent Directions (counterpart of
randblas_tpu/linalg/streaming.py).

The one-pass SVD touches each entry of A once: two independent sketches

    Y = A @ Omega        (m, k)   range sketch
    W = Psi @ A          (l, n)   co-range sketch,  l > k

and the recovery Q = orth(Y), B = (Psi Q)^+ W, A ~= Q B with A gone. For
data arriving as row blocks (``StreamingSketch``) Y's rows are filled per
block and W accumulates ``Psi[:, rows] @ block``, where ``Psi[:, rows]``
is regenerated per block from counters (``fill_dense_submat``, on the card
through the fill kernel K3), so the state is two small sketch buffers and
two RNGStates. The operator slices and Y are bitwise the same under any
chunking; W contracts over the chunked axis, so it agrees to float32
rounding.

Frequent Directions (Liberty 2013; Ghashami-Liberty-Phillips-Woodruff
2016) is the deterministic streaming sketch: B with at most ``ell`` live
rows such that ||A^T A - B^T B||_2 <= shrink_mass <= ||A||_F^2 / ell after
any prefix of the row stream. Its shrink is one float64 eigendecomposition
of the (2 ell, 2 ell) float32 Gram of the buffer.

Precision: the one-pass products (the only passes over the data), the
recovery's rotations and the shrink's Gram and projection run in float32
with TF32 off (``qb._mm_precise``), where the JAX package asks for
``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..base import require
from ..dense import DenseDist, DenseSkOp, default_device, fill_dense_submat
from ..rng.state import RNGState
from .qb import (_apply, _apply_t, _is_sparse, _mm_precise, _orth,
                 qr_clipped_lstsq, safe_svd)


def _sketch_dims(m: int, n: int, rank: int, oversample: int,
                 corange_factor: float):
    """Shared (k, l) of the one-pass pair: StreamingSketch and
    single_pass_svd must agree bitwise (DenseDist(l, m) determines both
    the Psi stream and the seed chain)."""
    require(rank >= 1, "rank must be >= 1")
    k = rank + oversample
    l = min(int(corange_factor * k) + 1, m)
    require(k <= min(m, n), "rank + oversample must be <= min dims")
    require(l > k, "the co-range sketch needs l > k rows (TYUC17): "
                   "raise corange_factor or lower rank + oversample")
    return k, l


def _recover(y, w, psi_full, rank):
    """TYUC17 recovery: Q = orth(Y); B solves (Psi Q) B = W. Householder QR
    for Q: the single-pass Y has no refinement passes to absorb CholQR's
    rank-deficiency junk."""
    q = _orth(y, "qr")                          # (m, k)
    pq = _mm_precise(psi_full, q)               # (l, k)
    b = qr_clipped_lstsq(pq, w)                 # (k, n)
    ub, s, vt = safe_svd(b, full_matrices=False)
    u = _mm_precise(q, ub[:, :rank])
    return u, s[:rank], vt[:rank, :]


class StreamingSketch:
    """One-pass sketch accumulator for row-streamed data.

    ``update(row_start, block)`` may be called for any partition of the
    rows, in any order, each row exactly once; ``finalize()`` returns the
    rank-``rank`` SVD. Omega is materialized once ((n, k), small) and
    Psi's column slice is counter-addressed per block, so the state is
    O((m + n) * k) however A arrives. The buffers live on ``device`` (the
    card by default).
    """

    def __init__(self, m: int, n: int, rank: int, state: RNGState, *,
                 oversample: int = 8, corange_factor: float = 2.0,
                 dtype=torch.float32, device=None):
        k, l = _sketch_dims(m, n, rank, oversample, corange_factor)
        self.m, self.n, self.rank, self.k, self.l = m, n, rank, k, l
        self.dtype = dtype
        self.device = default_device(device)
        # two independent, seed-chained operators
        om = DenseSkOp(DenseDist(n, k), state, dtype=dtype)
        self._omega = om.materialize(device=self.device)     # (n, k)
        self._psi_dist = DenseDist(l, m)
        self._psi_state = om.next_state
        S_psi = DenseSkOp(self._psi_dist, self._psi_state, dtype=dtype)
        self.next_state = S_psi.next_state
        self._y = torch.zeros((m, k), dtype=dtype, device=self.device)
        self._w = torch.zeros((l, n), dtype=dtype, device=self.device)
        self._seen = torch.zeros((m,), dtype=torch.bool, device=self.device)

    def update(self, row_start: int, block) -> None:
        """Absorb rows [row_start, row_start + block.shape[0])."""
        r = block.shape[0]
        require(0 <= row_start and row_start + r <= self.m,
                "row range out of bounds")
        # overlap guard (one host read): W accumulates, so a re-submitted
        # chunk (a retried stream read) would silently double-count
        require(not bool(self._seen[row_start:row_start + r].any()),
                "rows submitted twice (each row exactly once; W accumulates)")
        blk = block.to(device=self.device, dtype=self.dtype)
        self._y[row_start:row_start + r] = _mm_precise(blk, self._omega)
        # Psi[:, rows] regenerated from counters: any chunking yields the
        # same operator slice, bitwise
        psi_cols = fill_dense_submat(self._psi_dist, self._psi_state,
                                     self.l, r, 0, row_start,
                                     dtype=self.dtype, device=self.device)
        self._w = self._w + _mm_precise(psi_cols, blk)
        self._seen[row_start:row_start + r] = True

    def finalize(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(u, s, vt) of rank ``rank``. Every row must have been seen."""
        require(bool(self._seen.all()), "finalize before all rows seen")
        psi_full = fill_dense_submat(self._psi_dist, self._psi_state,
                                     self.l, self.m, 0, 0, dtype=self.dtype,
                                     device=self.device)
        return _recover(self._y, self._w, psi_full, self.rank)


def _fd_shrink(buf: torch.Tensor, ell: int):
    """One FD shrink of the (2 ell, n) buffer by the Gram
    eigendecomposition: FD's shrink lives in sigma^2 space, so the Gram
    route is exact for the algorithm; its squared condition only blurs
    eigenvalues at the eps * sigma_1^2 scale, the mass the shrink discards
    anyway. The eigendecomposition runs in float64: on the card PyTorch
    hands a float32 one of this size to cuSOLVER's Jacobi solver, whose
    eigenvalues were 2e-4 (relative to the largest) from float64's at
    512 x 512, in 13.3 ms against 4.9 ms for float64 (PERF.md, on an H100).
    eigh is ascending, so the top ell pairs are the reversed tail. Returns the
    shrunk buffer (the top ell directions rescaled to sqrt(sigma_i^2 -
    delta), the rest exact zeros) and delta = sigma_ell^2. On the card
    ``torch.linalg.eigh`` synchronizes with the host (its status check);
    nothing else here does."""
    g = _mm_precise(buf, buf.T)
    evals, u = (t.to(buf.dtype) for t in torch.linalg.eigh(g.double()))
    lam = torch.clamp(evals.flip(0)[:ell], min=0.0)    # descending
    uu = u.flip(1)[:, :ell]                            # (2 ell, ell)
    delta = lam[ell - 1]                               # sigma_ell^2
    w = _mm_precise(uu.T, buf)                         # rows sigma_i v_i^T
    scale = torch.sqrt(torch.clamp(lam - delta, min=0.0)
                       / torch.clamp(lam, min=torch.finfo(buf.dtype).tiny))
    new_buf = torch.zeros_like(buf)
    new_buf[:ell] = scale[:, None] * w
    return new_buf, delta


class FrequentDirections:
    """Frequent Directions: the deterministic streaming matrix sketch, the
    worst-case-guaranteed sibling of :class:`StreamingSketch`.

    Maintains ``B`` with at most ``ell`` live rows such that after any
    prefix of the row stream

        0 <= ||A x||^2 - ||B x||^2 <= ||A||_F^2 / ell   (unit x),

    with no probability of failure under any row order. The data-dependent
    bound is tighter: the error is at most :attr:`shrink_mass`, the running
    sum of the shrink offsets sigma_ell^2 (GLPW16 thm 1.1).

    Rows accumulate into a fixed (2 ell, n) buffer on ``device`` (the card
    by default) and each shrink is one eigendecomposition of its (2 ell,
    2 ell) Gram. Streaming is host-driven (chunk sizes are host decisions);
    the shrink mass stays on the device, so the one host synchronization
    of a shrink is the status check of its eigendecomposition.
    """

    def __init__(self, n: int, ell: int, dtype=torch.float32, device=None):
        require(ell >= 1, "ell must be >= 1")
        require(ell <= n, "ell > n is never useful: ell = n rows "
                          "already represent A^T A exactly")
        self.n, self.ell = n, ell
        self.dtype = dtype
        self.device = default_device(device)
        self._buf = torch.zeros((2 * ell, n), dtype=dtype, device=self.device)
        self._fill = 0                       # host-known live row count
        self._shrink_mass = torch.zeros((), dtype=dtype, device=self.device)

    @property
    def shrink_mass(self):
        """Running sum of shrink offsets sigma_ell^2, the a-posteriori FD
        error certificate (a device scalar; float() it to read)."""
        return self._shrink_mass

    def _shrink(self) -> None:
        self._buf, delta = _fd_shrink(self._buf, self.ell)
        self._fill = self.ell
        self._shrink_mass = self._shrink_mass + delta

    def _as_rows(self, block, what: str) -> torch.Tensor:
        block = torch.as_tensor(block)
        if block.dim() == 1:
            block = block[None, :]
        block = block.to(device=self.device, dtype=self.dtype)
        require(block.shape[1] == self.n, f"{what} must have n columns")
        return block

    def update(self, block) -> None:
        """Absorb a (r, n) block of rows (any r >= 1), shrinking whenever
        the buffer fills."""
        block = self._as_rows(block, "block")
        r = block.shape[0]
        off = 0
        while off < r:
            space = 2 * self.ell - self._fill
            if space == 0:
                self._shrink()
                continue
            take = min(space, r - off)
            self._buf[self._fill:self._fill + take] = block[off:off + take]
            self._fill += take
            off += take

    def ingest(self, a) -> None:
        """Absorb all rows of an (M, n) matrix in ell-row chunks, the
        matrix already on the device: a host loop of one copy and one
        shrink a chunk.

        Bit-identical to ``update(a)``: the same chunk boundaries as an
        ell-at-a-time update loop and the same shrink function, so the same
        shrink sequence. Use ``update`` when rows arrive over time."""
        a = self._as_rows(a, "matrix")
        rows = a.shape[0]
        ell = self.ell
        # lead-in: top the buffer up to the fill == ell invariant the loop
        # keeps (a partly filled buffer, the empty start)
        lead = min(rows, max(0, 2 * ell - self._fill))
        if lead:
            self.update(a[:lead])
        rest = rows - lead
        if rest and self._fill == 2 * ell:
            # exactly what update() does at the next arriving row
            self._shrink()
        nfull = rest // ell
        for c in range(nfull):
            self._buf[ell:] = a[lead + c * ell:lead + (c + 1) * ell]
            self._shrink()
        tail = rest - nfull * ell
        if tail:
            self.update(a[rows - tail:])

    def sketch(self) -> torch.Tensor:
        """The (ell, n) sketch B. Shrinks first if more than ell rows are
        live, so the returned B always satisfies the FD guarantee with ell
        rows."""
        if self._fill > self.ell:
            self._shrink()
        return self._buf[:self.ell]

    def merge(self, other: "FrequentDirections") -> None:
        """Absorb another FD sketch built from disjoint rows (FD is a
        mergeable summary, GLPW16 thm 1.2): other's shrunk rows stream into
        this buffer like any data block and the certificates add.
        ``other`` is shrunk to its live sketch as a side effect;
        ``other.ell`` need not equal ``self.ell``."""
        require(isinstance(other, FrequentDirections),
                "merge takes another FrequentDirections")
        require(other.n == self.n, "merge needs matching column counts")
        self.update(other.sketch())
        self._shrink_mass = (self._shrink_mass + other._shrink_mass.to(
            device=self.device, dtype=self.dtype))


def fd_pass(a: torch.Tensor, ell: int):
    """Frequent Directions over all rows of ``a`` (M, n) as a pure
    function: returns ``(B (ell, n), shrink_mass scalar)``, the same shrink
    sequence as ``FrequentDirections(n, ell).ingest(a)`` followed by
    ``sketch()`` (ell-row chunks, one shrink per full buffer; a ragged tail
    rides a zero-padded final chunk, which changes nothing: zero rows carry
    no Gram mass). No object state, so it can be mapped over shards."""
    require(ell >= 1, "ell must be >= 1")
    m, n = a.shape
    nchunks = max(1, -(-m // ell))
    pad = nchunks * ell - m
    ap = torch.cat([a, a.new_zeros((pad, n))]) if pad else a
    buf = a.new_zeros((2 * ell, n))
    buf[:ell] = ap[:ell]
    # a data-derived zero, as the JAX package's (a NaN in a[0, 0] shows)
    mass = ap[0, 0] * 0
    for c in range(1, nchunks):
        buf[ell:] = ap[c * ell:(c + 1) * ell]
        buf, delta = _fd_shrink(buf, ell)
        mass = mass + delta
    return buf[:ell], mass


def single_pass_svd(a, rank: int, state: RNGState, *,
                    oversample: int = 8, corange_factor: float = 2.0,
                    dtype=torch.float32
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               RNGState]:
    """Rank-``rank`` SVD touching A exactly once (TYUC17): for A too
    expensive to revisit (streaming, out-of-core, one-shot measurement).
    For in-memory A, ``rsvd`` / ``rsvd_krylov`` are more accurate. Both
    operators are filled on A's device. Returns ``(u, s, vt,
    next_state)``."""
    m, n = a.shape
    k, l = _sketch_dims(m, n, rank, oversample, corange_factor)
    om = DenseSkOp(DenseDist(n, k), state, dtype=dtype)
    psi_op = DenseSkOp(DenseDist(l, m), om.next_state, dtype=dtype)
    psi = psi_op.materialize(device=a.device)
    if _is_sparse(a):
        y = _apply(a, om.materialize(device=a.device))
        w = _apply_t(a, psi.T).T                 # (Psi A) via A^T Psi^T
    else:
        ad = a.to(dtype)
        y = _mm_precise(ad, om.materialize(device=a.device))
        w = _mm_precise(psi, ad)
    u, s, vt = _recover(y, w, psi, rank)
    return u, s, vt, psi_op.next_state
