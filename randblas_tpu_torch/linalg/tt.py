"""Tensor-train (TT) compression by randomized sketching (counterpart of
randblas_tpu/linalg/tt.py).

The TT format writes a p-way tensor X (n_1, ..., n_p) as a chain of 3-way
cores G_k (r_{k-1}, n_k, r_k) with r_0 = r_p = 1; storage is sum r n r
instead of prod(n). Every algorithm below is a sequence of batched matmuls
and einsums on the cores' device.

Entry points, all deterministic in the RNGState with next_state = f(shape,
ranks) (the library-wide stream contract):

- ``tt_gaussian``: a random TT with counter-addressed Gaussian cores, one
  ``fill_dense`` a core (on the card through the fill kernel K3).
- ``tt_from_dense``: randomized TT-SVD of a dense tensor, the rangefinder
  sketch plus power iteration per unfolding (Oseledets 2011, each SVD
  replaced by a sketch).
- ``tt_round``: Randomize-then-Orthogonalize rounding (Al Daas, Ballard et
  al., SISC 2023), recompressed by ``tt_round_deterministic``.
- ``tt_matvec``: a TT-matrix times a TT vector, optionally rounded.
- ``tt_single_pass`` and ``TTStream``: the streaming two-sided sketch
  (STTA, Kressner-Vandereycken-Voorhaar 2022).

Plus the algebra: ``tt_add`` (ranks add), ``tt_scale``, ``tt_dot`` /
``tt_norm`` (interface Gram chains, never densifying) and ``full()``.

The containers are plain classes holding lists of tensors, with
``.to(device)``. QR and SVD leave signs and rotations of the cores free, so
two runs agree on ``full()``, not core by core, wherever a factorization
intervenes. The products are plain float32 (the JAX package's default
precision).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..base import require
from ..dense import DenseDist, default_device, fill_dense
from ..rng.state import RNGState
from .qb import _orth, _stabilize, qr_clipped_lstsq, safe_svd


def _as_ranks(ranks, p: int) -> Tuple[int, ...]:
    """Normalize a rank spec (scalar or length p-1 sequence) to the
    internal length-(p+1) form with the boundary 1s."""
    if isinstance(ranks, int):
        inner = (ranks,) * (p - 1)
    else:
        inner = tuple(int(r) for r in ranks)
        require(len(inner) == p - 1,
                "ranks must be a scalar or length ndim-1")
    require(all(r >= 1 for r in inner), "TT ranks must be >= 1")
    return (1,) + inner + (1,)


class TTTensor:
    """A tensor in TT format: ``cores[k]`` has shape (r_k, n_k, r_{k+1}),
    r_0 = r_p = 1."""

    def __init__(self, cores: Sequence[torch.Tensor]):
        cores = list(cores)
        require(len(cores) >= 1, "TTTensor needs at least one core")
        for g in cores:
            require(g.dim() == 3, "TT cores must be 3-D (r_in, n, r_out)")
        require(cores[0].shape[0] == 1 and cores[-1].shape[-1] == 1,
                "boundary TT ranks must be 1")
        for a, b in zip(cores[:-1], cores[1:]):
            require(a.shape[-1] == b.shape[0],
                    "adjacent TT cores must agree on the shared rank")
        self.cores = cores

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(g.shape[1] for g in self.cores)

    @property
    def ranks(self) -> Tuple[int, ...]:
        return tuple(g.shape[0] for g in self.cores) + (1,)

    @property
    def ndim(self) -> int:
        return len(self.cores)

    @property
    def dtype(self):
        return self.cores[0].dtype

    @property
    def device(self) -> torch.device:
        return self.cores[0].device

    def to(self, device) -> "TTTensor":
        return TTTensor([g.to(device) for g in self.cores])

    def full(self) -> torch.Tensor:
        """Contract to the dense (n_1, ..., n_p) tensor (exponential in p
        by definition)."""
        out = self.cores[0]                       # (1, n_1, r_1)
        for g in self.cores[1:]:
            out = torch.einsum("a...b,bic->a...ic", out, g)
        return out[0, ..., 0]

    def __repr__(self):
        return (f"TTTensor(shape={self.shape}, ranks={self.ranks}, "
                f"dtype={self.dtype})")


def tt_gaussian(shape: Sequence[int], ranks, state: RNGState, *,
                dtype=torch.float32, device=None
                ) -> Tuple[TTTensor, RNGState]:
    """Random TT tensor with iid N(0,1) cores on ``device`` (the card by
    default): core k is one DenseDist(r_k, n_k * r_{k+1}) sample, the
    cores seed-chained, so the draw replays bit for bit on any device and
    next_state = f(shape, ranks)."""
    shape = tuple(int(n) for n in shape)
    require(all(n >= 1 for n in shape), "mode sizes must be >= 1")
    rr = _as_ranks(ranks, len(shape))
    device = default_device(device)
    cores = []
    st = state
    for k, n in enumerate(shape):
        r0, r1 = rr[k], rr[k + 1]
        flat, st = fill_dense(DenseDist(r0, n * r1), st, dtype=dtype,
                              device=device)
        cores.append(flat.reshape(r0, n, r1))
    return TTTensor(cores), st


def tt_scale(x: TTTensor, alpha) -> TTTensor:
    """alpha * x (absorbed into the first core)."""
    cores = list(x.cores)
    cores[0] = torch.as_tensor(alpha, dtype=cores[0].dtype,
                               device=cores[0].device) * cores[0]
    return TTTensor(cores)


def tt_add(x: TTTensor, y: TTTensor) -> TTTensor:
    """x + y exactly, with ranks ADDING (the block-diagonal core
    construction; round back down with :func:`tt_round`)."""
    require(x.shape == y.shape, "tt_add needs matching shapes")
    p = x.ndim
    if p == 1:
        return TTTensor([x.cores[0] + y.cores[0]])
    cores = []
    for k in range(p):
        a, b = x.cores[k], y.cores[k]
        if k == 0:
            cores.append(torch.cat([a, b], dim=2))
        elif k == p - 1:
            cores.append(torch.cat([a, b], dim=0))
        else:
            top = torch.cat([a, a.new_zeros((a.shape[0], a.shape[1],
                                             b.shape[2]))], dim=2)
            bot = torch.cat([b.new_zeros((b.shape[0], b.shape[1],
                                          a.shape[2])), b], dim=2)
            cores.append(torch.cat([top, bot], dim=0))
    return TTTensor(cores)


def tt_dot(x: TTTensor, y: TTTensor) -> torch.Tensor:
    """<x, y> by the interface Gram chain: carry W_k (r^x_k, r^y_k) through
    one batched contraction per mode; never densifies."""
    require(x.shape == y.shape, "tt_dot needs matching shapes")
    w = torch.ones((1, 1), dtype=x.dtype, device=x.device)
    for gx, gy in zip(x.cores, y.cores):
        # w[a, c] ; gx (a, i, b) ; gy (c, i, d)  ->  (b, d)
        w = torch.einsum("ac,aib,cid->bd", w, gx, gy.to(x.dtype))
    return w[0, 0]


def tt_norm(x: TTTensor) -> torch.Tensor:
    """Frobenius norm sqrt(<x, x>)."""
    return torch.sqrt(torch.clamp(tt_dot(x, x), min=0.0))


def tt_from_dense(x: torch.Tensor, ranks, state: RNGState, *,
                  oversample: int = 8, power_iters: int = 1,
                  dtype=torch.float32, orth: str = "cholqr"
                  ) -> Tuple[TTTensor, RNGState]:
    """Randomized TT-SVD of a dense tensor: sweep left to right, and at
    mode k range-find the (r_{k-1} n_k, n_{k+1}...n_p) unfolding of the
    carry with an oversampled Gaussian sketch (filled on x's device) and
    ``power_iters`` subspace iterations, then truncate to r_k through the
    small factor's SVD. The carry shrinks to Q^T @ unfolding, so each later
    mode works on an already compressed matrix. Returns ``(tt,
    next_state)``; requested ranks are clipped to each unfolding's feasible
    min(rows, cols)."""
    shape = tuple(int(n) for n in x.shape)
    p = len(shape)
    require(p >= 1, "tt_from_dense needs ndim >= 1")
    rr = list(_as_ranks(ranks, p))
    st = state
    cores = []
    carry = x.to(dtype).reshape(1, -1)           # (r_0 * n_1...n_p)
    r_prev = 1
    for k in range(p - 1):
        n_k = shape[k]
        rest = 1
        for n in shape[k + 1:]:
            rest *= n
        mat = carry.reshape(r_prev * n_k, rest)
        r_k = min(rr[k + 1], mat.shape[0], mat.shape[1])
        rr[k + 1] = r_k
        s = min(r_k + oversample, mat.shape[0], mat.shape[1])
        g, st = fill_dense(DenseDist(mat.shape[1], s), st, dtype=dtype,
                           device=x.device)
        y = mat @ g
        for _ in range(power_iters):
            q = _stabilize(y, orth)
            z = mat.T @ q
            w = _stabilize(z, orth)
            y = mat @ w
        q = _orth(y, orth)                        # (r_prev n_k, s)
        b = q.T @ mat
        if s > r_k:                               # truncate via small SVD
            ub, sv, vt = safe_svd(b, full_matrices=False)
            q = q @ ub[:, :r_k]
            b = sv[:r_k, None] * vt[:r_k, :]
        cores.append(q.reshape(r_prev, n_k, r_k))
        carry = b
        r_prev = r_k
    cores.append(carry.reshape(r_prev, shape[-1], 1))
    return TTTensor(cores), st


def tt_round_deterministic(x: TTTensor, ranks) -> TTTensor:
    """Classical TT rounding (Oseledets 2011): a right-to-left
    orthogonalization sweep, then a left-to-right SVD truncation sweep.
    With the tails orthonormal every per-mode truncation is the best one
    in the Frobenius metric. :func:`tt_round` skips the orthogonalization
    of the large input; this is its recompression backend and the
    deterministic baseline."""
    p = x.ndim
    if p == 1:
        return TTTensor(list(x.cores))
    rr = list(_as_ranks(ranks, p))
    # right-to-left: make cores 2..p row-orthonormal (LQ via QR of the
    # transposed right unfolding), absorbing the L factors leftward
    cores = list(x.cores)
    for k in range(p - 1, 0, -1):
        g = cores[k]
        r0, n_k, r1 = g.shape
        q, r = torch.linalg.qr(g.reshape(r0, n_k * r1).T)  # mat = r^T q^T
        cores[k] = q.T.reshape(-1, n_k, r1)
        cores[k - 1] = torch.einsum("aib,bc->aic", cores[k - 1], r.T)
    # left-to-right: truncate each left unfolding by its SVD (optimal: the
    # tail interface is orthonormal now)
    out = []
    carry = cores[0]
    for k in range(p - 1):
        s_prev, n_k, r1 = carry.shape
        u, sv, vt = safe_svd(carry.reshape(s_prev * n_k, r1),
                             full_matrices=False)
        r_k = min(rr[k + 1], u.shape[1])
        out.append(u[:, :r_k].reshape(s_prev, n_k, r_k))
        m = sv[:r_k, None] * vt[:r_k, :]
        carry = torch.einsum("ab,bic->aic", m, cores[k + 1])
    out.append(carry)
    return TTTensor(out)


def tt_round(x: TTTensor, ranks, state: RNGState, *,
             oversample: int = 4, orth: str = "qr"
             ) -> Tuple[TTTensor, RNGState]:
    """Randomize-then-Orthogonalize TT rounding: truncate x's ranks to
    ``ranks`` without the classical orthogonalization sweep over the large
    input.

    Draw an independent Gaussian TT R at ranks ``r + oversample``
    (:func:`tt_gaussian`, on x's device), precompute the right interface
    contractions W_k = <tail of x, tail of R> (r^x_k, l_k), then sweep
    left to right: each left unfolding's range is estimated from its
    sketch ``unfold @ W_k`` and one small QR a mode replaces the
    orthogonalization plus SVD of the classical algorithm. The oversampled
    result is then recompressed to the target by
    :func:`tt_round_deterministic`, cheap at the sketched ranks;
    truncating inside the sweep would pick subspaces in non-orthonormal
    tail coordinates and lose the quasi-optimality. Requested ranks are
    clipped to each unfolding's feasible size. Returns ``(tt,
    next_state)``; next_state = f(shape, ranks) only."""
    p = x.ndim
    shape = x.shape
    if p == 1:
        return TTTensor(list(x.cores)), state
    rr = list(_as_ranks(ranks, p))
    rx = x.ranks
    for k in range(1, p):
        feas_rows = 1
        for i in range(k):
            feas_rows *= shape[i]
        rr[k] = min(rr[k], rx[k], feas_rows)
    ell = [min(rr[k] + oversample, rx[k]) if 0 < k < p else 1
           for k in range(p + 1)]
    r_tt, nxt = tt_gaussian(shape, ell[1:p], state, dtype=x.dtype,
                            device=x.device)

    # right interface chain: ws[k] = tail contraction past mode k
    ws = [None] * (p + 1)
    w = torch.ones((1, 1), dtype=x.dtype, device=x.device)
    ws[p] = w
    for k in range(p - 1, 0, -1):
        w = torch.einsum("aib,cid,bd->ac", x.cores[k], r_tt.cores[k], w)
        ws[k] = w                                 # (r^x_k, l_k)

    cores = []
    carry = x.cores[0]                            # (s_{k-1}, n_k, r^x_k)
    for k in range(p - 1):
        s_prev = carry.shape[0]
        n_k = shape[k]
        unfold = carry.reshape(s_prev * n_k, -1)  # (s n, r^x_{k+1})
        q = _orth(unfold @ ws[k + 1], orth)       # (s n, min(sn, l_k))
        m = q.T @ unfold
        cores.append(q.reshape(s_prev, n_k, -1))
        carry = torch.einsum("ab,bic->aic", m, x.cores[k + 1])
    cores.append(carry)
    return tt_round_deterministic(TTTensor(cores), rr[1:p]), nxt


class TTMatrix:
    """A linear operator in TT-matrix (MPO) format: ``cores[k]`` has shape
    (R_k, n_out_k, n_in_k, R_{k+1}), R_0 = R_p = 1, acting on TT (or
    vectorized dense) tensors with mode sizes n_in. ``full()`` is the
    matrix it represents, with row index row-major over the out modes and
    column index row-major over the in modes (matching TTTensor.full() and
    reshape(-1))."""

    def __init__(self, cores: Sequence[torch.Tensor]):
        cores = list(cores)
        require(len(cores) >= 1, "TTMatrix needs at least one core")
        for g in cores:
            require(g.dim() == 4,
                    "TT-matrix cores must be 4-D (R_in, n_out, n_in, "
                    "R_out)")
        require(cores[0].shape[0] == 1 and cores[-1].shape[-1] == 1,
                "boundary TT-matrix ranks must be 1")
        for a, b in zip(cores[:-1], cores[1:]):
            require(a.shape[-1] == b.shape[0],
                    "adjacent TT-matrix cores must agree on the shared "
                    "rank")
        self.cores = cores

    @property
    def out_shape(self) -> Tuple[int, ...]:
        return tuple(g.shape[1] for g in self.cores)

    @property
    def in_shape(self) -> Tuple[int, ...]:
        return tuple(g.shape[2] for g in self.cores)

    @property
    def ranks(self) -> Tuple[int, ...]:
        return tuple(g.shape[0] for g in self.cores) + (1,)

    @property
    def ndim(self) -> int:
        return len(self.cores)

    @property
    def dtype(self):
        return self.cores[0].dtype

    @property
    def device(self) -> torch.device:
        return self.cores[0].device

    def to(self, device) -> "TTMatrix":
        return TTMatrix([g.to(device) for g in self.cores])

    def full(self) -> torch.Tensor:
        """Contract to the dense (prod n_out, prod n_in) matrix."""
        out = self.cores[0]                  # (1, o_1, i_1, R_1)
        for g in self.cores[1:]:
            out = torch.einsum("a...b,boic->a...oic", out, g)
        out = out[0, ..., 0]                 # (o_1, i_1, o_2, i_2, ...)
        p = len(self.cores)
        perm = tuple(range(0, 2 * p, 2)) + tuple(range(1, 2 * p, 2))
        m = 1
        for n in self.out_shape:
            m *= n
        return out.permute(perm).reshape(m, -1)

    def __repr__(self):
        return (f"TTMatrix(out={self.out_shape}, in={self.in_shape}, "
                f"ranks={self.ranks}, dtype={self.dtype})")


def tt_matrix_gaussian(out_shape: Sequence[int], in_shape: Sequence[int],
                       ranks, state: RNGState, *, dtype=torch.float32,
                       device=None) -> Tuple[TTMatrix, RNGState]:
    """Random TT-matrix with iid N(0,1) cores on ``device`` (the card by
    default): core k is one DenseDist(R_k, o_k * i_k * R_{k+1}) sample,
    seed-chained; next_state = f(shapes, ranks)."""
    out_shape = tuple(int(n) for n in out_shape)
    in_shape = tuple(int(n) for n in in_shape)
    require(len(out_shape) == len(in_shape) and len(out_shape) >= 1,
            "out_shape and in_shape must have the same length >= 1")
    rr = _as_ranks(ranks, len(out_shape))
    device = default_device(device)
    cores = []
    st = state
    for k, (o, i) in enumerate(zip(out_shape, in_shape)):
        r0, r1 = rr[k], rr[k + 1]
        flat, st = fill_dense(DenseDist(r0, o * i * r1), st, dtype=dtype,
                              device=device)
        cores.append(flat.reshape(r0, o, i, r1))
    return TTMatrix(cores), st


def tt_matvec(a: TTMatrix, x: TTTensor, *, ranks=None,
              state: RNGState = None, oversample: int = 4):
    """y = A @ x with A in TT-matrix format and x in TT format: the exact
    product has per-interface ranks R_k * r_k (each product core is one
    einsum). With ``ranks`` given the product is truncated at once, through
    :func:`tt_round` when ``state`` is given (returns ``(y,
    next_state)``), else through :func:`tt_round_deterministic` (returns
    ``y``)."""
    require(a.in_shape == x.shape,
            "TT-matrix in_shape must equal the TT vector's shape")
    cores = []
    for g, v in zip(a.cores, x.cores):
        # g (R0, o, i, R1) ; v (r0, i, r1) -> (R0 r0, o, R1 r1)
        c = torch.einsum("aoib,cid->acobd", g, v.to(g.dtype)).to(x.dtype)
        s = c.shape
        cores.append(c.reshape(s[0] * s[1], s[2], s[3] * s[4]))
    y = TTTensor(cores)
    if ranks is None:
        require(state is None, "state without ranks: nothing to round")
        return y
    if state is not None:
        return tt_round(y, ranks, state, oversample=oversample)
    return tt_round_deterministic(y, ranks)


def _stta_ranks(shape, ranks):
    """Clip target ranks to each interface's feasible size."""
    p = len(shape)
    rr = list(_as_ranks(ranks, p))
    for k in range(1, p):
        lead = 1
        for n in shape[:k]:
            lead *= n
        tail = 1
        for n in shape[k:]:
            tail *= n
        rr[k] = min(rr[k], lead, tail)
    return rr


def _stta_sketch(x, r_tt: TTTensor, l_tt: TTTensor, dtype):
    """The STTA sketch family Psi_k = Theta_{k-1} x Omega_k (l_{k-1}, n_k,
    r_k), k = 1..p: linear in x (sketches of additive updates add). One
    left sweep with L's heads plus short right chains with R's tails."""
    p = x.dim()

    def right_chain(t, k):
        if k == p:
            return t[..., None]               # r_p = 1
        for j in range(p, k, -1):
            g = r_tt.cores[j - 1]             # (r_{j-1}, n_j, r_j)
            if j == p:
                t = torch.einsum("...i,aib->...ab", t, g)[..., 0]
            else:
                t = torch.einsum("...ib,aib->...a", t, g)
        return t

    psis = []
    f = x.to(dtype)[None]                     # (l_0 = 1, n_1, ..., n_p)
    for k in range(1, p + 1):
        psis.append(right_chain(f, k))        # (l_{k-1}, n_k, r_k)
        if k < p:
            f = torch.einsum("lj...,ljm->m...", f, l_tt.cores[k - 1])
    return psis


def _stta_recover(psis, r_tt: TTTensor) -> TTTensor:
    """x-free core recovery G_k = Phi_{k-1}^+ Psi_k, with Phi_{k-1} = Psi_k
    contracted against R's core k (so the Phi family needs no storage of
    its own), by the clipped-QR least squares."""
    cores = [psis[0]]                         # l_0 = 1: core as is
    for k in range(2, len(psis) + 1):
        psi = psis[k - 1]
        phi = torch.einsum("ljb,ajb->la", psi, r_tt.cores[k - 1])
        l_prev, n_k, r_k = psi.shape
        g = qr_clipped_lstsq(phi, psi.reshape(l_prev, n_k * r_k))
        cores.append(g.reshape(-1, n_k, r_k))
    return TTTensor(cores)


def tt_single_pass(x: torch.Tensor, ranks, state: RNGState, *,
                   oversample: int = 4, dtype=torch.float32
                   ) -> Tuple[TTTensor, RNGState]:
    """Streaming two-sided TT approximation (STTA): a TT approximation of
    x from sketches that are linear in x, the TT analog of
    ``single_pass_svd``.

    Draw two independent Gaussian TTs on x's device: R at the target ranks
    r_k (its tails are the right sketches Omega_k) and L at r_k +
    ``oversample`` (its heads are the left sketches Theta_k). The only
    access to x is through Psi_k = Theta_{k-1} x Omega_k, and the cores
    are recovered x-free as G_k = Phi_{k-1}^+ Psi_k. For tensors that
    arrive as additive updates, accumulate with :class:`TTStream` instead.
    Returns ``(tt, next_state)``; next_state = f(shape, ranks)."""
    shape = tuple(int(n) for n in x.shape)
    require(len(shape) >= 1, "tt_single_pass needs ndim >= 1")
    rr = _stta_ranks(shape, ranks)
    r_tt, st = tt_gaussian(shape, rr[1:-1], state, dtype=dtype,
                           device=x.device)
    l_tt, st = tt_gaussian(shape, [r + oversample for r in rr[1:-1]], st,
                           dtype=dtype, device=x.device)
    return _stta_recover(_stta_sketch(x, r_tt, l_tt, dtype), r_tt), st


class TTStream:
    """Streaming TT accumulator over additive updates (x = the sum of
    deltas arriving in any order): keeps only the linear STTA sketch
    family Psi_k, never x. ``update`` per arrival, ``recover`` at any
    point (recovery does not consume the stream). The two Gaussian TTs
    live on ``device`` (the card by default); ``next_state`` chains like
    every operator's."""

    def __init__(self, shape, ranks, state: RNGState, *,
                 oversample: int = 4, dtype=torch.float32, device=None):
        self.shape = tuple(int(n) for n in shape)
        require(len(self.shape) >= 1, "TTStream needs ndim >= 1")
        rr = _stta_ranks(self.shape, ranks)
        self._dtype = dtype
        self._r_tt, st = tt_gaussian(self.shape, rr[1:-1], state,
                                     dtype=dtype, device=device)
        self._l_tt, st = tt_gaussian(
            self.shape, [r + oversample for r in rr[1:-1]], st,
            dtype=dtype, device=device)
        self.next_state = st
        self._psis = None

    def update(self, delta: torch.Tensor) -> "TTStream":
        require(tuple(delta.shape) == self.shape,
                "update shape must match the stream's shape")
        psis = _stta_sketch(delta.to(self._r_tt.device), self._r_tt,
                            self._l_tt, self._dtype)
        if self._psis is None:
            self._psis = psis
        else:
            self._psis = [a + b for a, b in zip(self._psis, psis)]
        return self

    def recover(self) -> TTTensor:
        require(self._psis is not None, "recover() before any update()")
        return _stta_recover(self._psis, self._r_tt)
