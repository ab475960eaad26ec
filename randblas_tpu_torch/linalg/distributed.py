"""Randomized linear algebra with the data's long axis sharded over a mesh
(counterpart of randblas_tpu/linalg/distributed.py), and the tall-skinny
``cholqr`` the rangefinder family orthonormalizes with.

The data A (m, n) is row-sharded over 'data' (a DTensor with placements
[Replicate(), Shard(0)], or a plain tensor every rank holds, of which each
takes its rows), and so are Q and every m-sized factor; what is replicated
is k- or n-sized. The JAX package leaves the products to XLA's sharding
propagation; here each row-sharded product is a local product and, where
it contracts over the rows, an all-reduce over 'data' of the thin result:

  * Y = A @ Omega      local (Omega replicated, n x k)
  * G = Y^T Y          k x k all-reduce: the one collective of a CholQR pass
  * Q = Y C^{-T}       local triangular solve
  * Z = A^T Q          n x k all-reduce
  * B = Q^T A          k x n all-reduce

The 'model' axis is unused (each 'model' row of the mesh computes the same
result). Grams and certificates run in float32 with TF32 off (``_mm_precise``,
``cholqr``), as on one device. Row-sharded results come back as DTensors,
replicated ones as plain tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..base import require
from ..dense import DenseDist, DenseSkOp
from ..rng.state import RNGState
from .qb import _cholesky, _ieee_f32, _matmul, _mm_precise, safe_svd


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
    return _cholqr(y, iters, shift, None)


def _cholqr(y: torch.Tensor, iters: int, shift: float, group
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cholqr`` of the row blocks of y held across ``group`` (None: all of
    y here): the Gram is their sum, an all-reduce; the rest is local."""
    from ..parallel.distributed import _all_reduce
    require(y.dim() == 2, "cholqr takes a 2-D array")
    require(iters >= 1, "iters must be >= 1")
    k = y.shape[1]
    dtype = y.dtype
    eye = torch.eye(k, dtype=dtype, device=y.device)
    eps, tiny = torch.finfo(dtype).eps, torch.finfo(dtype).tiny
    r = None
    with _ieee_f32():
        for _ in range(iters):
            g = _all_reduce(_matmul(y.T, y, dtype), group)
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


def _materialized_probe(n: int, k: int, state: RNGState, dtype, device
                        ) -> Tuple[torch.Tensor, RNGState]:
    """The replicated (n, k) Gaussian probe of the range sketch, filled on
    ``device`` (K3 on the card): n and k are the short dimensions, so it
    costs n k next to the m-sharded data."""
    S = DenseSkOp(DenseDist(n, k), state, dtype=dtype)
    return S.materialize(device=device), S.next_state


def _rows(a, mesh, dtype):
    """(this rank's rows of ``a`` in ``dtype``, the 'data' group): A's rows
    in DTensor chunks over 'data'."""
    from ..parallel.distributed import _mesh, _shard_extent, local_block
    shape, coord = _mesh(mesh)
    per = _shard_extent(a.shape[0], shape[1])
    return (local_block(a, mesh, 0, per, coord[1]).to(dtype),
            mesh.get_group("data"))


def _row_sharded(x: torch.Tensor, mesh, m: int):
    """The DTensor (m, k) whose row blocks over 'data' are the ranks' x."""
    from torch.distributed.tensor import Replicate, Shard
    from ..parallel.distributed import as_dtensor
    return as_dtensor(x.contiguous(), mesh, [Replicate(), Shard(0)],
                      (m, x.shape[1]))


def _range_rows(a_loc, k: int, state: RNGState, group, power_iters: int,
                dtype, cholqr_iters: int, gram_shift: float):
    """The rangefinder on row blocks: this rank's rows of Q."""
    from ..parallel.distributed import _all_reduce
    sm, _ = _materialized_probe(a_loc.shape[1], k, state, dtype,
                                a_loc.device)

    def qfix(y):
        return _cholqr(y, cholqr_iters, gram_shift, group)[0]

    q = qfix(_matmul(a_loc, sm, dtype))
    for _ in range(power_iters):
        z = _all_reduce(_matmul(a_loc.T, q, dtype), group)  # n x k
        w, _ = cholqr(z, iters=cholqr_iters, shift=gram_shift)
        q = qfix(_matmul(a_loc, w, dtype))
    return q


def distributed_rangefinder(a, k: int, state: RNGState, mesh, *,
                            power_iters: int = 2, dtype=torch.float32,
                            cholqr_iters: int = 2,
                            gram_shift: float = 0.0):
    """Orthonormal Q (m, k) approximating range(A), with A and Q
    row-sharded over 'data' throughout (Q a DTensor, placements
    [Replicate(), Shard(0)]).

    The distributed counterpart of ``rangefinder``: the same sketch and
    power iteration, every orthonormalization a CholQR (a k x k Gram
    all-reduce and a local solve) instead of a gathered Householder QR.
    ``gram_shift`` goes to CholQR for numerically rank-deficient
    sketches."""
    m, n = a.shape
    require(k <= min(m, n), "rank must be <= min dim")
    a_loc, group = _rows(a, mesh, dtype)
    q = _range_rows(a_loc, k, state, group, power_iters, dtype,
                    cholqr_iters, gram_shift)
    return _row_sharded(q, mesh, m)


def _qb_rows(a, k, state, mesh, power_iters, dtype, gram_shift):
    """(this rank's rows of Q, B = Q^T A replicated, m)."""
    from ..parallel.distributed import _all_reduce
    m, n = a.shape
    require(k <= min(m, n), "rank must be <= min dim")
    a_loc, group = _rows(a, mesh, dtype)
    q = _range_rows(a_loc, k, state, group, power_iters, dtype, 2,
                    gram_shift)
    return q, _all_reduce(_matmul(q.T, a_loc, dtype), group), m


def distributed_qb(a, k: int, state: RNGState, mesh, *,
                   power_iters: int = 2, dtype=torch.float32,
                   gram_shift: float = 0.0):
    """A ~= Q @ B with Q (m, k) row-sharded (a DTensor) and B = Q^T A (k,
    n) replicated (a k x n all-reduce)."""
    q, b, m = _qb_rows(a, k, state, mesh, power_iters, dtype, gram_shift)
    return _row_sharded(q, mesh, m), b


def distributed_rsvd(a, k: int, state: RNGState, mesh, *,
                     power_iters: int = 2, dtype=torch.float32,
                     gram_shift: float = 0.0, oversample: int = 8):
    """Rank-k randomized SVD with the long axis sharded end to end.

    Returns ``(u, s, vt)``: ``u`` (m, k) row-sharded (a DTensor), ``s``
    (k,) and ``vt`` (k, n) replicated. The SVD runs on the (k + p) x n
    factor only and U = Q @ Ub is local. ``oversample`` extra columns ride
    through the rangefinder and are cut after the small SVD, clamped to
    min(A.shape) - k; CholQR's rescue keeps k + p > rank(A) finite."""
    require(k <= min(a.shape), "rank must be <= min(A.shape)")
    oversample = min(oversample, min(a.shape) - k)
    q, b, m = _qb_rows(a, k + oversample, state, mesh, power_iters, dtype,
                       gram_shift)
    ub, s, vt = safe_svd(b, full_matrices=False)
    u = _matmul(q, ub[:, :k], q.dtype)
    return _row_sharded(u, mesh, m), s[:k], vt[:k]


def fd_shard(a_loc: torch.Tensor, ell: int, per: int):
    """A 'data' shard's Frequent Directions pass over its rows, zero-padded
    to the shard extent ``per`` as the JAX package pads them: (B (ell, n),
    shrink mass)."""
    from .streaming import fd_pass
    pad = per - a_loc.shape[0]
    if pad:
        a_loc = torch.cat([a_loc, a_loc.new_zeros((pad, a_loc.shape[1]))])
    return fd_pass(a_loc, ell)


def fd_merge(sketches: torch.Tensor, masses: torch.Tensor, n: int,
             ell: int, dtype):
    """One FrequentDirections from the shards' stacked (P ell, n) sketches,
    their certificates summed."""
    from .streaming import FrequentDirections
    fd = FrequentDirections(n, ell, dtype=dtype, device=sketches.device)
    fd._shrink_mass = masses.sum().to(dtype)
    fd.ingest(sketches)
    return fd


def distributed_fd(a, ell: int, mesh, *, dtype=torch.float32):
    """Frequent Directions of a row-sharded matrix, by mergeability
    (GLPW16 thm 1.2): each 'data' shard runs ``fd_pass`` over its own rows
    (no collective), the shards' (ell, n) sketches and certificates are
    gathered over 'data', and one more pass merges the stacked sketches
    with the certificates summed. ||A^T A - B^T B||_2 <= shrink_mass holds
    for the whole matrix. Returns the merged ``FrequentDirections``, the
    same on every rank."""
    import torch.distributed as dist
    from ..parallel.distributed import _mesh, _shard_extent, local_block
    require(a.dim() == 2, "distributed_fd takes a 2-D array")
    m, n = a.shape
    require(1 <= ell <= n, "need 1 <= ell <= n")
    shape, coord = _mesh(mesh)
    per = _shard_extent(m, shape[1])
    a_loc = local_block(a, mesh, 0, per, coord[1]).to(dtype)
    b, mass = fd_shard(a_loc, ell, per)
    group = mesh.get_group("data")
    bs = [torch.empty_like(b) for _ in range(shape[1])]
    ms = [torch.empty_like(mass.reshape(1)) for _ in range(shape[1])]
    dist.all_gather(bs, b.contiguous(), group=group)
    dist.all_gather(ms, mass.reshape(1), group=group)
    return fd_merge(torch.cat(bs), torch.cat(ms), n, ell, dtype)


def _absorb_gram(r: torch.Tensor, rel2: float, limit_cols: int, group):
    """Rank-cutoff orthonormalization of the row-sharded block ``r``: the
    eigendecomposition of its all-reduced k x k Gram, keeping directions
    with eigenvalue > rel2 * (the largest), then one CholQR-style pass (a
    second Gram all-reduce and a local solve). Returns ``(q, lam_max)``,
    q None when nothing is kept. The Gram's eigendecomposition runs in
    float64 (cuSOLVER's float32 one is accurate to ~1e-5)."""
    from ..parallel.distributed import _all_reduce
    g = _all_reduce(_mm_precise(r.T, r), group)
    g = 0.5 * (g + g.T)
    lam, v = torch.linalg.eigh(g.to(torch.float64))
    lam, v = lam.to(r.dtype), v.to(r.dtype)
    lam_max = float(lam[-1])
    keep = min(int((lam > rel2 * max(lam_max, 0.0)).sum()), limit_cols)
    if keep == 0 or lam_max <= 0.0:
        return None, lam_max
    lam_k = torch.clamp(lam[-keep:], min=torch.finfo(r.dtype).tiny)
    q = _mm_precise(r, v[:, -keep:] / torch.sqrt(lam_k))
    g2 = _all_reduce(_mm_precise(q.T, q), group)
    c = _cholesky(0.5 * (g2 + g2.T))
    return torch.linalg.solve_triangular(c, q.T, upper=False).T, lam_max


def distributed_krylov_rangefinder(a, block: int, state: RNGState, mesh, *,
                                   depth: int = 2, dtype=torch.float32):
    """Row-sharded block Krylov rangefinder (Musco–Musco 2015), the
    distributed counterpart of ``krylov_rangefinder``, with A and every
    m-sized block row-sharded end to end. Per depth step the collectives
    are an n x block all-reduce (A^T q), the basis-width x block
    Gram–Schmidt coefficients (twice) and the absorption's block x block
    Grams. Returns the orthonormal basis (a DTensor), width <= block *
    (depth + 1): the relative rank cutoff stops its growth once the range
    is captured."""
    from ..parallel.distributed import _all_reduce
    m, n = a.shape
    require(block >= 1, "block must be >= 1")
    require(depth >= 0, "depth must be >= 0")
    require(block * (depth + 1) <= min(m, n),
            "block * (depth+1) must be <= min(A.shape)")
    a_loc, group = _rows(a, mesh, dtype)
    sm, _ = _materialized_probe(n, block, state, dtype, a_loc.device)
    y = _matmul(a_loc, sm, dtype)
    # each block is cut relative to its own dominant eigenvalue (loop
    # blocks scale as sigma^2, the first as sigma), and the loop stops when
    # a block's projected Gram is a rounding ghost of its scale before
    rel = 20.0 * torch.finfo(dtype).eps * float(m) ** 0.5
    basis, _ = _absorb_gram(y, rel * rel, block, group)
    if basis is None:                               # A == 0
        return _row_sharded(a_loc.new_zeros((a_loc.shape[0], 0)), mesh, m)
    prev = basis
    for _ in range(depth):
        z = _all_reduce(_matmul(a_loc.T, prev, dtype), group)
        y = _matmul(a_loc, z, dtype)
        pre2 = float(_all_reduce((y * y).sum(dim=0), group).max())
        for _ in range(2):
            coef = _all_reduce(_mm_precise(basis.T, y), group)
            y = y - _mm_precise(basis, coef)
        q_new, lam_max = _absorb_gram(
            y, rel * rel, min(block, min(m, n) - basis.shape[1]), group)
        if q_new is None or lam_max <= (rel * rel) * pre2:
            break                                   # range captured
        prev = q_new
        basis = torch.cat([basis, prev], dim=1)
    return _row_sharded(basis, mesh, m)
