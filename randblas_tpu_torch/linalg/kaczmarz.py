"""Row- and column-action iterative solvers: block randomized Kaczmarz and
randomized block Gauss-Seidel, coordinate descent (counterpart of
randblas_tpu/linalg/kaczmarz.py).

Consumers of the counter-based sampling streams (``util.weights_to_cdf``
and ``util.sample_indices_iid``, the reference's util.hh:173-334). Each
step samples a block of rows or columns, so an update is a gather, two thin
products and one small Cholesky solve, and the per-sweep contraction
improves with the block size (Needell-Tropp 2014). All sampling happens up
front from the chained Uniform stream, so a solve is a function of (A, b,
state); the steps run in a host loop on A's device.

- ``block_kaczmarz``, row action: projects onto sampled row blocks'
  solution spaces; converges geometrically for consistent systems.
- ``block_gauss_seidel``, column action on the normal equations
  (Leventhal-Lewis 2010): converges geometrically to the least-squares
  solution of tall full-rank systems, consistent or not.

Sharded inputs (the JAX package gets them from XLA's sharding
propagation): ``block_kaczmarz`` takes A and b row-sharded over a mesh's
'data' axis (DTensors laid out [Replicate(), Shard(0)]),
``block_gauss_seidel`` A column-sharded ([Replicate(), Shard(1)]). Each
rank keeps its own rows or columns; the weights are computed there and
gathered, so the sampled blocks are the unsharded run's. Where a step needs
a whole panel (Kaczmarz's rows, the iid Gauss-Seidel orders' per-step
Grams), it is assembled with one all-reduce over 'data' in which every row
has one owner and the others add zeros, so it is exact. The 'shuffle'
order assembles each block's panel once, for its Gram; a step then
all-reduces only the (block,) product A_J^T r (exact, one owner an entry)
and the (m,) partial residual update A_J dx (summed over the ranks in
another order than the unsharded product). The rest of a step runs
replicated on every rank, and x comes back as a replicated DTensor on A's
mesh. With A laid out so, no rank holds the whole of A (a DTensor laid out
otherwise is gathered first, the distributed layer's rule).

Precision: the residuals, right-hand sides and updates run in float32 with
TF32 off (the JAX package's ``Precision.HIGHEST``); the Gauss-Seidel Grams
are plain float32 products (its default precision): they only
precondition, and the fixed point is pinned by the right-hand side and the
residual update.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..base import is_dtensor, mesh_of, require
from ..dense import DenseDist, DenseDistName, DenseSkOp
from ..rng.state import RNGState
from ..util import sample_indices_iid, sample_indices_iid_uniform, \
    weights_to_cdf
from .qb import _cholesky, _ieee_f32


def _sample_blocks(w: Optional[torch.Tensor], n: int, steps: int,
                   block: int, state: RNGState, device=None
                   ) -> Tuple[torch.Tensor, RNGState]:
    """(steps, block) int32 indices from the chained Uniform stream,
    importance-sampled from weights ``w`` (on w's device; all zeros sample
    uniformly, ``_nonzero_weights``) or uniform on ``device`` when w is
    None. A DTensor of weights is made a plain tensor once, here. One
    stream read for the whole solve."""
    if w is None:
        idx, nxt = sample_indices_iid_uniform(n, steps * block, state,
                                              device)
    else:
        if is_dtensor(w):
            w = w.full_tensor()
        idx, nxt = sample_indices_iid(weights_to_cdf(_nonzero_weights(w)),
                                      steps * block, state)
    return idx.reshape(steps, block), nxt


def _damped_spd_solve(g: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve (G + lam I) y = rhs for a small PSD Gram block. iid sampling
    duplicates rows or columns inside a block with probability ~ block^2 /
    (2n), which makes G exactly singular: the eps-scale Tikhonov floor
    keeps the Cholesky solve finite. The floor rides trace(G) so it scales
    with the data; the tiny() floor makes an all-zero block solve to 0."""
    s = g.shape[0]
    lam = torch.clamp(torch.finfo(g.dtype).eps * torch.trace(g) / s * 8.0,
                      min=torch.finfo(g.dtype).tiny)
    gd = g + lam * torch.eye(s, dtype=g.dtype, device=g.device)
    y = torch.cholesky_solve(rhs[:, None] if rhs.dim() == 1 else rhs,
                             _cholesky(gd))
    return y[:, 0] if rhs.dim() == 1 else y


def _nonzero_weights(w: torch.Tensor) -> torch.Tensor:
    """w, or all ones when w sums to 0 (all-zero A: uniform sampling, not a
    NaN CDF), keeping a NaN in the weights propagating."""
    total = w.sum()
    return torch.where(total > 0, w, torch.ones_like(w)) + total * 0


def block_kaczmarz(a: torch.Tensor, b: torch.Tensor, state: RNGState, *,
                   block: int = 256, steps: int = 64,
                   x0: Optional[torch.Tensor] = None,
                   sampling: str = "rownorm"
                   ) -> Tuple[torch.Tensor, RNGState]:
    """Block randomized Kaczmarz for ``A x = b`` (consistent systems).

    Each step samples ``block`` rows tau (probabilities ∝ ||a_i||^2 for
    ``sampling='rownorm'``, Strohmer-Vershynin, or ``'uniform'``) and
    projects x onto the block's solution space,

        x <- x + A_tau^+ (b_tau - A_tau x),

    A_tau^+ applied through the damped (block, block) Gram solve. For an
    inconsistent b it stalls at a ||r*||-sized horizon: use
    :func:`block_gauss_seidel` for least squares. A and b may be
    row-sharded DTensors (module notes). Returns ``(x, next_state)``."""
    require(a.dim() == 2, "block_kaczmarz takes a matrix A")
    m, n = a.shape
    require(b.shape[0] == m, "b must have A's row count")
    require(1 <= block <= m, "block must be in [1, m]")
    require(steps >= 1, "need at least one step")
    require(sampling in ("rownorm", "uniform"),
            "sampling must be 'rownorm' or 'uniform'")

    mesh = mesh_of(a, b, x0)
    if mesh is not None:
        from ..parallel import distributed as pd
        a, off = pd.data_chunk(a, mesh, 0)
        b = pd.data_chunk(b, mesh, 0)[0]
        x0 = pd.gathered(x0)
    w = (a * a).sum(dim=1) if sampling == "rownorm" else None
    if mesh is not None and w is not None:
        w = pd.data_sharded(w, mesh, 0, (m,))   # gathered by the sampler
    idx, nxt = _sample_blocks(w, m, steps, block, state, a.device)
    idx = idx.long()
    b = b.to(a.dtype)
    x = (a.new_zeros((n,) + tuple(b.shape[1:])) if x0 is None
         else x0.to(device=a.device, dtype=a.dtype))
    with _ieee_f32():
        for ix in idx:
            if mesh is None:
                rows, b_rows = a.index_select(0, ix), b.index_select(0, ix)
            else:       # (s, n), (s,) assembled exactly over 'data'
                rows, b_rows = pd.owned_rows((a, b), off, ix,
                                             mesh.get_group("data"))
            r = b_rows - rows @ x
            y = _damped_spd_solve(rows @ rows.T, r)
            x = x + rows.T @ y
    return (x if mesh is None else pd.replicated_on(x, mesh)), nxt


def block_gauss_seidel(a: torch.Tensor, b: torch.Tensor, state: RNGState,
                       *, block: int = 256, steps: int = 64,
                       x0: Optional[torch.Tensor] = None,
                       sampling: str = "shuffle"
                       ) -> Tuple[torch.Tensor, RNGState]:
    """Randomized block Gauss-Seidel / coordinate descent for tall least
    squares ``min ||A x - b||`` (Leventhal-Lewis 2010, block form).

    Each step takes a block of columns J and minimizes the residual exactly
    over those coordinates:

        dx = (A_J)^+ r,   x_J <- x_J + dx,   r <- r - A_J dx

    The residual is carried incrementally, so a step reads only the sampled
    (m, block) column panel. A may be a column-sharded DTensor (module
    notes). Returns ``(x, next_state)``.

    ``sampling``: ``'shuffle'`` (the default) draws one counter-addressed
    random permutation of the columns per solve and sweeps the fixed
    partition of the permuted A^T cyclically, so each block's damped Gram
    inverse is computed once; ``'colnorm'`` (LL10's importance weights) and
    ``'uniform'`` draw iid blocks, whose Grams are formed per step.
    Duplicate column indices in an iid block each get their share of the
    update (``index_add_``)."""
    require(a.dim() == 2, "block_gauss_seidel takes a matrix A")
    m, n = a.shape
    require(b.shape[0] == m, "b must have A's row count")
    require(b.dim() == 1, "block_gauss_seidel takes a single RHS vector")
    require(1 <= block <= n, "block must be in [1, n]")
    require(steps >= 1, "need at least one step")
    require(sampling in ("shuffle", "colnorm", "uniform"),
            "sampling must be 'shuffle', 'colnorm' or 'uniform'")

    mesh, off = mesh_of(a, b, x0), 0
    if mesh is not None:
        from ..parallel import distributed as pd
        a, off = pd.data_chunk(a, mesh, 1)
        b, x0 = pd.gathered(b), pd.gathered(x0)
    x_init = (a.new_zeros((n,)) if x0 is None
              else x0.to(device=a.device, dtype=a.dtype))
    with _ieee_f32():
        ax = a @ x_init if mesh is None else pd.sum_over(
            a @ x_init[off:off + a.shape[1]], mesh.get_group("data"))
        r_init = b.to(a.dtype) - ax

    if sampling == "shuffle":
        x, nxt = _gauss_seidel_shuffle(a, x_init, r_init, state, block,
                                       steps, mesh, off)
        return (x if mesh is None else pd.replicated_on(x, mesh)), nxt

    w = (a * a).sum(dim=0) if sampling == "colnorm" else None
    if mesh is not None and w is not None:
        w = pd.data_sharded(w, mesh, 0, (n,))   # gathered by the sampler
    idx, nxt = _sample_blocks(w, n, steps, block, state, a.device)
    idx = idx.long()
    # one contiguous A^T, so each panel is a gather of whole rows
    at = a.T.contiguous()
    x, r = x_init, r_init
    for jx in idx:
        if mesh is None:
            panel = at.index_select(0, jx)                # (s, m)
        else:           # its Gram needs the whole panel: assembled exactly
            panel, = pd.owned_rows((at,), off, jx, mesh.get_group("data"))
        g = panel @ panel.T          # plain float32: see the module notes
        with _ieee_f32():
            dx = _damped_spd_solve(g, panel @ r)
            # the damped solve splits the step evenly across duplicate
            # indices, so adding every copy applies the intended total
            x = x.index_add(0, jx, dx)
            r = r - panel.T @ dx
    return (x if mesh is None else pd.replicated_on(x, mesh)), nxt


def _gauss_seidel_shuffle(a, x_init, r_init, state: RNGState, block: int,
                          steps: int, mesh=None, off: int = 0
                          ) -> Tuple[torch.Tensor, RNGState]:
    """Shuffled-partition block Gauss-Seidel: permute the columns once (a
    stable argsort of one counter-addressed Uniform row, reproducible and
    seed-chained like every operator), pad A^T's permuted rows to a whole
    number of blocks with zero rows (phantom coordinates whose update is
    exactly 0), then sweep the fixed partition cyclically. Each block's
    damped Gram inverse is computed once, by one batched Cholesky solve, so
    a step is three matrix-vector products.

    With a ``mesh``, ``a`` is this rank's columns [off, off + k) of A. Each
    block's panel is assembled exactly once, for its Gram, and dropped
    (phantom index -1 assembles to zeros); the rank keeps its own columns
    of each block and their places in it. A step then all-reduces the
    block's A_J^T r, each entry from its one owner, and the partial
    products A_J dx of the residual update."""
    m, n = a.shape[0], x_init.shape[0]
    u_op = DenseSkOp(DenseDist(1, n, family=DenseDistName.Uniform), state,
                     dtype=torch.float32)
    perm = torch.argsort(u_op.materialize(device=a.device)[0], stable=True)
    nxt = u_op.next_state

    nblocks = -(-n // block)
    n_pad = nblocks * block
    if mesh is None:
        at_p = a.T.index_select(0, perm)
        if n_pad > n:
            at_p = torch.cat([at_p, a.new_zeros((n_pad - n, m))])
        panels = at_p.reshape(nblocks, block, m)
        grams = panels @ panels.transpose(1, 2)     # plain float32
    else:
        from ..parallel.distributed import owned_rows, sum_over
        group = mesh.get_group("data")
        at = a.T.contiguous()
        padded = torch.cat([perm, perm.new_full((n_pad - n,), -1)])
        grams, mine = [], []
        for bi in range(nblocks):
            jx = padded[bi * block:(bi + 1) * block]
            panel, = owned_rows((at,), off, jx, group)
            grams.append(panel @ panel.T)           # plain float32
            loc = jx - off
            pos = torch.nonzero((loc >= 0) & (loc < at.shape[0]))[:, 0]
            mine.append((pos, at.index_select(0, loc[pos])))
        grams = torch.stack(grams)
    s = block
    lam = torch.clamp(torch.finfo(a.dtype).eps
                      * torch.diagonal(grams, dim1=1, dim2=2).sum(-1)
                      / s * 8.0, min=torch.finfo(a.dtype).tiny)
    eye = torch.eye(s, dtype=a.dtype, device=a.device)
    grams = grams + lam[:, None, None] * eye
    invs = torch.cholesky_solve(eye.expand(nblocks, s, s), _cholesky(grams))

    xp = a.new_zeros((n_pad,))
    xp[:n] = x_init[perm]
    r = r_init
    with _ieee_f32():
        for step in range(steps):
            bi = step % nblocks
            if mesh is None:
                panel = panels[bi]
                dx = invs[bi] @ (panel @ r)
                r = r - panel.T @ dx
            else:
                pos, cols = mine[bi]
                g = a.new_zeros((s,)).index_copy_(0, pos, cols @ r)
                dx = invs[bi] @ sum_over(g, group)
                r = r - sum_over(cols.T @ dx[pos], group)
            xp[bi * block:(bi + 1) * block] += dx
    x = a.new_zeros((n,))
    x[perm] = xp[:n]
    return x, nxt
