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

Precision: the residuals, right-hand sides and updates run in float32 with
TF32 off (the JAX package's ``Precision.HIGHEST``); the Gauss-Seidel Grams
are plain float32 products (its default precision): they only
precondition, and the fixed point is pinned by the right-hand side and the
residual update.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..base import require
from ..dense import DenseDist, DenseDistName, DenseSkOp
from ..rng.state import RNGState
from ..util import sample_indices_iid, sample_indices_iid_uniform, \
    weights_to_cdf
from .qb import _cholesky, _ieee_f32


def _sample_blocks(w: Optional[torch.Tensor], n: int, steps: int,
                   block: int, state: RNGState, device=None
                   ) -> Tuple[torch.Tensor, RNGState]:
    """(steps, block) int32 indices from the chained Uniform stream,
    importance-sampled from weights ``w`` (on w's device) or uniform on
    ``device`` when w is None. One stream read for the whole solve."""
    if w is None:
        idx, nxt = sample_indices_iid_uniform(n, steps * block, state,
                                              device)
    else:
        idx, nxt = sample_indices_iid(weights_to_cdf(w), steps * block,
                                      state)
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
    :func:`block_gauss_seidel` for least squares. Returns ``(x,
    next_state)``."""
    require(a.dim() == 2, "block_kaczmarz takes a matrix A")
    m, n = a.shape
    require(b.shape[0] == m, "b must have A's row count")
    require(1 <= block <= m, "block must be in [1, m]")
    require(steps >= 1, "need at least one step")
    require(sampling in ("rownorm", "uniform"),
            "sampling must be 'rownorm' or 'uniform'")

    w = _nonzero_weights((a * a).sum(dim=1)) if sampling == "rownorm" \
        else None
    idx, nxt = _sample_blocks(w, m, steps, block, state, a.device)
    idx = idx.long()
    b = b.to(a.dtype)
    x = (a.new_zeros((n,) + tuple(b.shape[1:])) if x0 is None
         else x0.to(device=a.device, dtype=a.dtype))
    with _ieee_f32():
        for ix in idx:
            rows = a.index_select(0, ix)                  # (s, n)
            r = b.index_select(0, ix) - rows @ x
            y = _damped_spd_solve(rows @ rows.T, r)
            x = x + rows.T @ y
    return x, nxt


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
    (m, block) column panel. Returns ``(x, next_state)``.

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

    x_init = (a.new_zeros((n,)) if x0 is None
              else x0.to(device=a.device, dtype=a.dtype))
    with _ieee_f32():
        r_init = b.to(a.dtype) - a @ x_init

    if sampling == "shuffle":
        return _gauss_seidel_shuffle(a, x_init, r_init, state, block, steps)

    w = _nonzero_weights((a * a).sum(dim=0)) if sampling == "colnorm" \
        else None
    idx, nxt = _sample_blocks(w, n, steps, block, state, a.device)
    idx = idx.long()
    # one contiguous A^T, so each panel is a gather of whole rows
    at = a.T.contiguous()
    x, r = x_init, r_init
    for jx in idx:
        panel = at.index_select(0, jx)                    # (s, m)
        g = panel @ panel.T          # plain float32: see the module notes
        with _ieee_f32():
            dx = _damped_spd_solve(g, panel @ r)
            # the damped solve splits the step evenly across duplicate
            # indices, so adding every copy applies the intended total
            x = x.index_add(0, jx, dx)
            r = r - panel.T @ dx
    return x, nxt


def _gauss_seidel_shuffle(a, x_init, r_init, state: RNGState, block: int,
                          steps: int) -> Tuple[torch.Tensor, RNGState]:
    """Shuffled-partition block Gauss-Seidel: permute the columns once (a
    stable argsort of one counter-addressed Uniform row, reproducible and
    seed-chained like every operator), pad A^T's permuted rows to a whole
    number of blocks with zero rows (phantom coordinates whose update is
    exactly 0), then sweep the fixed partition cyclically. Each block's
    damped Gram inverse is computed once, by one batched Cholesky solve, so
    a step is three matrix-vector products."""
    m, n = a.shape
    u_op = DenseSkOp(DenseDist(1, n, family=DenseDistName.Uniform), state,
                     dtype=torch.float32)
    perm = torch.argsort(u_op.materialize(device=a.device)[0], stable=True)
    nxt = u_op.next_state

    nblocks = -(-n // block)
    n_pad = nblocks * block
    at_p = a.T.index_select(0, perm)
    if n_pad > n:
        at_p = torch.cat([at_p, a.new_zeros((n_pad - n, m))])
    panels = at_p.reshape(nblocks, block, m)
    grams = panels @ panels.transpose(1, 2)     # plain float32
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
            panel = panels[bi]
            dx = invs[bi] @ (panel @ r)
            xp[bi * block:(bi + 1) * block] += dx
            r = r - panel.T @ dx
    x = a.new_zeros((n,))
    x[perm] = xp[:n]
    return x, nxt
