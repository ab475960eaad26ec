"""Randomized Gram-Schmidt QR (Balabanov-Grigori 2021; counterpart of
randblas_tpu/linalg/rgs.py).

``rgs_qr`` factors a tall A = QR by orthogonalizing in sketch space:
columns are made orthonormal for the sketched inner product <Sx, Sy> of a
(d, m) subspace embedding S, so Q is well-conditioned (cond(Q) <=
sqrt((1+eps)/(1-eps))) even where cond(A) approaches 1/eps_machine, the
regime where CholQR's float32 Gram is singular.

S A is computed once (``_precise_sketch``); every projection updates the
(d, b) sketched panel in lockstep with the (m, b) full one. Columns go in
panels of ``block`` (a host loop): two CGS2 projection passes against the
finished basis, then the tiny (d, b) QR of the sketched panel.

Precision: RGS is the consumer whose correctness rests on the sketch's
fidelity, since the full-space basis is built from sketch-space
coefficients and sketch noise at delta ||A|| wipes out every singular
direction below delta. So ``_precise_sketch`` never reaches the fused
kernels K1, K2 or the SASO kernel K4, which contract with bf16 operands
(delta ~ 4e-3): on a TPU that failure is what the hardware test caught at
cond 3e7. Its products, the CGS2 projections and the final CholQR pass run
in float32 with TF32 off.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..base import require
from ..rng.state import RNGState
from .embed import make_embedding
from .qb import _cholesky, _clip_diagonal, _ieee_f32, _matmul

# |diag(R)| floored at eps ||R||_F: the panel solve stays finite on a
# rank-deficient panel
_clip_triangular = _clip_diagonal


def _rgs_panel_step(q_buf, sq_buf, r_buf, a_panel, sa_panel, col0: int):
    """Orthogonalize one (m, b) panel against the basis columns [0, col0)
    and write columns [col0, col0 + b) of the buffers in place."""
    b = a_panel.shape[1]
    q, sq = q_buf[:, :col0], sq_buf[:, :col0]
    p, sp = a_panel, sa_panel
    coeff = None
    with _ieee_f32():
        # two passes (CGS2, "twice is enough"): the sketched basis is
        # orthonormal, so each pass multiplies the residual by ~eps
        for _ in range(2):
            c = sq.T @ sp
            p = p - q @ c
            sp = sp - sq @ c
            coeff = c if coeff is None else coeff + c
        qs, rs = torch.linalg.qr(sp)                     # (d, b), (b, b)
        rs = _clip_triangular(rs)
        # Q_panel = P Rs^-1
        q_buf[:, col0:col0 + b] = torch.linalg.solve_triangular(
            rs, p, upper=True, left=False)
    sq_buf[:, col0:col0 + b] = qs
    # R columns [col0, col0 + b): the projection coefficients on top of
    # the panel's own triangle
    r_buf[:col0, col0:col0 + b] = coeff
    r_buf[col0:col0 + b, col0:col0 + b] = rs


# dense-materialization footprint cap of _precise_sketch (elements);
# module-level so that tests can lower it to drive the large-m branches
_FOOTPRINT_CAP = 1 << 27


def _precise_sketch(S, a: torch.Tensor, scale: float) -> torch.Tensor:
    """scale * S @ a at float32 precision, never through a bf16-operand
    kernel (K1, K2, K4).

    A dense operator up to the footprint cap is materialized (the fill
    kernel K3 on the card) and multiplied with TF32 off; above the cap it
    goes in chunks over the long axis. A SASO above the cap goes through
    the exact per-slot ``index_add_`` apply (``fixed_nnz_left_apply``),
    below it is materialized. An SRHT runs its Hadamard stages in float32
    with TF32 off."""
    from ..sparse import SparseSkOp
    from ..trig import TrigSkOp

    d, m = S.shape
    with _ieee_f32():
        if isinstance(S, TrigSkOp):
            sa = S.lmult(a)
        elif isinstance(S, SparseSkOp) and d * m > _FOOTPRINT_CAP:
            from ..ops.coo_apply import fixed_nnz_left_apply
            s = S.filled(a.device)
            nnz = S.dist.vec_nnz
            sa = fixed_nnz_left_apply(s.rows.reshape(m, nnz),
                                      s.vals.reshape(m, nnz), a, d)
        elif isinstance(S, SparseSkOp) or d * m <= _FOOTPRINT_CAP:
            sa = _matmul(S.materialize(device=a.device).to(a.dtype), a,
                         a.dtype)
        else:
            chunk = max(_FOOTPRINT_CAP // d, 1)
            sa = a.new_zeros((d, a.shape[1]))
            for c0 in range(0, m, chunk):
                mc = min(chunk, m - c0)
                blk = S.submat(d, mc, 0, c0, dtype=a.dtype, device=a.device)
                sa = sa + _matmul(blk, a[c0:c0 + mc], a.dtype)
    return torch.as_tensor(scale, dtype=a.dtype) * sa


def rgs_qr(a: torch.Tensor, state: RNGState, *, d: Optional[int] = None,
           block: int = 64, operator: str = "gaussian", final: str = "orth"
           ) -> Tuple[torch.Tensor, torch.Tensor, RNGState]:
    """QR of a tall matrix by randomized Gram-Schmidt (BG21). Returns
    ``(q, r, next_state)`` with ``a = q @ r`` to roundoff and ``r`` upper
    triangular.

    - ``final='orth'`` (default): one CholQR pass on the sketch-orthonormal
      basis makes Q orthonormal (its Gram is far from singular whatever
      cond(A) is).
    - ``final='sketch'``: Q satisfies (SQ)^T (SQ) = I instead.

    ``d`` is the embedding dimension (default ``2k + 8``, clipped to m);
    ``operator`` the family ('gaussian', 'saso', 'srht'). Rank-deficient
    panels are clipped smoothly (finite output)."""
    require(a.dim() == 2, "rgs_qr takes a matrix")
    m, k = a.shape
    require(k <= m, "rgs_qr factors TALL matrices (k <= m)")
    require(block >= 1, "block must be >= 1")
    require(final in ("orth", "sketch"), "final must be 'orth' or 'sketch'")
    if d is None:
        d = min(m, 2 * k + 8)
    require(k <= d <= m, "need k <= d <= m")
    block = min(block, k)

    from ..dense import isometry_scale_factor
    S = make_embedding(operator, d, m, state, dtype=a.dtype)
    # isometry scale: the sketched inner products approximate the
    # unit-scale ones, E[(cS)^T (cS)] = I
    sa = _precise_sketch(S, a, isometry_scale_factor(S.dist))

    q_buf = a.new_zeros((m, k))
    sq_buf = a.new_zeros((d, k))
    r_buf = a.new_zeros((k, k))
    for col0 in range(0, k, block):
        b = min(block, k - col0)
        _rgs_panel_step(q_buf, sq_buf, r_buf, a[:, col0:col0 + b],
                        sa[:, col0:col0 + b], col0)

    if final == "orth":
        # CholQR on the well-conditioned basis: its Gram's condition number
        # is cond(Q)^2 ~ (1+eps)/(1-eps)
        with _ieee_f32():
            c = _cholesky(q_buf.T @ q_buf)
            q_buf = torch.linalg.solve_triangular(c.T, q_buf, upper=True,
                                                  left=False)
            r_buf = c.T @ r_buf
    return q_buf, r_buf, S.next_state
