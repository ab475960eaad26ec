"""The linalg tier's embeddings, CholQR, rangefinders, QB, randomized SVD
and total least squares of the port against the JAX package, on the CPU,
with the same numpy-seeded inputs.

Tolerances:
- singular values: 1e-5 relative to the largest;
- orthonormal bases: as subspaces, max |Q_t Q_t^T - Q_j Q_j^T| <= 1e-4
  (LAPACK builds differ in Householder sign conventions, and a basis is
  only defined up to its span), or, for CholQR (positive Cholesky
  diagonal, so no sign freedom) and the SVD factors (up to column signs),
  1e-5 of max |want|;
- solutions (TLS, ``qr_clipped_lstsq``): 1e-5 relative (norm);
- the certificates of ``adaptive_rangefinder`` and
  ``range_error_estimate``: 2e-4 relative (see CERT_TOL);
- embeddings: the operators' entries exactly (Gaussian ones 1e-6 of max
  |want|: sin/cos/log a libm ulp apart); next states equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu import linalg as jla
from randblas_tpu.linalg import qb as jqb
from randblas_tpu.sparse_data.coo import COOMatrix as JCOO
import randblas_tpu_torch as rt
from randblas_tpu_torch import linalg as tla
from randblas_tpu_torch.linalg import qb as tqb

SUB_TOL = 1e-4
# a certificate is the norm of a probe's residual past the captured range,
# a difference of O(1) terms: float32 rounding of the terms (eps ||y||)
# over a residual of ~1e-2 ||y|| gives ~1e-5 relative, the Gaussian probes
# a libm ulp apart as much again
CERT_TOL = 2e-4


def _states(key=3):
    j = rb.RNGState.from_key(key)
    return j, rt.RNGState.from_dict(j.to_dict())


def _lowrank(m=200, n=60, k=12, seed=0, tail=1e-3):
    """A float32 (m, n) matrix with k singular values in [0.5, 1] and a tail
    at ``tail``: a gap after k, so a rank-k range is well defined."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.concatenate([np.logspace(0, -0.3, k),
                        tail * np.logspace(0, -1, n - k)])
    return ((u * s) @ v.T).astype(np.float32)


def _sub(qt, qj):
    qt = qt.numpy().astype(np.float64)
    qj = np.asarray(qj, np.float64)
    assert qt.shape == qj.shape
    return np.abs(qt @ qt.T - qj @ qj.T).max()


def _rel(t, j):
    j = np.asarray(j)
    return np.linalg.norm(t.numpy() - j) / np.linalg.norm(j)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got / np.abs(want).max(),
                               want / np.abs(want).max(), rtol=0, atol=tol)


def _signs_aligned(t, j, axis):
    """t with each column (axis 0) or row (axis 1) flipped to j's sign."""
    dots = (t.numpy() * np.asarray(j)).sum(axis=axis)
    s = torch.from_numpy(np.where(dots < 0, -1.0, 1.0).astype(np.float32))
    return t * (s[None, :] if axis == 0 else s[:, None])


def test_linalg_exports_this_slice():
    """Groups 1-5 of the JAX package's linalg tier and the distributed
    layer's five names: exactly 81 names, each one of
    ``randblas_tpu.linalg.__all__`` and each importable."""
    group1 = {
        "make_embedding", "cholqr", "rangefinder", "qb_decompose",
        "qb_to_svd", "adaptive_rangefinder", "range_error_estimate", "rsvd",
        "rsvd_adaptive", "cgls", "sketch_and_solve_lsq",
        "sketch_and_precondition", "min_norm_lsq", "ridge_lsq", "ihs_lsq",
        "tls_via_svd", "sketched_tls"}
    group2 = {
        "nystrom", "nystrom_apply", "nystrom_pcg", "hutchinson", "hutchpp",
        "xtrace", "xdiag", "diag_hutchinson", "exact_trace",
        "rademacher_probes", "leverage_scores", "exact_leverage_scores",
        "power_method", "spectral_norm", "extremal_eigs", "sketched_eigs",
        "required_power_iters", "rand_eigh", "rand_geigh"}
    group3 = {
        "krylov_rangefinder", "rsvd_krylov", "sgmres", "rgs_qr",
        "rpcholesky", "rpcholesky_pcg", "sketch_qrcp", "column_id", "cur",
        "amm", "sample_lsq", "random_fourier_features"}
    group4 = {
        "StreamingSketch", "FrequentDirections", "fd_pass", "single_pass_svd",
        "slq", "logdet", "lanczos_fn_apply", "kpm_density",
        "spectral_density", "eig_count", "block_kaczmarz",
        "block_gauss_seidel"}
    group5 = {
        "TTTensor", "TTMatrix", "TTStream", "tt_from_dense", "tt_gaussian",
        "tt_matrix_gaussian", "tt_add", "tt_dot", "tt_norm", "tt_scale",
        "tt_round", "tt_round_deterministic", "tt_matvec", "tt_single_pass",
        "tucker_from_dense", "tucker_full"}
    distributed = {
        "distributed_fd", "distributed_krylov_rangefinder", "distributed_qb",
        "distributed_rangefinder", "distributed_rsvd"}
    assert len(tla.__all__) == 81
    assert set(tla.__all__) == (group1 | group2 | group3 | group4 | group5
                                | distributed)
    assert set(tla.__all__) <= set(jla.__all__)
    assert all(callable(getattr(tla, name)) for name in tla.__all__)
    assert set(rb.__all__) <= set(rt.__all__)


def test_only_the_distributed_names_are_left():
    """With the distributed layer's five names, the port's linalg exports
    exactly the JAX package's names: none is left."""
    assert set(jla.__all__) == set(tla.__all__)
    assert len(jla.__all__) == len(tla.__all__)


@pytest.mark.parametrize("family,kind", [("saso", rt.SparseSkOp),
                                         ("gaussian", rt.DenseSkOp),
                                         ("srht", rt.TrigSkOp)])
def test_make_embedding(family, kind):
    js, ts = _states(4)
    jS = jla.make_embedding(family, 12, 50, js, vec_nnz=20)
    tS = tla.make_embedding(family, 12, 50, ts, vec_nnz=20)
    assert isinstance(tS, kind) and tS.shape == (12, 50)
    # Gaussian entries go through sin/cos/log, a libm ulp apart
    _close(tS.materialize(device="cpu"), jS.materialize(),
           1e-6 if family == "gaussian" else 0.0)
    assert tS.next_state.to_dict() == jS.next_state.to_dict()
    with pytest.raises(ValueError, match="unknown embedding"):
        tla.make_embedding("fft", 4, 8, ts)


@pytest.mark.parametrize("dtype,shift", [("float32", 0.0), ("float64", 0.0),
                                         ("float32", 1e-6)])
def test_cholqr(dtype, shift):
    y = np.random.default_rng(1).standard_normal((100, 8)).astype(dtype)
    qj, rj = jla.cholqr(jnp.asarray(y), shift=shift)
    qt, rr = tla.cholqr(torch.from_numpy(y), shift=shift)
    tol = 1e-5 if dtype == "float32" else 1e-12
    _close(qt, qj, tol)
    _close(rr, rj, tol)
    q = qt.numpy().astype(np.float64)
    assert np.abs(q.T @ q - np.eye(8)).max() <= 100 * np.finfo(dtype).eps


def test_cholqr_rescues_rank_deficiency():
    """A repeated column: the plain Cholesky fails, the shifted one is
    taken, and Q R still gives y back, in both packages."""
    y = np.random.default_rng(2).standard_normal((100, 8)).astype(np.float32)
    y[:, 3] = y[:, 2]
    for q, r in (tla.cholqr(torch.from_numpy(y)),
                 jla.cholqr(jnp.asarray(y))):
        q, r = np.asarray(q), np.asarray(r)
        assert np.isfinite(q).all() and np.isfinite(r).all()
        np.testing.assert_allclose(q @ r, y, atol=1e-4)
    with pytest.raises(ValueError):
        tla.cholqr(torch.ones(3))


@pytest.mark.parametrize("operator", ["gaussian", "saso", "srht"])
@pytest.mark.parametrize("orth", ["cholqr", "qr"])
@pytest.mark.parametrize("stabilizer", [None, "qr", "lu", "none"])
def test_rangefinder(operator, orth, stabilizer):
    a = _lowrank()
    js, ts = _states()
    qj = jla.rangefinder(jnp.asarray(a), 12, js, operator=operator,
                         orth=orth, stabilizer=stabilizer)
    qt = tla.rangefinder(torch.from_numpy(a), 12, ts, operator=operator,
                         orth=orth, stabilizer=stabilizer)
    assert _sub(qt, qj) <= SUB_TOL
    q = qt.numpy().astype(np.float64)
    assert np.abs(q.T @ q - np.eye(12)).max() <= 1e-5


def test_lu_stabilizer_spans_the_block():
    y = np.random.default_rng(3).standard_normal((40, 6)).astype(np.float32)
    got = tqb._stabilize(torch.from_numpy(y), "lu")
    want = jqb._stabilize(jnp.asarray(y), "lu")
    _close(got, want)
    # P L U == y
    lu_u = torch.linalg.lu_factor(torch.from_numpy(y))[0][:6].triu()
    np.testing.assert_allclose((got @ lu_u).numpy(), y, atol=1e-5)


def test_qb_and_svd_on_sparse_data():
    a = _lowrank(seed=1)
    a[np.abs(a) < 0.02] = 0.0
    js, ts = _states(5)
    qj, bj = jla.qb_decompose(JCOO.from_dense(jnp.asarray(a)), 12, js)
    coo = rt.COOMatrix.from_dense(torch.from_numpy(a))
    qt, bt = tla.qb_decompose(coo, 12, ts)
    assert _sub(qt, qj) <= SUB_TOL
    _close(qt @ bt, np.asarray(qj) @ np.asarray(bj))
    with pytest.raises(ValueError, match="gaussian"):
        tla.rangefinder(coo, 12, ts, operator="srht")


@pytest.mark.parametrize("operator", ["gaussian", "srht"])
def test_qb_to_svd_and_rsvd(operator):
    a = _lowrank(seed=2)
    js, ts = _states(6)
    qj, bj = jla.qb_decompose(jnp.asarray(a), 12, js, operator=operator)
    qt, bt = tla.qb_decompose(torch.from_numpy(a), 12, ts, operator=operator)
    _close(qt @ bt, np.asarray(qj) @ np.asarray(bj))
    uj, sj, vj = jla.qb_to_svd(qj, bj)
    ut, st, vt = tla.qb_to_svd(qt, bt)
    _close(st, sj)
    uj, sj, vj = jla.rsvd(jnp.asarray(a), 8, js, operator=operator)
    ut, st, vt = tla.rsvd(torch.from_numpy(a), 8, ts, operator=operator)
    assert ut.shape == (200, 8) and st.shape == (8,) and vt.shape == (8, 60)
    _close(st, sj)
    _close(_signs_aligned(ut, uj, 0), uj, 1e-4)
    _close(_signs_aligned(vt, vj, 1), vj, 1e-4)
    with pytest.raises(ValueError):
        tla.rsvd(torch.from_numpy(a), 58, ts)


@pytest.mark.parametrize("tol", [0.05, 1e-9])
def test_adaptive_rangefinder_and_rsvd_adaptive(tol):
    """A reachable tol stops at the range; an unreachable one runs to the
    cap or to a captured range, in both packages alike."""
    a = _lowrank(seed=3)
    js, ts = _states(7)
    qj, bj, nj = jla.adaptive_rangefinder(jnp.asarray(a), tol, js,
                                          max_rank=32)
    qt, bt, nt = tla.adaptive_rangefinder(torch.from_numpy(a), tol, ts,
                                          max_rank=32)
    assert qt.shape == qj.shape and nt.to_dict() == nj.to_dict()
    assert _sub(qt, qj) <= SUB_TOL
    assert abs(float(bt) - float(bj)) <= CERT_TOL * float(bj)
    uj, sj, vj, bdj, _ = jla.rsvd_adaptive(jnp.asarray(a), tol, js,
                                           max_rank=32)
    ut, st, vt, bdt, _ = tla.rsvd_adaptive(torch.from_numpy(a), tol, ts,
                                           max_rank=32)
    _close(st, sj)


def test_range_error_estimate():
    a = _lowrank(seed=4)
    js, ts = _states(8)
    q = np.linalg.qr(a[:, :12])[0].astype(np.float32)
    bj, nj = jla.range_error_estimate(jnp.asarray(a), jnp.asarray(q), js)
    bt, nt = tla.range_error_estimate(torch.from_numpy(a),
                                      torch.from_numpy(q), ts)
    assert bt.dtype == torch.float32 and nt.to_dict() == nj.to_dict()
    assert abs(float(bt) - float(bj)) <= CERT_TOL * float(bj)


def test_qr_clipped_lstsq():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((30, 6)).astype(np.float32)
    a[:, 5] = 0.0                             # a zero column is clipped
    for b in (rng.standard_normal(30).astype(np.float32),
              rng.standard_normal((30, 2)).astype(np.float32)):
        got = tqb.qr_clipped_lstsq(torch.from_numpy(a), torch.from_numpy(b))
        want = jqb.qr_clipped_lstsq(jnp.asarray(a), jnp.asarray(b))
        assert _rel(got, want) <= 1e-5
        assert torch.all(got[5] == 0.0) or float(got[5].abs().max()) < 1e-6
    # the all-zero system solves to 0, not NaN
    zero = tqb.qr_clipped_lstsq(torch.zeros(8, 3), torch.ones(8))
    assert torch.equal(zero, torch.zeros(3))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("family", ["gaussian", "saso"])
def test_tls(dtype, family):
    rng = np.random.default_rng(10)
    m, n = 400, 8
    a = rng.standard_normal((m, n))
    x = rng.standard_normal(n)
    ab = np.column_stack([a + 1e-3 * rng.standard_normal((m, n)),
                          a @ x + 1e-3 * rng.standard_normal(m)]).astype(
                              dtype)
    tol = 1e-5 if dtype == "float32" else 1e-10
    assert _rel(tla.tls_via_svd(torch.from_numpy(ab)),
                jla.tls_via_svd(jnp.asarray(ab))) <= tol
    js, ts = _states(11)
    if family == "gaussian":
        jS = rb.DenseSkOp(rb.DenseDist(40, m), js, dtype=getattr(jnp, dtype))
        tS = rt.DenseSkOp(rt.DenseDist(40, m), ts, dtype=getattr(torch, dtype))
    else:
        jS = rb.SparseSkOp(rb.SparseDist(40, m, 4), js)
        tS = rt.SparseSkOp(rt.SparseDist(40, m, 4), ts)
    got = tla.sketched_tls(tS, torch.from_numpy(ab))
    assert _rel(got, jla.sketched_tls(jS, jnp.asarray(ab))) <= tol
    assert np.linalg.norm(got.numpy() - x) <= 0.05 * np.linalg.norm(x)
    with pytest.raises(ValueError):
        tla.sketched_tls(rt.DenseSkOp(rt.DenseDist(5, m), ts),
                         torch.from_numpy(ab))


def test_make_matvec():
    """Dense float32 (the precise product), float64, sparse and callable
    operators give A @ v as in the JAX package."""
    a = _lowrank(m=40, n=30, k=5, seed=12)
    v = np.random.default_rng(13).standard_normal(30).astype(np.float32)
    a[np.abs(a) < 0.01] = 0.0
    cases = [(jnp.asarray(a), torch.from_numpy(a), v),
             (jnp.asarray(a, jnp.float64), torch.from_numpy(a).double(),
              v.astype(np.float64)),
             (JCOO.from_dense(jnp.asarray(a)),
              rt.COOMatrix.from_dense(torch.from_numpy(a)), v)]
    for ja, ta, vv in cases:
        _close(tqb.make_matvec(ta)(torch.from_numpy(vv)),
               jqb.make_matvec(ja)(jnp.asarray(vv)), 1e-6)
    f = tqb.make_matvec(lambda x: 2 * x)
    assert torch.equal(f(torch.ones(3)), torch.full((3,), 2.0))
