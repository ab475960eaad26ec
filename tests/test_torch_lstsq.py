"""The sketched least-squares solvers of the port against the JAX package,
on the CPU, with the same numpy-seeded inputs.

Tolerances: solutions 1e-5 relative (norm) on systems of condition 10,
the CGLS and CG solvers run to tol=1e-6 so that both stop past the
difference of their float32 roundings; CGLS / CG iteration counts within
2 of JAX's; next states equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu import linalg as jla
from randblas_tpu.linalg import lstsq as jlsq
from randblas_tpu.sparse_data.coo import COOMatrix as JCOO
import randblas_tpu_torch as rt
from randblas_tpu_torch import linalg as tla
from randblas_tpu_torch.linalg import lstsq as tlsq

X_TOL = 1e-5
ITER_SLACK = 2
EMBEDDINGS = ("saso", "gaussian", "srht")


def _states(key=3):
    j = rb.RNGState.from_key(key)
    return j, rt.RNGState.from_dict(j.to_dict())


def _tall(m=300, n=20, cond=10.0, noise=1e-4, seed=0, k_rhs=None):
    """A float32 (m, n) system with singular values in [1/cond, 1], a
    planted solution and a little noise, and its right-hand side."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(m, n)))
    v, _ = np.linalg.qr(rng.normal(size=(n, n)))
    a = (u * np.logspace(0, -np.log10(cond), n)) @ v.T
    shape = (n,) if k_rhs is None else (n, k_rhs)
    b = a @ rng.normal(size=shape) + noise * rng.normal(
        size=(m,) + shape[1:])
    return a.astype(np.float32), b.astype(np.float32)


def _sparse(a):
    a = a.copy()
    a[np.abs(a) < 0.05] = 0.0
    return a


def _rel(t, j):
    j = np.asarray(j)
    return np.linalg.norm(t.numpy() - j) / np.linalg.norm(j)


def _pair(a, sparse):
    if sparse:
        return (JCOO.from_dense(jnp.asarray(a)),
                rt.COOMatrix.from_dense(torch.from_numpy(a)))
    return jnp.asarray(a), torch.from_numpy(a)


def _check(name, jres, tres, iters_at=None):
    """Same solution, next state and (where given) iteration count."""
    xt, xj = tres[0], jres[0]
    assert xt.shape == tuple(xj.shape) and xt.dtype == torch.float32
    assert _rel(xt, xj) <= X_TOL, name
    assert tres[-1].to_dict() == jres[-1].to_dict()
    if iters_at is not None:
        assert abs(int(tres[iters_at]) - int(jres[iters_at])) <= ITER_SLACK


CASES = [(op, False) for op in EMBEDDINGS] + [("saso", True),
                                               ("gaussian", True)]


@pytest.mark.parametrize("operator,sparse", CASES)
def test_sketch_and_solve(operator, sparse):
    a, b = _tall()
    if sparse:
        a = _sparse(a)
    (ja, ta), (js, ts) = _pair(a, sparse), _states()
    _check("sas", jla.sketch_and_solve_lsq(ja, jnp.asarray(b), 60, js,
                                           operator=operator),
           tla.sketch_and_solve_lsq(ta, torch.from_numpy(b), 60, ts,
                                    operator=operator))


@pytest.mark.parametrize("operator,sparse", CASES)
@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
def test_sketch_and_precondition(operator, sparse, warm):
    a, b = _tall(seed=1)
    if sparse:
        a = _sparse(a)
    (ja, ta), (js, ts) = _pair(a, sparse), _states(4)
    kw = dict(operator=operator, warm_start=warm, tol=1e-6)
    _check("sap", jla.sketch_and_precondition(ja, jnp.asarray(b), js, **kw),
           tla.sketch_and_precondition(ta, torch.from_numpy(b), ts, **kw), 1)


@pytest.mark.parametrize("operator,sparse", CASES)
def test_min_norm_lsq(operator, sparse):
    a, _ = _tall(seed=2)
    a = np.ascontiguousarray(a.T)                 # wide: 20 x 300
    if sparse:
        a = _sparse(a)
    b = (a @ np.random.default_rng(5).normal(size=300)).astype(np.float32)
    (ja, ta), (js, ts) = _pair(a, sparse), _states(5)
    kw = dict(operator=operator, tol=1e-6)
    _check("min_norm", jla.min_norm_lsq(ja, jnp.asarray(b), js, **kw),
           tla.min_norm_lsq(ta, torch.from_numpy(b), ts, **kw), 1)


@pytest.mark.parametrize("operator,sparse", CASES)
def test_ridge_lsq(operator, sparse):
    a, b = _tall(seed=3)
    if sparse:
        a = _sparse(a)
    (ja, ta), (js, ts) = _pair(a, sparse), _states(6)
    kw = dict(operator=operator, tol=1e-6)
    _check("ridge", jla.ridge_lsq(ja, jnp.asarray(b), 0.1, js, **kw),
           tla.ridge_lsq(ta, torch.from_numpy(b), 0.1, ts, **kw), 1)


@pytest.mark.parametrize("operator,sparse", CASES)
def test_ihs_lsq(operator, sparse):
    a, b = _tall(seed=4)
    if sparse:
        a = _sparse(a)
    (ja, ta), (js, ts) = _pair(a, sparse), _states(7)
    _check("ihs", jla.ihs_lsq(ja, jnp.asarray(b), js, operator=operator),
           tla.ihs_lsq(ta, torch.from_numpy(b), ts, operator=operator))


def test_block_right_hand_sides():
    a, b = _tall(seed=5, k_rhs=3)
    (ja, ta), (js, ts) = _pair(a, False), _states(8)
    _check("sap block", jla.sketch_and_precondition(ja, jnp.asarray(b), js,
                                                    tol=1e-6),
           tla.sketch_and_precondition(ta, torch.from_numpy(b), ts,
                                       tol=1e-6), 1)
    _check("ihs block", jla.ihs_lsq(ja, jnp.asarray(b), js),
           tla.ihs_lsq(ta, torch.from_numpy(b), ts))


@pytest.mark.parametrize("x0", [False, True])
def test_cgls_and_pcg(x0):
    a, b = _tall(seed=6, cond=30.0)
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    start = np.full(20, 0.1, np.float32)
    kw_j = dict(x0=jnp.asarray(start)) if x0 else {}
    kw_t = dict(x0=torch.from_numpy(start)) if x0 else {}
    xj, kj, gj = jla.cgls(lambda y: ja @ y, lambda r: ja.T @ r,
                          jnp.asarray(b), 20, tol=1e-6, maxiter=400, **kw_j)
    xt, kt, gt = tla.cgls(lambda y: ta @ y, lambda r: ta.T @ r,
                          torch.from_numpy(b), 20, tol=1e-6, maxiter=400,
                          **kw_t)
    assert _rel(xt, xj) <= X_TOL and abs(kt - int(kj)) <= ITER_SLACK
    assert gt.shape == (1,)
    g = a.T @ a
    bb = np.random.default_rng(7).normal(size=(20, 2)).astype(np.float32)
    jg, tg = jnp.asarray(g), torch.from_numpy(g)
    xj, kj = jlsq._pcg(lambda v: jg @ v, jnp.asarray(bb), tol=1e-6,
                       maxiter=200)
    xt, kt = tlsq._pcg(lambda v: tg @ v, torch.from_numpy(bb), tol=1e-6,
                       maxiter=200)
    assert _rel(xt, xj) <= X_TOL and abs(kt - int(kj)) <= ITER_SLACK


def test_divergence_guards_return_the_best_iterate():
    """Unreachable tolerances (the JAX package's TestDivergenceGuard): CGLS
    ends at its best iterate before maxiter instead of iterating past
    working precision into divergence, and so does min_norm_lsq's CG."""
    a, b = _tall(m=600, n=40, cond=1e4, noise=1e-3, seed=11)
    x, iters, _ = tla.ridge_lsq(torch.from_numpy(a), torch.from_numpy(b),
                                0.01, _states(10)[1], tol=1e-7, maxiter=200)
    an, bn = a.astype(np.float64), b.astype(np.float64)
    x_ref = np.linalg.solve(an.T @ an + 0.01 * np.eye(40), an.T @ bn)
    assert np.abs(x.numpy() - x_ref).max() < 1e-3 and iters < 200
    rng = np.random.default_rng(12)
    aw = torch.from_numpy(rng.normal(size=(40, 300)).astype(np.float32))
    bw = torch.from_numpy(rng.normal(size=40).astype(np.float32))
    xm, _, _ = tla.min_norm_lsq(aw, bw, _states(11)[1], tol=1e-10,
                                maxiter=300)
    assert float(torch.linalg.norm(aw @ xm - bw) / torch.linalg.norm(bw)) \
        < 1e-4


def test_validation():
    a, b = _tall(m=40, n=20)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ts = _states()[1]
    # ihs_lsq refuses m <= n before the clamp of d to m
    sq = torch.from_numpy(a[:20])
    with pytest.raises(ValueError, match="strictly tall"):
        tla.ihs_lsq(sq, tb[:20], ts)
    with pytest.raises(ValueError, match="strictly tall"):
        tla.ihs_lsq(ta.T.contiguous(), tb[:20], ts)
    # the JAX package's message for the same square system names d instead
    with pytest.raises(ValueError, match="exceed n"):
        jla.ihs_lsq(jnp.asarray(a[:20]), jnp.asarray(b[:20]), _states()[0])
    for call in (lambda: tla.sketch_and_solve_lsq(ta, tb, 10, ts),
                 lambda: tla.sketch_and_precondition(ta.T, tb[:20], ts),
                 lambda: tla.min_norm_lsq(ta, tb, ts),
                 lambda: tla.ridge_lsq(ta, tb, -1.0, ts),
                 lambda: tla.ihs_lsq(ta, tb, ts, iters=0)):
        with pytest.raises(ValueError):
            call()
    coo = rt.COOMatrix.from_dense(ta)
    with pytest.raises(ValueError, match="SRHT"):
        tla.sketch_and_solve_lsq(coo, tb, 30, ts, operator="srht")
    # on a mesh, as in the JAX package: the SRHT is column-sharded only,
    # and sparse data rides the Gaussian operator; both checks come before
    # the mesh is used
    js = _states()[0]
    for fn, jfn in ((tla.sketch_and_precondition, jla.sketch_and_precondition),
                    (tla.ridge_lsq, jla.ridge_lsq),
                    (tla.ihs_lsq, jla.ihs_lsq)):
        targs = (ta, tb, 0.1, ts) if fn is tla.ridge_lsq else (ta, tb, ts)
        jargs = ((jnp.asarray(a), jnp.asarray(b), 0.1, js)
                 if fn is tla.ridge_lsq else (jnp.asarray(a), jnp.asarray(b),
                                              js))
        for f, args in ((fn, targs), (jfn, jargs)):
            with pytest.raises(ValueError, match="'saso' and 'gaussian'"):
                f(*args, operator="srht", mesh=object())
    jcoo = JCOO.from_dense(jnp.asarray(a))
    for f, args in ((tla.sketch_and_solve_lsq, (coo, tb, 30, ts)),
                    (jla.sketch_and_solve_lsq, (jcoo, jnp.asarray(b), 30,
                                                js))):
        with pytest.raises(ValueError, match="use operator='gaussian'"):
            f(*args, operator="saso", mesh=object())
