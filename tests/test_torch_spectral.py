"""The spectral tools, the block-Krylov SVD and sketched GMRES of the port
against the JAX package, on the CPU, with the same numpy-seeded inputs.

Tolerances: ``required_power_iters`` equal; eigenvalues and singular
values 1e-5 relative to the largest; the Krylov rangefinder's kept column
count equal and its basis as a subspace (max |Q_t Q_t^T - Q_j Q_j^T| <=
1e-4); the truncated Arnoldi basis and its image 1e-4 of max |want| (twelve
steps of float32 rounding in two orders); ``sgmres`` solutions 1e-5 relative; ``sketched_eigs(sym=False)``
Ritz values 1e-4 relative (a nonsymmetric eigenproblem of an
ill-conditioned float32 pencil, solved in float64); ``qb.safe_svd``
against numpy's float64 singular values within 20 eps of the largest, its
factors orthonormal and the reconstruction within 50 eps; next states
equal.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu import linalg as jla
from randblas_tpu.sparse_data.coo import COOMatrix as JCOO
import randblas_tpu_torch as rt
from randblas_tpu_torch import linalg as tla

# the modules, not the functions of the same name that linalg exports
jsg = importlib.import_module("randblas_tpu.linalg.sgmres")
tsg = importlib.import_module("randblas_tpu_torch.linalg.sgmres")

REL = 1e-5
RITZ_REL = 1e-4
SUB_TOL = 1e-4
N = 96


def _states(key=3):
    j = rb.RNGState.from_key(key)
    return j, rt.RNGState.from_dict(j.to_dict())


def _psd(n=N, seed=0, top=(4.0, 2.0, 1.0), floor=0.05):
    """A float32 SPD matrix with a few separated top eigenvalues over a
    flat floor: the power method converges in a few dozen steps."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.full(n, floor)
    lam[:len(top)] = top
    lam[-1] = floor / 4
    return ((u * lam) @ u.T).astype(np.float32)


def _lowrank(m=150, n=60, k=10, seed=1, tail=1e-2):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(m, n)))
    v, _ = np.linalg.qr(rng.normal(size=(n, n)))
    s = np.concatenate([np.logspace(0, -0.5, k),
                        tail * np.logspace(0, -1, n - k)])
    return ((u * s) @ v.T).astype(np.float32)


def _system(n=N, seed=2):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n)) / np.sqrt(n) + 4 * np.eye(n)
    return a.astype(np.float32), rng.normal(size=n).astype(np.float32)


def _close(t, j, tol=REL):
    j = np.asarray(j, np.float64)
    t = (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
         ).astype(np.float64)
    assert np.abs(t - j).max() <= tol * np.abs(j).max(), \
        np.abs(t - j).max() / np.abs(j).max()


def _sub(t, j):
    t = t.numpy().astype(np.float64)
    j = np.asarray(j, np.float64)
    assert t.shape == j.shape
    return np.abs(t @ t.T - j @ j.T).max()


@pytest.mark.parametrize("n,p_fail,tol", [(10, 1e-3, 1e-1),
                                          (1000, 1e-6, 1e-2),
                                          (4096, 1e-6, 1e-2),
                                          (10 ** 6, 1e-9, 1e-3)])
def test_required_power_iters(n, p_fail, tol):
    assert tla.required_power_iters(n, p_fail, tol) == \
        jla.required_power_iters(n, p_fail, tol)


def test_power_method():
    a = _psd()
    js, ts = _states(4)
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    jl, jv, jn = jla.power_method(lambda v: aj @ v, N, js, iters=60)
    tl, tv, tn = tla.power_method(lambda v: at @ v, N, ts, iters=60,
                                  device="cpu")
    _close(tl, jl)
    _close(tv * torch.sign((tv * torch.from_numpy(np.array(jv))).sum()),
           jv, 1e-4)
    assert tn.to_dict() == jn.to_dict()


@pytest.mark.parametrize("form", ["dense", "dense_singular", "sparse",
                                  "callable"])
def test_extremal_eigs(form):
    a = _psd()
    if form == "dense_singular":     # the Cholesky fails: complement path
        a[:, 0] = a[0, :] = 0.0
    js, ts = _states(5)
    kw = {"iters": 150}
    if form == "sparse":
        ja = JCOO.from_dense(jnp.asarray(a))
        ta = rt.COOMatrix.from_dense(torch.from_numpy(a), device="cpu")
    elif form == "callable":
        aj, at = jnp.asarray(a), torch.from_numpy(a)
        ja, ta = (lambda v: aj @ v), (lambda v: at @ v)
        kw["n"] = N
    else:
        ja, ta = jnp.asarray(a), torch.from_numpy(a)
    jlo, jhi, jn = jla.extremal_eigs(ja, js, **kw)
    tlo, thi, tn = tla.extremal_eigs(
        ta, ts, **kw, **({"device": "cpu"} if form == "callable" else {}))
    _close(thi, jhi)
    assert abs(float(tlo) - float(jlo)) <= REL * float(jhi)
    assert tn.to_dict() == jn.to_dict()


@pytest.mark.parametrize("sparse", [False, True])
def test_spectral_norm(sparse):
    a = _lowrank()
    js, ts = _states(6)
    if sparse:
        a[np.abs(a) < 0.01] = 0.0
        ja = JCOO.from_dense(jnp.asarray(a))
        ta = rt.COOMatrix.from_dense(torch.from_numpy(a), device="cpu")
    else:
        ja, ta = jnp.asarray(a), torch.from_numpy(a)
    js_, jn = jla.spectral_norm(ja, js, iters=200)
    ts_, tn = tla.spectral_norm(ta, ts, iters=200)
    _close(ts_, js_)
    assert tn.to_dict() == jn.to_dict()


@pytest.mark.parametrize("form", ["dense", "sparse", "callable"])
def test_sketched_eigs_sym(form):
    a = _psd()
    js, ts = _states(7)
    kw = {}
    if form == "sparse":
        ja = JCOO.from_dense(jnp.asarray(a))
        ta = rt.COOMatrix.from_dense(torch.from_numpy(a), device="cpu")
    elif form == "callable":
        aj, at = jnp.asarray(a), torch.from_numpy(a)
        ja, ta = (lambda v: aj @ v), (lambda v: at @ v)
        kw["n"] = N
    else:
        ja, ta = jnp.asarray(a), torch.from_numpy(a)
    jt, jx, jr, jn = jla.sketched_eigs(ja, 3, js, basis=24, sym=True, **kw)
    tt, tx, tr, tn = tla.sketched_eigs(
        ta, 3, ts, basis=24, sym=True,
        **kw, **({"device": "cpu"} if form == "callable" else {}))
    _close(tt, jt)
    assert _sub(tx, jx) <= SUB_TOL
    assert tn.to_dict() == jn.to_dict()


@pytest.mark.parametrize("operator", ["saso", "gaussian", "srht"])
@pytest.mark.parametrize("which", ["LM", "LR"])
def test_sketched_eigs_nonsym(operator, which):
    a, _ = _system()
    js, ts = _states(8)
    jt, jx, jr, jn = jla.sketched_eigs(jnp.asarray(a), 4, js, basis=40,
                                       operator=operator, which=which)
    tt, tx, tr, tn = tla.sketched_eigs(torch.from_numpy(a), 4, ts, basis=40,
                                       operator=operator, which=which)
    jt = np.asarray(jt)
    assert tt.dtype == torch.complex128 and tx.shape == (N, 4)
    assert np.abs(tt.numpy() - jt).max() <= RITZ_REL * np.abs(jt).max()
    assert tn.to_dict() == jn.to_dict()


def test_truncated_arnoldi():
    a, b = _system()
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    jq, jaq = jsg._truncated_arnoldi(lambda v: aj @ v, jnp.asarray(b), 12, 3)
    tq, taq = tsg._truncated_arnoldi(lambda v: at @ v, torch.from_numpy(b),
                                     12, 3)
    _close(tq, jq, 1e-4)
    _close(taq, jaq, 1e-4)


def test_truncated_arnoldi_zeroes_an_invariant_column():
    """A = I makes span{b, Ab} one-dimensional: the second column falls to
    the rounding floor and is zeroed, in both packages."""
    b = np.random.default_rng(3).normal(size=20).astype(np.float32)
    tq, _ = tsg._truncated_arnoldi(lambda v: v, torch.from_numpy(b), 4, 2)
    jq, _ = jsg._truncated_arnoldi(lambda v: v, jnp.asarray(b), 4, 2)
    assert not tq[:, 1:].any() and not np.asarray(jq)[:, 1:].any()


@pytest.mark.parametrize("form,operator,refine", [
    ("dense", "saso", 1), ("sparse", "saso", 1), ("callable", "saso", 1),
    ("dense", "gaussian", 0), ("dense", "srht", 2)])
def test_sgmres(form, operator, refine):
    a, b = _system()
    js, ts = _states(9)
    if form == "sparse":
        a[np.abs(a) < 0.05] = 0.0
        ja = JCOO.from_dense(jnp.asarray(a))
        ta = rt.COOMatrix.from_dense(torch.from_numpy(a), device="cpu")
    elif form == "callable":
        aj, at = jnp.asarray(a), torch.from_numpy(a)
        ja, ta = (lambda v: aj @ v), (lambda v: at @ v)
    else:
        ja, ta = jnp.asarray(a), torch.from_numpy(a)
    jx, jres, jn = jla.sgmres(ja, jnp.asarray(b), js, basis=30,
                              operator=operator, refine=refine)
    tx, tres, tn = tla.sgmres(ta, torch.from_numpy(b), ts, basis=30,
                              operator=operator, refine=refine)
    jx = np.asarray(jx)
    assert np.linalg.norm(tx.numpy() - jx) <= REL * np.linalg.norm(jx)
    assert abs(float(tres) - float(jres)) <= 1e-2 * float(jres) + 1e-6
    assert tn.to_dict() == jn.to_dict()


def test_thin_embedding_warns():
    a, b = _system()
    with pytest.warns(UserWarning, match="oversampling"):
        tla.sgmres(torch.from_numpy(a), torch.from_numpy(b), _states()[1],
                   basis=20, d=21)


@pytest.mark.parametrize("operator", ["gaussian", "saso", "srht"])
@pytest.mark.parametrize("depth", [0, 2])
def test_krylov_rangefinder(operator, depth):
    a = _lowrank()
    js, ts = _states(10)
    jq = jla.krylov_rangefinder(jnp.asarray(a), 6, js, depth=depth,
                                operator=operator)
    tq = tla.krylov_rangefinder(torch.from_numpy(a), 6, ts, depth=depth,
                                operator=operator)
    assert tq.shape == jq.shape                   # the same keep counts
    assert _sub(tq, jq) <= SUB_TOL


def test_krylov_rangefinder_stops_when_the_range_is_captured():
    """A of exact rank 5 in float64: the second block has nothing left, so
    both packages stop at the first block's kept columns."""
    rng = np.random.default_rng(11)
    a = rng.normal(size=(80, 5)) @ rng.normal(size=(5, 40))
    js, ts = _states(12)
    jq = jla.krylov_rangefinder(jnp.asarray(a), 8, js, depth=3,
                                dtype=jnp.float64)
    tq = tla.krylov_rangefinder(torch.from_numpy(a), 8, ts, depth=3,
                                dtype=torch.float64)
    assert tq.shape == jq.shape and tq.shape[1] <= 8


@pytest.mark.parametrize("sparse", [False, True])
def test_rsvd_krylov(sparse):
    a = _lowrank()
    js, ts = _states(13)
    if sparse:
        a[np.abs(a) < 0.01] = 0.0
        ja = JCOO.from_dense(jnp.asarray(a))
        ta = rt.COOMatrix.from_dense(torch.from_numpy(a), device="cpu")
    else:
        ja, ta = jnp.asarray(a), torch.from_numpy(a)
    ju, jsv, jvt = jla.rsvd_krylov(ja, 8, js, depth=2)
    tu, tsv, tvt = tla.rsvd_krylov(ta, 8, ts, depth=2)
    _close(tsv, jsv)
    assert _sub(tu, ju) <= SUB_TOL
    assert _sub(tvt.T, np.asarray(jvt).T) <= SUB_TOL


def test_rsvd_krylov_pads_a_low_rank_input():
    rng = np.random.default_rng(14)
    a = (rng.normal(size=(60, 3)) @ rng.normal(size=(3, 30)))
    js, ts = _states(15)
    ju, jsv, jvt = jla.rsvd_krylov(jnp.asarray(a), 6, js, depth=1,
                                   dtype=jnp.float64)
    tu, tsv, tvt = tla.rsvd_krylov(torch.from_numpy(a), 6, ts, depth=1,
                                   dtype=torch.float64)
    assert tu.shape == ju.shape and tvt.shape == jvt.shape
    _close(tsv, jsv, math.sqrt(REL))


@pytest.mark.parametrize("shape,dtype", [((200, 30), torch.float32),
                                         ((30, 200), torch.float32),
                                         ((40, 40), torch.float32),
                                         ((90, 12), torch.float64)])
def test_safe_svd(shape, dtype):
    """The thin SVD through Householder QR and a float64 SVD of the small
    factor: the singular values of numpy's float64 SVD, orthonormal
    factors and the reconstruction, to the input's precision."""
    from randblas_tpu_torch.linalg.qb import safe_svd
    rng = np.random.default_rng(16)
    x = (rng.normal(size=shape) * np.logspace(0, -3, shape[1])).astype(
        np.float32 if dtype == torch.float32 else np.float64)
    u, s, vt = safe_svd(torch.from_numpy(x))
    k = min(shape)
    assert u.shape == (shape[0], k) and vt.shape == (k, shape[1])
    assert u.dtype == s.dtype == vt.dtype == dtype
    eps = torch.finfo(dtype).eps
    _close(s, np.linalg.svd(x.astype(np.float64), compute_uv=False),
           20 * eps)
    eye = torch.eye(k, dtype=dtype)
    assert (u.T @ u - eye).abs().max() <= 50 * eps
    assert (vt @ vt.T - eye).abs().max() <= 50 * eps
    assert ((u * s) @ vt - torch.from_numpy(x)).abs().max() <= \
        50 * eps * np.abs(x).max()
