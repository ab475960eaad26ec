"""Nystrom and its PCG, the randomized eigensolvers and RPCholesky of the
port against the JAX package, on the CPU, with the same numpy-seeded
inputs.

Tolerances: eigenvalues (lam, w, theta) 1e-5 relative to the largest;
bases as subspaces, max |U_t U_t^T - U_j U_j^T| <= 1e-4 (LAPACK sign and
rotation freedom inside a basis); PCG solutions 1e-5 relative with the
iteration counts within 1; RPCholesky's pivots bitwise given JAX's cdf, and
F F^T 1e-5 relative; next states equal.
"""

import importlib

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
jrpc = importlib.import_module("randblas_tpu.linalg.rpcholesky")
trpc = importlib.import_module("randblas_tpu_torch.linalg.rpcholesky")

REL = 1e-5
SUB_TOL = 1e-4
ITER_SLACK = 1


def _states(key=3):
    j = rb.RNGState.from_key(key)
    return j, rt.RNGState.from_dict(j.to_dict())


def _psd(n=80, rank=None, seed=0, shift=0.0):
    """A float32 PSD matrix with eigenvalues 2^(-i/4) (the first ``rank``
    of them, when given) plus ``shift`` I."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = 2.0 ** (-np.arange(n) / 4.0)
    if rank is not None:
        lam[rank:] = 0.0
    return ((u * lam) @ u.T + shift * np.eye(n)).astype(np.float32)


def _sym(n=80, seed=1):
    """A symmetric indefinite float32 matrix with a decaying +- spectrum."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = 2.0 ** (-np.arange(n) / 4.0) * np.where(np.arange(n) % 3, 1, -1)
    return ((u * lam) @ u.T).astype(np.float32)


def _rel_vals(t, j):
    j = np.asarray(j, np.float64)
    return np.abs(t.numpy().astype(np.float64) - j).max() / np.abs(j).max()


def _sub(t, j):
    t = t.numpy().astype(np.float64)
    j = np.asarray(j, np.float64)
    return np.abs(t @ t.T - j @ j.T).max()


def _rel(t, j):
    j = np.asarray(j, np.float64)
    return np.linalg.norm(t.numpy() - j) / np.linalg.norm(j)


@pytest.mark.parametrize("form", ["dense", "sparse", "callable"])
def test_nystrom(form):
    a = _psd(rank=12)
    js, ts = _states(4)
    if form == "dense":
        ja, ta, kw = jnp.asarray(a), torch.from_numpy(a), {}
    elif form == "sparse":
        ja = JCOO.from_dense(jnp.asarray(a))
        ta = rt.COOMatrix.from_dense(torch.from_numpy(a), device="cpu")
        kw = {}
    else:
        aj, at = jnp.asarray(a), torch.from_numpy(a)
        ja, ta = (lambda x: aj @ x), (lambda x: at @ x)
        kw = {"n": 80}
    ju, jl, jn = jla.nystrom(ja, 16, js, **kw)
    tu, tl, tn = tla.nystrom(ta, 16, ts, device="cpu", **kw)
    assert _rel_vals(tl, jl) <= REL
    # the captured rank-12 range as subspaces
    assert _sub(tu[:, :12], np.asarray(ju)[:, :12]) <= SUB_TOL
    assert tn.to_dict() == jn.to_dict()
    x = np.random.default_rng(2).normal(size=(80, 3)).astype(np.float32)
    want = np.asarray(jla.nystrom_apply(ju, jl, jnp.asarray(x)))
    got = tla.nystrom_apply(tu, tl, torch.from_numpy(x))
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("form,mu,k_rhs", [("dense", 1e-3, None),
                                           ("dense", 1e-2, 3),
                                           ("callable", 1e-3, None),
                                           ("dense_rank_deficient", 0.0,
                                            None)])
def test_nystrom_pcg(form, mu, k_rhs):
    rank = 20 if form == "dense_rank_deficient" else None
    a = _psd(n=120, rank=rank, shift=0.0 if rank else 1e-2)
    rng = np.random.default_rng(3)
    if rank:     # b in range(A): the warm start is the solution
        b = a @ rng.normal(size=120).astype(np.float32)
    else:
        b = rng.normal(size=(120,) if k_rhs is None else (120, k_rhs))
    b = b.astype(np.float32)
    if form == "callable":
        aj, at = jnp.asarray(a), torch.from_numpy(a)
        ja, ta = (lambda x: aj @ x), (lambda x: at @ x)
    else:
        ja, ta = jnp.asarray(a), torch.from_numpy(a)
    js, ts = _states(5)
    jx, jk, jn = jla.nystrom_pcg(ja, jnp.asarray(b), js, d=30, mu=mu,
                                 tol=1e-6)
    tx, tk, tn = tla.nystrom_pcg(ta, torch.from_numpy(b), ts, d=30, mu=mu,
                                 tol=1e-6)
    assert _rel(tx, jx) <= REL
    assert abs(int(tk) - int(jk)) <= ITER_SLACK
    assert tn.to_dict() == jn.to_dict()


@pytest.mark.parametrize("operator", ["gaussian", "saso", "srht"])
def test_rand_eigh(operator):
    a = _sym()
    js, ts = _states(6)
    jw, ju = jla.rand_eigh(jnp.asarray(a), 12, js, operator=operator)
    tw, tu = tla.rand_eigh(torch.from_numpy(a), 12, ts, operator=operator)
    assert _rel_vals(tw, jw) <= REL
    # the well-separated dominant eigenvectors (|w| > 0.3) as a subspace
    top = np.abs(np.asarray(jw)) > 0.3
    assert _sub(tu[:, torch.from_numpy(top)], np.asarray(ju)[:, top]) \
        <= SUB_TOL


def test_rand_geigh():
    n, k = 96, 6
    rng = np.random.default_rng(7)
    g = rng.normal(size=(n, n))
    b = (g @ g.T / n + np.eye(n)).astype(np.float32)
    ell = np.linalg.cholesky(b.astype(np.float64))
    u, _ = np.linalg.qr(rng.normal(size=(n, k)))
    a = (ell @ ((u * np.linspace(5.0, -3.0, k)) @ u.T) @ ell.T).astype(
        np.float32)
    js, ts = _states(8)
    jw, jx = jla.rand_geigh(jnp.asarray(a), jnp.asarray(b), k, js)
    tw, tx = tla.rand_geigh(torch.from_numpy(a), torch.from_numpy(b), k, ts)
    assert _rel_vals(tw, jw) <= REL
    # B-orthonormal eigenvectors of distinct eigenvalues: equal up to sign
    jx = np.asarray(jx)
    signs = np.sign((tx.numpy() * jx).sum(axis=0))
    assert _rel_vals(tx * torch.from_numpy(signs.astype(np.float32)),
                     jx) <= 1e-4


def test_inv_sqrt_psd():
    rng = np.random.default_rng(9)
    g = rng.normal(size=(8, 5)).astype(np.float32)
    h = g @ g.T                                      # rank 5 of 8
    want = np.asarray(jrpc._inv_sqrt_psd(jnp.asarray(h)))
    got = trpc._inv_sqrt_psd(torch.from_numpy(h))
    assert _rel_vals(got, want) <= REL


def test_pivots_bitwise_given_jax_cdf():
    """The port's sampler on JAX's cdf of a residual diagonal draws JAX's
    pivots: the cdfs of ``jnp.cumsum`` and ``torch.cumsum`` may differ by
    ulps, the sampling given one cdf may not."""
    d = np.abs(np.random.default_rng(10).normal(size=300)).astype(np.float32)
    cdf = jnp.cumsum(jnp.asarray(d))
    cdf = np.asarray(cdf / cdf[-1])
    js, ts = _states(11)
    ji, jn = rb.sample_indices_iid(cdf, 64, js)
    ti, tn = rt.sample_indices_iid(torch.from_numpy(cdf.copy()), 64, ts)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tn.to_dict() == jn.to_dict()


@pytest.mark.parametrize("form,block", [("dense", None), ("dense", 7),
                                        ("oracle", 10)])
def test_rpcholesky(form, block):
    a = _psd(n=90, shift=1e-3)
    js, ts = _states(12)
    if form == "oracle":
        aj, at = jnp.asarray(a), torch.from_numpy(a)
        jf, jp, jn = jla.rpcholesky(lambda idx: aj[:, idx], 24, js,
                                    block=block, n=90, diag=jnp.diagonal(aj))
        tf, tp, tn = tla.rpcholesky(lambda idx: at[:, idx.long()], 24, ts,
                                    block=block, n=90,
                                    diag=torch.diagonal(at))
    else:
        jf, jp, jn = jla.rpcholesky(jnp.asarray(a), 24, js, block=block)
        tf, tp, tn = tla.rpcholesky(torch.from_numpy(a), 24, ts, block=block)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    jf = np.asarray(jf, np.float64)
    tf = tf.numpy().astype(np.float64)
    assert (np.abs(tf @ tf.T - jf @ jf.T).max()
            <= REL * np.abs(jf @ jf.T).max())
    assert tn.to_dict() == jn.to_dict()


@pytest.mark.parametrize("mu,k_rhs", [(1e-3, None), (1e-2, 2)])
def test_rpcholesky_pcg(mu, k_rhs):
    a = _psd(n=120, shift=1e-2)
    rng = np.random.default_rng(13)
    b = rng.normal(size=(120,) if k_rhs is None else (120, k_rhs)).astype(
        np.float32)
    js, ts = _states(14)
    jx, jk, jn = jla.rpcholesky_pcg(jnp.asarray(a), jnp.asarray(b), js,
                                    rank=30, mu=mu, tol=1e-6)
    tx, tk, tn = tla.rpcholesky_pcg(torch.from_numpy(a), torch.from_numpy(b),
                                    ts, rank=30, mu=mu, tol=1e-6)
    assert _rel(tx, jx) <= REL
    assert abs(int(tk) - int(jk)) <= ITER_SLACK
    assert tn.to_dict() == jn.to_dict()
