"""Approximate matrix multiplication, leverage-score row sampling, the
sketched QRCP / column ID / CUR and random Fourier features of the port
against the JAX package, on the CPU, with the same numpy-seeded inputs.

Tolerances: sampled indices bitwise given the same cdf; estimates and
solutions 1e-5 relative (norm); QRCP pivots equal on spectra without near
ties (columns scaled apart); the ID coefficients and CUR's U 1e-4 relative
(k x k solves, CUR's through normal equations, of float32 factors that
agree to ~1e-6); random Fourier features 1e-5 absolute (|z| <=
sqrt(2/D)); next states equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu import linalg as jla
from randblas_tpu.sparse_data.coo import COOMatrix as JCOO
import randblas_tpu_torch as rt
from randblas_tpu_torch import linalg as tla

REL = 1e-5
SOLVE_REL = 1e-4


def _states(key=3):
    j = rb.RNGState.from_key(key)
    return j, rt.RNGState.from_dict(j.to_dict())


def _rel(t, j):
    j = np.asarray(j, np.float64)
    return np.linalg.norm(t.numpy().astype(np.float64) - j) / np.linalg.norm(j)


def test_amm_indices_bitwise_given_the_cdf():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(20, 300)).astype(np.float32)
    b = rng.normal(size=(300, 15)).astype(np.float32)
    w = np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=1)
    cdf = np.array(rb.weights_to_cdf(jnp.asarray(w)))
    js, ts = _states(4)
    ji, jn = rb.sample_indices_iid(cdf, 120, js)
    ti, tn = rt.sample_indices_iid(torch.from_numpy(cdf), 120, ts)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tn.to_dict() == jn.to_dict()


@pytest.mark.parametrize("s", [1, 64, 500])
def test_amm(s):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(24, 400)).astype(np.float32)
    b = (rng.normal(size=(400, 18)) * np.logspace(0, -2, 18)).astype(
        np.float32)
    js, ts = _states(5)
    je, jn = jla.amm(jnp.asarray(a), jnp.asarray(b), s, js)
    te, tn = tla.amm(torch.from_numpy(a), torch.from_numpy(b), s, ts)
    assert _rel(te, je) <= REL
    assert tn.to_dict() == jn.to_dict()


def test_amm_zero_product_and_nan():
    a = np.zeros((5, 30), np.float32)
    b = np.random.default_rng(2).normal(size=(30, 4)).astype(np.float32)
    te, tn = tla.amm(torch.from_numpy(a), torch.from_numpy(b), 10,
                     _states(6)[1])
    je, jn = jla.amm(jnp.asarray(a), jnp.asarray(b), 10, _states(6)[0])
    assert not te.any() and tn.to_dict() == jn.to_dict()
    a[2, 3] = np.nan
    with pytest.raises(ValueError):    # the cdf's check sees the NaN
        tla.amm(torch.from_numpy(a), torch.from_numpy(b), 10, _states(6)[1])


@pytest.mark.parametrize("scores,lam,k_rhs", [("estimate", 0.5, None),
                                              ("exact", 0.9, 2),
                                              ("estimate", 0.0, None),
                                              ("estimate", 1.0, None)])
def test_sample_lsq(scores, lam, k_rhs):
    rng = np.random.default_rng(7)
    m, n = 600, 12
    a = (rng.normal(size=(m, n)) * np.logspace(0, -1, n)).astype(np.float32)
    a[:4] *= 10.0
    b = (a @ rng.normal(size=(n,) if k_rhs is None else (n, k_rhs))
         + 1e-2 * rng.normal(size=(m,) if k_rhs is None else (m, k_rhs))
         ).astype(np.float32)
    js, ts = _states(8)
    jkw, tkw = {"lam": lam}, {"lam": lam}
    if scores == "exact":
        sc = np.array(jla.exact_leverage_scores(jnp.asarray(a)))
        jkw["scores"], tkw["scores"] = jnp.asarray(sc), torch.from_numpy(sc)
    jx, jn = jla.sample_lsq(jnp.asarray(a), jnp.asarray(b), 100, js, **jkw)
    tx, tn = tla.sample_lsq(torch.from_numpy(a), torch.from_numpy(b), 100,
                            ts, **tkw)
    assert _rel(tx, jx) <= REL
    assert tn.to_dict() == jn.to_dict()


def _columns_apart(m=120, n=50, k=6, seed=9):
    """A float32 (m, n) matrix of rank ~k whose columns have norms scaled
    apart (no near ties for the pivoting) plus a small tail."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, k)) @ rng.normal(size=(k, n))
    a = a * np.logspace(0, -1.5, n)[rng.permutation(n)]
    return (a + 1e-4 * rng.normal(size=(m, n))).astype(np.float32)


def _data(a, sparse):
    if sparse:
        return (JCOO.from_dense(jnp.asarray(a)),
                rt.COOMatrix.from_dense(torch.from_numpy(a), device="cpu"))
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("stabilizer", [None, "lu"])
def test_sketch_qrcp(sparse, stabilizer):
    ja, ta = _data(_columns_apart(), sparse)
    js, ts = _states(10)
    jq, jb, jp = jla.sketch_qrcp(ja, 6, js, stabilizer=stabilizer)
    tq, tb, tp = tla.sketch_qrcp(ta, 6, ts, stabilizer=stabilizer)
    np.testing.assert_array_equal(tp[:6], jp[:6])
    assert sorted(tp.tolist()) == list(range(50))
    assert _rel(tb, jb) <= 1e-4


@pytest.mark.parametrize("sparse", [False, True])
def test_column_id(sparse):
    ja, ta = _data(_columns_apart(), sparse)
    js, ts = _states(11)
    jj, jz = jla.column_id(ja, 6, js)
    tj, tz = tla.column_id(ta, 6, ts)
    np.testing.assert_array_equal(tj, jj)
    assert _rel(tz, jz) <= SOLVE_REL
    np.testing.assert_allclose(tz.numpy()[:, tj], np.eye(6), atol=1e-4)


@pytest.mark.parametrize("sparse,operator", [(False, "gaussian"),
                                             (True, "gaussian"),
                                             (False, "saso"),
                                             (False, "srht")])
def test_cur(sparse, operator):
    a = _columns_apart(m=64, n=48)
    ja, ta = _data(a, sparse)
    js, ts = _states(12)
    ji, jj, ju = jla.cur(ja, 6, js, operator=operator)
    ti, tj, tu = tla.cur(ta, 6, ts, operator=operator)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tj, jj)
    assert _rel(tu, ju) <= SOLVE_REL
    approx = a[:, tj] @ tu.numpy() @ a[ti, :]
    assert np.linalg.norm(approx - a) <= 1e-2 * np.linalg.norm(a)


def test_onehot():
    from randblas_tpu.linalg.qrcp import _onehot as jonehot
    from randblas_tpu_torch.linalg.qrcp import _onehot as tonehot
    idx = np.array([3, 0, 7])
    np.testing.assert_array_equal(tonehot(idx, 9, torch.float32).numpy(),
                                  np.asarray(jonehot(idx, 9, jnp.float32)))


@pytest.mark.parametrize("n_features,bandwidth", [(64, 1.0), (256, 3.0),
                                                  (33, 0.5)])
def test_random_fourier_features(n_features, bandwidth):
    x = np.random.default_rng(13).normal(size=(40, 7)).astype(np.float32)
    js, ts = _states(14)
    jz, jn = jla.random_fourier_features(jnp.asarray(x), n_features,
                                         bandwidth, js)
    tz, tn = tla.random_fourier_features(torch.from_numpy(x), n_features,
                                         bandwidth, ts)
    assert tz.shape == (40, n_features)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=0, atol=1e-5)
    assert tn.to_dict() == jn.to_dict()
