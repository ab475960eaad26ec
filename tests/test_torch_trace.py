"""The trace and diagonal estimators and the leverage scores of the port
against the JAX package, on the CPU, with the same numpy-seeded inputs:
dense tensors, sparse containers and callable operators.

Tolerances: Rademacher probes bitwise; estimates 1e-5 relative (the
XTrace standard error, a spread of nearly equal float32 estimates, 1e-5
relative to the estimate); diagonals 1e-5 of max |want|; leverage scores
1e-5 relative per row; next states equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu import linalg as jla
from randblas_tpu.linalg import trace as jtrace
from randblas_tpu.sparse_data.coo import COOMatrix as JCOO
import randblas_tpu_torch as rt
from randblas_tpu_torch import linalg as tla
from randblas_tpu_torch.linalg import trace as ttrace

REL = 1e-5
N = 64


def _states(key=3):
    j = rb.RNGState.from_key(key)
    return j, rt.RNGState.from_dict(j.to_dict())


def _psd(n=N, seed=0, decay=8.0):
    """A float32 symmetric PSD matrix with eigenvalues 2^(-i/decay)."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return ((u * 2.0 ** (-np.arange(n) / decay)) @ u.T).astype(np.float32)


def _nonsym(n=N, seed=1):
    rng = np.random.default_rng(seed)
    return (_psd(n, seed) + 0.05 * rng.normal(size=(n, n))).astype(np.float32)


def _operands(a, form):
    """(JAX operand, port operand) for a dense, sparse or callable A."""
    if form == "dense":
        return jnp.asarray(a), torch.from_numpy(a)
    if form == "sparse":
        s = a.copy()
        s[np.abs(s) < 0.02] = 0.0
        return (JCOO.from_dense(jnp.asarray(s)),
                rt.COOMatrix.from_dense(torch.from_numpy(s), device="cpu"))
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    return (lambda x: ja @ x), (lambda x: ta @ x)


def _rel(t, j):
    j = np.asarray(j, np.float64)
    t = t.numpy().astype(np.float64)
    return np.abs(t - j).max() / np.abs(j).max()


def test_rademacher_probes_bitwise():
    js, ts = _states(4)
    jv, jn = jla.rademacher_probes(50, 7, js)
    tv, tn = tla.rademacher_probes(50, 7, ts, device="cpu")
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert set(np.unique(tv.numpy())) == {-1.0, 1.0}
    assert tn.to_dict() == jn.to_dict()


def test_callable_operators_make_probes_on_the_card_by_default():
    """A callable holds no tensor: without ``device`` its probes are asked
    of the card, which this host lacks."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tla.hutchinson(lambda x: x, 8, 4, _states()[1])


@pytest.mark.parametrize("form", ["dense", "sparse", "callable"])
@pytest.mark.parametrize("name,budget", [("hutchinson", 12),
                                         ("hutchpp", 30)])
def test_hutchinson_and_hutchpp(form, name, budget):
    a = _psd()
    ja, ta = _operands(a, form)
    js, ts = _states(5)
    kw = {"device": "cpu"} if form == "callable" else {}
    jest, jn = getattr(jla, name)(ja, N, budget, js)
    test, tn = getattr(tla, name)(ta, N, budget, ts, **kw)
    assert abs(float(test) - float(jest)) <= REL * abs(float(jest))
    assert tn.to_dict() == jn.to_dict()


@pytest.mark.parametrize("form", ["dense", "sparse", "callable"])
@pytest.mark.parametrize("budget", [8, 24])
def test_xtrace(form, budget):
    a = _nonsym() if form != "callable" else _psd()
    ja, ta = _operands(a, form)
    js, ts = _states(6)
    kw = {"device": "cpu"} if form == "callable" else {}
    jest, jse, jn = jla.xtrace(ja, N, budget, js)
    test, tse, tn = tla.xtrace(ta, N, budget, ts, **kw)
    assert abs(float(test) - float(jest)) <= REL * abs(float(jest))
    assert abs(float(tse) - float(jse)) <= REL * abs(float(jest))
    assert tn.to_dict() == jn.to_dict()


@pytest.mark.parametrize("form", ["dense", "sparse", "callable"])
def test_diag_hutchinson(form):
    a = _psd()
    ja, ta = _operands(a, form)
    js, ts = _states(7)
    kw = {"device": "cpu"} if form == "callable" else {}
    jd, jn = jla.diag_hutchinson(ja, N, 10, js)
    td, tn = tla.diag_hutchinson(ta, N, 10, ts, **kw)
    assert _rel(td, jd) <= REL
    assert tn.to_dict() == jn.to_dict()


@pytest.mark.parametrize("form", ["dense", "sparse", "callable",
                                  "callable_rmatvec"])
def test_xdiag(form):
    a = _nonsym() if form in ("dense", "sparse", "callable_rmatvec") \
        else _psd()
    ja, ta = _operands(a, "callable" if form == "callable_rmatvec" else form)
    js, ts = _states(8)
    jkw, tkw = {}, {}
    if form.startswith("callable"):
        tkw["device"] = "cpu"
    if form == "callable_rmatvec":
        at_j, at_t = jnp.asarray(a.T.copy()), torch.from_numpy(a.T.copy())
        jkw["rmatvec"] = lambda x: at_j @ x
        tkw["rmatvec"] = lambda x: at_t @ x
    jd, jn = jla.xdiag(ja, N, 24, js, **jkw)
    td, tn = tla.xdiag(ta, N, 24, ts, **tkw)
    assert _rel(td, jd) <= REL
    assert tn.to_dict() == jn.to_dict()


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_exact_trace(form):
    a = _nonsym()
    ja, ta = _operands(a, form)
    assert abs(float(tla.exact_trace(ta)) - float(jla.exact_trace(ja))) \
        <= REL * abs(float(jla.exact_trace(ja)))


def test_loo_directions_on_a_rank_deficient_r():
    """The floored diagonal keeps the solve finite where R is singular."""
    rng = np.random.default_rng(9)
    r = np.triu(rng.normal(size=(6, 6))).astype(np.float32)
    r[4, 4] = 0.0
    r[5, 5] = 1e-30
    want = np.asarray(jtrace._loo_directions(jnp.asarray(r)))
    got = ttrace._loo_directions(torch.from_numpy(r))
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("operator", ["saso", "gaussian", "srht"])
@pytest.mark.parametrize("jl_dim", [0, 6])
def test_leverage_scores(operator, jl_dim):
    rng = np.random.default_rng(10)
    a = (rng.normal(size=(400, 16))
         * np.logspace(0, -1, 16)).astype(np.float32)
    a[:5] *= 20.0                      # a few high-leverage rows
    js, ts = _states(11)
    jsc, jn = jla.leverage_scores(jnp.asarray(a), js, jl_dim=jl_dim,
                                  operator=operator)
    tsc, tn = tla.leverage_scores(torch.from_numpy(a), ts, jl_dim=jl_dim,
                                  operator=operator)
    jsc = np.asarray(jsc, np.float64)
    np.testing.assert_allclose(tsc.numpy(), jsc, rtol=REL, atol=0)
    assert tn.to_dict() == jn.to_dict()


def test_exact_leverage_scores():
    a = np.random.default_rng(12).normal(size=(120, 10)).astype(np.float32)
    want = np.asarray(jla.exact_leverage_scores(jnp.asarray(a)))
    got = tla.exact_leverage_scores(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    assert abs(got.sum() - 10.0) < 1e-4
