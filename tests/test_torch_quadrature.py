"""Stochastic Lanczos quadrature (``slq``, ``logdet``,
``lanczos_fn_apply``) and the spectral densities (``spectral_density``,
``eig_count``, ``kpm_density``) of the port against the JAX package, on the
CPU, with the same numpy-seeded inputs: dense tensors, sparse containers
and callable operators. Each package gets its own ``f`` (``jnp.log`` and
``torch.log``, ...).

Tolerances: Rademacher probes bitwise (through the densities' equal next
states and ``test_rademacher_probes_bitwise`` of test_torch_trace.py);
Lanczos alphas and betas 1e-5 relative to the largest; ``slq``,
``logdet``, ``eig_count``, the densities and their grids 1e-4 relative
(max abs difference over max |want|); ``lanczos_fn_apply`` 1e-4
relative; the Gershgorin enclosure of a COO matrix with duplicate
triplets equal to that of its dense sum; next states equal; validation
messages equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu import linalg as jla
from randblas_tpu.linalg import quadrature as jq
from randblas_tpu.sparse_data.coo import COOMatrix as JCOO
import randblas_tpu_torch as rt
from randblas_tpu_torch import linalg as tla
from randblas_tpu_torch.linalg import density as tdens
from randblas_tpu_torch.linalg import quadrature as tq

REL = 1e-4
LANCZOS_REL = 1e-5
N, STEPS, PROBES = 96, 20, 4


def _states(key=3):
    j = rb.RNGState.from_key(key)
    return j, rt.RNGState.from_dict(j.to_dict())


def _rel(t, j):
    j = np.asarray(j, np.float64)
    t = np.asarray(t, np.float64)
    assert t.shape == j.shape
    return np.abs(t - j).max() / np.abs(j).max()


def _spd(n=N, seed=0, lo=0.5, hi=4.0):
    """A float32 SPD matrix with eigenvalues spread over [lo, hi]."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return ((u * np.linspace(lo, hi, n)) @ u.T).astype(np.float32)


def _operands(a, form):
    """(JAX operand, port operand, n argument) for a dense, sparse or
    callable A."""
    if form == "dense":
        return jnp.asarray(a), torch.from_numpy(a), None
    if form == "sparse":
        s = a.copy()
        s[np.abs(s) < 0.02] = 0.0
        s = (s + s.T) / 2
        return (JCOO.from_dense(jnp.asarray(s)),
                rt.COOMatrix.from_dense(torch.from_numpy(s), device="cpu"),
                None)
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    return (lambda x: ja @ x), (lambda x: ta @ x), a.shape[0]


def _same_error(jfn, tfn):
    """Both raise ValueError with the same requirement message."""
    with pytest.raises(ValueError) as je:
        jfn()
    with pytest.raises(ValueError) as te:
        tfn()
    msg = str(je.value).split("requirement failed: ")[1]
    assert str(te.value).split("requirement failed: ")[1] == msg


def test_block_lanczos_tridiag():
    a = _spd()
    v0 = np.random.default_rng(4).standard_normal((N, PROBES)).astype(
        np.float32)
    ja, jb, jn, _ = jq._block_lanczos_tridiag(
        lambda x: jnp.asarray(a) @ x, jnp.asarray(v0), STEPS)
    ta, tb, tn, basis = tq._block_lanczos_tridiag(
        lambda x: torch.from_numpy(a) @ x, torch.from_numpy(v0), STEPS)
    assert tuple(ta.shape) == (PROBES, STEPS)
    assert tuple(tb.shape) == (PROBES, STEPS - 1)
    assert _rel(ta, ja) <= LANCZOS_REL and _rel(tb, jb) <= LANCZOS_REL
    assert _rel(tn, jn) <= LANCZOS_REL
    # the basis of each probe is orthonormal (the reorthogonalization)
    for j in range(PROBES):
        q = basis[:, :, j].double()
        assert (q @ q.T - torch.eye(STEPS, dtype=torch.float64)).abs().max() \
            < 1e-5


@pytest.mark.parametrize("form", ["dense", "sparse", "callable"])
@pytest.mark.parametrize("fname", ["log", "exp"])
def test_slq(form, fname):
    ja, ta, n = _operands(_spd(), form)
    js, ts = _states(5)
    je, jn = jla.slq(ja, getattr(jnp, fname), js, probes=PROBES,
                     steps=STEPS, n=n)
    te, tn = tla.slq(ta, getattr(torch, fname), ts, probes=PROBES,
                     steps=STEPS, n=n, device="cpu")
    assert abs(float(te) - float(je)) <= REL * abs(float(je))
    assert tn.to_dict() == jn.to_dict()


def test_logdet():
    a = _spd()
    js, ts = _states(6)
    je, jn = jla.logdet(jnp.asarray(a), js, probes=16, steps=STEPS)
    te, tn = tla.logdet(torch.from_numpy(a), ts, probes=16, steps=STEPS)
    assert abs(float(te) - float(je)) <= REL * abs(float(je))
    assert tn.to_dict() == jn.to_dict()
    exact = np.linalg.slogdet(a.astype(np.float64))[1]
    assert abs(float(te) - exact) <= 0.1 * abs(exact)


def test_slq_masks_a_broken_down_lanczos():
    """A rank-4 PSD A exhausts its Krylov space before the depth: ghost
    nodes at 0 carry no weight, and log stays finite in both packages."""
    rng = np.random.default_rng(7)
    g = rng.normal(size=(N, 4))
    a = (g @ g.T + np.eye(N)).astype(np.float32)
    js, ts = _states(8)
    je, _ = jla.slq(jnp.asarray(a), jnp.log, js, probes=PROBES, steps=STEPS)
    te, _ = tla.slq(torch.from_numpy(a), torch.log, ts, probes=PROBES,
                    steps=STEPS)
    assert np.isfinite(float(te))
    assert abs(float(te) - float(je)) <= REL * abs(float(je))


@pytest.mark.parametrize("form", ["dense", "callable"])
@pytest.mark.parametrize("cols", [None, 3])
def test_lanczos_fn_apply(form, cols):
    a = _spd()
    ja, ta, n = _operands(a, form)
    rng = np.random.default_rng(9)
    b = rng.standard_normal((N,) if cols is None else (N, cols)).astype(
        np.float32)
    jx = jla.lanczos_fn_apply(ja, jnp.sqrt, jnp.asarray(b), steps=STEPS,
                              n=n)
    tx = tla.lanczos_fn_apply(ta, torch.sqrt, torch.from_numpy(b),
                              steps=STEPS, n=n)
    assert _rel(tx, jx) <= REL
    w, v = np.linalg.eigh(a.astype(np.float64))
    exact = (v * np.sqrt(w)) @ v.T @ b.astype(np.float64)
    assert _rel(tx, exact) <= 1e-4


@pytest.mark.parametrize("form", ["dense", "sparse", "callable"])
def test_spectral_density(form):
    ja, ta, n = _operands(_spd(), form)
    js, ts = _states(10)
    jg, jd, jn = jla.spectral_density(ja, js, probes=PROBES, steps=STEPS,
                                      npts=101, n=n)
    tg, td, tn = tla.spectral_density(ta, ts, probes=PROBES, steps=STEPS,
                                      npts=101, n=n, device="cpu")
    assert _rel(tg, jg) <= REL and _rel(td, jd) <= REL
    assert tn.to_dict() == jn.to_dict()
    total = np.trapezoid(td.numpy().astype(np.float64), tg.numpy())
    assert abs(total - N) < 0.05 * N


def test_spectral_density_given_grid_and_sigma():
    a = _spd()
    js, ts = _states(11)
    grid = np.linspace(0.0, 4.5, 64).astype(np.float32)
    _, jd, _ = jla.spectral_density(jnp.asarray(a), js, probes=PROBES,
                                    steps=STEPS, grid=jnp.asarray(grid),
                                    sigma=0.1)
    tg, td, _ = tla.spectral_density(torch.from_numpy(a), ts, probes=PROBES,
                                     steps=STEPS, grid=torch.from_numpy(grid),
                                     sigma=0.1)
    np.testing.assert_array_equal(tg.numpy(), grid)
    assert _rel(td, jd) <= REL


def test_eig_count():
    """Three clusters; the interval around the middle one has its ends in
    the gaps."""
    rng = np.random.default_rng(12)
    lam = np.concatenate([-2 + 0.02 * rng.standard_normal(30),
                          0.5 + 0.02 * rng.standard_normal(40),
                          3 + 0.02 * rng.standard_normal(26)])
    u, _ = np.linalg.qr(rng.normal(size=(N, N)))
    a = ((u * lam) @ u.T).astype(np.float32)
    js, ts = _states(13)
    jc, jn = jla.eig_count(jnp.asarray(a), -0.5, 1.5, js, probes=PROBES,
                           steps=STEPS)
    tc, tn = tla.eig_count(torch.from_numpy(a), -0.5, 1.5, ts,
                           probes=PROBES, steps=STEPS)
    assert abs(float(tc) - float(jc)) <= REL * abs(float(jc))
    assert tn.to_dict() == jn.to_dict()
    assert abs(float(tc) - 40) < 0.25 * 40


@pytest.mark.parametrize("form", ["dense", "sparse", "callable"])
def test_kpm_density(form):
    ja, ta, n = _operands(_spd(), form)
    bounds = (0.3, 4.2) if form == "callable" else None
    js, ts = _states(14)
    jg, jd, jn = jla.kpm_density(ja, js, degree=24, probes=PROBES, npts=101,
                                 bounds=bounds, n=n)
    tg, td, tn = tla.kpm_density(ta, ts, degree=24, probes=PROBES, npts=101,
                                 bounds=bounds, n=n, device="cpu")
    assert _rel(tg, jg) <= REL and _rel(td, jd) <= REL
    assert tn.to_dict() == jn.to_dict()


def test_kpm_gershgorin_sums_duplicate_triplets():
    """Duplicate COO triplets add: the sparse enclosure equals the dense
    enclosure of the summed matrix, and both packages' densities agree."""
    a = _spd(16, seed=15)
    r, c = np.nonzero(np.ones_like(a))
    half = a[r, c] / 2
    rows = np.concatenate([r, r]).astype(np.int32)
    cols = np.concatenate([c, c]).astype(np.int32)
    vals = np.concatenate([half, a[r, c] - half]).astype(np.float32)
    tcoo = rt.COOMatrix.from_arrays(16, 16, rows, cols, vals, device="cpu")
    lo, hi = tdens._gershgorin(tcoo, 16)
    dlo, dhi = tdens._gershgorin(torch.from_numpy(a), 16)
    assert abs(float(lo) - float(dlo)) <= 1e-5 * abs(float(dlo))
    assert abs(float(hi) - float(dhi)) <= 1e-5 * abs(float(dhi))
    jcoo = JCOO(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
                16, 16)
    js, ts = _states(16)
    jg, jd, _ = jla.kpm_density(jcoo, js, degree=8, probes=2, npts=33)
    tg, td, _ = tla.kpm_density(tcoo, ts, degree=8, probes=2, npts=33)
    assert _rel(tg, jg) <= REL and _rel(td, jd) <= REL


def test_validation():
    a = _spd(8)
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    jr, tr_ = jnp.asarray(a[:, :6]), torch.from_numpy(a[:, :6])
    js, ts = _states()
    for jfn, tfn in [
        (lambda: jla.slq(jr, jnp.log, js), lambda: tla.slq(tr_, torch.log,
                                                          ts)),
        (lambda: jla.slq(lambda x: x, jnp.log, js),
         lambda: tla.slq(lambda x: x, torch.log, ts, device="cpu")),
        (lambda: jla.slq(ja, jnp.log, js, probes=0),
         lambda: tla.slq(ta, torch.log, ts, probes=0)),
        (lambda: jla.logdet(ja, js, steps=9),
         lambda: tla.logdet(ta, ts, steps=9)),
        (lambda: jla.lanczos_fn_apply(jr, jnp.exp, jnp.ones(8)),
         lambda: tla.lanczos_fn_apply(tr_, torch.exp, torch.ones(8))),
        (lambda: jla.lanczos_fn_apply(ja, jnp.exp, jnp.ones(7)),
         lambda: tla.lanczos_fn_apply(ta, torch.exp, torch.ones(7))),
        (lambda: jla.lanczos_fn_apply(ja, jnp.exp, jnp.ones(8), steps=0),
         lambda: tla.lanczos_fn_apply(ta, torch.exp, torch.ones(8),
                                      steps=0)),
        (lambda: jla.spectral_density(jr, js),
         lambda: tla.spectral_density(tr_, ts)),
        (lambda: jla.spectral_density(ja, js, steps=8, npts=1),
         lambda: tla.spectral_density(ta, ts, steps=8, npts=1)),
        (lambda: jla.eig_count(ja, 1.0, 1.0, js),
         lambda: tla.eig_count(ta, 1.0, 1.0, ts)),
        (lambda: jla.kpm_density(lambda x: x, js, n=8),
         lambda: tla.kpm_density(lambda x: x, ts, n=8, device="cpu")),
        (lambda: jla.kpm_density(ja, js, degree=1),
         lambda: tla.kpm_density(ta, ts, degree=1)),
        (lambda: jla.kpm_density(ja, js, probes=0),
         lambda: tla.kpm_density(ta, ts, probes=0)),
    ]:
        _same_error(jfn, tfn)


def test_callable_operators_make_probes_on_the_card_by_default():
    """A callable holds no tensor: without ``device`` its probes are asked
    of the card, which this host lacks."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ts = _states()[1]
    for fn in (lambda: tla.slq(lambda x: x, torch.log, ts, n=8, steps=4),
               lambda: tla.spectral_density(lambda x: x, ts, n=8, steps=4),
               lambda: tla.kpm_density(lambda x: x, ts, n=8,
                                       bounds=(0.0, 1.0))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
