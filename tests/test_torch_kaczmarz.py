"""Block Kaczmarz and block Gauss-Seidel of the port against the JAX
package, on the CPU, with the same numpy-seeded inputs.

The data's entries are -1, 0 and 1, so every row and column norm is a
small integer: the weights' partial sums are exact in float32, the two
packages' cdfs are equal and the importance-sampled indices are bitwise
(``weights_to_cdf``'s cumulative sums are otherwise up to 2 ulp apart).

Tolerances: sampled indices and the shuffle's permutation bitwise; next
states equal; the damped Gram solve 1e-5 relative on a nonsingular Gram
(finite on a singular one); solutions x within
1e-4 of max |x| of the JAX package's (48 float32 steps of products and
Cholesky solves, summed in other orders); duplicate indices of an iid
Gauss-Seidel block each applied (``index_add_``), as JAX's ``.at[].add``
does; validation messages equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu import linalg as jla
from randblas_tpu.linalg import kaczmarz as jk
import randblas_tpu_torch as rt
from randblas_tpu_torch import linalg as tla
from randblas_tpu_torch.linalg import kaczmarz as tk

REL = 1e-4
M, N = 256, 32


def _states(key=3):
    j = rb.RNGState.from_key(key)
    return j, rt.RNGState.from_dict(j.to_dict())


def _rel(t, j):
    j = np.asarray(j, np.float64)
    t = np.asarray(t, np.float64)
    assert t.shape == j.shape
    return np.abs(t - j).max() / np.abs(j).max()


def _system(m=M, n=N, seed=0, consistent=True):
    """A with entries in {-1, 0, 1} (integer row and column norms), x_true
    and b = A x_true (plus noise when not consistent)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-1, 2, size=(m, n)).astype(np.float32)
    xt = rng.standard_normal(n).astype(np.float32)
    b = a @ xt
    if not consistent:
        b = b + rng.standard_normal(m).astype(np.float32)
    return a, xt, b.astype(np.float32)


def _same_error(jfn, tfn):
    """Both raise ValueError with the same requirement message."""
    with pytest.raises(ValueError) as je:
        jfn()
    with pytest.raises(ValueError) as te:
        tfn()
    msg = str(je.value).split("requirement failed: ")[1]
    assert str(te.value).split("requirement failed: ")[1] == msg


@pytest.mark.parametrize("weighted", [False, True])
def test_sample_blocks_bitwise(weighted):
    a, _, _ = _system()
    w = (a * a).sum(axis=1) if weighted else None
    js, ts = _states(4)
    ji, jn = jk._sample_blocks(None if w is None else jnp.asarray(w), M, 6,
                               16, js)
    ti, tn = tk._sample_blocks(None if w is None else torch.from_numpy(w), M,
                               6, 16, ts, "cpu")
    assert tuple(ti.shape) == (6, 16) and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tn.to_dict() == jn.to_dict()


def test_damped_spd_solve():
    rng = np.random.default_rng(5)
    p = rng.standard_normal((12, 20)).astype(np.float32)
    p[3] = p[7]                                  # a duplicated row: singular
    g = p @ p.T
    rhs = rng.standard_normal(12).astype(np.float32)
    jy = jk._damped_spd_solve(jnp.asarray(g), jnp.asarray(rhs))
    ty = tk._damped_spd_solve(torch.from_numpy(g), torch.from_numpy(rhs))
    # y's part along e_3 - e_7 is set by the eps-scale damping alone (a
    # 1/eps condition number): finite in both packages, not comparable
    assert torch.isfinite(ty).all() and np.isfinite(np.asarray(jy)).all()
    g2 = g + np.eye(12, dtype=np.float32)
    assert _rel(tk._damped_spd_solve(torch.from_numpy(g2),
                                     torch.from_numpy(rhs)),
                jk._damped_spd_solve(jnp.asarray(g2), jnp.asarray(rhs))) \
        <= 1e-5
    ty2 = tk._damped_spd_solve(torch.from_numpy(g),
                               torch.from_numpy(rhs)[:, None])
    assert torch.equal(ty2[:, 0], ty)
    zero = tk._damped_spd_solve(torch.zeros(4, 4), torch.zeros(4))
    assert torch.equal(zero, torch.zeros(4))


@pytest.mark.parametrize("sampling", ["rownorm", "uniform"])
@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_block_kaczmarz(sampling, rhs):
    a, xt, b = _system()
    if rhs == "matrix":
        b = np.stack([b, 2 * b], axis=1)
    js, ts = _states(6)
    jx, jn = jla.block_kaczmarz(jnp.asarray(a), jnp.asarray(b), js,
                                block=32, steps=24, sampling=sampling)
    tx, tn = tla.block_kaczmarz(torch.from_numpy(a), torch.from_numpy(b), ts,
                                block=32, steps=24, sampling=sampling)
    assert _rel(tx, jx) <= REL
    assert tn.to_dict() == jn.to_dict()
    x1 = tx if rhs == "vector" else tx[:, 0]
    assert np.linalg.norm(x1.numpy() - xt) <= 1e-3 * np.linalg.norm(xt)


def test_block_kaczmarz_from_x0():
    a, xt, b = _system()
    x0 = np.ones(N, np.float32)
    js, ts = _states(7)
    jx, _ = jla.block_kaczmarz(jnp.asarray(a), jnp.asarray(b), js, block=16,
                               steps=8, x0=jnp.asarray(x0))
    tx, _ = tla.block_kaczmarz(torch.from_numpy(a), torch.from_numpy(b), ts,
                               block=16, steps=8, x0=torch.from_numpy(x0))
    assert _rel(tx, jx) <= REL


@pytest.mark.parametrize("sampling", ["shuffle", "colnorm", "uniform"])
def test_block_gauss_seidel(sampling):
    """Least squares of an inconsistent system, the block not dividing n
    (the shuffle pads phantom columns), from zero and from an x0."""
    a, _, b = _system(consistent=False)
    x0 = np.full(N, 0.5, np.float32)
    xls = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                          rcond=None)[0]
    for start in (None, x0):
        js, ts = _states(8)
        jx, jn = jla.block_gauss_seidel(
            jnp.asarray(a), jnp.asarray(b), js, block=12, steps=48,
            sampling=sampling, x0=None if start is None else jnp.asarray(x0))
        tx, tn = tla.block_gauss_seidel(
            torch.from_numpy(a), torch.from_numpy(b), ts, block=12,
            steps=48, sampling=sampling,
            x0=None if start is None else torch.from_numpy(x0))
        assert _rel(tx, jx) <= REL
        assert tn.to_dict() == jn.to_dict()
    assert np.linalg.norm(tx.numpy() - xls) <= 5e-3 * np.linalg.norm(xls)


def test_shuffle_permutation_bitwise():
    """The shuffle's column order: a stable argsort of the same Uniform
    row in both packages."""
    js, ts = _states(9)
    ju = rb.DenseSkOp(rb.DenseDist(1, 50, rb.DenseDistName.Uniform), js)
    tu = rt.DenseSkOp(rt.DenseDist(1, 50, rt.DenseDistName.Uniform), ts)
    jp = np.asarray(jnp.argsort(ju.materialize()[0]))
    tp = torch.argsort(tu.materialize(device="cpu")[0], stable=True)
    np.testing.assert_array_equal(tp.numpy(), jp)


def test_gauss_seidel_applies_every_duplicate_index():
    """n = 6 columns in blocks of 6 iid draws: nearly every block repeats a
    column. Each copy's share of the damped step is added (index_add_), as
    JAX's .at[].add does; an indexed += would keep one copy."""
    a, _, b = _system(64, 6, seed=11, consistent=False)
    js, ts = _states(10)
    idx, _ = tk._sample_blocks(None, 6, 4, 6, ts, "cpu")
    assert any(len(set(r.tolist())) < 6 for r in idx)
    jx, _ = jla.block_gauss_seidel(jnp.asarray(a), jnp.asarray(b), js,
                                   block=6, steps=4, sampling="uniform")
    tx, _ = tla.block_gauss_seidel(torch.from_numpy(a), torch.from_numpy(b),
                                   ts, block=6, steps=4, sampling="uniform")
    assert _rel(tx, jx) <= REL
    # the first step by hand: from x = 0, r = b
    jx1 = idx[0].long()
    panel = torch.from_numpy(a).T[jx1]
    dx = tk._damped_spd_solve(panel @ panel.T, panel @ torch.from_numpy(b))
    x1, _ = tla.block_gauss_seidel(torch.from_numpy(a), torch.from_numpy(b),
                                   ts, block=6, steps=1, sampling="uniform")
    assert torch.allclose(x1, torch.zeros(6).index_add(0, jx1, dx),
                          rtol=1e-6, atol=1e-6)
    dropped = torch.zeros(6)
    dropped[jx1] += dx
    assert not torch.allclose(x1, dropped, rtol=1e-6, atol=1e-6)


def test_validation():
    a, _, b = _system(16, 4)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    js, ts = _states()
    for kw in ({"block": 0}, {"block": 17}, {"steps": 0},
               {"sampling": "colnorm"}):
        _same_error(lambda: jla.block_kaczmarz(ja, jb, js, **kw),
                    lambda: tla.block_kaczmarz(ta, tb, ts, **kw))
    for kw in ({"block": 5}, {"steps": 0}, {"sampling": "rownorm"}):
        _same_error(lambda: jla.block_gauss_seidel(ja, jb, js, **kw),
                    lambda: tla.block_gauss_seidel(ta, tb, ts, **kw))
    for jfn, tfn in [
        (lambda: jla.block_kaczmarz(ja[0], jb, js),
         lambda: tla.block_kaczmarz(ta[0], tb, ts)),
        (lambda: jla.block_kaczmarz(ja, jb[:5], js),
         lambda: tla.block_kaczmarz(ta, tb[:5], ts)),
        (lambda: jla.block_gauss_seidel(ja, jb[:5], js, block=2),
         lambda: tla.block_gauss_seidel(ta, tb[:5], ts, block=2)),
        (lambda: jla.block_gauss_seidel(ja, ja, js, block=2),
         lambda: tla.block_gauss_seidel(ta, ta, ts, block=2)),
    ]:
        _same_error(jfn, tfn)
