"""The tensor-train and Tucker tiers of the port against the JAX package,
on the CPU, with the same numpy-seeded inputs; TT inputs carried across by
``convert.tt_from_jax`` and ``convert.ttmatrix_from_jax``.

Tolerances: Gaussian cores (``tt_gaussian``, ``tt_matrix_gaussian``)
within 1e-6 of max |want| (the float32 log/sin/cos of two math libraries,
a last bit apart on ~10% of the values); next states equal; cores with no
factorization between input and output (``tt_scale``, ``tt_add``, the
carried-across cores) bitwise, the exact ``tt_matvec`` product's cores and
the STTA sketches Psi_k 1e-6 relative (einsums in another order);
``full()`` of everything that passes through a QR or an SVD 1e-5 relative
(signs and rotations of the cores are free, so cores are not compared);
``tt_dot`` / ``tt_norm`` 1e-5 relative; Tucker factors as projectors U U^T
1e-5; ranks equal; validation messages equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu import linalg as jla
from randblas_tpu.linalg import tt as jtt
import randblas_tpu_torch as rt
from randblas_tpu_torch import linalg as tla
from randblas_tpu_torch.linalg import tt as ttt

REL = 1e-5
CORE_REL = 1e-6
SHAPE = (6, 7, 5, 4)


def _states(key=3):
    j = rb.RNGState.from_key(key)
    return j, rt.RNGState.from_dict(j.to_dict())


def _rel(t, j):
    j = np.asarray(j, np.float64)
    t = t.detach().numpy().astype(np.float64)
    assert t.shape == j.shape
    return np.abs(t - j).max() / np.abs(j).max()


def _cores(x):
    return [np.asarray(c) for c in x.cores]


def _pair_tt(shape=SHAPE, ranks=(3, 4, 2), key=1):
    """A JAX Gaussian TT and the same cores in the port."""
    jx, _ = jla.tt_gaussian(shape, ranks, rb.RNGState.from_key(key))
    return jx, rt.tt_from_jax(_cores(jx), device="cpu")


def _decaying(shape=SHAPE, terms=8, seed=8, decay=0.25):
    """A float32 sum of rank-one terms with weights decay^t plus 1e-3 noise:
    the gaps between the leading singular values of each unfolding keep a
    truncation well posed at float32 rounding, and
    every unfolding has full rank, so the oversampled sketches do too (a
    rank-deficient sketch leaves CholQR's rescue columns as rounding noise,
    which two float32 runs do not share)."""
    rng = np.random.default_rng(seed)
    y = 1e-3 * rng.standard_normal(shape)
    for t in range(terms):
        vs = [rng.standard_normal(n) for n in shape]
        out = vs[0]
        for v in vs[1:]:
            out = np.multiply.outer(out, v)
        y += decay ** t * out
    return y.astype(np.float32)


def _same_error(jfn, tfn):
    """Both raise ValueError with the same requirement message."""
    with pytest.raises(ValueError) as je:
        jfn()
    with pytest.raises(ValueError) as te:
        tfn()
    msg = str(je.value).split("requirement failed: ")[1]
    assert str(te.value).split("requirement failed: ")[1] == msg


@pytest.mark.parametrize("shape,ranks", [(SHAPE, (3, 4, 2)), ((9,), 5)])
def test_tt_gaussian(shape, ranks):
    js, ts = _states(4)
    jx, jn = jla.tt_gaussian(shape, ranks, js)
    tx, tn = tla.tt_gaussian(shape, ranks, ts, device="cpu")
    assert tx.shape == jx.shape and tx.ranks == jx.ranks
    assert tx.ndim == jx.ndim and tx.dtype == torch.float32
    for t, j in zip(tx.cores, jx.cores):
        assert _rel(t, j) <= CORE_REL
    assert _rel(tx.full(), jx.full()) <= CORE_REL
    assert tn.to_dict() == jn.to_dict()


def test_tt_matrix_gaussian():
    js, ts = _states(14)
    jm, jn = jla.tt_matrix_gaussian((3, 4, 2), (5, 2, 3), (2, 3), js)
    tm, tn = tla.tt_matrix_gaussian((3, 4, 2), (5, 2, 3), (2, 3), ts,
                                    device="cpu")
    assert (tm.out_shape, tm.in_shape, tm.ranks, tm.ndim) == \
        (jm.out_shape, jm.in_shape, jm.ranks, jm.ndim)
    for t, j in zip(tm.cores, jm.cores):
        assert _rel(t, j) <= CORE_REL
    assert _rel(tm.full(), jm.full()) <= CORE_REL
    assert tn.to_dict() == jn.to_dict()


def test_convert_round_trip():
    """A JAX tt_gaussian carried across: cores bit for bit, full() the same
    contraction (1e-6: the two einsums sum the ranks in another order)."""
    jx, tx = _pair_tt()
    assert tx.device == torch.device("cpu")
    for t, j in zip(tx.cores, jx.cores):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert _rel(tx.full(), jx.full()) <= CORE_REL
    jm, _ = jla.tt_matrix_gaussian((3, 4), (2, 5), 3, rb.RNGState.from_key(2))
    tm = rt.ttmatrix_from_jax(_cores(jm), device="cpu")
    for t, j in zip(tm.cores, jm.cores):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert _rel(tm.full(), jm.full()) <= CORE_REL
    assert tx.to("cpu").cores[0].device == torch.device("cpu")


def test_tt_scale_add_dot_norm():
    jx, tx = _pair_tt()
    jy, ty = _pair_tt(key=9)
    js_, ts_ = jla.tt_scale(jx, 2.5), tla.tt_scale(tx, 2.5)
    ja, ta = jla.tt_add(jx, jy), tla.tt_add(tx, ty)
    for t, j in zip(ts_.cores + ta.cores, js_.cores + ja.cores):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert ta.ranks == ja.ranks == (1, 6, 8, 4, 1)
    for jv, tv in ((jla.tt_dot(ja, jx), tla.tt_dot(ta, tx)),
                   (jla.tt_norm(ja), tla.tt_norm(ta))):
        assert abs(float(tv) - float(jv)) <= REL * abs(float(jv))
    # one mode: the cores add
    j1, t1 = _pair_tt((9,), 1, 5)
    np.testing.assert_array_equal(tla.tt_add(t1, t1).cores[0].numpy(),
                                  np.asarray(jla.tt_add(j1, j1).cores[0]))


@pytest.mark.parametrize("case,orth,power_iters", [
    ("exact", "qr", 1), ("decaying", "cholqr", 2), ("clipped", "cholqr", 0)])
def test_tt_from_dense(case, orth, power_iters):
    """Exact-rank recovery (Householder QR: an exact-rank tensor's
    oversampled sketch is rank-deficient), the truncation of a decaying
    tensor, and a requested rank (30) clipped to its unfolding's
    min(rows, cols) = 14."""
    if case == "exact":
        x, ranks = np.array(_pair_tt(key=7)[0].full()), (3, 4, 2)
    elif case == "decaying":
        x, ranks = _decaying(), 5
    else:
        x, ranks = _decaying(), (2, 30, 3)
    js, ts = _states(2)
    jt, jn = jla.tt_from_dense(jnp.asarray(x), ranks, js, orth=orth,
                               power_iters=power_iters)
    tt, tn = tla.tt_from_dense(torch.from_numpy(x), ranks, ts, orth=orth,
                               power_iters=power_iters)
    assert tt.ranks == jt.ranks
    if case == "clipped":
        assert tt.ranks == (1, 2, 14, 3, 1)
    assert _rel(tt.full(), jt.full()) <= REL
    assert tn.to_dict() == jn.to_dict()


@pytest.mark.parametrize("ranks", [3, (2, 4, 3)])
def test_tt_round_and_deterministic(ranks):
    js, ts = _states(12)
    x = _decaying()
    jy, _ = jla.tt_from_dense(jnp.asarray(x), 6, js, power_iters=2)
    ty = rt.tt_from_jax(_cores(jy), device="cpu")
    jd, td = (jla.tt_round_deterministic(jy, ranks),
              tla.tt_round_deterministic(ty, ranks))
    assert td.ranks == jd.ranks
    assert _rel(td.full(), jd.full()) <= REL
    js, ts = _states(13)
    jr, jn = jla.tt_round(jy, ranks, js, oversample=3)
    tr, tn = tla.tt_round(ty, ranks, ts, oversample=3)
    assert tr.ranks == jr.ranks
    assert _rel(tr.full(), jr.full()) <= REL
    assert tn.to_dict() == jn.to_dict()


def test_tt_round_of_a_doubled_tensor():
    """x + 2x rounded back to x's ranks is 3x (the add-then-round
    certificate), in both packages alike."""
    jx, tx = _pair_tt()
    js, ts = _states(3)
    jr, _ = jla.tt_round(jla.tt_add(jx, jla.tt_scale(jx, 2.0)), (3, 4, 2),
                         js)
    tr, _ = tla.tt_round(tla.tt_add(tx, tla.tt_scale(tx, 2.0)), (3, 4, 2),
                         ts)
    assert tr.ranks == jr.ranks == (1, 3, 4, 2, 1)
    assert _rel(tr.full(), jr.full()) <= REL
    assert _rel(tr.full(), 3 * np.asarray(jx.full(), np.float64)) <= 1e-4


@pytest.mark.parametrize("mode", ["exact", "deterministic", "randomized"])
def test_tt_matvec(mode):
    jm, _ = jla.tt_matrix_gaussian((3, 4, 2, 3), SHAPE, 2,
                                   rb.RNGState.from_key(14))
    tm = rt.ttmatrix_from_jax(_cores(jm), device="cpu")
    jx, tx = _pair_tt()
    if mode == "exact":
        jy, ty = jla.tt_matvec(jm, jx), tla.tt_matvec(tm, tx)
        assert ty.ranks == jy.ranks == (1, 6, 8, 4, 1)
        for t, j in zip(ty.cores, jy.cores):
            assert _rel(t, j) <= CORE_REL
        want = np.asarray(jm.full(), np.float64) @ np.asarray(
            jx.full(), np.float64).reshape(-1)
        assert _rel(ty.full().reshape(-1), want) <= REL
        return
    if mode == "deterministic":
        jy, ty = (jla.tt_matvec(jm, jx, ranks=3),
                  tla.tt_matvec(tm, tx, ranks=3))
    else:
        js, ts = _states(15)
        (jy, jn), (ty, tn) = (jla.tt_matvec(jm, jx, ranks=3, state=js),
                              tla.tt_matvec(tm, tx, ranks=3, state=ts))
        assert tn.to_dict() == jn.to_dict()
    assert ty.ranks == jy.ranks
    assert _rel(ty.full(), jy.full()) <= REL


def test_stta_sketches():
    """The STTA sketches Psi_k, core by core (no factorization between x
    and them), from the same Gaussian TTs carried across."""
    x = _decaying((6, 7, 5, 4))
    jr, _ = jla.tt_gaussian(x.shape, 3, rb.RNGState.from_key(21))
    jl, _ = jla.tt_gaussian(x.shape, 5, rb.RNGState.from_key(22))
    jp = jtt._stta_sketch(jnp.asarray(x), jr, jl, jnp.float32)
    tp = ttt._stta_sketch(torch.from_numpy(x),
                          rt.tt_from_jax(_cores(jr), device="cpu"),
                          rt.tt_from_jax(_cores(jl), device="cpu"),
                          torch.float32)
    assert len(tp) == len(jp) == 4
    for t, j in zip(tp, jp):
        assert _rel(t, j) <= CORE_REL


@pytest.mark.parametrize("ranks", [3, (2, 5, 3)])
def test_tt_single_pass_and_stream(ranks):
    """tt_single_pass against JAX's, TTStream against JAX's TTStream over
    four additive updates (0.1, 0.2, 0.3 and 0.4 times x), and TTStream ==
    tt_single_pass of the sum in the port."""
    x = _decaying()
    js, ts = _states(16)
    jp, jn = jla.tt_single_pass(jnp.asarray(x), ranks, js)
    tp, tn = tla.tt_single_pass(torch.from_numpy(x), ranks, ts)
    assert tp.ranks == jp.ranks
    assert _rel(tp.full(), jp.full()) <= REL
    assert tn.to_dict() == jn.to_dict()
    parts = [np.float32(w) * x for w in (0.1, 0.2, 0.3, 0.4)]
    jst = jla.TTStream(x.shape, ranks, js)
    tst = tla.TTStream(x.shape, ranks, ts, device="cpu")
    for p in parts:
        jst.update(jnp.asarray(p))
        tst.update(torch.from_numpy(p))
    assert tst.next_state.to_dict() == jst.next_state.to_dict() == \
        tn.to_dict()
    assert _rel(tst.recover().full(), jst.recover().full()) <= REL
    assert _rel(tst.recover().full(), tp.full().numpy()) <= REL


def test_tucker_full():
    rng = np.random.default_rng(5)
    core = rng.standard_normal((2, 3, 4)).astype(np.float32)
    fac = [rng.standard_normal((n, r)).astype(np.float32)
           for n, r in ((5, 2), (6, 3), (7, 4))]
    want = jla.tucker_full(jnp.asarray(core), [jnp.asarray(f) for f in fac])
    got = tla.tucker_full(torch.from_numpy(core),
                          [torch.from_numpy(f) for f in fac])
    assert _rel(got, want) <= CORE_REL


@pytest.mark.parametrize("ranks,orth", [(3, "cholqr"), ((2, 3, 4, 2), "qr")])
def test_tucker_from_dense(ranks, orth):
    x = _decaying()
    js, ts = _states(2)
    jc, jf, jn = jla.tucker_from_dense(jnp.asarray(x), ranks, js, orth=orth)
    tc, tf, tn = tla.tucker_from_dense(torch.from_numpy(x), ranks, ts,
                                       orth=orth)
    assert tuple(tc.shape) == tuple(jc.shape)
    assert _rel(tla.tucker_full(tc, tf), jla.tucker_full(jc, jf)) <= REL
    for t, j in zip(tf, jf):
        j = np.asarray(j, np.float64)
        assert _rel(t @ t.T, j @ j.T) <= REL
    assert tn.to_dict() == jn.to_dict()


def test_validation():
    jx, tx = _pair_tt()
    bad = np.ones((2, 3, 1), np.float32)
    jm, _ = jla.tt_matrix_gaussian((3,), (4,), 1, rb.RNGState.from_key(2))
    tm = rt.ttmatrix_from_jax(_cores(jm), device="cpu")
    js, ts = _states()
    for jfn, tfn in [
        (lambda: jla.TTTensor([jnp.asarray(bad)]),
         lambda: tla.TTTensor([torch.from_numpy(bad)])),
        (lambda: jla.TTTensor([jnp.ones((1, 3))]),
         lambda: tla.TTTensor([torch.ones(1, 3)])),
        (lambda: jla.TTMatrix([jnp.ones((1, 3, 1))]),
         lambda: tla.TTMatrix([torch.ones(1, 3, 1)])),
        (lambda: jla.tt_gaussian((3, 4), (2, 2), js),
         lambda: tla.tt_gaussian((3, 4), (2, 2), ts, device="cpu")),
        (lambda: jla.tt_gaussian((3, 4), 0, js),
         lambda: tla.tt_gaussian((3, 4), 0, ts, device="cpu")),
        (lambda: jla.tt_add(jx, jla.tt_gaussian((3, 4), 2, js)[0]),
         lambda: tla.tt_add(tx, tla.tt_gaussian((3, 4), 2, ts,
                                                device="cpu")[0])),
        (lambda: jla.tt_matvec(jm, jx), lambda: tla.tt_matvec(tm, tx)),
        (lambda: jla.tt_matvec(jla.tt_matrix_gaussian(SHAPE, SHAPE, 1, js)[0],
                               jx, state=js),
         lambda: tla.tt_matvec(tla.tt_matrix_gaussian(SHAPE, SHAPE, 1, ts,
                                                      device="cpu")[0],
                               tx, state=ts)),
        (lambda: jla.TTStream(SHAPE, 2, js).update(jnp.ones((6, 7))),
         lambda: tla.TTStream(SHAPE, 2, ts, device="cpu").update(
             torch.ones(6, 7))),
        (lambda: jla.TTStream(SHAPE, 2, js).recover(),
         lambda: tla.TTStream(SHAPE, 2, ts, device="cpu").recover()),
        (lambda: jla.tucker_full(jnp.ones((2, 2)), [jnp.ones((3, 2))]),
         lambda: tla.tucker_full(torch.ones(2, 2), [torch.ones(3, 2)])),
        (lambda: jla.tucker_from_dense(jnp.ones((3, 4)), (2,), js),
         lambda: tla.tucker_from_dense(torch.ones(3, 4), (2,), ts)),
    ]:
        _same_error(jfn, tfn)


def test_random_tts_default_to_the_card():
    """A Gaussian TT holds no input tensor: without ``device`` its cores are
    asked of the card, which this host lacks."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for fn in (lambda: tla.tt_gaussian((3, 4), 2, _states()[1]),
               lambda: tla.tt_matrix_gaussian((3,), (4,), 1, _states()[1]),
               lambda: tla.TTStream((3, 4), 2, _states()[1])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
