"""The one-pass SVD, StreamingSketch and Frequent Directions of the port
against the JAX package, on the CPU, with the same numpy-seeded inputs.

Tolerances: singular values 1e-5 of the largest and the rank-r
reconstructions U diag(s) V^T 1e-5 relative (signs of the factors are
free, so they are not compared); next states equal; StreamingSketch's
range sketch Y bitwise under two chunkings and its result within 1e-5 of
``single_pass_svd``'s; FD's B^T B within 1e-5 of ||A||_F^2 (eigenvector
signs are free, so rows of B are not compared) and ``shrink_mass`` 1e-5
relative; ``ingest`` bitwise ``update``, and ``fd_pass`` bitwise
``ingest`` plus ``sketch()``, in the port; validation messages equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu import linalg as jla
from randblas_tpu.linalg import streaming as jst
from randblas_tpu.sparse_data.coo import COOMatrix as JCOO
import randblas_tpu_torch as rt
from randblas_tpu_torch import linalg as tla
from randblas_tpu_torch.linalg import streaming as tst

REL = 1e-5
M, N, RANK = 200, 120, 8


def _states(key=3):
    j = rb.RNGState.from_key(key)
    return j, rt.RNGState.from_dict(j.to_dict())


def _rel(t, j):
    j = np.asarray(j, np.float64)
    t = np.asarray(t, np.float64)
    assert t.shape == j.shape
    return np.abs(t - j).max() / np.abs(j).max()


def _lowrank(m=M, n=N, k=RANK, seed=1):
    """A float32 matrix with planted singular values 10 -> 1 over the top k
    and a 1e-3 noise floor."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(m, k)))
    v, _ = np.linalg.qr(rng.normal(size=(n, k)))
    a = (u * np.linspace(10.0, 1.0, k)) @ v.T + 1e-3 * rng.normal(size=(m, n))
    return a.astype(np.float32)


def _decaying(m=512, n=64, seed=23):
    """Rows with the spectrum 2^(-i/8): test_tpu_hardware.py's FD input at a
    small width."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, n)) * 2.0 ** (-np.arange(n) / 8.0)
            ).astype(np.float32)


def _usv(u, s, vt):
    u, s, vt = (np.asarray(x, np.float64) for x in (u, s, vt))
    return (u * s) @ vt


def _same_error(jfn, tfn):
    """Both raise ValueError with the same requirement message."""
    with pytest.raises(ValueError) as je:
        jfn()
    with pytest.raises(ValueError) as te:
        tfn()
    msg = str(je.value).split("requirement failed: ")[1]
    assert str(te.value).split("requirement failed: ")[1] == msg


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_single_pass_svd(form):
    a = _lowrank()
    if form == "sparse":
        a[np.abs(a) < 0.05] = 0.0
        ja = JCOO.from_dense(jnp.asarray(a))
        ta = rt.COOMatrix.from_dense(torch.from_numpy(a), device="cpu")
    else:
        ja, ta = jnp.asarray(a), torch.from_numpy(a)
    js, ts = _states(35)
    ju, jsv, jvt, jn = jla.single_pass_svd(ja, RANK, js)
    tu, tsv, tvt, tn = tla.single_pass_svd(ta, RANK, ts)
    assert tuple(tu.shape) == (M, RANK) and tuple(tvt.shape) == (RANK, N)
    assert np.abs(tsv.numpy() - np.asarray(jsv)).max() <= REL * float(jsv[0])
    assert _rel(_usv(tu, tsv, tvt), _usv(ju, jsv, jvt)) <= REL
    assert tn.to_dict() == jn.to_dict()


def test_streaming_sketch():
    """The same rows in two chunkings and orders: Y bitwise, the result
    within 1e-5 of single_pass_svd's in the port and of JAX's
    StreamingSketch; next states equal."""
    a = _lowrank()
    js, ts = _states(36)
    want = tla.single_pass_svd(torch.from_numpy(a), RANK, ts)
    jss = jla.StreamingSketch(M, N, RANK, js)
    sketches = []
    for chunks in ([(0, 64), (64, 137), (137, M)],
                   [(150, M), (0, 50), (50, 150)]):
        s = tla.StreamingSketch(M, N, RANK, ts, device="cpu")
        for lo, hi in chunks:
            s.update(lo, torch.from_numpy(a[lo:hi]))
        sketches.append(s)
    for lo, hi in [(0, 64), (64, 137), (137, M)]:
        jss.update(lo, jnp.asarray(a[lo:hi]))
    assert torch.equal(sketches[0]._y, sketches[1]._y)
    assert (sketches[0].k, sketches[0].l) == (jss.k, jss.l) == (16, 33)
    assert sketches[0].next_state.to_dict() == jss.next_state.to_dict() \
        == want[3].to_dict()
    ref = _usv(*jss.finalize())
    for s in sketches:
        u, sv, vt = s.finalize()
        assert np.abs(sv.numpy() - want[1].numpy()).max() <= \
            REL * float(want[1][0])
        assert _rel(_usv(u, sv, vt), _usv(*want[:3])) <= REL
        assert _rel(_usv(u, sv, vt), ref) <= REL


def test_streaming_sketch_guards():
    js, ts = _states(37)
    a = _lowrank()
    blk_j, blk_t = jnp.asarray(a[:10]), torch.from_numpy(a[:10])

    def twice(mk, blk):
        def run():
            s = mk()
            s.update(5, blk)
            s.update(10, blk)
        return run

    mk_j = lambda: jla.StreamingSketch(M, N, RANK, js)          # noqa: E731
    mk_t = lambda: tla.StreamingSketch(M, N, RANK, ts,          # noqa: E731
                                       device="cpu")
    _same_error(twice(mk_j, blk_j), twice(mk_t, blk_t))
    _same_error(lambda: mk_j().update(195, blk_j),
                lambda: mk_t().update(195, blk_t))
    _same_error(lambda: mk_j().finalize(), lambda: mk_t().finalize())
    for args in ((M, N, 0), (M, N, 120), (12, N, 4)):
        _same_error(lambda: jst._sketch_dims(*args, 8, 2.0),
                    lambda: tst._sketch_dims(*args, 8, 2.0))
    _same_error(lambda: jst._sketch_dims(M, N, 4, 8, 0.5),
                lambda: tst._sketch_dims(M, N, 4, 8, 0.5))


def test_fd_shrink():
    """One shrink of the same buffer: the shrunk buffer's Gram and the
    offset sigma_ell^2."""
    buf = _decaying(32, 64)
    jb, jd = jst._fd_shrink_jit(jnp.asarray(buf), 16)
    tb, td = tst._fd_shrink(torch.from_numpy(buf), 16)
    assert torch.equal(tb[16:], torch.zeros(16, 64))
    fro2 = float((buf.astype(np.float64) ** 2).sum())
    jb, tb = np.asarray(jb, np.float64), tb.numpy().astype(np.float64)
    assert np.abs(tb.T @ tb - jb.T @ jb).max() <= REL * fro2
    assert abs(float(td) - float(jd)) <= REL * float(jd)


@pytest.mark.parametrize("ell,chunk", [(16, 160), (8, 37)])
def test_frequent_directions(ell, chunk):
    """update in ragged chunks against JAX's; ingest bitwise update in the
    port; the GLPW16 certificate."""
    a = _decaying()
    n = a.shape[1]
    jfd = jla.FrequentDirections(n, ell)
    tfd = tla.FrequentDirections(n, ell, device="cpu")
    for i in range(0, a.shape[0], chunk):
        jfd.update(jnp.asarray(a[i:i + chunk]))
        tfd.update(torch.from_numpy(a[i:i + chunk]))
    jb = np.asarray(jfd.sketch(), np.float64)
    tb = tfd.sketch().numpy().astype(np.float64)
    a64 = a.astype(np.float64)
    fro2 = (a64 ** 2).sum()
    assert np.abs(tb.T @ tb - jb.T @ jb).max() <= REL * fro2
    mass = float(tfd.shrink_mass)
    assert abs(mass - float(jfd.shrink_mass)) <= REL * mass
    err = np.linalg.norm(a64.T @ a64 - tb.T @ tb, 2)
    assert err <= mass * (1 + 1e-4) and mass <= fro2 / ell

    ing = tla.FrequentDirections(n, ell, device="cpu")
    ing.ingest(torch.from_numpy(a))
    upd = tla.FrequentDirections(n, ell, device="cpu")
    for i in range(0, a.shape[0], ell):
        upd.update(torch.from_numpy(a[i:i + ell]))
    assert torch.equal(ing.sketch(), upd.sketch())
    assert torch.equal(ing.shrink_mass, upd.shrink_mass)
    jing = jla.FrequentDirections(n, ell)
    jing.ingest(jnp.asarray(a))
    jb = np.asarray(jing.sketch(), np.float64)
    tb = ing.sketch().numpy().astype(np.float64)
    assert np.abs(tb.T @ tb - jb.T @ jb).max() <= REL * fro2


@pytest.mark.parametrize("m", [512, 512 - 37])
def test_fd_pass(m):
    """fd_pass against JAX's and, in the port, bitwise ingest + sketch() of
    a fresh FrequentDirections (a ragged m rides a zero-padded chunk)."""
    a = _decaying(m)
    jb, jm = jla.fd_pass(jnp.asarray(a), 16)
    tb, tm = tla.fd_pass(torch.from_numpy(a), 16)
    fro2 = float((a.astype(np.float64) ** 2).sum())
    jb, tb64 = np.asarray(jb, np.float64), tb.numpy().astype(np.float64)
    assert np.abs(tb64.T @ tb64 - jb.T @ jb).max() <= REL * fro2
    assert abs(float(tm) - float(jm)) <= REL * float(jm)
    fd = tla.FrequentDirections(a.shape[1], 16, device="cpu")
    fd.ingest(torch.from_numpy(a))
    assert torch.equal(fd.sketch(), tb) and torch.equal(fd.shrink_mass, tm)
    # one chunk: no shrink, a zero certificate
    b1, m1 = tla.fd_pass(torch.from_numpy(a[:10]), 16)
    assert torch.equal(b1[:10], torch.from_numpy(a[:10])) and float(m1) == 0


def test_fd_merge():
    a = _decaying()
    halves = (a[:300], a[300:])
    jfds = [jla.FrequentDirections(64, 16) for _ in halves]
    tfds = [tla.FrequentDirections(64, 16, device="cpu") for _ in halves]
    for jf, tf, h in zip(jfds, tfds, halves):
        jf.update(jnp.asarray(h))
        tf.update(torch.from_numpy(h))
    jfds[0].merge(jfds[1])
    tfds[0].merge(tfds[1])
    jb = np.asarray(jfds[0].sketch(), np.float64)
    tb = tfds[0].sketch().numpy().astype(np.float64)
    fro2 = float((a.astype(np.float64) ** 2).sum())
    assert np.abs(tb.T @ tb - jb.T @ jb).max() <= REL * fro2
    mass = float(tfds[0].shrink_mass)
    assert abs(mass - float(jfds[0].shrink_mass)) <= REL * mass


def test_fd_validation():
    jfd = jla.FrequentDirections(8, 4)
    tfd = tla.FrequentDirections(8, 4, device="cpu")
    for jfn, tfn in [
        (lambda: jla.FrequentDirections(8, 0),
         lambda: tla.FrequentDirections(8, 0, device="cpu")),
        (lambda: jla.FrequentDirections(8, 9),
         lambda: tla.FrequentDirections(8, 9, device="cpu")),
        (lambda: jfd.update(jnp.ones((3, 7))),
         lambda: tfd.update(torch.ones(3, 7))),
        (lambda: jfd.ingest(jnp.ones((3, 7))),
         lambda: tfd.ingest(torch.ones(3, 7))),
        (lambda: jfd.merge(jla.FrequentDirections(7, 4)),
         lambda: tfd.merge(tla.FrequentDirections(7, 4, device="cpu"))),
        (lambda: jfd.merge(None), lambda: tfd.merge(None)),
        (lambda: jla.fd_pass(jnp.ones((3, 7)), 0),
         lambda: tla.fd_pass(torch.ones(3, 7), 0)),
    ]:
        _same_error(jfn, tfn)


def test_streaming_state_defaults_to_the_card():
    """StreamingSketch and FrequentDirections take no tensor at
    construction: without ``device`` their buffers are asked of the card,
    which this host lacks."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for fn in (lambda: tla.StreamingSketch(M, N, RANK, _states()[1]),
               lambda: tla.FrequentDirections(8, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
