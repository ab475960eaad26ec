"""util's samplers and helpers, default_state and isometry_scale_factor of
the port against the JAX package, on the CPU, with the same numpy-seeded
inputs.

Tolerances:
- counter streams, indices, signs and next states: equal, bit for bit (the
  stream contract; both map words to indices in float64);
- symmetrize, overwrite_triangle, transpose_square, safe_scal,
  print_colmaj, default_state and isometry_scale_factor: exact;
- weights_to_cdf: 1 ulp of float32 where the partial sums are exact, else
  both within the cumulative sum's rounding bound of the float64 cdf
  (JAX's cumsum sums in another order).
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu import util as jutil
import randblas_tpu_torch as rt
from randblas_tpu_torch import util as tutil

RNGS = ("philox4x32", "philox2x32", "threefry4x32", "threefry2x32")


def _states(rng, carry=False):
    """The same state in both packages; ``carry`` puts the counter just
    below a word boundary, so the stream's offsets carry across words."""
    j = rb.RNGState.from_key(11, rng)
    if carry:
        j = j.incr(2 ** 32 - 3)
    return j, rt.RNGState.from_dict(j.to_dict())


@pytest.mark.parametrize("rng", RNGS)
@pytest.mark.parametrize("carry", [False, True], ids=["key", "carry"])
@pytest.mark.parametrize("k", [1, 4, 13])
def test_uniform_stream_bitwise(rng, carry, k):
    j, t = _states(rng, carry)
    jb, jn = jutil._uniform_stream_bits(j, k)
    tb, tn = tutil._uniform_stream_bits(t, k, device="cpu")
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb, np.int64))
    assert tn.to_dict() == jn.to_dict()
    ju, _ = jutil._uniform_stream(j, k)
    tu, _ = tutil._uniform_stream(t, k, device="cpu")
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))


@pytest.mark.parametrize("rng", RNGS)
@pytest.mark.parametrize("n", [1, 7, 1000, 2 ** 25 + 3, 2 ** 31 - 1])
def test_sample_indices_iid_uniform_bitwise(rng, n):
    j, t = _states(rng, carry=n == 7)
    js, jn = rb.sample_indices_iid_uniform(n, 301, j)
    ts, tn = rt.sample_indices_iid_uniform(n, 301, t, device="cpu")
    assert ts.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tn.to_dict() == jn.to_dict()


@pytest.mark.parametrize("weights", [
    "uniform", "random32", "random64", "degenerate", "zeros_between"])
def test_sample_indices_iid_bitwise(weights):
    rng = np.random.default_rng(3)
    w = {"uniform": np.ones(10, np.float32),
         "random32": rng.random(50).astype(np.float32),
         "random64": rng.random(2000),
         "degenerate": np.array([0.0, 0.0, 1.0, 0.0], np.float32),
         "zeros_between": np.array([1.0, 0.0, 0.0, 3.0, 0.0, 2.0])}[weights]
    jcdf = rb.weights_to_cdf(jnp.asarray(w))
    tcdf = rt.weights_to_cdf(torch.from_numpy(w))
    j, t = _states("philox4x32")
    # the same cdf into both samplers: the indices depend only on it and
    # on the stream
    js, jn = rb.sample_indices_iid(jcdf, 997, j)
    ts, tn = rt.sample_indices_iid(torch.tensor(np.asarray(jcdf)), 997, t)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tn.to_dict() == jn.to_dict()
    # the port's own cdf gives the same indices where it equals JAX's
    if torch.equal(tcdf, torch.tensor(np.asarray(jcdf))):
        assert torch.equal(rt.sample_indices_iid(tcdf, 997, t)[0], ts)
    if weights == "degenerate":
        assert (ts == 2).all()


def test_weights_to_cdf():
    """Within 1 ulp of JAX's where the float32 partial sums are exact
    (dyadic weights); for any weights both lie within the cumulative sum's
    rounding bound, n eps, of the float64 cdf: JAX's cumsum (an XLA
    reduce_window) sums in another order than torch.cumsum, 2 ulp apart at
    50 random weights."""
    rng = np.random.default_rng(5)
    dyadic = (rng.integers(0, 64, 300) / 8).astype(np.float32)
    np.testing.assert_array_almost_equal_nulp(
        rt.weights_to_cdf(torch.from_numpy(dyadic)).numpy(),
        np.asarray(rb.weights_to_cdf(jnp.asarray(dyadic))), nulp=1)
    w = rng.random(2000).astype(np.float32)
    exact = np.cumsum(w.astype(np.float64))
    exact /= exact[-1]
    bound = len(w) * np.finfo(np.float32).eps
    for got in (rt.weights_to_cdf(torch.from_numpy(w)).numpy(),
                np.asarray(rb.weights_to_cdf(jnp.asarray(w)))):
        assert got.dtype == np.float32
        assert np.abs(got - exact).max() <= bound


def test_weights_to_cdf_rejects_negative_weights():
    for pkg, arr in ((rb, jnp.asarray), (rt, torch.tensor)):
        with pytest.raises(ValueError):
            pkg.weights_to_cdf(arr([1.0, -2.0, 3.0]))
        # a threshold below the weights lets them through
        pkg.weights_to_cdf(arr([1.0, -2.0, 3.0]), error_if_below=-3.0)


@pytest.mark.parametrize("uplo", ["upper", "lower"])
def test_symmetry_helpers_exact(uplo):
    a = np.random.default_rng(4).standard_normal((6, 6)).astype(np.float32)
    ta = torch.from_numpy(a)
    np.testing.assert_array_equal(rt.symmetrize(ta, uplo).numpy(),
                                  np.asarray(rb.symmetrize(a, uplo)))
    for off, val in ((1, 0.0), (0, -2.5), (-1, 7.0)):
        np.testing.assert_array_equal(
            rt.overwrite_triangle(ta, uplo, off, val).numpy(),
            np.asarray(rb.overwrite_triangle(a, uplo, off, val)))
    wide = np.ones((3, 5), np.float32)
    np.testing.assert_array_equal(
        rt.overwrite_triangle(torch.from_numpy(wide), uplo).numpy(),
        np.asarray(rb.overwrite_triangle(wide, uplo)))
    np.testing.assert_array_equal(rt.transpose_square(ta).numpy(),
                                  np.asarray(rb.transpose_square(a)))
    with pytest.raises(ValueError):
        rt.symmetrize(torch.ones(2, 3))
    with pytest.raises(ValueError):
        rt.transpose_square(torch.ones(2, 3))


def test_safe_scal_overwrites_at_zero():
    x = np.array([1.0, np.nan, np.inf, -2.0], np.float32)
    tx = torch.from_numpy(x)
    for alpha in (0, 0.0, 2.5, -1):
        got = rt.safe_scal(alpha, tx).numpy()
        np.testing.assert_array_equal(got,
                                      np.asarray(rb.safe_scal(alpha, x)))
    # a tensor alpha takes the select path in both
    for alpha in (0.0, 3.0):
        got = rt.safe_scal(torch.tensor(alpha), tx).numpy()
        want = np.asarray(rb.safe_scal(jnp.asarray(alpha), x))
        np.testing.assert_array_equal(got, want)
    assert np.all(rt.safe_scal(0.0, tx).numpy() == 0.0)


def test_print_colmaj_matches():
    a = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    outs = []
    for pkg, arr in ((rb, a), (rt, torch.from_numpy(a))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            pkg.print_colmaj(arr, "A")
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].startswith("A\n")


def test_default_state_and_isometry_scales():
    for key, rng in ((0, "philox4x32"), (9, "threefry2x32")):
        assert (rt.default_state(key, rng).to_dict()
                == rb.default_state(key, rng).to_dict())
    assert rt.default_state().to_dict() == rb.default_state().to_dict()
    pairs = [
        (rb.DenseDist(10, 40), rt.DenseDist(10, 40)),
        (rb.DenseDist(40, 10, rb.DenseDistName.Uniform),
         rt.DenseDist(40, 10, rt.DenseDistName.Uniform)),
        (rb.SparseDist(10, 40, 4, rb.MajorAxis.Short),
         rt.SparseDist(10, 40, 4, rt.MajorAxis.Short)),
        (rb.SparseDist(10, 40, 4, rb.MajorAxis.Long),
         rt.SparseDist(10, 40, 4, rt.MajorAxis.Long)),
        (rb.SparseDist(50, 12, 3, rb.MajorAxis.Long),
         rt.SparseDist(50, 12, 3, rt.MajorAxis.Long)),
        (rb.TrigDist(16, 100), rt.TrigDist(16, 100)),
    ]
    for jd, td in pairs:
        assert rt.isometry_scale_factor(td) == rb.isometry_scale_factor(jd)


def test_samplers_default_to_the_card():
    st = rt.RNGState.from_key(1)
    calls = [lambda: rt.sample_indices_iid_uniform(10, 5, st)[0],
             lambda: tutil._uniform_stream_bits(st, 5)[0],
             lambda: rt.hadamard_matrix(4),
             lambda: rt.srht_operator(4, 10)._sample()[0],
             lambda: rt.TrigSkOp(rt.TrigDist(4, 10), st).materialize()]
    for call in calls:
        if torch.cuda.is_available():
            assert call().is_cuda
        else:  # never a quiet run on the CPU
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    # a sampler given a tensor follows its device
    cdf = rt.weights_to_cdf(torch.ones(4))
    assert rt.sample_indices_iid(cdf, 3, st)[0].device == cdf.device
