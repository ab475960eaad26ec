"""The Walsh–Hadamard transform and the SRHT operators of the port against
the JAX package, on the CPU, with the same numpy-seeded inputs.

Tolerances:
- ``hadamard_matrix``, ``_balanced_factors``, signs, indices and next
  states: exact (the stream contract);
- ``hadamard_transform``: 1e-6 of max |want| in float32, 1e-12 in float64
  (the same +-1 stages, float sums in another order);
- ``lmult``, ``lmult_t``, ``materialize`` and ``sketch_general``: 1e-6 of
  max |want| (float32; the repeated rows of ``lmult_t`` add in another
  order);
- the gradient of ||S a||^2: 1e-5 of max |want|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu.ops import hadamard as jhad
import randblas_tpu_torch as rt
from randblas_tpu_torch import skge
from randblas_tpu_torch.ops import hadamard as thad

TOL = 1e-6


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = np.abs(want).max() or 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


def _data(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _ops(d, m, key=3, rng="philox4x32", carry=False, dtype="float32"):
    st = rb.RNGState.from_key(key, rng)
    if carry:
        st = st.incr(2 ** 32 - 5)
    jS = rb.TrigSkOp(rb.TrigDist(d, m), st, dtype=getattr(jnp, dtype))
    tS = rt.TrigSkOp(rt.TrigDist(d, m), rt.RNGState.from_dict(st.to_dict()),
                     dtype=getattr(torch, dtype))
    return jS, tS


# ------------------------------------------------------------- Hadamard


@pytest.mark.parametrize("k", [1, 2, 4, 32, 512])
def test_hadamard_matrix_exact(k):
    got = rt.hadamard_matrix(k, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(rb.hadamard_matrix(k)))
    assert rt.hadamard_matrix(k, torch.float64, "cpu").dtype == torch.float64


def test_factors_and_powers_of_two():
    for lg in range(22):
        for cap in (2, 8, 128, 512, 4096):
            assert (thad._balanced_factors(1 << lg, cap)
                    == jhad._balanced_factors(1 << lg, cap))
    for m in (0, 1, 3, 4, 100, 1024, 1025):
        assert thad.is_pow2(m) == jhad.is_pow2(m)
        assert thad.next_pow2(m) == jhad.next_pow2(m)


@pytest.mark.parametrize("m,n,cap", [(1, 3, 512), (2, 5, 512), (256, 3, 512),
                                     (2048, 4, 512), (2048, 4, 8),
                                     (1024, 3, 2)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("float64", 1e-12)])
def test_hadamard_transform(m, n, cap, dtype, tol):
    x = _data((m, n), m + n, getattr(np, dtype))
    want = rb.hadamard_transform(jnp.asarray(x), max_factor=cap,
                                 precision="highest")
    _close(rt.hadamard_transform(torch.from_numpy(x), max_factor=cap), want,
           tol)


def test_hadamard_transform_rejects():
    for pkg, arr in ((rb, jnp.zeros), (rt, torch.zeros)):
        with pytest.raises(ValueError):
            pkg.hadamard_transform(arr((12, 3)))
        with pytest.raises(ValueError):
            pkg.hadamard_transform(arr((16, 3)), max_factor=3)
        with pytest.raises(ValueError):
            pkg.hadamard_matrix(6)


# ------------------------------------------------------------- TrigSkOp


@pytest.mark.parametrize("d,m", [(16, 100), (8, 64), (1, 5), (200, 33)])
@pytest.mark.parametrize("rng", ["philox4x32", "threefry2x32"])
@pytest.mark.parametrize("carry", [False, True], ids=["key", "carry"])
def test_sample_bitwise_and_next_state(d, m, rng, carry):
    jS, tS = _ops(d, m, 7, rng, carry)
    js, ji = jS._sample()
    ts, ti = tS._sample("cpu")
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32
    assert tS.next_state.to_dict() == jS.next_state.to_dict()
    assert tS._sample("cpu")[0] is ts          # kept per device
    # chaining: the next operator's stream starts where this one ended
    jS2 = rb.TrigSkOp(rb.TrigDist(d, m), jS.next_state)
    tS2 = rt.TrigSkOp(rt.TrigDist(d, m), tS.next_state)
    np.testing.assert_array_equal(tS2._sample("cpu")[1].numpy(),
                                  np.asarray(jS2._sample()[1]))


@pytest.mark.parametrize("d,m", [(16, 100), (8, 64), (40, 37)])
def test_lmult_lmult_t_materialize(d, m):
    jS, tS = _ops(d, m)
    a, b = _data((m, 7), 1), _data((d, 5), 2)
    _close(tS.lmult(torch.from_numpy(a)), jS.lmult(jnp.asarray(a)))
    _close(tS.lmult_t(torch.from_numpy(b)), jS.lmult_t(jnp.asarray(b)))
    mat = tS.materialize(device="cpu")
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jS.materialize()))
    assert set(np.unique(mat.numpy())) <= {-1.0, 1.0}


def test_float64_operator():
    jS, tS = _ops(16, 100, dtype="float64")
    a = _data((100, 4), 3, np.float64)
    _close(rt.sketch_general(tS, torch.from_numpy(a)),
           rb.sketch_general(jS, jnp.asarray(a)), 1e-12)


@pytest.mark.parametrize("side,op_s,storage,data", [
    ("left", "N", (16, 100), (100, 7)),
    ("left", "T", (16, 100), (16, 7)),
    ("right", "N", (100, 16), (7, 100)),
    ("right", "T", (16, 100), (7, 100)),
])
def test_sketch_general(side, op_s, storage, data):
    jS, tS = _ops(*storage, key=5)
    a = _data(data, 4)
    skge.route_counts.clear()
    got = rt.sketch_general(tS, torch.from_numpy(a), side=side, op_s=op_s)
    assert skge.route_counts == {"srht": 1}
    _close(got, rb.sketch_general(jS, jnp.asarray(a), side=side, op_s=op_s))
    # alpha, and beta with out (beta = 0 overwrites a NaN out)
    out = _data(tuple(got.shape), 5)
    kw = dict(side=side, op_s=op_s, alpha=0.5)
    _close(rt.sketch_general(tS, torch.from_numpy(a), beta=2.0,
                             out=torch.from_numpy(out), **kw),
           rb.sketch_general(jS, jnp.asarray(a), beta=2.0,
                             out=jnp.asarray(out), **kw))
    nan = torch.full(tuple(got.shape), float("nan"))
    assert torch.isfinite(rt.sketch_general(tS, torch.from_numpy(a),
                                            beta=0.0, out=nan, **kw)).all()
    # op_a = "T" reads the data transposed
    _close(rt.sketch_general(tS, torch.from_numpy(a.T.copy()), side=side,
                             op_s=op_s, op_a="T"),
           rb.sketch_general(jS, jnp.asarray(a.T.copy()), side=side,
                             op_s=op_s, op_a="T"))


def test_wrappers_take_trig_operators():
    jS, tS = _ops(8, 60, key=2)
    x = _data((60,), 6)
    _close(rt.sketch_vector(tS, torch.from_numpy(x)),
           rb.sketch_vector(jS, jnp.asarray(x)))
    a = _data((60, 60), 7)
    a = (a + a.T) / 2
    _close(rt.sketch_symmetric(tS, torch.from_numpy(a)),
           rb.sketch_symmetric(jS, jnp.asarray(a)))


def test_no_submatrix_addressing():
    """A block of the operator is refused on either side, in both
    packages: a row offset, fewer rows, fewer columns on the right."""
    a = np.zeros((64, 3), np.float32)
    cases = [((8, 64), a, dict(d=4, ro_s=1)), ((8, 64), a, dict(d=4)),
             ((64, 8), a.T.copy(), dict(d=4, side="right"))]
    for shape, data, kw in cases:
        jS, tS = _ops(*shape)
        for pkg, S, arr in ((rb, jS, jnp.asarray(data)),
                            (rt, tS, torch.from_numpy(data))):
            with pytest.raises(ValueError, match="submatrix addressing"):
                pkg.sketch_general(S, arr, **kw)


def test_gradient_matches_jax_grad():
    jS, tS = _ops(8, 60)
    a = _data((60, 5), 8)
    g = jax.grad(lambda x: jnp.sum(jS.lmult(x) ** 2))(jnp.asarray(a))
    ta = torch.from_numpy(a).requires_grad_(True)
    (tS.lmult(ta) ** 2).sum().backward()
    _close(ta.grad, g, 1e-5)
    # and through sketch_general
    ta.grad = None
    (rt.sketch_general(tS, ta) ** 2).sum().backward()
    _close(ta.grad, g, 1e-5)


def test_convert_carries_operators_across():
    jS, _ = _ops(16, 100, key=9)
    a = _data((100, 6), 9)
    want = rb.sketch_general(jS, jnp.asarray(a))
    lazy = rt.trig_skop_from_jax(16, 100, jS.seed_state.to_dict())
    _close(rt.sketch_general(lazy, torch.from_numpy(a)), want)
    jS._sample()                              # cache the JAX operator's draw
    held = rt.skop_from_jax(jS, device="cpu")
    assert isinstance(held, rt.TrigSkOp)
    np.testing.assert_array_equal(held._sample("cpu")[1].numpy(),
                                  np.asarray(jS._indices))
    assert held.next_state.to_dict() == jS.next_state.to_dict()
    _close(rt.sketch_general(held, torch.from_numpy(a)), want)
    # an operator with no cache comes across lazy, the same values
    jS2, _ = _ops(16, 100, key=10)
    again = rt.skop_from_jax(jS2)
    _close(rt.sketch_general(again, torch.from_numpy(a)),
           rb.sketch_general(jS2, jnp.asarray(a)))


def test_srht_operator():
    jS = rb.srht_operator(8, 64, key=4)
    tS = rt.srht_operator(8, 64, key=4, device="cpu")
    np.testing.assert_array_equal(tS.materialize("cpu").numpy(),
                                  np.asarray(jS.materialize()))
    assert rt.isometry_scale_factor(tS.dist) == rb.isometry_scale_factor(jS.dist)
