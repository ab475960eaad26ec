"""TensorSketch, the Kronecker FJLT and polynomial kernel features of the
port against the JAX package, on the CPU, with the same numpy-seeded
inputs.

Tolerances: 1e-5 of max |want| (FFT and index-add sums in another order);
next states equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
import randblas_tpu_torch as rt
from randblas_tpu_torch import skge

TOL = 1e-5


def _close(got, want, tol=TOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = np.abs(want).max() or 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


def _data(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _states(key):
    j = rb.RNGState.from_key(key)
    return j, rt.RNGState.from_dict(j.to_dict())


def _same(fn_name, j_args, t_args, key, **kw):
    js, ts = _states(key)
    jout, jn = getattr(rb, fn_name)(*j_args, state=js, **kw)
    tout, tn = getattr(rt, fn_name)(*t_args, state=ts, **kw)
    _close(tout, jout)
    assert tn.to_dict() == jn.to_dict()
    return tout


@pytest.mark.parametrize("dims,d", [
    ((16, 12), 8),          # d <= m: Short CountSketches
    ((7, 5), 8),            # d > m: Long CountSketches
    ((6, 5, 4), 13),        # three factors, odd d
    ((40,), 16),            # one factor: a plain CountSketch
])
def test_tensor_sketch(dims, d):
    fs = [_data((m, 3), i) for i, m in enumerate(dims)]
    skge.route_counts.clear()
    _same("tensor_sketch", ([jnp.asarray(f) for f in fs], d),
          ([torch.from_numpy(f) for f in fs], d), key=17)
    assert set(skge.route_counts) <= {"sparse_fixed_nnz", "sparse_coo"}


@pytest.mark.parametrize("dims,d", [((16, 12), 8), ((7, 5), 8),
                                    ((3, 4, 5), 13)])
def test_tensor_sketch_explicit(dims, d):
    x = _data((int(np.prod(dims)), 4), 3)
    got = _same("tensor_sketch_explicit", (jnp.asarray(x), dims, d),
                (torch.from_numpy(x), dims, d), key=5)
    # the explicit form of the Khatri–Rao product is the structured sketch
    fs = [_data((m, 4), 10 + i) for i, m in enumerate(dims)]
    kr = fs[0]
    for f in fs[1:]:
        kr = (kr[:, None, :] * f[None, :, :]).reshape(-1, 4)
    exp, _ = rt.tensor_sketch_explicit(torch.from_numpy(kr), dims, d,
                                       _states(5)[1])
    imp, _ = rt.tensor_sketch([torch.from_numpy(f) for f in fs], d,
                              _states(5)[1])
    _close(exp, imp.numpy())
    assert got.shape == (d, 4)


def test_tensor_sketch_vectors():
    vs = [_data((m,), i) for i, m in enumerate((9, 6))]
    _same("tensor_sketch_vectors", ([jnp.asarray(v) for v in vs], 11),
          ([torch.from_numpy(v) for v in vs], 11), key=3)


def test_polynomial_kernel_features():
    x = _data((10, 6), 4)
    _same("polynomial_kernel_features", (jnp.asarray(x), 3, 32),
          (torch.from_numpy(x), 3, 32), key=8)
    with pytest.raises(ValueError):
        rt.polynomial_kernel_features(torch.from_numpy(x), 0, 8,
                                      rt.RNGState.from_key(0))


@pytest.mark.parametrize("dims,d", [((16, 12), 8), ((7, 5), 20),
                                    ((6, 5, 3), 13)])
def test_kfjlt(dims, d):
    fs = [_data((m, 3), i) for i, m in enumerate(dims)]
    _same("kfjlt_sketch", ([jnp.asarray(f) for f in fs], d),
          ([torch.from_numpy(f) for f in fs], d), key=21)
    x = _data((int(np.prod(dims)), 3), 7)
    _same("kfjlt_sketch_explicit", (jnp.asarray(x), dims, d),
          (torch.from_numpy(x), dims, d), key=21)
    assert rt.tensor.kfjlt_scale(dims, d) == rb.tensor.kfjlt_scale(dims, d)


def test_validation():
    st = rt.RNGState.from_key(0)
    for call in (lambda: rt.tensor_sketch([], 4, st),
                 lambda: rt.tensor_sketch([torch.ones(3, 2),
                                           torch.ones(3, 5)], 4, st),
                 lambda: rt.tensor_sketch([torch.ones(3, 2)], 0, st),
                 lambda: rt.tensor_sketch_explicit(torch.ones(7, 2), (2, 3),
                                                   4, st),
                 lambda: rt.kfjlt_sketch_explicit(torch.ones(6, 2), (2, 0),
                                                  4, st),
                 lambda: rt.kfjlt_sketch([], 4, st)):
        with pytest.raises(ValueError):
            call()
