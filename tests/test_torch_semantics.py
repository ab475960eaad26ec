"""The library's contracts on the port, as tests/test_accumulate_semantics.py
and tests/test_updates.py hold the JAX package to them, on the CPU.

- beta == 0 overwrites the output, never multiplies it (util.hh safe_scal):
  a NaN-filled ``out`` gives a finite result at every entry point that
  takes (beta, out), with every operator family.
- Seed chaining (rtd/source/tutorial/updates.rst): an operator seeded at
  S1.next_state continues S1's stream, so the update scenarios 1-4 equal
  the one-shot sketch (exactly where the products are the same sums, to
  float32 rounding where they add in another order), and states chain
  across the dense, sparse-sign and SRHT families as in the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
import randblas_tpu_torch as rt

RNG = np.random.default_rng(11)


def _t(shape):
    return torch.from_numpy(RNG.normal(size=shape).astype(np.float32))


def _nan(shape):
    return torch.full(shape, float("nan"))


# --------------------------------------------------- beta == 0 overwrites


@pytest.mark.parametrize("family", ["dense", "sparse", "trig"])
@pytest.mark.parametrize("side", ["left", "right"])
def test_sketch_general_beta_zero_overwrites(family, side):
    d, m, n = 4, 12, 3
    st = rt.RNGState.from_key(0)
    shape = (d, m) if side == "left" else (m, d)
    S = {"dense": lambda: rt.DenseSkOp(rt.DenseDist(*shape), st),
         "sparse": lambda: rt.SparseSkOp(rt.SparseDist(*shape, 2), st),
         "trig": lambda: rt.TrigSkOp(rt.TrigDist(*shape), st)}[family]()
    A = _t((m, n)) if side == "left" else _t((n, m))
    out_shape = (d, n) if side == "left" else (n, d)
    got = rt.sketch_general(S, A, side=side, beta=0.0, out=_nan(out_shape))
    assert torch.isfinite(got).all()
    want = rt.sketch_general(S, A, side=side)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # a tensor beta of 0 takes the select path: the same
    got = rt.sketch_general(S, A, side=side, beta=torch.tensor(0.0),
                            out=_nan(out_shape))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_wrappers_beta_zero_overwrite():
    D = RNG.normal(size=(5, 7)).astype(np.float32)
    D[D < 0.5] = 0.0
    sp = rt.COOMatrix.from_dense(torch.from_numpy(D))
    B = _t((7, 3))
    assert torch.isfinite(rt.left_spmm(sp, B, beta=0.0,
                                       out=_nan((5, 3)))).all()
    A = _t((4, 5))
    assert torch.isfinite(rt.right_spmm(A, sp, beta=0.0,
                                        out=_nan((4, 7)))).all()
    D = RNG.normal(size=(12, 6)).astype(np.float32)
    D[np.abs(D) < 1.0] = 0.0
    S = rt.DenseSkOp(rt.DenseDist(4, 12), rt.RNGState.from_key(2))
    assert torch.isfinite(rt.sketch_sparse(
        S, rt.COOMatrix.from_dense(torch.from_numpy(D)), beta=0.0,
        out=_nan((4, 6)))).all()
    T = rt.TrigSkOp(rt.TrigDist(4, 12), rt.RNGState.from_key(3))
    assert torch.isfinite(rt.sketch_vector(T, _t((12,)), beta=0.0,
                                           out=_nan((4,)))).all()
    sym = _t((12, 12))
    sym = sym + sym.T
    assert torch.isfinite(rt.sketch_symmetric(T, sym, beta=0.0,
                                              out=_nan((4, 12)))).all()
    assert torch.isfinite(rt.safe_scal(0.0, _nan((3,)))).all()


# ------------------------------------------------------- seed chaining


def _op(n_rows, n_cols, ma, state):
    return rt.DenseSkOp(rt.DenseDist(n_rows, n_cols, rt.DenseDistName.Gaussian,
                                     rt.MajorAxis[ma]), state)


def test_scenario_1_grow_sketch_size_left():
    m, n, d1, d2 = 24, 5, 4, 3
    A = _t((m, n))
    c = rt.RNGState.from_key(1)
    S1 = _op(d1, m, "Long", c)
    S2 = _op(d2, m, "Long", S1.next_state)
    two_step = torch.cat([rt.sketch_general(S1, A),
                          rt.sketch_general(S2, A)])
    one_shot = rt.sketch_general(_op(d1 + d2, m, "Long", c), A)
    assert torch.equal(two_step, one_shot)


def test_scenario_2_new_data_left():
    d, n, m1, m2 = 4, 5, 16, 12
    c = rt.RNGState.from_key(2)
    A1, A2 = _t((m1, n)), _t((m2, n))
    S1 = _op(d, m1, "Short", c)
    S2 = _op(d, m2, "Short", S1.next_state)
    B = rt.sketch_general(S2, A2, beta=1.0, out=rt.sketch_general(S1, A1))
    one_shot = rt.sketch_general(_op(d, m1 + m2, "Short", c),
                                 torch.cat([A1, A2]))
    np.testing.assert_allclose(B.numpy(), one_shot.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_scenario_3_grow_sketch_size_right():
    n, rows, d1, d2 = 20, 6, 3, 4
    A = _t((rows, n))
    c = rt.RNGState.from_key(3)
    S1 = _op(n, d1, "Long", c)              # tall, column-wise
    S2 = _op(n, d2, "Long", S1.next_state)
    two_step = torch.cat([rt.sketch_general(S1, A, side="right"),
                          rt.sketch_general(S2, A, side="right")], dim=1)
    one_shot = rt.sketch_general(_op(n, d1 + d2, "Long", c), A,
                                 side="right")
    assert torch.equal(two_step, one_shot)


def test_scenario_4_new_data_right():
    d, rows, n1, n2 = 5, 6, 14, 10
    c = rt.RNGState.from_key(4)
    A1, A2 = _t((rows, n1)), _t((rows, n2))
    S1 = _op(n1, d, "Short", c)             # tall, row-wise
    S2 = _op(n2, d, "Short", S1.next_state)
    B = rt.sketch_general(S2, A2, side="right", beta=1.0,
                          out=rt.sketch_general(S1, A1, side="right"))
    one_shot = rt.sketch_general(_op(n1 + n2, d, "Short", c),
                                 torch.cat([A1, A2], dim=1), side="right")
    np.testing.assert_allclose(B.numpy(), one_shot.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_states_chain_across_the_three_families():
    """Dense, then sparse-sign, then SRHT, each seeded at the last one's
    next_state: the same states and the same sketches as the JAX
    package's chain."""
    js = rb.RNGState.from_key(5, "threefry4x32").incr(2 ** 32 - 9)
    ts = rt.RNGState.from_dict(js.to_dict())
    A = RNG.normal(size=(40, 3)).astype(np.float32)
    for make_j, make_t in (
            (lambda s: rb.DenseSkOp(rb.DenseDist(6, 40), s),
             lambda s: rt.DenseSkOp(rt.DenseDist(6, 40), s)),
            (lambda s: rb.SparseSkOp(rb.SparseDist(6, 40, 3), s),
             lambda s: rt.SparseSkOp(rt.SparseDist(6, 40, 3), s)),
            (lambda s: rb.TrigSkOp(rb.TrigDist(6, 40), s),
             lambda s: rt.TrigSkOp(rt.TrigDist(6, 40), s)),
            (lambda s: rb.SparseSkOp(rb.SparseDist(6, 40, 3,
                                                   rb.MajorAxis.Long), s),
             lambda s: rt.SparseSkOp(rt.SparseDist(6, 40, 3,
                                                   rt.MajorAxis.Long), s))):
        jS, tS = make_j(js), make_t(ts)
        want = np.asarray(rb.sketch_general(jS, jnp.asarray(A)))
        got = rt.sketch_general(tS, torch.from_numpy(A)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert tS.next_state.to_dict() == jS.next_state.to_dict()
        js, ts = jS.next_state, tS.next_state
