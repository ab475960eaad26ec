"""K4 (the SASO sketch) and the sparse-operator routes of sketch_general,
the port against the JAX package on the CPU, same numpy-seeded inputs.

Tolerances (normalised by max |want|):
- K4's plain version against JAX's Pallas kernel in interpret mode: 1e-5.
  Both round A to bf16 and multiply by exact +-1 signs; only the order of
  the float32 sums differs (the readings are about 3e-8).
- The other sparse routes (fixed-nnz, row gather, COO) against JAX's: 1e-5,
  float32 sums in another order; bf16 data 2e-2 (bf16 sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu.ops.saso_sketch import saso_sketch as jsaso
from randblas_tpu.ops.saso_sketch import (
    saso_sketch_supported as jsaso_supported)
import randblas_tpu_torch as rt
from randblas_tpu_torch import skge as tskge
from randblas_tpu_torch.ops import saso_sketch as tsaso_mod
from randblas_tpu_torch.ops.saso_sketch import (saso_sketch,
                                                saso_sketch_reference,
                                                saso_sketch_supported)


def _data(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _norm_err(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _ops(shape, k, major="Short", key=3):
    jS = rb.SparseSkOp(rb.SparseDist(*shape, k, rb.MajorAxis[major]),
                       rb.RNGState.from_key(key))
    tS = rt.SparseSkOp(rt.SparseDist(*shape, k, rt.MajorAxis[major]),
                       rt.RNGState.from_key(key))
    return jS, tS


# ------------------------------------------------------------------- K4


@pytest.mark.parametrize("d,m,n,k,alpha", [
    (1024, 4096, 256, 8, 1.0),    # config-3-like, aligned
    (100, 777, 65, 8, 1.0),       # everything ragged
    (60, 500, 33, 3, 1.0),        # d below one 128-row block of the TPU
    (1000, 2048, 129, 16, 1.0),   # the most slots, ragged n
    (513, 4096, 7, 1, 1.0),       # one slot, skinny operand
    (256, 2048, 64, 8, -0.75),    # alpha
    (2048, 4096, 40, 8, 1.0),     # past the old shared-memory limit
    (4000, 8192, 24, 8, 1.0),     # near the gate's d_pad = 4096
])
def test_k4_plain_matches_jax_kernel(d, m, n, k, alpha):
    """The cases of tests/test_saso_kernel.py."""
    jS, tS = _ops((d, m), k, key=d + k)
    js, ts = jS.filled(), tS.filled(device="cpu")
    A = _data((m, n), d + k)
    want = jsaso(js.rows.reshape(m, k), js.vals.reshape(m, k),
                 jnp.asarray(A), d, alpha, interpret=True)
    got = saso_sketch(ts.rows.reshape(m, k), ts.vals.reshape(m, k),
                      torch.from_numpy(A), d, alpha)
    assert got.dtype == torch.float32 and got.shape == (d, n)
    assert _norm_err(got, want) <= 1e-5
    # the operands are rounded to bf16: a float32 product is further away
    exact = alpha * (np.asarray(jS.materialize(), np.float64) @ A)
    assert _norm_err(got, exact) > 1e-4


def test_k4_padding_columns_add_nothing():
    """A column with index -1 (the kernel's padding) contributes zero."""
    m, k, d = 50, 4, 20
    rng = np.random.default_rng(1)
    idx = torch.from_numpy(rng.integers(0, d, (m, k)).astype(np.int32))
    sgn = torch.from_numpy(rng.choice([-1.0, 1.0], (m, k)).astype(np.float32))
    idx[7:12] = -1
    A = torch.from_numpy(_data((m, 9), 2))
    got = saso_sketch(idx, sgn, A, d)
    A_bf = A.to(torch.bfloat16).float()
    keep = torch.ones(m, dtype=torch.bool)
    keep[7:12] = False
    want = saso_sketch(idx[keep], sgn[keep], A_bf[keep], d)
    assert torch.equal(got, want)


def test_k4_takes_column_major_data():
    """The right sketch hands K4 a transposed view; the result is the same
    as for the row-major copy."""
    jS, tS = _ops((40, 300), 6)
    ts = tS.filled(device="cpu")
    A_t = torch.from_numpy(_data((17, 300), 4)).T   # (300, 17), strided
    assert not A_t.is_contiguous()
    args = (ts.rows.reshape(300, 6), ts.vals.reshape(300, 6))
    assert torch.equal(saso_sketch(*args, A_t, 40),
                       saso_sketch(*args, A_t.contiguous(), 40))


def test_k4_gate():
    assert saso_sketch_supported(1024, 65536, 8, 2048)
    assert saso_sketch_supported(1621, 100, 8, 10)   # no shared-memory limit
    assert saso_sketch_supported(4096, 100, 16, 10)
    assert not saso_sketch_supported(4097, 100, 8, 10)   # d_pad > 4096
    assert not saso_sketch_supported(1024, 65536, 17, 2048)   # slot axis
    with pytest.raises(ValueError, match="gate"):
        saso_sketch(torch.zeros((5, 17), dtype=torch.int32),
                    torch.ones((5, 17)), torch.ones((5, 3)), 100)
    with pytest.raises(ValueError, match="gate"):
        saso_sketch(torch.zeros((5, 8), dtype=torch.int32),
                    torch.ones((5, 8)), torch.ones((5, 3)), 4097)


@pytest.mark.parametrize("d", [0, 1, 60, 128, 129, 1556, 1557, 1620, 1621,
                               3968, 3969, 4096, 4097, 8192])
def test_k4_gate_equals_jax(d):
    """The port's gate is the JAX package's over k, m and n, degenerate
    sizes included."""
    for k in (0, 1, 8, 16, 17):
        for m in (0, 1, 65536):
            for n in (0, 1, 2048):
                assert saso_sketch_supported(d, m, k, n) == \
                    jsaso_supported(d, m, k, n), (d, m, k, n)


def test_k4_route_past_the_old_limit():
    """A float32 SASO sketch with 1620 < d <= 4096 takes the K4 route
    (its plain version on the CPU under use_saso_kernel=True)."""
    jS, tS = _ops((3000, 4096), 8, key=12)
    A = _data((4096, 16), 12)
    with rb.flags(use_saso_kernel="interp"):
        want = rb.sketch_general(jS, jnp.asarray(A))
    tskge.route_counts.clear()
    with rt.flags(use_saso_kernel=True):
        got = rt.sketch_general(tS.filled(device="cpu"), torch.from_numpy(A))
    assert dict(tskge.route_counts) == {"sparse_saso_kernel": 1}
    assert _norm_err(got, want) <= 1e-5


def test_k4_does_not_launch_on_the_cpu():
    tsaso_mod.saso_sketch.launches = 0
    _, tS = _ops((30, 200), 4)
    with rt.flags(use_saso_kernel=True):
        rt.sketch_general(tS.filled(device="cpu"),
                          torch.from_numpy(_data((200, 5), 0)))
    assert tsaso_mod.saso_sketch.launches == 0
    assert tskge.route_counts["sparse_saso_kernel"] >= 1


# ------------------------------------------------------- sketch_general

# (operator shape, major, side, op_s, block (d, ro_s, co_s) or None) ->
# the port's route with the K4 flag on
ROUTE_CASES = [
    ((40, 300), "Short", "left", "N", None, "sparse_saso_kernel"),
    ((300, 40), "Short", "left", "N", None, "sparse_row_gather"),
    ((300, 40), "Short", "left", "T", None, "sparse_saso_kernel"),
    ((40, 300), "Short", "left", "T", None, "sparse_row_gather"),
    ((300, 40), "Short", "right", "N", None, "sparse_saso_kernel"),
    ((40, 300), "Short", "right", "N", None, "sparse_row_gather"),
    ((40, 300), "Short", "right", "T", None, "sparse_saso_kernel"),
    ((300, 40), "Short", "right", "T", None, "sparse_row_gather"),
    ((40, 300), "Long", "left", "N", None, "sparse_coo"),
    ((300, 40), "Long", "right", "N", None, "sparse_coo"),
    ((40, 300), "Short", "left", "N", (30, 5, 7), "sparse_coo"),
    ((300, 40), "Short", "left", "T", (20, 9, 3), "sparse_coo"),
    ((40, 300), "Short", "right", "N", (25, 4, 6), "sparse_coo"),
    ((64, 64), "Short", "left", "N", None, "sparse_coo"),      # square
]


def _call(mod, S, A, side, op_s, blk, **kw):
    args = {} if blk is None else dict(d=blk[0], ro_s=blk[1], co_s=blk[2])
    return mod.sketch_general(S, A, side=side, op_s=op_s, **args, **kw)


def _data_for(shape, side, op_s, blk, n=23, seed=0):
    """Data whose contraction length fills the operator, or the block."""
    n_rows, n_cols = shape
    ro, co = (0, 0) if blk is None else blk[1:]
    if side == "left":    # op_s(block) is (d, m)
        m = n_cols - co if op_s == "N" else n_rows - ro
        return _data((m, n), seed)
    m = n_rows - ro if op_s == "N" else n_cols - co   # op_s(block): (m, d)
    return _data((n, m), seed)


@pytest.mark.parametrize("kernel", [True, False], ids=["k4", "no_k4"])
@pytest.mark.parametrize("shape,major,side,op_s,blk,route", ROUTE_CASES)
def test_sparse_routes_match_jax(shape, major, side, op_s, blk, route,
                                 kernel):
    jS, tS = _ops(shape, 6, major)
    A = _data_for(shape, side, op_s, blk)
    with rb.flags(use_saso_kernel="interp" if kernel else False):
        want = _call(rb, jS, jnp.asarray(A), side, op_s, blk, alpha=1.5)
    tskge.route_counts.clear()
    with rt.flags(use_saso_kernel=kernel):
        got = _call(rt, tS.filled(device="cpu"), torch.from_numpy(A), side,
                    op_s, blk, alpha=1.5)
    if not kernel and route == "sparse_saso_kernel":
        route = "sparse_fixed_nnz"
    assert dict(tskge.route_counts) == {route: 1}
    assert _norm_err(got, want) <= 1e-5


def test_auto_takes_no_kernel_on_the_cpu():
    _, tS = _ops((40, 300), 6)
    tskge.route_counts.clear()
    rt.sketch_general(tS.filled(device="cpu"),
                      torch.from_numpy(_data((300, 4), 1)))
    assert dict(tskge.route_counts) == {"sparse_fixed_nnz": 1}


def test_bf16_data_takes_the_fixed_nnz_route():
    """K4's gate takes float32 data only, as the JAX gate does."""
    jS, tS = _ops((40, 300), 6)
    A = _data((300, 16), 2)
    want = rb.sketch_general(jS, jnp.asarray(A, jnp.bfloat16))
    tskge.route_counts.clear()
    with rt.flags(use_saso_kernel=True):
        got = rt.sketch_general(tS.filled(device="cpu"),
                                torch.from_numpy(A).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert dict(tskge.route_counts) == {"sparse_fixed_nnz": 1}
    assert _norm_err(got, np.asarray(want, np.float32)) <= 2e-2


@pytest.mark.parametrize("side", ["left", "right"])
def test_user_triplets_take_the_coo_route(side):
    """Triplets not in the fill's order are not canonical: general COO."""
    jS, tS = _ops((40, 300), 6)
    js = jS.filled()
    perm = np.random.default_rng(5).permutation(js.rows.shape[0])
    rows, cols, vals = (np.asarray(x)[perm] for x in (js.rows, js.cols,
                                                       js.vals))
    jU = rb.SparseSkOp(jS.dist, jS.seed_state, rows=jnp.asarray(rows),
                       cols=jnp.asarray(cols), vals=jnp.asarray(vals))
    tU = rt.sparse_skop_from_jax(40, 300, 6, "Short",
                                 jS.seed_state.to_dict(), rows, cols, vals,
                                 device="cpu")
    A = _data((300, 9) if side == "left" else (9, 40), 6)
    want = rb.sketch_general(jU, jnp.asarray(A), side=side)
    tskge.route_counts.clear()
    with rt.flags(use_saso_kernel=True):
        got = rt.sketch_general(tU, torch.from_numpy(A), side=side)
    assert dict(tskge.route_counts) == {"sparse_coo": 1}
    assert _norm_err(got, want) <= 1e-5


def test_beta_and_out_match_jax():
    jS, tS = _ops((40, 300), 6)
    A, B0 = _data((300, 11), 7), _data((40, 11), 8)
    with rb.flags(use_saso_kernel="interp"):
        want = rb.sketch_general(jS, jnp.asarray(A), alpha=-1.0, beta=0.5,
                                 out=jnp.asarray(B0))
    with rt.flags(use_saso_kernel=True):
        got = rt.sketch_general(tS.filled(device="cpu"), torch.from_numpy(A),
                                alpha=-1.0, beta=0.5,
                                out=torch.from_numpy(B0))
    assert _norm_err(got, want) <= 1e-5


def test_lazy_operator_fills_on_the_data_device():
    """sketch_general fills a lazy operator where the data lies."""
    jS, tS = _ops((30, 200), 5)
    A = _data((200, 3), 9)
    got = rt.sketch_general(tS, torch.from_numpy(A))
    assert not tS.known_filled
    assert _norm_err(got, rb.sketch_general(jS, jnp.asarray(A))) <= 1e-5


def test_trig_operators_still_raise():
    with pytest.raises(NotImplementedError, match="SRHT"):
        rt.sketch_general(object(), torch.zeros((3, 3)))


def test_saso_reference_is_the_plain_version():
    _, tS = _ops((50, 400), 8)
    ts = tS.filled(device="cpu")
    A = torch.from_numpy(_data((400, 30), 10))
    args = (ts.rows.reshape(400, 8), ts.vals.reshape(400, 8), A, 50, 2.0)
    assert torch.equal(saso_sketch(*args), saso_sketch_reference(*args))
