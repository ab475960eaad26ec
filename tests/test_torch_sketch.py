"""The slice as a whole: the port's sketch_general against the JAX
package's, on the CPU, with the same numpy-seeded inputs.

Tolerances (normalised by max |want|):
- staged route, float32: 1e-4. Both fill the block and multiply in float32;
  the sums run in another order and Gaussian values differ by ulps
  (cross-platform log/sin/cos).
- fused routes (K1 and K2): 1e-4. Both round the operands to bf16 (JAX
  runs its Pallas kernels in interpret mode, as tests/test_fused_coverage.py
  does); the readings are about 1.8e-7, while the float32 staged product is
  2e-3 to 2.7e-3 away, so the limit tells the two apart.
- bf16 data on the staged route: 2e-2 (bf16 products and outputs).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu import skge as jskge
from randblas_tpu.ops import fused_sketch as jfs
import randblas_tpu_torch as rt
from randblas_tpu_torch import skge as tskge

_REPO = Path(__file__).resolve().parent.parent


def _ops(shape, family="Gaussian", key=3, major="Long", rng="philox4x32"):
    jS = rb.DenseSkOp(rb.DenseDist(*shape, rb.DenseDistName[family],
                                   rb.MajorAxis[major]),
                      rb.RNGState.from_key(key, rng))
    tS = rt.DenseSkOp(rt.DenseDist(*shape, rt.DenseDistName[family],
                                   rt.MajorAxis[major]),
                      rt.RNGState.from_key(key, rng))
    return jS, tS


def _data(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _norm_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _close(got, want, atol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol)


@pytest.fixture
def jax_fused_interpret(monkeypatch):
    """Force the JAX package's fused dispatch, its Pallas kernels K1 and K2
    in interpret mode (as tests/test_fused_coverage.py does)."""
    monkeypatch.setattr(jskge, "use_fused", True)
    for name in ("fused_sketch", "fused_sketch_colmajor"):
        orig = getattr(jfs, name)

        def interp(*args, _orig=orig, **kwargs):
            kwargs["interpret"] = True
            return _orig(*args, **kwargs)

        monkeypatch.setattr(jfs, name, interp)


# (operator shape, family, major, A shape, kwargs of sketch_general)
STAGED_CASES = [
    ((32, 1024), "Gaussian", "Long", (1024, 64), {}),            # main path
    ((32, 1000), "Uniform", "Long", (990, 50),
     dict(d=20, ro_s=5, co_s=7, alpha=0.5)),
    ((1000, 24), "Gaussian", "Long", (24, 40), {}),              # ColMajor
    ((40, 300), "Uniform", "Short", (300, 16), {}),              # ColMajor
    ((300, 40), "Gaussian", "Long", (300, 20), dict(op_s="T")),  # left-Trans
    ((32, 512), "Gaussian", "Long", (40, 512), dict(op_a="T")),
    ((32, 512), "Gaussian", "Long", (50, 32), dict(side="right")),
    ((600, 30), "Uniform", "Long", (20, 500),
     dict(side="right", d=25, ro_s=7, co_s=3)),
    ((32, 512), "Gaussian", "Long", (24, 512),
     dict(side="right", op_s="T", alpha=-2.0)),
]


@pytest.mark.parametrize("shape,family,major,a_shape,kw", STAGED_CASES)
def test_staged_route_matches_jax(shape, family, major, a_shape, kw):
    jS, tS = _ops(shape, family, major=major)
    A = _data(a_shape, seed=sum(a_shape))
    tskge.route_counts.clear()
    want = rb.sketch_general(jS, jnp.asarray(A), **kw)
    got = rt.sketch_general(tS, torch.from_numpy(A), **kw)
    assert got.dtype == torch.float32
    _close(got, want, atol=1e-4)
    side = kw.get("side", "left")
    assert tskge.route_counts == {f"{side}_staged": 1}


@pytest.mark.parametrize("dtype,jdtype,atol", [
    (torch.float64, jnp.float64, 1e-12),
    (torch.bfloat16, jnp.bfloat16, 2e-2)])
def test_staged_route_other_dtypes(dtype, jdtype, atol):
    jS, tS = _ops((16, 400), "Uniform", key=8)
    A = _data((400, 24), seed=8)
    want = rb.sketch_general(jS, jnp.asarray(A, dtype=jdtype), alpha=0.25)
    got = rt.sketch_general(tS, torch.from_numpy(A).to(dtype), alpha=0.25)
    assert got.dtype == dtype
    _close(got, np.asarray(want.astype(jnp.float32)), atol=atol)


# (operator shape, family, rng, A shape, kwargs)
FUSED_CASES = [
    ((16, 2048), "Gaussian", "philox4x32", (2048, 128), {}),      # main path
    ((24, 1100), "Gaussian", "philox4x32", (1000, 60),
     dict(d=13, ro_s=4, co_s=3, alpha=0.5)),
    ((8, 600), "Uniform", "threefry4x32", (512, 32), dict(co_s=8)),
]


@pytest.mark.parametrize("shape,family,rng,a_shape,kw", FUSED_CASES)
def test_forced_fused_route_matches_jax(jax_fused_interpret, shape, family,
                                        rng, a_shape, kw):
    jS, tS = _ops(shape, family, key=5, rng=rng)
    A = _data(a_shape, seed=a_shape[1])
    want = rb.sketch_general(jS, jnp.asarray(A), **kw)
    tskge.route_counts.clear()
    with rt.flags(use_fused=True):
        got = rt.sketch_general(tS, torch.from_numpy(A), **kw)
    assert tskge.route_counts == {"left_fused": 1}
    _close(got, want, atol=1e-4)
    # and the float32 staged product, to bf16 accuracy
    staged = rt.sketch_general(tS, torch.from_numpy(A), **kw)
    _close(got, staged.numpy(), atol=2e-2)


# (operator shape, family, major, A shape, kwargs, route): every fused
# route of sketch_general, forced onto the kernels' plain versions
ROUTE_CASES = [
    ((1000, 24), "Gaussian", "Long", (24, 40), {}, "left_colmajor_fused"),
    ((40, 300), "Uniform", "Short", (290, 16),
     dict(d=33, ro_s=5, co_s=7, alpha=0.5), "left_colmajor_fused"),
    ((40, 300), "Gaussian", "Short", (50, 290),
     dict(op_a="T", d=30, ro_s=3), "left_colmajor_fused"),
    ((300, 40), "Gaussian", "Long", (300, 20), dict(op_s="T"),
     "left_trans_fused"),                                   # onto K1
    ((40, 300), "Uniform", "Long", (33, 20),
     dict(op_s="T", d=250, ro_s=7, co_s=5, alpha=-2.0),
     "left_trans_fused"),                                   # onto K2
    ((512, 64), "Gaussian", "Long", (8, 512), dict(side="right"),
     "right_fused"),
    ((600, 30), "Uniform", "Long", (20, 500),
     dict(side="right", d=25, ro_s=7, co_s=3), "right_fused"),
    ((64, 512), "Gaussian", "Long", (8, 512),
     dict(side="right", op_s="T", alpha=0.25), "right_fused"),
    ((512, 64), "Uniform", "Short", (60, 8),
     dict(side="right", op_s="T", op_a="T", d=500, co_s=2), "right_fused"),
]


@pytest.mark.parametrize("shape,family,major,a_shape,kw,route", ROUTE_CASES)
def test_forced_fused_routes_match_jax(jax_fused_interpret, shape, family,
                                       major, a_shape, kw, route):
    jS, tS = _ops(shape, family, key=9, major=major)
    A = _data(a_shape, seed=sum(a_shape))
    want = rb.sketch_general(jS, jnp.asarray(A), **kw)
    tskge.route_counts.clear()
    with rt.flags(use_fused=True):
        got = rt.sketch_general(tS, torch.from_numpy(A), **kw)
    assert tskge.route_counts == {route: 1}
    assert got.dtype == torch.float32
    _close(got, want, atol=1e-4)
    # and the float32 staged product, to bf16 accuracy
    staged = rt.sketch_general(tS, torch.from_numpy(A), **kw)
    _close(got, staged.numpy(), atol=2e-2)


@pytest.mark.parametrize("side,a_shape,out_shape,route",
                         [("left", (24, 12), (100, 12), "left_colmajor_fused"),
                          ("right", (12, 100), (12, 24), "right_fused")])
def test_fused_out_and_beta_match_jax(jax_fused_interpret, side, a_shape,
                                      out_shape, route):
    jS, tS = _ops((100, 24), "Uniform", key=2)
    A = _data(a_shape, seed=1)
    out = _data(out_shape, seed=2)
    want = rb.sketch_general(jS, jnp.asarray(A), side=side, alpha=2.0,
                             beta=0.5, out=jnp.asarray(out))
    tskge.route_counts.clear()
    with rt.flags(use_fused=True):
        got = rt.sketch_general(tS, torch.from_numpy(A), side=side,
                                alpha=2.0, beta=0.5,
                                out=torch.from_numpy(out))
    assert tskge.route_counts == {route: 1}
    _close(got, want, atol=1e-4)


@pytest.mark.parametrize("major", ["Long", "Short"])
def test_square_dists_keep_the_transposed_routes_staged(jax_fused_interpret,
                                                        major):
    # a square dist transposes to itself, so block(S)^T is not the
    # transposed dist's block: the left-Trans and right NoTrans sketches
    # take the staged route, and under use_fused=True the left one raises
    jS, tS = _ops((32, 32), major=major, key=4)
    A = _data((32, 8), seed=4)
    # the JAX package's fused left-Trans route applies the identity anyway
    # and returns another product (a fault of the reference)
    jax_left = rb.sketch_general(jS, jnp.asarray(A), op_s="T")
    M = np.asarray(jS.materialize())
    assert _norm_err(jax_left, M.T @ A) > 0.1
    tskge.route_counts.clear()
    with rt.flags(use_fused=True):
        with pytest.raises(ValueError, match="forced"):
            rt.sketch_general(tS, torch.from_numpy(A), op_s="T")
        right = rt.sketch_general(tS, torch.from_numpy(A.T), side="right")
    assert tskge.route_counts == {"right_staged": 1}
    _close(right, A.T @ M, atol=1e-4)
    left = rt.sketch_general(tS, torch.from_numpy(A), op_s="T")
    _close(left, M.T @ A, atol=1e-4)


def test_forced_fused_raises_where_the_kernel_does_not_apply():
    _, tS = _ops((300, 40))
    with rt.flags(use_fused=True):
        with pytest.raises(ValueError, match="forced"):
            rt.sketch_general(tS, torch.ones(40, 8, dtype=torch.float64))
    held = rt.DenseSkOp(tS.dist, tS.seed_state,
                        materialized=tS.materialize(device="cpu"))
    _, wide = _ops((8, 64))
    held_wide = rt.DenseSkOp(wide.dist, wide.seed_state,
                             materialized=wide.materialize(device="cpu"))
    tskge.route_counts.clear()
    with rt.flags(use_fused=False):
        rt.sketch_general(wide, torch.ones(64, 4))
    rt.sketch_general(held_wide, torch.ones(64, 4))
    rt.sketch_general(held, torch.ones(40, 4))
    assert tskge.route_counts == {"left_staged": 3}


def test_kernel_fill_staged_route_matches_jax_pallas_fill(monkeypatch):
    monkeypatch.setattr(jskge, "use_pallas_fill", True)  # interpret off-TPU
    jS, tS = _ops((24, 700), "Gaussian", key=12)
    A = _data((650, 30), seed=12)
    want = rb.sketch_general(jS, jnp.asarray(A), d=20, ro_s=2, co_s=41)
    with rt.flags(use_kernel_fill=True):
        got = rt.sketch_general(tS, torch.from_numpy(A), d=20, ro_s=2,
                                co_s=41)
    _close(got, want, atol=1e-4)


@pytest.mark.parametrize("side,a_shape,out_shape",
                         [("left", (256, 12), (16, 12)),
                          ("right", (12, 16), (12, 256))])
def test_out_and_beta_match_jax(side, a_shape, out_shape):
    jS, tS = _ops((16, 256), "Uniform", key=2)
    A = _data(a_shape, seed=1)
    out = _data(out_shape, seed=2)
    want = rb.sketch_general(jS, jnp.asarray(A), side=side, alpha=2.0,
                             beta=0.5, out=jnp.asarray(out))
    got = rt.sketch_general(tS, torch.from_numpy(A), side=side, alpha=2.0,
                            beta=0.5, out=torch.from_numpy(out))
    _close(got, want, atol=1e-5)


def test_beta_zero_overwrites_nan_out():
    _, tS = _ops((16, 256), key=2)
    A = torch.from_numpy(_data((256, 12), seed=1))
    bad = torch.full((16, 12), float("nan"))
    plain = rt.sketch_general(tS, A)
    got = rt.sketch_general(tS, A, beta=0.0, out=bad)
    assert torch.equal(got, plain)
    got_t = rt.sketch_general(tS, A, beta=torch.tensor(0.0), out=bad)
    assert torch.equal(got_t, plain)
    with pytest.raises(ValueError, match="beta"):
        rt.sketch_general(tS, A, beta=1.0)
    with pytest.raises(ValueError, match="out has shape"):
        rt.sketch_general(tS, A, beta=1.0, out=torch.zeros(3, 3))


@pytest.mark.parametrize("shape,major,kw", [
    ((16, 256), "Long", {}),                                # K1
    ((256, 16), "Long", dict(alpha=0.5)),                   # K2
    ((256, 16), "Long", dict(op_s="T", d=200, m=12, ro_s=9, co_s=3)),
])
def test_sketch_vector_matches_jax(jax_fused_interpret, shape, major, kw):
    jS, tS = _ops(shape, key=6, major=major)
    op_s = kw.get("op_s", "N")
    d, m = kw.get("d", shape[0]), kw.get("m", shape[1])
    x = _data((m if op_s == "N" else d,), seed=6)
    y = _data((d if op_s == "N" else m,), seed=7)
    want = rb.sketch_vector(jS, jnp.asarray(x), beta=0.5, out=jnp.asarray(y),
                            **kw)
    with rt.flags(use_fused=True):
        got = rt.sketch_vector(tS, torch.from_numpy(x), beta=0.5,
                               out=torch.from_numpy(y), **kw)
    _close(got, want, atol=1e-4)
    with pytest.raises(ValueError, match="x length mismatch"):
        rt.sketch_vector(tS, torch.ones(3))
    with pytest.raises(ValueError, match="both d and m"):
        rt.sketch_vector(tS, torch.from_numpy(x), d=4)


@pytest.mark.parametrize("side", ["left", "right"])
def test_sketch_symmetric_matches_jax(jax_fused_interpret, side):
    # the right operator at least half the data's size: JAX's right route
    # (a v5e gate the port does not copy) fuses only from there
    jS, tS = _ops((24, 200) if side == "left" else (200, 120), key=8)
    X = _data((200, 200), seed=8)
    A = (X + X.T) / 2
    want = rb.sketch_symmetric(jS, jnp.asarray(A), side=side, alpha=0.5)
    tskge.route_counts.clear()
    with rt.flags(use_fused=True):
        got = rt.sketch_symmetric(tS, torch.from_numpy(A), side=side,
                                  alpha=0.5)
    assert tskge.route_counts == {f"{side}_fused": 1}
    _close(got, want, atol=1e-4)


def test_require_symmetric_matches_jax():
    A = np.eye(4, dtype=np.float32)
    A[1, 2] = 0.5
    with pytest.raises(ValueError) as want:
        rb.require_symmetric(jnp.asarray(A))
    with pytest.raises(ValueError) as got:
        rt.require_symmetric(torch.from_numpy(A))
    assert str(got.value) == str(want.value)
    rt.require_symmetric(torch.from_numpy(A), tol=-1.0)
    rt.require_symmetric(torch.from_numpy(A), tol=1.0)
    _, tS = _ops((8, 4))
    with pytest.raises(ValueError, match="symmetry check failed"):
        rt.sketch_symmetric(tS, torch.from_numpy(A))
    with pytest.raises(ValueError, match="must be square"):
        rt.sketch_symmetric(tS, torch.ones(4, 3))


def test_convert_carries_operators_across():
    jS, _ = _ops((20, 300), "Uniform", key=77)
    jS = rb.DenseSkOp(jS.dist, jS.seed_state.incr(2 ** 33 + 5))
    d = jS.seed_state.to_dict()
    tS = rt.skop_from_jax(20, 300, jS.dist.family.name,
                          jS.dist.major_axis.name, d)
    np.testing.assert_array_equal(tS.materialize(device="cpu").numpy(),
                                  np.asarray(jS.materialize()))
    assert rt.state_from_jax(d).to_dict() == d
    assert rt.dist_from_jax(20, 300, "U", "L") == tS.dist
    assert tS.next_state.to_dict() == jS.next_state.to_dict()


def test_other_operators_are_not_ported_yet():
    """Operators of other types, here the JAX package's own SparseSkOp,
    raise and name the port's operator families; the port's SparseSkOp and
    TrigSkOp are taken."""
    sp = rb.SparseSkOp(rb.SparseDist(8, 64, vec_nnz=2),
                       rb.RNGState.from_key(0))
    with pytest.raises(NotImplementedError, match="TrigSkOp"):
        rt.sketch_general(sp, torch.ones(64, 3))
    tp = rt.SparseSkOp(rt.SparseDist(8, 64, vec_nnz=2),
                       rt.RNGState.from_key(0)).filled(device="cpu")
    assert rt.sketch_general(tp, torch.ones(64, 3)).shape == (8, 3)
    tt = rt.srht_operator(8, 64, device="cpu")
    assert rt.sketch_general(tt, torch.ones(64, 3)).shape == (8, 3)


def test_sketch_convenience_and_flags_restore():
    _, tS = _ops((8, 128))
    A = torch.from_numpy(_data((128, 5), seed=3))
    assert torch.equal(rt.sketch(tS, A), rt.sketch_general(tS, A))
    with pytest.raises(RuntimeError):
        with rt.flags(use_fused=True, use_kernel_fill=True):
            assert rt.get_flag("use_fused") is True
            raise RuntimeError("body fails")
    assert rt.get_flag("use_fused") == "auto"
    assert rt.get_flag("use_kernel_fill") is False
    with pytest.raises(ValueError, match="unknown"):
        rt.get_flag("use_pallas_fill")


def test_import_leaves_jax_out():
    code = ("import sys, randblas_tpu_torch, randblas_tpu_torch.ops.fused_sketch, "
            "randblas_tpu_torch.ops._build; "
            "assert 'jax' not in sys.modules, 'jax imported'; print('ok')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
