"""Parity of the port's dense operators (randblas_tpu_torch.dense and
ops/dense_fill) with the JAX package, on the CPU.

Tolerances: word streams and Uniform values are exact. Gaussian values go
through float32 log/sin/cos, whose results differ across math libraries,
so they are compared at rtol/atol 2e-3 (the cross-platform tolerance the
JAX package documents in rng/transforms.py)."""

import functools

import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu import dense as jdense
from randblas_tpu.ops import dense_fill as jfill
import randblas_tpu_torch as rt
from randblas_tpu_torch.ops import dense_fill as tfill
from randblas_tpu_torch.ops import fused_sketch as tfs

GAUSS_TOL = dict(rtol=2e-3, atol=2e-3)

# (shape, family, major axis): RowMajor- and ColMajor-natural, both families
DISTS = [
    ((13, 70), "Gaussian", "Long"),    # wide Long: RowMajor
    ((70, 13), "Gaussian", "Long"),    # tall Long: ColMajor
    ((13, 70), "Uniform", "Short"),    # wide Short: ColMajor
    ((70, 13), "Uniform", "Short"),    # tall Short: RowMajor
    ((33, 70), "Uniform", "Long"),
    ((70, 33), "Gaussian", "Short"),
]


def _pair(shape, family, major, key=5, rng="philox4x32"):
    jd = rb.DenseDist(*shape, rb.DenseDistName[family], rb.MajorAxis[major])
    td = rt.DenseDist(*shape, rt.DenseDistName[family], rt.MajorAxis[major])
    return (jd, rb.RNGState.from_key(key, rng),
            td, rt.RNGState.from_key(key, rng))


def _assert_values(got, want, family):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    if family == "Uniform":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **GAUSS_TOL)


@functools.lru_cache(maxsize=None)
def _jax_full(shape, family, major):
    """The JAX package's full operator (its blocks are slices of it: the
    JAX suite's own submatrix invariant)."""
    jd, js, _, _ = _pair(shape, family, major)
    return np.asarray(rb.fill_dense_submat(jd, js, *shape))


@pytest.mark.parametrize("shape,family,major", DISTS)
@pytest.mark.parametrize("block", [(None, None, 0, 0), (9, 11, 3, 2),
                                   (5, 7, 8, 1)])
def test_fill_dense_submat_matches_jax(shape, family, major, block):
    _, _, td, ts = _pair(shape, family, major)
    r, c, ro, co = block
    r = shape[0] if r is None else r
    c = shape[1] if c is None else c
    want = _jax_full(shape, family, major)[ro:ro + r, co:co + c]
    got = rt.fill_dense_submat(td, ts, r, c, ro, co, device="cpu")
    _assert_values(got, want, family)
    assert got.is_contiguous()


def test_jax_block_is_slice_of_jax_full():
    jd, js, _, _ = _pair(*DISTS[1])
    np.testing.assert_array_equal(
        np.asarray(rb.fill_dense_submat(jd, js, 9, 11, 3, 2)),
        _jax_full(*DISTS[1])[3:12, 2:13])


@pytest.mark.parametrize("rng", ["philox4x32", "threefry4x32",
                                 "philox2x32", "threefry2x32"])
def test_word_stream_matches_jax_bitwise(rng):
    state_j = rb.RNGState.from_key(3, rng).incr(2 ** 32 - 3)
    state_t = rt.RNGState.from_key(3, rng).incr(2 ** 32 - 3)
    n_cols_parent, n_rows, n_cols, ptr = 37, 6, 29, 2 * 37 + 5
    bits, fbs = jfill.fill_rowmajor_bits(n_cols_parent, n_rows, n_cols, ptr,
                                         state_j)
    start, fbs_t, stride, nblk, _ = tfill.fill_geometry(
        n_cols_parent, n_cols, ptr, state_t.block_width)
    assert fbs_t == fbs
    words = tfill.rowmajor_words(state_t.incr(start), n_rows, nblk, stride)
    got = torch.stack(list(words), dim=-1).numpy()
    np.testing.assert_array_equal(got, np.asarray(bits).astype(np.int64))


@pytest.mark.parametrize("rng", ["philox4x32", "threefry2x32"])
@pytest.mark.parametrize("family", ["Gaussian", "Uniform"])
def test_other_generators_fill_matches_jax(rng, family):
    jd, js, td, ts = _pair((20, 41), family, "Long", key=8, rng=rng)
    _assert_values(rt.fill_dense_submat(td, ts, 7, 19, 4, 3, device="cpu"),
                   rb.fill_dense_submat(jd, js, 7, 19, 4, 3), family)


@pytest.mark.parametrize("shape,family,major", DISTS)
def test_submatrix_is_slice_of_full_bitwise(shape, family, major):
    td = rt.DenseDist(*shape, rt.DenseDistName[family], rt.MajorAxis[major])
    ts = rt.RNGState.from_key(21)
    full = rt.fill_dense_submat(td, ts, *shape, device="cpu")
    for r, c, ro, co in [(1, 1, 0, 0), (4, 9, 3, 1), (shape[0] - 2, 5, 2, 6),
                         (3, shape[1] - 1, 7, 1)]:
        sub = rt.fill_dense_submat(td, ts, r, c, ro, co, device="cpu")
        assert torch.equal(sub, full[ro:ro + r, co:co + c])


@pytest.mark.parametrize("shape,family,major", DISTS)
def test_next_state_matches_jax(shape, family, major):
    jd, js, td, ts = _pair(shape, family, major)
    js, ts = js.incr(2 ** 32 - 1), ts.incr(2 ** 32 - 1)
    assert rt.compute_next_state(td, ts).to_dict() == \
        jdense.compute_next_state(jd, js).to_dict()
    _, jnext = rb.fill_dense(jd, js)
    arr, tnext = rt.fill_dense(td, ts, device="cpu")
    assert tnext.to_dict() == jnext.to_dict()
    assert tnext.to_dict() == rt.DenseSkOp(td, ts).next_state.to_dict()
    assert tuple(arr.shape) == shape


def test_seed_chaining_concatenates_exactly():
    # wide Long operators stacked by rows continue one stream (RowMajor)
    d1 = rt.DenseDist(6, 40)
    s0 = rt.RNGState.from_key(4)
    a1, s1 = rt.fill_dense(d1, s0, device="cpu")
    a2, _ = rt.fill_dense(d1, s1, device="cpu")
    both, _ = rt.fill_dense(rt.DenseDist(12, 40), s0, device="cpu")
    assert torch.equal(torch.cat([a1, a2]), both)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("family", ["Gaussian", "Uniform"])
def test_skop_dtypes_match_jax(dtype, family):
    import jax.numpy as jnp
    jdt = {torch.float64: jnp.float64, torch.bfloat16: jnp.bfloat16}[dtype]
    jd, js, td, ts = _pair((10, 50), family, "Long")
    jS = rb.DenseSkOp(jd, js, dtype=jdt)
    tS = rt.DenseSkOp(td, ts, dtype=dtype)
    got = tS.submat(5, 20, 2, 9, device="cpu")
    assert got.dtype == dtype
    want = np.asarray(jS.submat(5, 20, 2, 9).astype(jnp.float32))
    got = got.to(torch.float32)
    if family == "Uniform":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-2, atol=1e-2)
    # a narrowing submat of a float32 operator equals the cast block
    narrow = rt.DenseSkOp(td, ts).submat(5, 20, 2, 9, dtype=dtype,
                                         device="cpu")
    wide = rt.DenseSkOp(td, ts).submat(5, 20, 2, 9, device="cpu").to(dtype)
    assert torch.equal(narrow, wide)


def test_skop_materialize_and_blackbox():
    td = rt.DenseDist(8, 30)
    S = rt.DenseSkOp(td, 3)
    full = S.materialize(device="cpu")
    assert torch.equal(full, rt.fill_dense_submat(td, S.seed_state, 8, 30,
                                                  device="cpu"))
    assert torch.equal(S.submat(3, 4, 2, 5, device="cpu"), full[2:5, 5:9])
    held = rt.DenseSkOp(td, S.seed_state, materialized=full)
    assert torch.equal(held.submat(3, 4, 2, 5), full[2:5, 5:9])
    bb = rt.DenseDist(4, 5, rt.DenseDistName.BlackBox)
    with pytest.raises(ValueError):
        rt.DenseSkOp(bb, 0)
    with pytest.raises(ValueError):
        S.submat(9, 1, 0, 0, device="cpu")


def test_lazy_fills_default_to_the_card():
    td = rt.DenseDist(8, 30, rt.DenseDistName.Uniform)
    S = rt.DenseSkOp(td, 3)
    calls = [lambda: rt.fill_dense_submat(td, S.seed_state, 8, 30),
             lambda: rt.fill_dense(td, S.seed_state)[0],
             S.materialize,
             lambda: S.submat(3, 4, 2, 5),
             lambda: tfs.fill_block(S, 8, 30),
             lambda: tfs.fill_block_reference(S, 8, 30)]
    for call in calls:
        if torch.cuda.is_available():
            assert call().is_cuda
        else:  # never a quiet fill on the CPU
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    # a held operator keeps its own tensor's device
    full = S.materialize(device="cpu")
    held = rt.DenseSkOp(td, S.seed_state, materialized=full)
    assert torch.equal(held.materialize(), full)
    assert held.submat(3, 4, 2, 5).device.type == "cpu"


def test_layout_helpers_match_jax():
    for shape, _, major in DISTS + [((16, 16), "Gaussian", "Long"),
                                    ((16, 16), "Gaussian", "Short")]:
        jd = rb.DenseDist(*shape, major_axis=rb.MajorAxis[major])
        td = rt.DenseDist(*shape, major_axis=rt.MajorAxis[major])
        assert rt.dist_to_layout(td).name == jdense.dist_to_layout(jd).name
        assert rt.major_axis_length(td) == jdense.major_axis_length(jd)
