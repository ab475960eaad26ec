"""The port's x64 (64-bit-counter, float64-stream) generators against the
Random123 KAT vectors and the JAX package, on the CPU: the numpy block
functions (randblas_tpu_torch/rng/x64.py), the limb view of RNGState, the
counter-addressed float64 fill and its semantics (submatrix = slice of the
full operator, autotranspose, next state and chaining), DenseSkOp's float64
deduction, and ``sketch_general`` of an x64 operator.

Tolerances: words, states and Uniform fills bitwise; the numpy engine's
Gaussian fill bitwise with the JAX package's numpy engine; products
<= 1e-12 normalised by max |want|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu import dense as jdense
from randblas_tpu.rng import x64 as jx64
import randblas_tpu_torch as rt
from randblas_tpu_torch import dense as tdense
from randblas_tpu_torch.base import MajorAxis
from randblas_tpu_torch.rng import x64 as tx64
from tests.test_rng_kat import _FILE_VECTORS_64, _hex_words64
from tests.test_rng_histograms import (HIST_U01_TF4X64, HIST_U01FIXEDPT_TF4X64,
                                       HIST_UNEG11_TF4X64, N_ITERS,
                                       _histogram, _u01_64, _u01fixedpt_64,
                                       _uneg11_64)

X64_RNGS = ["philox4x64", "threefry4x64"]
X64_RNGS_ALL = X64_RNGS + ["philox2x64", "threefry2x64"]
PROD_TOL = 1e-12


def _states(key, name):
    j = rb.RNGState.from_key(key, name)
    return j, rt.RNGState.from_dict(j.to_dict())


def _dists(shape, family="Gaussian"):
    return (rb.DenseDist(*shape, family=rb.DenseDistName[family]),
            rt.DenseDist(*shape, family=rt.DenseDistName[family]))


# -- block functions ---------------------------------------------------------

@pytest.mark.parametrize("gen", X64_RNGS_ALL)
def test_kat_replay(gen):
    rows = [r for r in _FILE_VECTORS_64 if r[0] == gen]
    assert len(rows) >= 6
    fn = tx64.GENERATORS_X64[gen][0]
    for _, rounds, ctr, key, expected in rows:
        out = fn(_hex_words64(ctr)[None, :], _hex_words64(key), rounds)
        np.testing.assert_array_equal(out.reshape(-1),
                                      _hex_words64(expected),
                                      err_msg=f"{gen} rounds={rounds}")


@pytest.mark.parametrize("gen", X64_RNGS_ALL)
def test_blocks_match_jax(gen):
    fn, w, kw, rounds = tx64.GENERATORS_X64[gen]
    assert tx64.GENERATORS_X64[gen][1:] == jx64.GENERATORS_X64[gen][1:]
    rng = np.random.default_rng(7)
    ctrs = rng.integers(0, 2 ** 64, size=(300, w), dtype=np.uint64)
    key = rng.integers(0, 2 ** 64, size=(kw,), dtype=np.uint64)
    np.testing.assert_array_equal(fn(ctrs, key, rounds),
                                  jx64.GENERATORS_X64[gen][0](ctrs, key,
                                                              rounds))


def test_limb_word_views_and_transforms_match_jax():
    rng = np.random.default_rng(3)
    words = np.concatenate([rng.integers(0, 2 ** 64, size=(4000,),
                                         dtype=np.uint64),
                            np.array([0, 1, 2 ** 63 - 1, 2 ** 63,
                                      2 ** 64 - 1], np.uint64)])
    limbs = tx64.words_to_limbs(words)
    np.testing.assert_array_equal(limbs, jx64.words_to_limbs(words))
    np.testing.assert_array_equal(tx64.limbs_to_words(limbs), words)
    np.testing.assert_array_equal(tx64.u01_f64(words), jx64.u01_f64(words))
    np.testing.assert_array_equal(tx64.uneg11_f64(words),
                                  jx64.uneg11_f64(words))
    blocks = words[:4000].reshape(-1, 4)
    for transform in ("uneg11", "boxmul"):
        np.testing.assert_array_equal(
            tx64.block_values_f64(blocks, transform),
            jx64.block_values_f64(blocks, transform))


@pytest.mark.parametrize("which", ["u01", "uneg11", "u01fixedpt"])
def test_rng_histograms_x64(which):
    """The x64 rows of test_rng_histograms.py with the port's words:
    Threefry4x64 for counters 1..1000, zero key, pinned 26-bin
    histograms."""
    ctrs = np.zeros((N_ITERS, 4), np.uint64)
    ctrs[:, 0] = np.arange(1, N_ITERS + 1, dtype=np.uint64)
    words = tx64.threefry4x64(ctrs, np.zeros(4, np.uint64), 20).reshape(-1)
    fn, want = {"u01": (_u01_64, HIST_U01_TF4X64),
                "uneg11": (_uneg11_64, HIST_UNEG11_TF4X64),
                "u01fixedpt": (_u01fixedpt_64, HIST_U01FIXEDPT_TF4X64)}[which]
    assert _histogram(fn(words)) == want


# -- RNGState ------------------------------------------------------------------

@pytest.mark.parametrize("name", X64_RNGS_ALL)
def test_state_limb_incr_matches_word_math(name):
    """``incr`` over the uint32 limbs == Random123 ctr.incr over the uint64
    words, and the JAX package's state, limb for limb."""
    j, st = _states(5, name)
    assert st.to_dict() == j.to_dict()
    st2 = st.incr(2 ** 32 - 1).incr(2 ** 32 - 1).incr(5)
    words = tx64.limbs_to_words(np.asarray(st2.counter))
    assert int(words[0]) == 2 * (2 ** 32 - 1) + 5
    assert all(int(w) == 0 for w in words[1:])
    assert st2.to_dict() == j.incr(2 ** 32 - 1).incr(2 ** 32 - 1).incr(
        5).to_dict()
    near = tx64.words_to_limbs(
        np.array([2 ** 64 - 1] + [0] * (len(words) - 1), np.uint64))
    st3 = rt.RNGState.from_arrays(near, st.key, name).incr(2)
    words3 = tx64.limbs_to_words(np.asarray(st3.counter))
    assert int(words3[0]) == 1 and int(words3[1]) == 1
    jst3 = rb.RNGState.from_arrays(near, np.asarray(j.key, np.uint32),
                                   name).incr(2)
    assert st3.to_dict() == jst3.to_dict()
    assert st.incr_key(2 ** 40 + 3).to_dict() == j.incr_key(
        2 ** 40 + 3).to_dict()


@pytest.mark.parametrize("name", X64_RNGS_ALL)
def test_state_shape_and_full_64bit_key(name):
    j, st = _states(0x123456789ABCDEF0, name)
    assert st.to_dict() == j.to_dict()
    assert int(tx64.limbs_to_words(np.asarray(st.key))[0]) == \
        0x123456789ABCDEF0
    assert st.is_x64 and st.block_width == j.block_width
    assert (st.len_c, st.len_k) == (j.len_c, j.len_k)
    assert rt.RNGState.from_dict(st.to_dict()) == st


# -- the float64 fill ----------------------------------------------------------

@pytest.mark.parametrize("name", X64_RNGS)
@pytest.mark.parametrize("family", ["Gaussian", "Uniform"])
@pytest.mark.parametrize("shape", [(8, 30), (30, 8)])
def test_submat_equals_slice_and_jax(name, family, shape):
    """Blocks of the numpy engine: bitwise the slice of the full operator
    and bitwise the JAX package's numpy engine."""
    js, ts = _states(99, name)
    jd, td = _dists(shape, family)
    with rb.flags(use_native_x64=False), rt.flags(use_native_x64=False):
        full = rt.fill_dense_submat(td, ts, *shape, 0, 0, torch.float64,
                                    device="cpu").numpy()
        jfull = np.asarray(rb.fill_dense_submat(jd, js, *shape, 0, 0,
                                                jnp.float64))
        np.testing.assert_array_equal(full, jfull)
        for ro, co, nr, nc in [(0, 0, 3, 5), (2, 3, 5, 9), (1, 0, 7, 30),
                               (5, 1, 2, 2)]:
            nr, nc = min(nr, shape[0] - ro), min(nc, shape[1] - co)
            blk = rt.fill_dense_submat(td, ts, nr, nc, ro, co,
                                       torch.float64, device="cpu")
            assert blk.dtype == torch.float64
            np.testing.assert_array_equal(blk.numpy(),
                                          full[ro:ro + nr, co:co + nc])


@pytest.mark.parametrize("name", X64_RNGS)
def test_autotranspose(name):
    _, st = _states(11, name)
    wide = rt.DenseDist(6, 20, major_axis=MajorAxis.Long)
    tall = rt.DenseDist(20, 6, major_axis=MajorAxis.Long)
    a = rt.fill_dense_submat(wide, st, 6, 20, 0, 0, torch.float64, "cpu")
    b = rt.fill_dense_submat(tall, st, 20, 6, 0, 0, torch.float64, "cpu")
    assert torch.equal(a, b.T)


@pytest.mark.parametrize("name", X64_RNGS)
def test_next_state_and_chaining(name):
    js, st = _states(3, name)
    s1 = rt.DenseSkOp(rt.DenseDist(4, 25), st)
    s2 = rt.DenseSkOp(rt.DenseDist(5, 25), s1.next_state)
    tall = rt.DenseSkOp(rt.DenseDist(9, 25), st)
    cat = torch.cat([s1.materialize(device="cpu"),
                     s2.materialize(device="cpu")])
    assert torch.equal(cat, tall.materialize(device="cpu"))
    want = jdense.compute_next_state(rb.DenseDist(9, 25), js)
    assert tall.next_state.to_dict() == want.to_dict()
    assert st.incr(-(-25 // st.block_width) * 9) == tall.next_state
    arr, nxt = rt.fill_dense(rt.DenseDist(9, 25), st, torch.float64, "cpu")
    assert torch.equal(arr, cat) and nxt.to_dict() == jdense.fill_dense(
        rb.DenseDist(9, 25), js, jnp.float64)[1].to_dict()


@pytest.mark.parametrize("family", ["Gaussian", "Uniform"])
def test_engines_and_their_count(family):
    """``use_native_x64="auto"`` takes the native engine where it builds,
    False the numpy one; ``x64_engine_counts`` says which filled. Uniform
    values agree bitwise, Gaussian ones within 1 ulp."""
    from randblas_tpu_torch import native
    _, st = _states(8, "philox4x64")
    _, td = _dists((16, 40), family)
    tdense.x64_engine_counts.clear()
    with rt.flags(use_native_x64=False):
        a = rt.fill_dense_submat(td, st, 16, 40, 0, 0, torch.float64, "cpu")
    assert tdense.x64_engine_counts == {"numpy": 1}
    b = rt.fill_dense_submat(td, st, 16, 40, 0, 0, torch.float64, "cpu")
    engine = "native" if native.available() else "numpy"
    assert tdense.x64_engine_counts[engine] == 1 + (engine == "numpy")
    if family == "Uniform":
        assert torch.equal(a, b)
    else:
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=4e-16)


def test_f64_values_are_not_f32_representable():
    _, st = _states(1, "philox4x64")
    vals = rt.fill_dense_submat(rt.DenseDist(16, 16), st, 16, 16, 0, 0,
                                torch.float64, "cpu")
    assert (vals.float().double() != vals).double().mean() > 0.9


# -- operators and sketches ----------------------------------------------------

def test_denseskop_dtype_deduction():
    assert rt.DenseSkOp(rt.DenseDist(4, 8), 0).dtype == torch.float32
    _, st = _states(0, "philox4x64")
    s64 = rt.DenseSkOp(rt.DenseDist(4, 8), st)
    assert s64.dtype == torch.float64
    full = s64.materialize(device="cpu")
    assert full.dtype == torch.float64
    s32 = rt.DenseSkOp(rt.DenseDist(4, 8), st, dtype=torch.float32)
    assert torch.equal(s32.materialize(device="cpu"), full.float())
    assert torch.equal(s64.submat(2, 3, 1, 4, dtype=torch.float32,
                                  device="cpu"), full[1:3, 4:7].float())


@pytest.mark.parametrize("name", X64_RNGS)
@pytest.mark.parametrize("family", ["Gaussian", "Uniform"])
@pytest.mark.parametrize("side", ["left", "right"])
def test_sketch_general_matches_jax(name, family, side):
    """A sketch by an x64 operator takes the staged route (host fill, then
    a float64 product) and equals the JAX package's."""
    from randblas_tpu_torch import skge
    js, ts = _states(21, name)
    jd, td = _dists((8, 40), family)
    rng = np.random.default_rng(5)
    a = rng.normal(size=(40, 6) if side == "left" else (6, 8))
    jS, tS = rb.DenseSkOp(jd, js), rt.DenseSkOp(td, ts)
    skge.route_counts.clear()
    got = rt.sketch_general(tS, torch.from_numpy(a), side=side)
    assert dict(skge.route_counts) == {f"{side}_staged": 1}
    want = np.asarray(rb.sketch_general(jS, jnp.asarray(a), side=side))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy() / np.abs(want).max(),
                               want / np.abs(want).max(), rtol=0,
                               atol=PROD_TOL)


def test_converted_x64_operator_sketches_like_jax():
    """``skop_from_jax`` carries a JAX DenseSkOp with an x64 seed (its
    float64 dtype included), and its sketch equals the JAX one."""
    js, _ = _states(44, "threefry4x64")
    jS = rb.DenseSkOp(rb.DenseDist(12, 50), js)
    tS = rt.skop_from_jax(jS)
    assert tS.dtype == torch.float64 and tS.seed_state.is_x64
    assert tS.next_state.to_dict() == jS.next_state.to_dict()
    tS2 = rt.skop_from_jax(12, 50, "Gaussian", "Long", js.to_dict())
    assert tS2.dtype == torch.float64
    a = np.random.default_rng(6).normal(size=(50, 7))
    want = np.asarray(rb.sketch_general(jS, jnp.asarray(a)))
    for op in (tS, tS2):
        got = rt.sketch_general(op, torch.from_numpy(a)).numpy()
        np.testing.assert_allclose(got / np.abs(want).max(),
                                   want / np.abs(want).max(), rtol=0,
                                   atol=PROD_TOL)


def test_other_consumers_of_x64_states_raise():
    """Sparse operators and the samplers have no x64 stream, as in the JAX
    package: they raise rather than fill."""
    _, st = _states(2, "philox4x64")
    with pytest.raises(ValueError):
        rt.SparseSkOp(rt.SparseDist(4, 30, vec_nnz=2), st).filled("cpu")
    with pytest.raises(ValueError):
        rt.sample_indices_iid_uniform(10, 5, st, device="cpu")
