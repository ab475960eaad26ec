"""The x64 fill K6's plain PyTorch version (randblas_tpu_torch/ops/x64_fill.py
and the tensor section of rng/x64.py) against the Random123 KAT vectors and
the JAX package, on the CPU; and the route of ``fill_dense_submat`` for an
x64 seed on a CUDA device, which runs K6 and never a host engine.

Tolerances: raw blocks, states and Uniform values bitwise; Gaussian values
within X64_PLAIN_GAUSS_ULP of the JAX package's (its numpy or native
engine): torch's sin, cos and log on the CPU against numpy's or glibc's,
each an ulp or two apart, then r * sin rounds once more.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu.rng import x64 as jx64
import randblas_tpu_torch as rt
from randblas_tpu_torch import dense as tdense
from randblas_tpu_torch import native
from randblas_tpu_torch.ops import _build
from randblas_tpu_torch.ops import x64_fill
from randblas_tpu_torch.rng import x64 as tx64
from tests.test_rng_kat import _FILE_VECTORS_64, _hex_words64

X64_RNGS = tuple(x64_fill.GEN_CODES)
X64_PLAIN_GAUSS_ULP = 4


def _pairs(words) -> list:
    """uint64[..., w] words -> w (lo, hi) limb-tensor pairs."""
    limbs = torch.from_numpy(tx64.words_to_limbs(words).astype(np.int64))
    return [(limbs[..., 2 * i], limbs[..., 2 * i + 1])
            for i in range(limbs.shape[-1] // 2)]


def _words(pairs) -> np.ndarray:
    """w (lo, hi) limb-tensor pairs -> uint64[..., w] words."""
    limbs = torch.stack([t for p in pairs for t in p], dim=-1)
    return tx64.limbs_to_words(limbs.numpy().astype(np.uint32))


def _ulps(got, want) -> float:
    return float(np.max(np.abs(got - want) / np.spacing(np.abs(want))))


def _near_wrap_state(key, rng, below):
    """A state of ``rng`` whose counter word 0 is ``below`` counters short of
    2^64 (word 1 is 7): a block past it carries into word 1."""
    w = tx64.GENERATORS_X64[rng][1]
    words = np.array([2 ** 64 - below, 7] + [0] * (w - 2), np.uint64)
    j = rb.RNGState.from_key(key, rng)
    limbs = tx64.words_to_limbs(words)
    return (rb.RNGState.from_arrays(limbs, np.asarray(j.key, np.uint32),
                                    rng),
            rt.RNGState.from_arrays(limbs, j.key, rng))


# -- the tensor block functions -----------------------------------------------

@pytest.mark.parametrize("gen", X64_RNGS)
def test_tensor_blocks_replay_kat(gen):
    rows = [r for r in _FILE_VECTORS_64 if r[0] == gen]
    assert len(rows) >= 6
    fn = tx64.GENERATORS_X64_T[gen]
    for _, rounds, ctr, key, expected in rows:
        got = fn(_pairs(_hex_words64(ctr)[None, :]),
                 [int(k) for k in _hex_words64(key)], rounds)
        np.testing.assert_array_equal(_words(got).reshape(-1),
                                      _hex_words64(expected),
                                      err_msg=f"{gen} rounds={rounds}")


@pytest.mark.parametrize("gen", X64_RNGS)
def test_tensor_blocks_match_jax(gen):
    """Random counters and keys, and counters at 0 and 2^64 - 1, through
    the tensor block function and the JAX package's numpy one."""
    _, w, kw, rounds = jx64.GENERATORS_X64[gen]
    rng = np.random.default_rng(11)
    ctrs = rng.integers(0, 2 ** 64, size=(400, w), dtype=np.uint64)
    ctrs[:4] = 2 ** 64 - 1
    ctrs[4:8] = 0
    key = rng.integers(0, 2 ** 64, size=(kw,), dtype=np.uint64)
    got = tx64.GENERATORS_X64_T[gen](_pairs(ctrs),
                                     [int(k) for k in key], rounds)
    np.testing.assert_array_equal(
        _words(got),
        jx64.GENERATORS_X64[gen][0](ctrs, key, rounds))


def test_tensor_transforms_match_jax():
    rng = np.random.default_rng(12)
    words = np.concatenate([
        rng.integers(0, 2 ** 64, size=(8000,), dtype=np.uint64),
        np.array([0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1, 2 ** 53 + 1,
                  2 ** 64 - 2 ** 11 + 1, 2 ** 64 - 2 ** 10], np.uint64)])
    (pair,) = _pairs(words[:, None])
    np.testing.assert_array_equal(tx64.u01_f64_t(pair).numpy(),
                                  jx64.u01_f64(words))
    np.testing.assert_array_equal(tx64.uneg11_f64_t(pair).numpy(),
                                  jx64.uneg11_f64(words))
    blocks = words.reshape(-1, 4)
    pairs = _pairs(blocks)
    np.testing.assert_array_equal(
        torch.stack(tx64.block_values_f64_t(pairs, "uneg11"), -1).numpy(),
        jx64.block_values_f64(blocks, "uneg11"))
    got = torch.stack(tx64.block_values_f64_t(pairs, "boxmul"), -1).numpy()
    assert _ulps(got, jx64.block_values_f64(blocks, "boxmul")) \
        <= X64_PLAIN_GAUSS_ULP


# -- the plain fill against the JAX package's ---------------------------------

def _check_fill(jS, tS, block, family):
    got = x64_fill.fill_block64_reference(tS, *block, device="cpu")
    assert got.dtype == torch.float64 and got.is_contiguous()
    want = np.asarray(rb.fill_dense_submat(jS.dist, jS.seed_state, *block,
                                           jnp.float64))
    assert got.shape == want.shape
    if family == "Uniform":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert _ulps(got.numpy(), want) <= X64_PLAIN_GAUSS_ULP
    return got


def _ops(shape, family, major, jstate, tstate):
    jd = rb.DenseDist(*shape, rb.DenseDistName[family], rb.MajorAxis[major])
    td = rt.DenseDist(*shape, rt.DenseDistName[family], rt.MajorAxis[major])
    return rb.DenseSkOp(jd, jstate), rt.DenseSkOp(td, tstate)


@pytest.mark.parametrize("gen", X64_RNGS)
@pytest.mark.parametrize("family", ["Gaussian", "Uniform"])
@pytest.mark.parametrize("shape,major", [((13, 37), "Long"),
                                         ((37, 13), "Long")])
def test_plain_fill_matches_jax(gen, family, shape, major):
    """Both natural layouts (wide+Long RowMajor, tall+Long ColMajor), the
    full operator and blocks at unaligned offsets (fbs != 0)."""
    j = rb.RNGState.from_key(0x1234_5678_9ABC_DEF0 + len(gen), gen)
    jS, tS = _ops(shape, family, major, j, rt.RNGState.from_dict(j.to_dict()))
    layout = rt.dist_to_layout(tS.dist)
    assert layout == (rt.Layout.RowMajor if shape[0] < shape[1]
                      else rt.Layout.ColMajor)
    full = _check_fill(jS, tS, (*shape, 0, 0), family)
    for r, c, ro, co in ((7, 8, 3, 5), (5, 3, 1, 2), (2, 11, 6, 1)):
        blk = _check_fill(jS, tS, (r, c, ro, co), family)
        assert torch.equal(blk, full[ro:ro + r, co:co + c])


@pytest.mark.parametrize("gen", X64_RNGS)
@pytest.mark.parametrize("shape", [(9, 50), (50, 9)])
def test_plain_fill_carries_past_word0(gen, shape):
    """Counter word 0 close enough to 2^64 that the block's counters carry
    into word 1 partway through it."""
    js, ts = _near_wrap_state(3, gen, 120)
    for family in ("Gaussian", "Uniform"):
        jS, tS = _ops(shape, family, "Long", js, ts)
        _check_fill(jS, tS, (*shape, 0, 0), family)
        _check_fill(jS, tS, (shape[0] - 2, shape[1] - 3, 1, 3), family)


def test_wrapper_on_the_cpu_is_the_plain_version():
    S = rt.DenseSkOp(rt.DenseDist(10, 30, rt.DenseDistName.Uniform),
                     rt.RNGState.from_key(4, "threefry2x64"))
    before = x64_fill.fill_block64.launches
    got = x64_fill.fill_block64(S, 6, 20, 2, 7, device="cpu")
    assert torch.equal(got, x64_fill.fill_block64_reference(S, 6, 20, 2, 7,
                                                            device="cpu"))
    assert x64_fill.fill_block64.launches == before
    with pytest.raises(ValueError, match="x64 generators"):
        x64_fill.fill_block64(rt.DenseSkOp(rt.DenseDist(4, 8), 0), 4, 8,
                              device="cpu")


# -- the route on a CUDA device -----------------------------------------------

def _forbid_host_engines(monkeypatch):
    def host(*args, **kwargs):
        raise AssertionError("a CUDA x64 fill reached a host engine")
    monkeypatch.setattr(native, "fill_rowmajor64", host)
    monkeypatch.setattr(tx64, "fill_rowmajor64", host)


@pytest.mark.parametrize("shape", [(8, 40), (40, 8)])
def test_cuda_fill_takes_k6(monkeypatch, shape):
    """``fill_dense_submat(device="cuda")`` of an x64 seed hands the plan to
    K6's launcher (stood in for here by the plain version on the CPU),
    counts it as "card", casts the float64 values to the dtype asked and
    never runs a host engine."""
    plans = []

    def launch(p, device):
        plans.append((p, torch.device(device).type))
        return x64_fill._plain64(p, "cpu")

    _forbid_host_engines(monkeypatch)
    monkeypatch.setattr(x64_fill, "_launch64", launch)
    st = rt.RNGState.from_key(9, "philox4x64")
    dist = rt.DenseDist(*shape, rt.DenseDistName.Uniform)
    tdense.x64_engine_counts.clear()
    for dtype in (torch.float64, torch.float32):
        got = rt.fill_dense_submat(dist, st, 5, 6, 2, 1, dtype, "cuda")
        want = tdense.fill_dense_submat_reference(dist, st, 5, 6, 2, 1,
                                                  dtype, "cpu")
        assert got.dtype == dtype and torch.equal(got, want)
    assert dict(tdense.x64_engine_counts) == {"card": 2}
    assert [(p.colmajor, dev) for p, dev in plans] == \
        [(shape[0] > shape[1], "cuda")] * 2


@pytest.mark.parametrize("failure", ["no_nvcc", "build_fails"])
def test_cuda_fill_raises_when_the_library_fails(monkeypatch, failure):
    """No fallback: when the kernel library cannot be built, a CUDA x64
    fill raises and no host engine fills the block instead."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def build_fails():
        raise RuntimeError("nvcc failed (exit 1)")

    _forbid_host_engines(monkeypatch)
    monkeypatch.setattr(_build, "_lib", None)
    if failure == "no_nvcc":
        monkeypatch.setattr(_build, "_nvcc", no_nvcc)
        monkeypatch.setattr(_build, "_digest", lambda: "never built")
    else:
        monkeypatch.setattr(_build, "_ensure_built", build_fails)
    tdense.x64_engine_counts.clear()
    before = x64_fill.fill_block64.launches
    S = rt.DenseSkOp(rt.DenseDist(16, 64),
                     rt.RNGState.from_key(2, "philox4x64"))
    with pytest.raises(RuntimeError, match="nvcc"):
        S.materialize(device="cuda")
    assert not tdense.x64_engine_counts
    assert x64_fill.fill_block64.launches == before


def test_cpu_fill_keeps_the_host_engines():
    """On the CPU an x64 block is still made by the host engine that
    ``use_native_x64`` picks, never by the plain version of K6."""
    st = rt.RNGState.from_key(6, "threefry4x64")
    dist = rt.DenseDist(12, 30)
    tdense.x64_engine_counts.clear()
    rt.fill_dense_submat(dist, st, 12, 30, 0, 0, torch.float64, "cpu")
    with rt.flags(use_native_x64=False):
        rt.fill_dense_submat(dist, st, 12, 30, 0, 0, torch.float64, "cpu")
    engine = "native" if native.available() else "numpy"
    assert tdense.x64_engine_counts == collections.Counter([engine, "numpy"])
