"""The port's loader of the native host engine (randblas_tpu_torch/native.py)
against native/randblas_host.cpp, the port's plain versions and the JAX
package, on the CPU.

Tolerances: words, Uniform fills, Fisher-Yates indices and signs bitwise;
the float32 Gaussian fill within 1e-3 (the engine's libm Box-Muller
against the port's float32 one, as ``test_native.py`` holds it); the
float64 Gaussian fill within 2 ulp of the numpy engine (libm's and numpy's
sin, cos and log a last bit apart, then r * sin rounds once more: 2 ulp at
about 0.2% of a (64, 65536) block's values). Every test that
needs the library skips, with the reason, where no C++ compiler builds it:
the fixture decides, when the test runs.
"""

import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu import native as jnative
from randblas_tpu.rng import philox4x32 as jphilox4x32
import randblas_tpu_torch as rt
from randblas_tpu_torch import native
from randblas_tpu_torch.rng import philox4x32, threefry4x32
from randblas_tpu_torch.rng import x64 as tx64
from tests.test_rng_kat import _FILE_VECTORS_64, _hex_words64


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip("native library not built (make -C native failed or "
                    "no C++ compiler)")
    return native


def _words(rng, shape):
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)


@pytest.mark.parametrize("gen", ["philox4x32", "threefry4x32"])
def test_blocks_match_plain_and_jax(lib, gen):
    rng = np.random.default_rng(0)
    ctrs = _words(rng, (256, 4))
    key = _words(rng, (2 if gen == "philox4x32" else 4,))
    got = getattr(lib, gen)(ctrs, key)
    plain = {"philox4x32": philox4x32, "threefry4x32": threefry4x32}[gen]
    want = plain(torch.from_numpy(ctrs.astype(np.int64)),
                 torch.from_numpy(key.astype(np.int64)))
    np.testing.assert_array_equal(got, want.numpy().astype(np.uint32))
    if gen == "philox4x32":
        np.testing.assert_array_equal(got, np.asarray(jphilox4x32(ctrs,
                                                                  key)))
    else:
        np.testing.assert_array_equal(got, jnative.threefry4x32(ctrs, key))


def test_philox_kat(lib):
    ctr = np.array([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344],
                   dtype=np.uint32)
    key = np.array([0xA4093822, 0x299F31D0], dtype=np.uint32)
    np.testing.assert_array_equal(
        lib.philox4x32(ctr[None], key)[0],
        np.array([0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1],
                 dtype=np.uint32))


@pytest.mark.parametrize("gen", ["philox4x64", "threefry4x64",
                                 "philox2x64", "threefry2x64"])
def test_cbrng64_kat_and_numpy(lib, gen):
    for name, rounds, ctr, key, expected in _FILE_VECTORS_64:
        if name == gen:
            out = lib.cbrng64(gen, _hex_words64(ctr), _hex_words64(key),
                              rounds)
            np.testing.assert_array_equal(out.reshape(-1),
                                          _hex_words64(expected))
    fn, w, kw, rounds = tx64.GENERATORS_X64[gen]
    rng = np.random.default_rng(7)
    ctrs = rng.integers(0, 2 ** 64, size=(200, w), dtype=np.uint64)
    key = rng.integers(0, 2 ** 64, size=(kw,), dtype=np.uint64)
    np.testing.assert_array_equal(lib.cbrng64(gen, ctrs, key, rounds),
                                  fn(ctrs, key, rounds))


@pytest.mark.parametrize("rng_name", ["philox4x32", "threefry4x32"])
@pytest.mark.parametrize("family", ["Gaussian", "Uniform"])
def test_fill_rowmajor_matches_plain_fill(lib, rng_name, family):
    """The engine's float32 fill of a RowMajor-natural block (unscaled)
    against the port's plain fill and the JAX package's loader."""
    st = rt.RNGState.from_key(5, rng_name)
    dist = rt.DenseDist(9, 23, rt.DenseDistName[family])
    want = rt.fill_dense_submat(dist, st, 6, 17, 2, 3, device="cpu").numpy()
    if family == "Uniform":
        want = want / np.float32(np.sqrt(3.0))
    gaussian = family == "Gaussian"
    got = lib.fill_rowmajor(23, 6, 17, 2 * 23 + 3, np.asarray(st.counter),
                            np.asarray(st.key), gaussian, rng=rng_name)
    tol = 1e-3 if gaussian else 1e-6
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_array_equal(
        got, jnative.fill_rowmajor(23, 6, 17, 2 * 23 + 3,
                                   np.asarray(st.counter),
                                   np.asarray(st.key), gaussian,
                                   rng=rng_name))


@pytest.mark.parametrize("name", ["philox4x64", "threefry4x64"])
@pytest.mark.parametrize("gaussian", [False, True])
def test_fill_rowmajor64_matches_numpy_engine(lib, name, gaussian):
    st = rt.RNGState.from_key(0xFEEDFACE, name)
    transform = "boxmul" if gaussian else "uneg11"
    want = tx64.fill_rowmajor64(37, 15, 21, 3 * 37 + 2, st, transform)
    got = lib.fill_rowmajor64(37, 15, 21, 3 * 37 + 2,
                              tx64.limbs_to_words(np.asarray(st.counter)),
                              tx64.limbs_to_words(np.asarray(st.key)),
                              gaussian, name)
    if gaussian:
        np.testing.assert_array_max_ulp(got, want, maxulp=2)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rng_name", ["philox4x32", "threefry4x32"])
def test_fisher_yates_matches_plain_and_jax(lib, rng_name):
    st = rt.RNGState.from_key(7, rng_name)
    idxs, vals = lib.fisher_yates(np.asarray(st.counter), np.asarray(st.key),
                                  4, 30, 12, rng=rng_name)
    ti, tv = rt.repeated_fisher_yates(st, 4, 30, 12, device="cpu")
    np.testing.assert_array_equal(idxs, ti.numpy())
    np.testing.assert_array_equal(vals, tv.numpy())
    ji, jv = rb.repeated_fisher_yates(rb.RNGState.from_dict(st.to_dict()),
                                      4, 30, 12)
    np.testing.assert_array_equal(idxs, np.asarray(ji))
    np.testing.assert_array_equal(vals, np.asarray(jv))


def test_thread_count_invariance(lib):
    """The same fill twice, and a row block of it on its own, bitwise (the
    reference's multithreading test, test_denseskop.cc:300-341)."""
    ctr, key = np.zeros(4, np.uint32), np.array([3, 0], np.uint32)
    ref = lib.fill_rowmajor(40, 32, 40, 0, ctr, key, True)
    np.testing.assert_array_equal(ref, lib.fill_rowmajor(40, 32, 40, 0, ctr,
                                                         key, True))
    np.testing.assert_array_equal(
        ref[8:16], lib.fill_rowmajor(40, 8, 40, 8 * 40, ctr, key, True))
    st = rt.RNGState.from_key(3, "philox4x64")
    c64 = tx64.limbs_to_words(np.asarray(st.counter))
    k64 = tx64.limbs_to_words(np.asarray(st.key))
    ref64 = lib.fill_rowmajor64(41, 33, 41, 0, c64, k64, True)
    np.testing.assert_array_equal(
        ref64[5:20], lib.fill_rowmajor64(41, 15, 41, 5 * 41, c64, k64, True))


def test_loader_builds_once(monkeypatch, tmp_path):
    """One build attempt per process: a failed build (every make variant of
    ``_MAKE_ARGS``) leaves ``available()`` False and is not retried; entry
    points then raise."""
    import subprocess
    calls = []

    def failing_run(*args, **kwargs):
        calls.append(args)
        raise subprocess.CalledProcessError(2, args[0])

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_SO_PATH", str(tmp_path / "missing.so"))
    monkeypatch.setattr(native.subprocess, "run", failing_run)
    assert not native.available()
    assert not native.available()
    assert len(calls) == len(native._MAKE_ARGS)
    assert all(c[0][:2] == ["make", "-C"] for c in calls)
    assert [c[0][3:] for c in calls] == [list(a) for a in native._MAKE_ARGS]
    with pytest.raises(RuntimeError, match="unavailable"):
        native.philox4x32(np.zeros((1, 4), np.uint32),
                          np.zeros(2, np.uint32))
