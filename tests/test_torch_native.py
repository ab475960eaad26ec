"""The port's loader of the native host engine (randblas_tpu_torch/native.py)
against native/randblas_host.cpp, the port's plain versions and the JAX
package, on the CPU.

The JAX package is reached through its pure functions (its generators,
``fill_dense_submat``, ``repeated_fisher_yates``), never through its own
loader of the library, which builds ``native/librandblas_host.so`` in
place and may find it half written while another process builds it.

Tolerances: words, Fisher-Yates indices and signs bitwise; a Uniform fill
within 1e-6 (the unscaled engine against the scaled fill divided by
sqrt(3)); the float32 Gaussian fill within 1e-3 (the engine's libm
Box-Muller against the port's and JAX's float32 ones, as
``test_native.py`` holds it); the
float64 Gaussian fill within 2 ulp of the numpy engine (libm's and numpy's
sin, cos and log a last bit apart, then r * sin rounds once more: 2 ulp at
about 0.2% of a (64, 65536) block's values). Every test that
needs the library skips, with the reason, where no C++ compiler builds it:
the fixture decides, when the test runs.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu.rng import philox4x32 as jphilox4x32
from randblas_tpu.rng import threefry4x32 as jthreefry4x32
import randblas_tpu_torch as rt
from randblas_tpu_torch import native
from randblas_tpu_torch.rng import philox4x32, threefry4x32
from randblas_tpu_torch.rng import x64 as tx64
from tests.test_rng_kat import _FILE_VECTORS_64, _hex_words64


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip("native library not built (no C++ compiler built "
                    "native/randblas_host.cpp)")
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
    jax_gen = {"philox4x32": jphilox4x32, "threefry4x32": jthreefry4x32}[gen]
    np.testing.assert_array_equal(got, np.asarray(jax_gen(ctrs, key)))


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
    against the port's plain fill and the JAX package's fill."""
    st = rt.RNGState.from_key(5, rng_name)
    dist = rt.DenseDist(9, 23, rt.DenseDistName[family])
    want = rt.fill_dense_submat(dist, st, 6, 17, 2, 3, device="cpu").numpy()
    jwant = np.asarray(rb.fill_dense_submat(
        rb.DenseDist(9, 23, rb.DenseDistName[family]),
        rb.RNGState.from_key(5, rng=rng_name), 6, 17, 2, 3))
    if family == "Uniform":
        want = want / np.float32(np.sqrt(3.0))
        jwant = jwant / np.float32(np.sqrt(3.0))
    gaussian = family == "Gaussian"
    got = lib.fill_rowmajor(23, 6, 17, 2 * 23 + 3, np.asarray(st.counter),
                            np.asarray(st.key), gaussian, rng=rng_name)
    tol = 1e-3 if gaussian else 1e-6
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, jwant, rtol=tol, atol=tol)


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
    """One build attempt per process: a failed build (every compiler
    variant of ``_variants``) leaves ``available()`` False and is not
    retried; entry points then raise."""
    calls = []

    def failing_run(*args, **kwargs):
        calls.append(args)
        raise subprocess.CalledProcessError(2, args[0])

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.subprocess, "run", failing_run)
    assert not native.available()
    assert not native.available()
    assert [c[0][:-4] for c in calls] == [[cxx, *flags]
                                          for cxx, flags in native._variants()]
    assert all(c[0][-4:-2] == ["-shared", "-o"]
               and c[0][-1] == native._SOURCE for c in calls)
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))
    with pytest.raises(RuntimeError, match="unavailable"):
        native.philox4x32(np.zeros((1, 4), np.uint32),
                          np.zeros(2, np.uint32))


_RACER = """
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
from randblas_tpu_torch import native
native._BUILD_DIR = sys.argv[2]
open(sys.argv[3] + f".ready{os.getpid()}", "w").close()
while not os.path.exists(sys.argv[3]):
    time.sleep(0.001)
ok = native.available()
block = native.philox4x32(np.arange(4, dtype=np.uint32)[None],
                          np.array([7, 9], np.uint32)) if ok else None
print(json.dumps({"ok": ok, "compiled": native.build_seconds is not None,
                  "block": None if block is None else block.tolist()}))
"""


def test_concurrent_builds_share_one_library(lib, tmp_path):
    """Two processes start the locked build into one empty build directory
    at the same moment: both load a whole library, only one compiles, no
    temporary file is left, and both give the same Philox block, the
    port's plain one."""
    build_dir, go = tmp_path / "_build", tmp_path / "go"
    repo = str(Path(__file__).resolve().parent.parent)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RACER, repo, str(build_dir), str(go)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    deadline = time.monotonic() + 120
    while len(list(tmp_path.glob("go.ready*"))) < 2:   # both imported
        assert time.monotonic() < deadline and all(
            p.poll() is None for p in procs), "a racer did not start"
        time.sleep(0.01)
    go.touch()
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert all(g["ok"] for g in got), got
    assert sorted(g["compiled"] for g in got) == [False, True]
    assert len(list(build_dir.glob("*.so"))) == 1
    assert not list(build_dir.glob("*.tmp"))
    want = philox4x32(torch.arange(4)[None], torch.tensor([7, 9]))
    assert got[0]["block"] == got[1]["block"] == want.tolist()
