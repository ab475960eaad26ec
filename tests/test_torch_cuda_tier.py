"""CPU guards of the port's card tier (tests/test_torch_cuda_hardware.py and
its cases, tests/_torch_cuda_cases.py):

- completeness: ``COUNTERPARTS`` maps every test function of
  tests/test_tpu_hardware.py (found by ``ast``) to the cases that port it;
- branch coverage: the branch grid reaches every load mode, cluster size,
  split count, K4 KMAX, K3 kernel and transform, K5 order and slot width,
  K6 kernel, generator and family and K7 generator, log and orientation it
  lists (``grid_required``) with the occupancy the recorded card reported,
  and each branch declares the facts its shapes give there;
- twins: every case at ``scale="cpu"`` on CPU tensors, where the wrappers
  run their plain versions, against the same checks, with no kernel
  launched; each oracle the port computed itself (a materialised
  operator, the plain fill, the plain K1, K2, K4, K5 or K6, a sparse
  operator's triplets) is held against the JAX package's counterpart at
  the same seed: Uniform values, sparse operators and triplets bit for
  bit, Gaussian values within the cross-platform tolerance (rtol = atol = 2e-3, rng/transforms.py; K6's
  float64 ones within X64_GAUSS_ULP of the JAX host engine), products
  normalised by max |want| within 1e-4 (K1, K2; 1e-2 for bf16 data) and
  1e-5 (K4, K5), the JAX kernels in interpret mode;
- import boundary: the cases and the card tier import with jax and the
  JAX package blocked.
"""

import ast
import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
import _torch_cuda_cases as cases

TESTS = Path(__file__).resolve().parent
GAUSS_TOL = dict(rtol=2e-3, atol=2e-3)   # cross-platform transcendentals
X64_GAUSS_ULP = 4   # torch's float64 sin, cos, log on the CPU vs the JAX
                    # host engine's (test_torch_x64_fill.py)
CPU = torch.device("cpu")


def test_counterparts_cover_the_tpu_tier():
    tree = ast.parse((TESTS / "test_tpu_hardware.py").read_text())
    names = {node.name for node in tree.body
             if isinstance(node, ast.FunctionDef)
             and node.name.startswith("test_")}
    assert len(names) == 29
    assert set(cases.COUNTERPARTS) == names
    # test_rowmajor_fused_on_hardware is parametrised over two generators
    assert len(cases.COUNTERPART_CASES) == 30
    assert set(cases.COUNTERPART_CASES) <= set(cases.CASES)


def test_branch_grid_reaches_every_value():
    reach = cases.grid_reach()
    for key, values in cases.grid_required().items():
        assert values <= reach[key], (key, values - reach[key])
    # without clusters of 16 the grid asks for none
    assert 16 not in cases.grid_required({8: 15})[("K1", "cluster")]


@pytest.mark.parametrize("bid", list(cases.BRANCHES))
def test_branch_declares_its_facts(bid):
    assert cases.branch_facts(bid) == cases.declared_facts(bid)


def test_k6_geometry_is_the_kernels():
    """The K6 geometry the branch facts assume is csrc/x64_fill.cu's."""
    import re
    src = (TESTS.parent / "randblas_tpu_torch" / "csrc"
           / "x64_fill.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))
    assert cases.K6_ROWS == const("X64_ROWS")
    assert cases.K6_T_STEP == (const("X64_THREADS") // const("X64_TX")
                               * const("X64_T_BLOCKS"))


def test_k7_geometry_is_the_kernels():
    """The K7 block and register log the branch facts assume are
    csrc/saso_fill.cu's."""
    import re
    from randblas_tpu_torch.ops import saso_fill
    src = (TESTS.parent / "randblas_tpu_torch" / "csrc"
           / "saso_fill.cu").read_text()
    assert cases.K7_THREADS == int(re.search(
        r"constexpr int kThreads = (\d+);", src).group(1))
    assert saso_fill.REGISTER_LOG == int(re.search(
        r"constexpr int kRegisterLog = (\d+);", src).group(1))


def test_load_mode_follows_a_map():
    x = torch.zeros((64, 36))
    assert cases.load_mode(x) == "tma_rows"
    assert cases.load_mode(x.T) == "tma_cols"
    assert cases.load_mode(x[:, 1:]) == "direct"       # base + 4 bytes
    assert cases.load_mode(x[:, :35]) == "tma_rows"    # row stride kept
    assert cases.load_mode(torch.zeros((64, 35))) == "direct"
    assert cases.load_mode(torch.zeros((64, 8), dtype=torch.bfloat16)) \
        == "tma_rows"
    assert cases.load_mode(torch.zeros((64, 4), dtype=torch.bfloat16)) \
        == "direct"
    assert cases.load_mode(torch.zeros((64, 1))) == "direct"
    # K1 pads an unaligned co_s into a new contiguous A
    assert cases.load_mode(cases.kernel_operand("K1", x.T, 3)) == "tma_rows"
    assert cases.load_mode(cases.kernel_operand("K2", x.T, 3)) == "tma_cols"


# ------------------------------------------------------------ the twins


def _dense(spec):
    dist = rb.DenseDist(*spec["shape"], rb.DenseDistName[spec["family"]],
                        rb.MajorAxis[spec["major"]])
    return rb.DenseSkOp(dist, rb.RNGState.from_dict(spec["state"]))


def _values_close(got, want, gaussian):
    assert got.shape == want.shape, (got.shape, want.shape)
    if gaussian:
        np.testing.assert_allclose(got, want, **GAUSS_TOL)
    else:
        np.testing.assert_array_equal(got, want)


def _norm_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


@functools.lru_cache(maxsize=None)
def _sparse_triplets(shape, k, major, dtype, index):
    """The JAX package's SparseSkOp.filled triplets for one distribution
    and its types, jitted once."""
    dist = rb.SparseDist(*shape, k, rb.MajorAxis[major])

    def fill(state):
        s = rb.SparseSkOp(dist, state, dtype=getattr(jnp, dtype),
                          index_dtype=getattr(jnp, index)).filled()
        return s.rows, s.cols, s.vals
    return jax.jit(fill)


@functools.lru_cache(maxsize=None)
def _sparse_materialize(shape, k, major):
    """The JAX package's SparseSkOp.materialize for one distribution,
    jitted once (it runs the sampler op by op otherwise, seconds a call)."""
    dist = rb.SparseDist(*shape, k, rb.MajorAxis[major])
    return jax.jit(lambda state: rb.SparseSkOp(dist, state).materialize())


def jax_agrees(orc: cases.PortOracle):
    """Hold a port-computed oracle against the JAX package's counterpart
    at the same seed."""
    s, value = orc.spec, orc.value
    if orc.kind in ("dense", "fill"):
        jS = _dense(s)
        rows, cols, ro, co = s["block"]
        if s.get("transform") == "boxmul_i32":
            from randblas_tpu.ops import fused_sketch as jfs
            want = jfs.pallas_fill_block(jS, rows, cols, ro, co,
                                         interpret=True)
        else:
            want = rb.fill_dense_submat(jS.dist, jS.seed_state, rows, cols,
                                        ro, co)
        _values_close(np.asarray(value), np.asarray(want),
                      s["family"] == "Gaussian")
    elif orc.kind == "fill64":
        rows, cols, ro, co = s["block"]
        jS = _dense(s)
        want = np.asarray(rb.fill_dense_submat(jS.dist, jS.seed_state, rows,
                                               cols, ro, co, jnp.float64))
        assert value.shape == want.shape, (value.shape, want.shape)
        if s["family"] == "Gaussian":
            ulps = np.abs(value - want) / np.spacing(np.abs(want))
            assert ulps.max() <= X64_GAUSS_ULP, ulps.max()
        else:
            np.testing.assert_array_equal(value, want)
    elif orc.kind == "sparse":
        want = _sparse_materialize(tuple(s["shape"]), s["k"], s["major"])(
            rb.RNGState.from_dict(s["state"]))
        np.testing.assert_array_equal(value, np.asarray(want))
    elif orc.kind == "fy":
        want = _sparse_triplets(tuple(s["shape"]), s["k"], s["major"],
                                s["dtype"], s["index"])(
            rb.RNGState.from_dict(s["state"]))
        for got, w in zip(value, want):
            assert got.dtype == np.asarray(w).dtype, (got.dtype, w.dtype)
            np.testing.assert_array_equal(got, np.asarray(w))
    elif orc.kind == "trig":
        jS = rb.TrigSkOp(rb.TrigDist(s["d"], s["m"]),
                         rb.RNGState.from_dict(s["state"]))
        np.testing.assert_allclose(value, np.asarray(jS.materialize()),
                                   rtol=1e-6, atol=1e-7)
    elif orc.kind in ("k1", "k2"):
        from randblas_tpu.ops import fused_sketch as jfs
        fn = jfs.fused_sketch if orc.kind == "k1" else \
            jfs.fused_sketch_colmajor
        d, m, ro, co = s["block"]
        a = jnp.asarray(s["a"])
        if s["dtype"] == "bfloat16":
            a = a.astype(jnp.bfloat16)
        want = fn(_dense(s), a, alpha=s["alpha"], interpret=True, rows_s=d,
                  cols_s=m, ro_s=ro, co_s=co)
        tol = 1e-2 if s["dtype"] == "bfloat16" else 1e-4
        assert _norm_err(value, np.asarray(want.astype(jnp.float32))) <= tol
    elif orc.kind == "k4":
        from randblas_tpu.ops.saso_sketch import saso_sketch as jsaso
        want = jsaso(jnp.asarray(s["idx"]), jnp.asarray(s["vals"]),
                     jnp.asarray(s["a"]), s["d"], s["alpha"], interpret=True)
        assert _norm_err(value, want) <= 1e-5
    elif orc.kind == "k5":
        from randblas_tpu.ops import ell_spmm as jell
        from randblas_tpu.sparse_data import COOMatrix, ELLMatrix
        coo = COOMatrix.from_arrays(s["m"], s["k"], s["rows"], s["cols"],
                                    s["vals"])
        jb = ELLMatrix.from_coo(coo).blocked(word_major=s["word_major"])
        want = jell.blocked_ell_matmul(jb, jnp.asarray(s["b"]),
                                       alpha=s["alpha"], interpret=True)
        # the JAX kernel rounds a repeated (row, column)'s summed value to
        # bf16, K5 each entry: one bf16 ulp apart there (test_torch_ell.py)
        key = np.asarray(s["rows"]) * s["k"] + np.asarray(s["cols"])
        repeated = len(np.unique(key)) < len(key)
        assert _norm_err(value, want) <= (2.0 ** -8 if repeated else 1e-5)
    elif orc.kind == "kfjlt":
        from randblas_tpu.tensor import _kfjlt_sample
        parts, _ = _kfjlt_sample(tuple(s["dims"]), s["d"],
                                 rb.RNGState.from_dict(s["state"]),
                                 jnp.float32)
        for (sgn, m_pad, idx), (jsgn, jm_pad, jidx) in zip(value, parts):
            assert m_pad == jm_pad
            np.testing.assert_array_equal(sgn, np.asarray(jsgn))
            np.testing.assert_array_equal(idx, np.asarray(jidx))
    else:
        raise ValueError(orc.kind)


@pytest.fixture(scope="module")
def gloo_mesh():
    import torch.distributed as dist
    from randblas_tpu_torch import parallel as par
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    par.initialize_multihost(f"localhost:{port}", num_processes=1,
                             process_id=0, backend="gloo")
    try:
        yield par.make_sketch_mesh(1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("cid", cases.COUNTERPART_CASES)
def test_counterpart_twin(cid, request):
    kw = ({"mesh": request.getfixturevalue("gloo_mesh")}
          if cid in cases.NEEDS_MESH else {})
    out = cases.CASES[cid](CPU, "cpu", **kw)
    cases.verify(out, CPU)
    for orc in out.oracles:
        jax_agrees(orc)


@pytest.mark.parametrize("bid", list(cases.BRANCHES))
def test_branch_twin(bid):
    out = cases.run_branch(bid, CPU, "cpu")
    cases.verify(out, CPU)
    assert out.oracles
    for orc in out.oracles:
        jax_agrees(orc)


def test_card_tier_imports_with_jax_blocked():
    """The cases and the card tier import with jax and the JAX package
    blocked in sys.modules, as on the card's machine, which has no JAX."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['randblas_tpu'] = None\n"
            "import _torch_cuda_cases, test_torch_cuda_hardware\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', "
            "'randblas_tpu.')) for m in sys.modules if sys.modules[m])\n"
            "print(len(_torch_cuda_cases.CASES), "
            "len(_torch_cuda_cases.BRANCHES))\n")
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=TESTS.parent, capture_output=True, text=True,
                         timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": f"{TESTS}:{TESTS.parent}"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [str(len(cases.CASES)),
                                  str(len(cases.BRANCHES))]
