"""Sparse data containers, conversions, SpMM, sketch_sparse and
MatrixMarket IO: the port against the JAX package on the CPU, same
numpy-seeded inputs.

Tolerances:
- containers, conversions and index arrays: equal, element for element.
- products through COO (left_spmm/right_spmm/spmm, sketch_sparse): 1e-5 of
  max |want|; float32 sums in another order (segment_sum / scatter against
  index_add_ / index_put_).
- products through BlockedELL (JAX's Pallas kernel in interpret mode
  against K5's plain version): 1e-5 of max |want| on data without repeated
  (row, column) pairs; both round to bf16 (tests/test_torch_ell.py).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu import io as jio
from randblas_tpu import sparse_data as jsd
from randblas_tpu.ops import ell_spmm as jell
import randblas_tpu_torch as rt
from randblas_tpu_torch import io as tio
from randblas_tpu_torch import sparse_data as tsd
from randblas_tpu_torch.ops import ell_spmm as tell

_MTX = Path(__file__).resolve().parent.parent / "data" / "sparse_rank20.mtx"
FORMATS = ["COOMatrix", "CSRMatrix", "CSCMatrix", "ELLMatrix"]


def _dense(n_rows, n_cols, seed, density=0.25):
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((n_rows, n_cols)).astype(np.float32)
    return mat * (rng.random(mat.shape) < density)


def _both(cls, dense):
    return (getattr(jsd, cls).from_dense(jnp.asarray(dense)),
            getattr(tsd, cls).from_dense(dense, device="cpu"))


def _close(got, want, atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max() or 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol)


def _arrays_equal(t_obj, j_obj, names):
    for name in names:
        np.testing.assert_array_equal(getattr(t_obj, name).numpy(),
                                      np.asarray(getattr(j_obj, name)))


# ------------------------------------------------------------ containers


def test_containers_equal_jax():
    dense = _dense(13, 9, seed=1)
    j, t = _both("COOMatrix", dense)
    _arrays_equal(t, j, ("rows", "cols", "vals"))
    assert t.sort.name == j.sort.name and t.nnz == j.nnz
    j, t = _both("CSRMatrix", dense)
    _arrays_equal(t, j, ("rowptr", "colidxs", "vals"))
    np.testing.assert_array_equal(t.row_indices().numpy(),
                                  np.asarray(j.row_indices()))
    j, t = _both("CSCMatrix", dense)
    _arrays_equal(t, j, ("colptr", "rowidxs", "vals"))
    np.testing.assert_array_equal(t.col_indices().numpy(),
                                  np.asarray(j.col_indices()))
    j, t = _both("ELLMatrix", dense)
    _arrays_equal(t, j, ("colidxs", "vals"))
    for cls in FORMATS:
        np.testing.assert_array_equal(_both(cls, dense)[1].to_dense().numpy(),
                                      dense)


def test_conversions_and_transposes_equal_jax():
    rng = np.random.default_rng(2)
    r, c = rng.integers(0, 20, 60), rng.integers(0, 15, 60)
    v = rng.standard_normal(60).astype(np.float32)
    j = jsd.COOMatrix.from_arrays(20, 15, r, c, v)
    t = tsd.COOMatrix.from_arrays(20, 15, r, c, v, device="cpu")
    assert t.sort.name == j.sort.name == "NONE"
    for fn, names in (("coo_to_csr", ("rowptr", "colidxs", "vals")),
                      ("coo_to_csc", ("colptr", "rowidxs", "vals"))):
        _arrays_equal(getattr(tsd, fn)(t), getattr(jsd, fn)(j), names)
    for order in ("CSR", "CSC"):
        _arrays_equal(t.sorted(tsd.NonzeroSort[order]),
                      j.sorted(jsd.NonzeroSort[order]),
                      ("rows", "cols", "vals"))
    jt, tt = j.transpose(), t.transpose()
    assert tt.shape == jt.shape == (15, 20)
    back = tsd.csr_to_coo(tsd.coo_to_csr(t))
    _arrays_equal(back, jsd.csr_to_coo(jsd.coo_to_csr(j)),
                  ("rows", "cols", "vals"))
    _arrays_equal(tsd.csc_to_coo(tsd.coo_to_csc(t)),
                  jsd.csc_to_coo(jsd.coo_to_csc(j)), ("rows", "cols", "vals"))
    csr_t = tsd.transpose_as_csc(tsd.coo_to_csr(t))
    np.testing.assert_array_equal(csr_t.to_dense().numpy(),
                                  np.asarray(j.to_dense()).T)
    csc_t = tsd.transpose_as_csr(tsd.coo_to_csc(t))
    np.testing.assert_array_equal(csc_t.to_dense().numpy(),
                                  np.asarray(j.to_dense()).T)
    _arrays_equal(tsd.ell_to_coo(tsd.coo_to_ell(t)),
                  jsd.ell_to_coo(jsd.coo_to_ell(j)), ("rows", "cols", "vals"))


def test_sort_detection_and_index_base_equal_jax():
    rows, cols = np.array([1, 2, 3]), np.array([1, 1, 2])
    vals = np.array([1.0, 2.0, 3.0], np.float32)
    for r, c in ((rows, cols), (cols[::-1].copy(), rows[::-1].copy()),
                 (rows[[1, 0, 2]], cols[[1, 0, 2]])):
        j = jsd.COOMatrix.from_arrays(4, 4, r, c, vals)
        t = tsd.COOMatrix.from_arrays(4, 4, r, c, vals, device="cpu")
        assert t.sort.name == j.sort.name
    one = tsd.IndexBase.One
    t = tsd.COOMatrix.from_arrays(3, 2, rows, cols, vals, index_base=one,
                                  device="cpu")
    j = jsd.COOMatrix.from_arrays(3, 2, rows, cols, vals,
                                  index_base=jsd.IndexBase.One)
    np.testing.assert_array_equal(t.to_dense().numpy(),
                                  np.asarray(j.to_dense()))
    t = tsd.CSRMatrix.from_arrays(2, 3, [0, 1, 3], [1, 2, 3], [1.0, 2.0, 3.0],
                                  index_base=one, device="cpu")
    j = jsd.CSRMatrix.from_arrays(2, 3, np.array([0, 1, 3]),
                                  np.array([1, 2, 3]),
                                  np.array([1.0, 2.0, 3.0]),
                                  index_base=jsd.IndexBase.One)
    np.testing.assert_array_equal(t.to_dense().numpy(),
                                  np.asarray(j.to_dense()))


def test_host_arrays_go_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsd.COOMatrix.from_arrays(2, 2, [0], [1], [1.0])
    t = tsd.COOMatrix.from_arrays(2, 2, torch.tensor([0]), torch.tensor([1]),
                                  torch.tensor([1.0]))
    assert t.device.type == "cpu"


# ------------------------------------------------------------ SpMM


@pytest.mark.parametrize("cls", FORMATS)
@pytest.mark.parametrize("op_a", ["N", "T"])
@pytest.mark.parametrize("op_b", ["N", "T"])
def test_left_spmm_matches_jax(cls, op_a, op_b):
    d, m, n = 7, 9, 4
    dense = _dense(d, m, 6) if op_a == "N" else _dense(m, d, 6)
    jA, tA = _both(cls, dense)
    B = np.random.default_rng(7).standard_normal(
        (m, n) if op_b == "N" else (n, m)).astype(np.float32)
    want = rb.left_spmm(jA, jnp.asarray(B), op_a=op_a, op_b=op_b, d=d,
                        alpha=1.5)
    got = rt.left_spmm(tA, torch.from_numpy(B), op_a=op_a, op_b=op_b, d=d,
                       alpha=1.5)
    _close(got, want)


@pytest.mark.parametrize("cls", FORMATS)
@pytest.mark.parametrize("op_b", ["N", "T"])
def test_right_spmm_matches_jax(cls, op_b):
    m, k, d = 5, 8, 6
    dense = _dense(k, d, 8) if op_b == "N" else _dense(d, k, 8)
    jB, tB = _both(cls, dense)
    A = np.random.default_rng(9).standard_normal((m, k)).astype(np.float32)
    want = rb.right_spmm(jnp.asarray(A), jB, op_b=op_b, d=d)
    got = rt.right_spmm(torch.from_numpy(A), tB, op_b=op_b, d=d)
    _close(got, want)


@pytest.mark.parametrize("cls", FORMATS)
@pytest.mark.parametrize("side", ["left", "right"])
def test_spmm_offsets_alpha_beta_match_jax(cls, side):
    dense = _dense(12, 14, 10)
    jS, tS = _both(cls, dense)
    rng = np.random.default_rng(11)
    if side == "left":   # op_a(submat(A)) is (6, 8) at (3, 4)
        B, C = rng.standard_normal((8, 5)), rng.standard_normal((6, 5))
        kw = dict(d=6, ro_a=3, co_a=4)
    else:                # op_b(submat(B)) is (8, 6) at (2, 5)
        B, C = rng.standard_normal((5, 8)), rng.standard_normal((5, 6))
        kw = dict(d=6, ro_b=2, co_b=5)
    B, C = B.astype(np.float32), C.astype(np.float32)
    args_j = (jS, jnp.asarray(B)) if side == "left" else (jnp.asarray(B), jS)
    args_t = ((tS, torch.from_numpy(B)) if side == "left"
              else (torch.from_numpy(B), tS))
    want = rb.spmm(*args_j, side=side, alpha=-2.0, beta=0.5,
                   out=jnp.asarray(C), **kw)
    got = rt.spmm(*args_t, side=side, alpha=-2.0, beta=0.5,
                  out=torch.from_numpy(C), **kw)
    _close(got, want)


@pytest.fixture
def jax_bell_interpret(monkeypatch):
    """Route the JAX package's BlockedELL products through its Pallas
    kernel in interpret mode."""
    monkeypatch.setattr(jell, "force_interpret", True)


@pytest.mark.parametrize("cls", ["COOMatrix", "CSRMatrix", "CSCMatrix"])
def test_auto_blocked_ell_matches_jax(cls):
    """A full untransposed product converts the data to BlockedELL once and
    goes through K5 (its plain version here, asked for with True). The JAX
    package takes that route only past its v5e gates, so the reference is
    its kernel on the same conversion."""
    dense = _dense(300, 400, 12, density=0.02)
    jA, tA = _both(cls, dense)
    B = np.random.default_rng(13).standard_normal((400, 130)).astype(
        np.float32)
    jb = jsd.ELLMatrix.from_coo(jsd.to_coo(jA)).blocked()
    want = jell.blocked_ell_matmul(jb, jnp.asarray(B), 0.5, interpret=True)
    tell.blocked_ell_matmul.launches = 0
    with rt.flags(auto_blocked_ell=True):
        got = rt.left_spmm(tA, torch.from_numpy(B), alpha=0.5)
        again = rt.left_spmm(tA, torch.from_numpy(B), alpha=0.5)
    assert getattr(tA, "_bell_cache").device.type == "cpu"
    assert torch.equal(got, again)
    assert tell.blocked_ell_matmul.launches == 0
    _close(got, want)
    # on CPU tensors "auto" keeps the COO route: float32 operands
    exact = rt.left_spmm(tA, torch.from_numpy(B), alpha=0.5)
    _close(exact, 0.5 * dense @ B)


def test_blocked_ell_left_spmm_matches_jax(jax_bell_interpret):
    dense = _dense(200, 300, 14, density=0.03)
    jb = jsd.ELLMatrix.from_dense(jnp.asarray(dense)).blocked(word_major=4)
    tb = tsd.ELLMatrix.from_dense(dense, device="cpu").blocked(word_major=4)
    B = np.random.default_rng(15).standard_normal((jb.b_rows, 20)).astype(
        np.float32)
    _close(rt.left_spmm(tb, torch.from_numpy(B)),
           rb.left_spmm(jb, jnp.asarray(B)))
    with pytest.raises(ValueError, match="full untransposed"):
        rt.left_spmm(tb, torch.from_numpy(B), ro_a=1, d=199)


# ------------------------------------------------------------ sketch_sparse


def _dense_ops(shape, key=0, major="Long"):
    return (rb.DenseSkOp(rb.DenseDist(*shape, major_axis=rb.MajorAxis[major]),
                         rb.RNGState.from_key(key)),
            rt.DenseSkOp(rt.DenseDist(*shape, major_axis=rt.MajorAxis[major]),
                         rt.RNGState.from_key(key)))


SKSP_CASES = [
    # (side, op_s, op_a, operator shape, data shape, kwargs)
    ("left", "N", "N", (6, 15), (15, 7), {}),
    ("left", "T", "N", (15, 6), (15, 7), {}),
    ("left", "N", "T", (6, 15), (7, 15), {}),
    ("left", "N", "N", (8, 20), (15, 7), dict(ro_s=2, co_s=3)),
    ("left", "N", "N", (6, 12), (15, 9), dict(ro_a=2, co_a=1)),
    ("right", "N", "N", (15, 6), (7, 15), {}),
    ("right", "T", "N", (6, 15), (7, 15), {}),
    ("right", "N", "T", (15, 6), (15, 7), {}),
    ("right", "N", "N", (18, 9), (7, 15), dict(ro_s=3, co_s=2, d=5)),
]


@pytest.mark.parametrize("cls", ["COOMatrix", "CSRMatrix"])
@pytest.mark.parametrize("side,op_s,op_a,s_shape,a_shape,kw", SKSP_CASES)
def test_sketch_sparse_matches_jax(cls, side, op_s, op_a, s_shape, a_shape,
                                   kw):
    jS, tS = _dense_ops(s_shape, key=3)
    jA, tA = _both(cls, _dense(*a_shape, seed=16))
    want = rb.sketch_sparse(jS, jA, side=side, op_s=op_s, op_a=op_a,
                            alpha=2.0, **kw)
    got = rt.sketch_sparse(tS, tA, side=side, op_s=op_s, op_a=op_a,
                           alpha=2.0, **kw)
    _close(got, want)


@pytest.mark.parametrize("op_s,major", [("N", "Long"), ("N", "Short"),
                                        ("T", "Long")])
def test_sketch_sparse_word_major_blocked_ell_matches_jax(
        op_s, major, jax_bell_interpret):
    """Config 4b's form: a word-major BlockedELL sketched from the right.
    JAX hands its kernel the operator block in storage order; the port
    hands K5 the natural block and K5 maps the rows."""
    m, n, d = 150, 301, 24
    dense = _dense(m, n, 17, density=0.02)
    jb = jsd.ELLMatrix.from_dense(jnp.asarray(dense)).blocked(word_major=4)
    tb = tsd.ELLMatrix.from_dense(dense, device="cpu").blocked(word_major=4)
    jS, tS = _dense_ops((n, d) if op_s == "N" else (d, n), key=4,
                        major=major)
    tell.blocked_ell_matmul.launches = 0
    want = rb.sketch_sparse(jS, jb, side="right", op_s=op_s)
    got = rt.sketch_sparse(tS, tb, side="right", op_s=op_s)
    assert got.shape == (m, d)
    _close(got, want)
    # the left side needs the transposed data: BlockedELL refuses, as in JAX
    with pytest.raises(ValueError, match="full untransposed"):
        rb.sketch_sparse(*_dense_ops((d, m))[:1], jb, side="left")
    with pytest.raises(ValueError, match="full untransposed"):
        rt.sketch_sparse(_dense_ops((d, m))[1], tb, side="left")


def test_sketch_sparse_out_and_beta_match_jax():
    jS, tS = _dense_ops((6, 15), key=5)
    jA, tA = _both("CSCMatrix", _dense(15, 7, seed=18))
    C = np.random.default_rng(19).standard_normal((6, 7)).astype(np.float32)
    want = rb.sketch_sparse(jS, jA, beta=0.5, out=jnp.asarray(C))
    got = rt.sketch_sparse(tS, tA, beta=0.5, out=torch.from_numpy(C))
    _close(got, want)
    with pytest.raises(ValueError):
        rt.sketch_sparse(tS, tA, beta=0.5)


# ------------------------------------------------------------ io


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc", "ell", "dense"])
def test_load_matrix_market_matches_jax(fmt):
    want = jio.load_matrix_market(str(_MTX), fmt)
    got = tio.load_matrix_market(str(_MTX), fmt, device="cpu")
    if fmt == "dense":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    assert got.shape == want.shape == (2000, 1500)
    for name in {"coo": ("rows", "cols", "vals"),
                 "csr": ("rowptr", "colidxs", "vals"),
                 "csc": ("colptr", "rowidxs", "vals"),
                 "ell": ("colidxs", "vals")}[fmt]:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


def test_sketch_of_the_matrix_market_data_matches_jax():
    """The flat-buffer API on the repository's MatrixMarket matrix: a SASO
    sketch of its dense form, and a dense sketch of its sparse form."""
    from randblas_tpu import compat as jcompat
    from randblas_tpu_torch import compat as tcompat
    jA = jio.load_matrix_market(str(_MTX), "csr")
    tA = tio.load_matrix_market(str(_MTX), "csr", device="cpu")
    jS, tS = _dense_ops((64, 2000), key=6)
    _close(rt.sketch_sparse(tS, tA), rb.sketch_sparse(jS, jA))
    dense = np.asarray(jio.load_matrix_market(str(_MTX), "dense"))
    st = rb.RNGState.from_key(7).to_dict()
    jO = rb.SparseSkOp(rb.SparseDist(64, 2000, 8), rb.RNGState.from_dict(st))
    tO = rt.sparse_skop_from_jax(64, 2000, 8, "Short", st)
    outs = []
    for mod, S, kw in ((jcompat, jO, {}),
                       (tcompat, tO.filled(device="cpu"), {"device": "cpu"})):
        b_buf = np.zeros(64 * 1500, np.float32)
        mod.sketch_general(rb.Layout.RowMajor if mod is jcompat
                           else rt.Layout.RowMajor, "N", "N", 64, 1500, 2000,
                           1.0, S, 0, 0, dense.reshape(-1), 1500, 0.0, b_buf,
                           1500, **kw)
        outs.append(b_buf)
    _close(outs[1], outs[0])


def test_save_matrix_market_round_trip(tmp_path):
    dense = _dense(12, 9, seed=20, density=0.4)
    path = str(tmp_path / "m.mtx")
    tio.save_matrix_market(path, tsd.COOMatrix.from_dense(dense,
                                                         device="cpu"))
    for fmt in ("coo", "csr", "csc", "ell"):
        got = tio.load_matrix_market(path, fmt, device="cpu")
        np.testing.assert_allclose(got.to_dense().numpy(), dense, rtol=1e-6)
    tio.save_matrix_market(path, torch.from_numpy(dense))
    np.testing.assert_allclose(
        jio.load_matrix_market(path, "dense"), dense, rtol=1e-6)


def test_converted_containers_match_jax():
    dense = _dense(10, 8, seed=21)
    j = jsd.COOMatrix.from_dense(jnp.asarray(dense))
    t = rt.coo_from_jax(10, 8, np.asarray(j.rows), np.asarray(j.cols),
                        np.asarray(j.vals), j.sort.value, device="cpu")
    assert t.sort.name == j.sort.name
    np.testing.assert_array_equal(t.to_dense().numpy(), dense)
    j = jsd.CSRMatrix.from_dense(jnp.asarray(dense))
    t = tsd.CSRMatrix.from_arrays(10, 8, *(np.asarray(x) for x in (
        j.rowptr, j.colidxs, j.vals)), device="cpu")
    np.testing.assert_array_equal(t.to_dense().numpy(), dense)
    j = jsd.CSCMatrix.from_dense(jnp.asarray(dense))
    t = tsd.CSCMatrix.from_arrays(10, 8, *(np.asarray(x) for x in (
        j.colptr, j.rowidxs, j.vals)), device="cpu")
    np.testing.assert_array_equal(t.to_dense().numpy(), dense)
    j = jsd.ELLMatrix.from_dense(jnp.asarray(dense))
    t = rt.ell_from_jax(10, 8, np.asarray(j.colidxs), np.asarray(j.vals),
                        device="cpu")
    np.testing.assert_array_equal(t.to_dense().numpy(), dense)
