"""Sparse-sign operators, the COO products and the flat-buffer API of the
port against the JAX package, on the CPU, with the same numpy-seeded
inputs.

Tolerances:
- Fisher-Yates indices, signs, next states and printed operators: equal,
  bit for bit (the stream contract).
- COO products: 1e-5 of max |want|. Both sum float32 terms, in another
  order (segment_sum against index_add_).
- compat: as the products it wraps, 1e-5 of max |want|.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu import compat as jcompat
from randblas_tpu.ops import coo_apply as jcoo
import randblas_tpu_torch as rt
from randblas_tpu_torch import compat as tcompat
from randblas_tpu_torch.ops import coo_apply as tcoo

_KEY_WORDS = {"philox4x32": 2, "philox2x32": 1, "threefry4x32": 4,
              "threefry2x32": 2}


def _state_dict(rng, carry):
    """A state dict; ``carry`` puts word 0 of the counter just below 2^32
    (and word 1 at its top for 4-word counters), so the vector offsets
    i * vec_nnz + j carry across words."""
    n_ctr = 4 if "4x" in rng else 2
    ctr = [0] * n_ctr
    if carry:
        ctr[0] = 0xFFFFFFF0
        if n_ctr == 4:
            ctr[1] = 0xFFFFFFFF
    key = [0x9E3779B9 + i for i in range(_KEY_WORDS[rng])]
    return {"rng": rng, "counter": ctr, "key": key}


def _ops(shape, k, major="Short", state=None, key=5):
    state = state or rb.RNGState.from_key(key).to_dict()
    jS = rb.SparseSkOp(rb.SparseDist(*shape, k, rb.MajorAxis[major]),
                       rb.RNGState.from_dict(state))
    tS = rt.SparseSkOp(rt.SparseDist(*shape, k, rt.MajorAxis[major]),
                       rt.RNGState.from_dict(state))
    return jS, tS


def _close(got, want, atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max() or 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol)


# ------------------------------------------------------------ Fisher-Yates


@pytest.mark.parametrize("rng", sorted(_KEY_WORDS))
@pytest.mark.parametrize("carry", [False, True], ids=["key", "carry"])
@pytest.mark.parametrize("shape,major", [
    ((12, 300), "Short"), ((300, 12), "Short"),   # SASO wide, tall
    ((12, 300), "Long"), ((300, 12), "Long"),     # LASO wide, tall
])
def test_fill_matches_jax_bitwise(rng, carry, shape, major):
    state = _state_dict(rng, carry)
    k = 5 if major == "Short" else 7
    jS, tS = _ops(shape, k, major, state)
    js, ts = jS.filled(), tS.filled(device="cpu")
    for name in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    assert ts.canonical and js.canonical


@pytest.mark.parametrize("rng", ["philox4x32", "threefry4x32"])
def test_repeated_fisher_yates_matches_jax(rng):
    st = _state_dict(rng, carry=True)
    j_idx, j_val = rb.repeated_fisher_yates(rb.RNGState.from_dict(st), 8,
                                            1024, 700)
    t_idx, t_val = rt.repeated_fisher_yates(rt.RNGState.from_dict(st), 8,
                                            1024, 700, device="cpu")
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_val.numpy(), np.asarray(j_val))
    assert t_idx.dtype == torch.int32 and t_val.dtype == torch.float32


@pytest.mark.parametrize("k,dim_major", [(1, 1), (3, 3), (16, 16), (8, 9)])
def test_draws_without_replacement(k, dim_major):
    """Every vector's k indices are distinct, including k == dim_major."""
    idx, vals = rt.repeated_fisher_yates(rt.RNGState.from_key(1), k,
                                         dim_major, 500, device="cpu")
    srt = idx.sort(dim=1).values
    assert bool((srt[:, 1:] != srt[:, :-1]).all())
    assert int(idx.min()) >= 0 and int(idx.max()) < dim_major
    assert set(vals.unique().tolist()) <= {-1.0, 1.0}


def test_first_vectors_equal_a_shorter_draw():
    st = rt.RNGState.from_dict(_state_dict("philox4x32", carry=True))
    full = rt.repeated_fisher_yates(st, 6, 50, 400, device="cpu")
    head = rt.repeated_fisher_yates(st, 6, 50, 37, device="cpu")
    for a, b in zip(full, head):
        assert torch.equal(a[:37], b)


@pytest.mark.parametrize("shape,k,major", [
    ((10, 300), 4, "Short"), ((300, 10), 4, "Short"),
    ((10, 300), 4, "Long"), ((300, 10), 4, "Long"), ((64, 64), 8, "Short"),
])
def test_next_state_min_quirk(shape, k, major):
    """The Short-major next state advances by min(n_rows, n_cols) * k,
    though the fill consumes max(n_rows, n_cols) * k counters: the
    reference's formula, kept as part of the stream contract."""
    jS, tS = _ops(shape, k, major)
    assert tS.next_state.to_dict() == jS.next_state.to_dict()
    minor = min(shape) if major == "Short" else max(shape)
    assert tS.next_state.counter[0] == minor * k
    assert rt.sparse.sparse_nnz(tS.dist) == rb.sparse.sparse_nnz(jS.dist)


def test_materialize_transpose_and_print():
    jS, tS = _ops((9, 40), 3)
    _close(tS.materialize(device="cpu"), jS.materialize(), atol=0)
    jT, tT = jS.transpose(), tS.transpose(device="cpu")
    assert tT.shape == (40, 9) and tT.canonical == jT.canonical
    _close(tT.materialize(), jT.materialize(), atol=0)
    j_out, t_out = io.StringIO(), io.StringIO()
    rb.print_sparse(jS, file=j_out)
    rt.print_sparse(tS, file=t_out, device="cpu")
    assert t_out.getvalue() == j_out.getvalue()
    assert "filled" in repr(tS.filled(device="cpu")) and "lazy" in repr(tS)


def test_user_triplets_are_not_canonical():
    rows = torch.tensor([0, 2, 1], dtype=torch.int32)
    S = rt.SparseSkOp(rt.SparseDist(3, 5, 1), 0, rows=rows,
                      cols=torch.tensor([4, 0, 1]),
                      vals=torch.tensor([1.0, -1.0, 1.0]), canonical=False)
    assert S.known_filled and not S.canonical
    assert S.filled(device="cpu") is S
    with pytest.raises(ValueError):
        rt.SparseSkOp(rt.SparseDist(3, 5, 1), 0, rows=rows)


def test_fill_defaults_to_the_card(monkeypatch):
    """A lazy operator fills on the card unless asked for the CPU, and
    raises when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tS = _ops((8, 30), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tS.filled()
    assert tS.filled(device="cpu").rows.device.type == "cpu"


def test_dist_checks_match():
    for args in [(0, 5, 1), (5, 5, 0), (4, 100, 5)]:
        with pytest.raises(ValueError):
            rb.SparseDist(*args)
        with pytest.raises(ValueError):
            rt.SparseDist(*args)


# ------------------------------------------------------------ COO products


def _coo(d, m, nnz, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, d, nnz), rng.integers(0, m, nnz),
            rng.standard_normal(nnz).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("fn", ["coo_left_apply", "coo_left_apply_dense",
                                "coo_left_apply_panels",
                                "coo_left_apply_auto"])
@pytest.mark.parametrize("window", [(40, 60, 0, 0), (25, 33, 7, 11)])
def test_coo_products_match_jax(fn, window):
    d, m, ro, co = window
    rows, cols, vals = _coo(50, 80, 400, seed=d + m)
    b = np.random.default_rng(1).standard_normal((m, 70)).astype(np.float32)
    kw = {"panel": 16} if fn == "coo_left_apply_panels" else {}
    want = getattr(jcoo, fn)(rows, cols, vals, b, d, m, ro, co, 0.5, **kw)
    got = getattr(tcoo, fn)(*_t(rows, cols, vals, b), d, m, ro, co, 0.5,
                            **kw)
    _close(got, want)


def test_coo_densify_matches_jax():
    rows, cols, vals = _coo(30, 40, 300, seed=3)
    want = jcoo.coo_densify(rows, cols, vals, 20, 25, 4, 6)
    got = tcoo.coo_densify(*_t(rows, cols, vals), 20, 25, 4, 6)
    _close(got, want, atol=1e-6)


@pytest.mark.parametrize("fn,shape", [("fixed_nnz_left_apply", (200, 6)),
                                      ("row_gather_apply", (30, 6))])
def test_fixed_structure_products_match_jax(fn, shape):
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 30 if fn == "fixed_nnz_left_apply" else 200,
                       shape).astype(np.int32)
    vals = rng.choice([-1.0, 1.0], shape).astype(np.float32)
    b = rng.standard_normal((200, 17)).astype(np.float32)
    if fn == "fixed_nnz_left_apply":
        want = jcoo.fixed_nnz_left_apply(jnp.asarray(idx), jnp.asarray(vals),
                                         jnp.asarray(b), 30, -2.0)
        got = tcoo.fixed_nnz_left_apply(*_t(idx, vals, b), 30, -2.0)
    else:
        want = jcoo.row_gather_apply(jnp.asarray(idx), jnp.asarray(vals),
                                     jnp.asarray(b), -2.0)
        got = tcoo.row_gather_apply(*_t(idx, vals, b), -2.0)
    _close(got, want)


# ------------------------------------------------------------ compat


def _flat(mat, layout, ld=None):
    n_rows, n_cols = mat.shape
    if layout.name == "ColMajor":
        buf = np.zeros((n_cols, ld or n_rows), dtype=mat.dtype)
        buf[:, :n_rows] = mat.T
    else:
        buf = np.zeros((n_rows, ld or n_cols), dtype=mat.dtype)
        buf[:, :n_cols] = mat
    return buf.reshape(-1)


def _both_layouts(layout_name):
    return rb.Layout[layout_name], rt.Layout[layout_name]


@pytest.mark.parametrize("layout", ["ColMajor", "RowMajor"])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("side", ["left", "right"])
def test_compat_sketch_general_matches_jax(layout, kind, side):
    jl, tl = _both_layouts(layout)
    d, m, n = 6, 40, 5
    if kind == "dense":
        jS = rb.DenseSkOp(rb.DenseDist(d, m), rb.RNGState.from_key(2))
        tS = rt.DenseSkOp(rt.DenseDist(d, m), rt.RNGState.from_key(2))
    else:
        jS, tS = _ops((d, m), 3, key=2)
        tS = tS.filled(device="cpu")
    rng = np.random.default_rng(7)
    colmajor = layout == "ColMajor"
    if side == "left":   # B (d, n) = 2 S (d, m) A (m, n) + 0.5 B
        A, B0 = rng.standard_normal((m, n)), rng.standard_normal((d, n))
        lda, ldb = (m, d) if colmajor else (n, n)
        args = ("N", "N", d, n, m, 2.0)
    else:                # B (n, m) = 2 A (n, d) S (d, m) + 0.5 B
        A, B0 = rng.standard_normal((n, d)), rng.standard_normal((n, m))
        lda, ldb = (n, n) if colmajor else (d, m)
        args = ("N", "N", n, m, d, 2.0)
    A, B0 = A.astype(np.float32), B0.astype(np.float32)
    outs = []
    for mod, lay, S in ((jcompat, jl, jS), (tcompat, tl, tS)):
        a_buf, b_buf = _flat(A, lay), _flat(B0, lay)
        kw = {"device": "cpu"} if mod is tcompat else {}
        if side == "left":
            mod.sketch_general(lay, *args, S, 0, 0, a_buf, lda, 0.5, b_buf,
                               ldb, **kw)
        else:
            mod.sketch_general(lay, *args, a_buf, lda, S, 0, 0, 0.5, b_buf,
                               ldb, **kw)
        outs.append(b_buf)
    _close(outs[1], outs[0])


def test_compat_vector_symmetric_and_fill_match_jax():
    d, n = 4, 10
    st = rb.RNGState.from_key(4).to_dict()
    jS = rb.DenseSkOp(rb.DenseDist(d, n), rb.RNGState.from_dict(st))
    tS = rt.DenseSkOp(rt.DenseDist(d, n), rt.RNGState.from_dict(st))
    rng = np.random.default_rng(9)
    x = rng.standard_normal(2 * n).astype(np.float32)
    y = rng.standard_normal(3 * d).astype(np.float32)
    jy, ty = y.copy(), y.copy()
    jcompat.sketch_vector(rb.Op.NoTrans, 1.5, jS, x, 2, 0.5, jy, 3)
    tcompat.sketch_vector(rt.Op.NoTrans, 1.5, tS, x, 2, 0.5, ty, 3,
                          device="cpu")
    _close(ty, jy)
    np.testing.assert_array_equal(ty[np.arange(len(y)) % 3 != 0],
                                  y[np.arange(len(y)) % 3 != 0])
    A = rng.standard_normal((n, n)).astype(np.float32)
    A = A + A.T
    jb, tb = np.zeros(d * n, np.float32), np.zeros(d * n, np.float32)
    jcompat.sketch_symmetric(rb.Layout.RowMajor, 1.0, jS, A.reshape(-1), n,
                             0.0, jb, n)
    tcompat.sketch_symmetric(rt.Layout.RowMajor, 1.0, tS, A.reshape(-1), n,
                             0.0, tb, n, device="cpu")
    _close(tb, jb)
    dist_j = rb.DenseDist(30, 7, rb.DenseDistName.Uniform)
    dist_t = rt.DenseDist(30, 7, rt.DenseDistName.Uniform)
    jf, tf = np.zeros(30 * 7, np.float32), np.zeros(30 * 7, np.float32)
    jn = jcompat.fill_dense(rb.Layout.ColMajor, dist_j, 30, 7, 0, 0, jf,
                            rb.RNGState.from_dict(st))
    tn = tcompat.fill_dense(rt.Layout.ColMajor, dist_t, 30, 7, 0, 0, tf,
                            rt.RNGState.from_dict(st), device="cpu")
    np.testing.assert_array_equal(tf, jf)
    assert tn.to_dict() == jn.to_dict()


def test_compat_layout_helpers_match_jax():
    a = np.arange(24, dtype=np.float32)
    for lay in ("ColMajor", "RowMajor"):
        jl, tl = _both_layouts(lay)
        np.testing.assert_array_equal(tcompat.read_mat(tl, a, 3, 4, 6),
                                      jcompat.read_mat(jl, a, 3, 4, 6))
        jb, tb = np.zeros(20, np.float32), np.zeros(20, np.float32)
        jcompat.flip_layout(jl, 3, 4, a, 6, jb, 5)
        tcompat.flip_layout(tl, 3, 4, a, 6, tb, 5)
        np.testing.assert_array_equal(tb, jb)
    jb, tb = np.zeros(30, np.float32), np.zeros(30, np.float32)
    jcompat.omatcopy(3, 4, a, 4, 1, jb, 1, 5)
    tcompat.omatcopy(3, 4, a, 4, 1, tb, 1, 5)
    np.testing.assert_array_equal(tb, jb)


def test_every_port_module_imports_with_jax_blocked():
    """Every module of the port, its application tier (examples_torch/),
    chip_smoke.py and the scripts beside it (kernel_variants.py, the
    ablations, dist_smoke.py and gate_sweep.py) import with jax and the
    JAX package blocked in sys.modules."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['randblas_tpu'] = None\n"
        "import randblas_tpu_torch as rt\n"
        "import examples_torch as ex\n"
        "names = [m.name for m in pkgutil.walk_packages(rt.__path__, "
        "'randblas_tpu_torch.')]\n"
        "names += [m.name for m in pkgutil.walk_packages(ex.__path__, "
        "'examples_torch.')]\n"
        "for name in names + ['chip_smoke', 'kernel_variants', "
        "'fused_ablation', 'saso_ablation', 'fill_ablation', "
        "'dist_smoke', 'gate_sweep']:\n"
        "    importlib.import_module(name)\n"
        "print(' '.join(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 30
    # the host engines and the linalg modules of groups 2 to 5 among them
    assert {"randblas_tpu_torch.native", "randblas_tpu_torch.rng.x64"} \
        <= names
    assert {f"randblas_tpu_torch.linalg.{m}" for m in (
        "features", "leverage", "trace", "nystrom", "eigh", "rpcholesky",
        "amm", "qrcp", "krylov", "sgmres", "spectral", "rgs", "streaming",
        "quadrature", "density", "kaczmarz", "tt", "tucker")} <= names
    # and the distributed layer and the profiling module
    assert {"randblas_tpu_torch.parallel.distributed",
            "randblas_tpu_torch.parallel.multihost",
            "randblas_tpu_torch.profiling"} <= names
    # and the eleven applications, with the JAX examples' file names
    examples = {p.stem for p in (repo / "examples").glob("*.py")}
    assert len(examples) == 11
    assert {f"examples_torch.{m}" for m in examples} <= names
