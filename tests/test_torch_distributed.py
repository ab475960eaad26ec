"""The port's distributed layer, shard by shard in one process, against the
port's single-device sketches and the JAX package's ``randblas_tpu.parallel``
on the 8 virtual CPU devices of tests/conftest.py.

Each shard body of ``randblas_tpu_torch.parallel.distributed`` is a plain
function of (mesh coordinate, mesh shape, local blocks, operator); these
tests run every shard of the (1, 1), (1, 4), (2, 2) and (4, 1) meshes in
turn, add the partials over 'data' in rank order (what the all-reduce
does) and assemble the blocks over 'model'. Same numpy inputs and seeds as
tests/test_distributed.py (D, M, N = 16, 64, 8). Its four update scenarios
(a sketch grown in d or in m, left and right, from chained states) run on
the 2 x 4, 2 x 2, 1 x 4 and 4 x 1 meshes, with its tolerances (1e-6 where
the blocks stack, 1e-5 where the partials add).

Tolerances, normalised by max |want|:
- operator tiles: bitwise (a sketch of the identity assembles to the
  operator itself, exactly: every other term is a zero);
- float32 staged shards: 1e-5, a reduction-order difference;
- ``use_fused=True`` (K1's and K2's plain versions): 1e-4 against the JAX
  package's ``use_fused=True, interpret=True``, the bound of the port's
  K1 parity;
- K4's plain version: the JAX package's own bound, 2^-7 max |want| + 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu import parallel as jpar
from randblas_tpu.flags import flags as jflags
from randblas_tpu.sparse_data import COOMatrix as JCOO
import randblas_tpu_torch as rt
from randblas_tpu_torch import parallel as tpar
from randblas_tpu_torch.ops import saso_sketch as tsaso
from randblas_tpu_torch.parallel import distributed as td

D, M, N = 16, 64, 8
MESHES = [(1, 1), (1, 4), (2, 2), (4, 1)]
STAGED_TOL = 1e-5
FUSED_TOL = 1e-4


def _jmesh(shape):
    model, data = shape
    return jpar.make_sketch_mesh(model, data, jax.devices()[:model * data])


def _dense(shape, key, family="Gaussian", major="Long"):
    args = (rb.DenseDistName[family], rb.MajorAxis[major])
    targs = (rt.DenseDistName[family], rt.MajorAxis[major])
    return (rb.DenseSkOp(rb.DenseDist(*shape, *args), rb.RNGState.from_key(key)),
            rt.DenseSkOp(rt.DenseDist(*shape, *targs),
                         rt.RNGState.from_key(key)))


def _data(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


# ------------------------------------------------ the meshes, emulated


def left(S, A, shape, extents=td.left_extents, body=td.left_shard, **kw):
    """The left layout's shards: A's rows over 'data', B's over 'model'."""
    d_per, m_per = extents(S, shape)
    blocks = []
    for mi in range(shape[0]):
        acc = 0
        for di in range(shape[1]):
            co, cols = td.shard_span(S.shape[1], m_per, di)
            a_blk = td.replicated(A[co:co + cols], None)
            acc = acc + td.sum_over(body(S, a_blk, (mi, di), shape, **kw),
                                    None)
        blocks.append(acc)
    return torch.cat(blocks)


def right(S, A, shape, **kw):
    """The right layout's shards: A's columns over 'data', B's over
    'model'."""
    d_per, m_per = td.right_extents(S, shape)
    blocks = []
    for mi in range(shape[0]):
        acc = 0
        for di in range(shape[1]):
            ro, rows = td.shard_span(S.shape[0], m_per, di)
            a_blk = td.replicated(A[:, ro:ro + rows], None)
            acc = acc + td.sum_over(
                td.right_shard(S, a_blk, (mi, di), shape, **kw), None)
        blocks.append(acc)
    return torch.cat(blocks, dim=1)


def cols(S, A, shape, **kw):
    """The column layout's blocks: A's columns over 'data', B's rows over
    'model', no sum."""
    n = A.shape[1]
    _, n_per = td.cols_extents(S, n, shape)
    out = []
    for mi in range(shape[0]):
        row = []
        for di in range(shape[1]):
            c0, nc = td.shard_span(n, n_per, di)
            a_blk = td.replicated(A[:, c0:c0 + nc], None)
            row.append(td.cols_shard(S, a_blk, (mi, di), shape, n, **kw))
        out.append(torch.cat(row, dim=1))
    return torch.cat(out)


def sparse_data(S, coo, shape):
    blocks = []
    for mi in range(shape[0]):
        acc = 0
        for di in range(shape[1]):
            acc = acc + td.sparse_data_shard(S, coo, (mi, di), shape)
        blocks.append(acc)
    return torch.cat(blocks)


# ----------------------------------------------------------- the tests


def test_exports_match_the_jax_package():
    assert tpar.__all__ == jpar.__all__
    assert all(callable(getattr(tpar, name)) for name in tpar.__all__)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("use_fused", [False, True])
def test_tiles_are_the_single_device_operator(shape, use_fused):
    """A sketch of the identity assembles each layout's tiles: bitwise the
    single-device operator (staged), or its bf16 rounding (K1)."""
    _, S = _dense((D, M), 9)
    full = S.materialize(device="cpu")
    want = full.to(torch.bfloat16).float() if use_fused else full
    assert torch.equal(left(S, torch.eye(M), shape, use_fused=use_fused),
                       want)
    assert torch.equal(cols(S, torch.eye(M), shape, use_fused=use_fused),
                       want)
    _, St = _dense((M, D), 10)
    full_t = St.materialize(device="cpu")
    want_t = full_t.to(torch.bfloat16).float() if use_fused else full_t
    assert torch.equal(right(St, torch.eye(M), shape, use_fused=use_fused),
                       want_t)
    # and each staged tile is the slice of the full fill
    d_per, m_per = td.left_extents(S, shape)
    for mi in range(shape[0]):
        for di in range(shape[1]):
            ro, rows = td.shard_span(D, d_per, mi)
            co, cols_ = td.shard_span(M, m_per, di)
            assert torch.equal(S.submat(rows, cols_, ro, co, device="cpu"),
                               full[ro:ro + rows, co:co + cols_])


@pytest.mark.parametrize("shape", MESHES)
def test_left(shape):
    jS, tS = _dense((D, M), 5)
    A = _data((M, N), 0)
    got = left(tS, torch.from_numpy(A), shape, use_fused=False)
    _close(got, rt.sketch_general(tS, torch.from_numpy(A)), STAGED_TOL)
    _close(got, jpar.distributed_sketch(jS, jnp.asarray(A), _jmesh(shape)),
           STAGED_TOL)


@pytest.mark.parametrize("shape", MESHES)
def test_left_fused(shape):
    """K1's plain version in every shard against the JAX package's fused
    shards (interpret mode) and the port's single-device K1."""
    jS, tS = _dense((D, 512), 21)
    A = _data((512, N), 3)
    got = left(tS, torch.from_numpy(A), shape, use_fused=True)
    want = jpar.distributed_sketch(jS, jnp.asarray(A), _jmesh(shape),
                                   use_fused=True, interpret=True)
    _close(got, want, FUSED_TOL)
    with rt.flags(use_fused=True):
        _close(got, rt.sketch_general(tS, torch.from_numpy(A)), FUSED_TOL)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("use_fused", [False, True])
def test_right(shape, use_fused):
    jS, tS = _dense((M, D), 13)
    A = _data((10, M), 2)
    got = right(tS, torch.from_numpy(A), shape, use_fused=use_fused)
    want = jpar.distributed_sketch_right(
        jS, jnp.asarray(A), _jmesh(shape), use_fused=use_fused,
        interpret=use_fused)
    _close(got, want, FUSED_TOL if use_fused else STAGED_TOL)
    if not use_fused:
        _close(got, rt.sketch_general(tS, torch.from_numpy(A), side="right"),
               STAGED_TOL)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("use_fused", [False, True])
def test_cols(shape, use_fused):
    jS, tS = _dense((D, M), 17)
    A = _data((M, 32), 4)
    got = cols(tS, torch.from_numpy(A), shape, use_fused=use_fused)
    want = jpar.distributed_sketch_cols(jS, jnp.asarray(A), _jmesh(shape),
                                        use_fused=use_fused,
                                        interpret=use_fused)
    _close(got, want, FUSED_TOL if use_fused else STAGED_TOL)
    if not use_fused:
        _close(got, rt.sketch_general(tS, torch.from_numpy(A)), STAGED_TOL)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("d", [16, 13])
def test_cols_trig(shape, d):
    """SRHT over the column layout: each shard transforms its own columns
    and keeps its 'model' slice of the sampled rows."""
    jS = rb.TrigSkOp(rb.TrigDist(d, M), rb.RNGState.from_key(23))
    tS = rt.TrigSkOp(rt.TrigDist(d, M), rt.RNGState.from_key(23))
    A = _data((M, N), 2)
    got = cols(tS, torch.from_numpy(A), shape, alpha=0.5)
    _close(got, 0.5 * rt.sketch_general(tS, torch.from_numpy(A)), STAGED_TOL)
    _close(got, jpar.distributed_sketch_cols(jS, jnp.asarray(A),
                                             _jmesh(shape), alpha=0.5),
           STAGED_TOL)
    with pytest.raises(ValueError, match="SRHT has no fused"):
        cols(tS, torch.from_numpy(A), shape, use_fused=True)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("route", ["fixed_nnz", "kernel"])
def test_sparse(shape, route):
    """Canonical wide SASO shards: one index_add_ a slot, or K4's plain
    version (skge's K4 gate under ``use_saso_kernel=True``)."""
    jS = rb.SparseSkOp(rb.SparseDist(D, M, vec_nnz=4), rb.RNGState.from_key(3))
    tS = rt.SparseSkOp(rt.SparseDist(D, M, vec_nnz=4), rt.RNGState.from_key(3))
    A = _data((M, N), 1)
    s = tS.filled("cpu")
    kernel = route == "kernel"
    before = tsaso.saso_sketch.launches
    with rt.flags(use_saso_kernel=kernel):
        got = left(s, torch.from_numpy(A), shape,
                   extents=td.sparse_extents, body=td.sparse_shard)
    assert tsaso.saso_sketch.launches == before  # the CPU
    with jflags(use_saso_kernel=kernel):
        want = jpar.distributed_sparse_sketch(jS, jnp.asarray(A),
                                              _jmesh(shape))
    want = np.asarray(want)
    tol = 2 ** -7 + 1e-4 / np.abs(want).max() if kernel else STAGED_TOL
    _close(got, want, tol)
    _close(got, rt.sketch_general(tS, torch.from_numpy(A)),
           tol if kernel else STAGED_TOL)


def test_sparse_kernel_shards_take_k4(monkeypatch):
    """The K4 route hands K4 the shard's window: indices outside it -1,
    their signs beside them, d the shard's rows."""
    calls = []
    real = tsaso.saso_sketch

    def spy(idx, vals, a, d, alpha=1.0):
        calls.append((idx.clone(), vals.clone(), d))
        return real(idx, vals, a, d, alpha)

    monkeypatch.setattr(tsaso, "saso_sketch", spy)
    tS = rt.SparseSkOp(rt.SparseDist(D, M, vec_nnz=4), rt.RNGState.from_key(3))
    s = tS.filled("cpu")
    with rt.flags(use_saso_kernel=True):
        left(s, torch.from_numpy(_data((M, N), 1)), (2, 2),
             extents=td.sparse_extents, body=td.sparse_shard)
    assert len(calls) == 4
    rows = s.rows.reshape(M, 4).long()
    for (idx, vals, d), (mi, di) in zip(calls, [(0, 0), (0, 1), (1, 0),
                                                (1, 1)]):
        assert d == D // 2 and idx.shape == (M // 2, 4)
        blk = rows[di * M // 2:(di + 1) * M // 2] - mi * D // 2
        inside = (blk >= 0) & (blk < D // 2)
        assert torch.equal(idx.long(), torch.where(inside, blk, -1))
        assert torch.equal(vals, s.vals.reshape(M, 4)[di * M // 2:
                                                      (di + 1) * M // 2])


def test_sparse_noncanonical():
    """User-ordered triplets take the windowed COO shard."""
    jS = rb.SparseSkOp(rb.SparseDist(D, M, vec_nnz=4), rb.RNGState.from_key(3))
    tS = rt.SparseSkOp(rt.SparseDist(D, M, vec_nnz=4), rt.RNGState.from_key(3))
    s = tS.filled("cpu")
    perm = torch.from_numpy(np.random.default_rng(7).permutation(
        s.rows.shape[0]))
    shuffled = rt.SparseSkOp(tS.dist, tS.seed_state, rows=s.rows[perm],
                             cols=s.cols[perm], vals=s.vals[perm])
    A = _data((M, N), 1)
    got = left(shuffled, torch.from_numpy(A), (2, 2),
               extents=td.sparse_extents, body=td.sparse_shard)
    _close(got, jpar.distributed_sparse_sketch(jS, jnp.asarray(A),
                                               _jmesh((2, 2))), STAGED_TOL)


@pytest.mark.parametrize("shape", MESHES)
def test_sparse_data(shape):
    rng = np.random.default_rng(11)
    m, n, d, nnz = 64, 24, 16, 150
    r, c = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    v = rng.normal(size=nnz).astype(np.float32)
    jA = JCOO.from_arrays(m, n, r, c, v)
    tA = rt.COOMatrix.from_arrays(m, n, r, c, v, device="cpu")
    jS, tS = _dense((d, m), 23)
    got = sparse_data(tS, tA, shape)
    _close(got, rt.sketch_sparse(tS, tA), STAGED_TOL)
    _close(got, jpar.distributed_sketch_sparse_data(jS, jA, _jmesh(shape)),
           STAGED_TOL)


@pytest.mark.parametrize("kind", ["left", "right", "sparse_op",
                                  "sparse_data", "cols"])
def test_pad_and_shard(kind):
    """d = 12, m = 40 (and friends) on 2 x 2: nothing divides the mesh
    and the counter-aligned shards (m_per = 20, 12) clip at the parent."""
    shape = (2, 2)
    rng = np.random.default_rng(5)
    mesh = _jmesh(shape)
    if kind == "left":
        jS, tS = _dense((12, 40), 31)
        A = rng.normal(size=(40, 7)).astype(np.float32)
        got = left(tS, torch.from_numpy(A), shape)
        want = jpar.distributed_sketch(jS, jnp.asarray(A), mesh)
        mine = rt.sketch_general(tS, torch.from_numpy(A))
    elif kind == "right":
        jS, tS = _dense((40, 12), 32)
        A = rng.normal(size=(5, 40)).astype(np.float32)
        got = right(tS, torch.from_numpy(A), shape)
        want = jpar.distributed_sketch_right(jS, jnp.asarray(A), mesh)
        mine = rt.sketch_general(tS, torch.from_numpy(A), side="right")
    elif kind == "sparse_op":
        jS = rb.SparseSkOp(rb.SparseDist(12, 40, vec_nnz=3),
                           rb.RNGState.from_key(33))
        tS = rt.SparseSkOp(rt.SparseDist(12, 40, vec_nnz=3),
                           rt.RNGState.from_key(33))
        A = rng.normal(size=(40, 7)).astype(np.float32)
        got = left(tS.filled("cpu"), torch.from_numpy(A), shape,
                   extents=td.sparse_extents, body=td.sparse_shard)
        want = jpar.distributed_sparse_sketch(jS, jnp.asarray(A), mesh)
        mine = rt.sketch_general(tS.filled("cpu"), torch.from_numpy(A))
    elif kind == "sparse_data":
        nnz = 77
        r, c = rng.integers(0, 40, nnz), rng.integers(0, 9, nnz)
        v = rng.normal(size=nnz).astype(np.float32)
        jS, tS = _dense((12, 40), 34)
        tA = rt.COOMatrix.from_arrays(40, 9, r, c, v, device="cpu")
        got = sparse_data(tS, tA, shape)
        want = jpar.distributed_sketch_sparse_data(
            jS, JCOO.from_arrays(40, 9, r, c, v), mesh)
        mine = rt.sketch_sparse(tS, tA)
    else:
        jS, tS = _dense((12, 40), 35)
        A = rng.normal(size=(40, 13)).astype(np.float32)
        got = cols(tS, torch.from_numpy(A), shape)
        want = jpar.distributed_sketch_cols(jS, jnp.asarray(A), mesh)
        mine = rt.sketch_general(tS, torch.from_numpy(A))
    _close(got, want, STAGED_TOL)
    _close(got, mine, STAGED_TOL)


@pytest.mark.parametrize("layout", ["left", "right", "cols"])
@pytest.mark.parametrize("use_fused", [False, True])
def test_gradient(layout, use_fused):
    """d sum(B^2) / dA through the shard bodies and the all-reduce's and
    replication's autograd Functions (collectives emulated: each shard's
    contribution is accumulated into the one leaf), against jax.grad of
    the JAX package's sharded sketch and the port's single-device
    gradient. K1's backward pass is K2's plain version."""
    shape = (2, 2)
    mesh = _jmesh(shape)
    if layout == "right":
        jS, tS = _dense((32, 8), 2)
        A = _data((6, 32), 12)
        jfn, emu = jpar.distributed_sketch_right, right
        single = dict(side="right")
    else:
        jS, tS = _dense((16, 32), 1)
        A = _data((32, 8 if layout == "left" else 16), 11)
        jfn = (jpar.distributed_sketch if layout == "left"
               else jpar.distributed_sketch_cols)
        emu = left if layout == "left" else cols
        single = {}
    a = torch.from_numpy(A).requires_grad_(True)
    (emu(tS, a, shape, use_fused=use_fused) ** 2).sum().backward()
    want = jax.grad(lambda x: jnp.sum(jfn(
        jS, x, mesh, use_fused=use_fused, interpret=use_fused) ** 2))(
        jnp.asarray(A))
    _close(a.grad, want, FUSED_TOL if use_fused else STAGED_TOL)
    a1 = torch.from_numpy(A).requires_grad_(True)
    with rt.flags(use_fused=use_fused):
        (rt.sketch_general(tS, a1, **single) ** 2).sum().backward()
    _close(a.grad, a1.grad, FUSED_TOL if use_fused else STAGED_TOL)


@pytest.mark.parametrize("parts", [1, 3, 4])
def test_owned_rows_assemble_exactly(parts):
    """The panels of the sharded solvers: each rank's rows of a tensor in
    DTensor chunks (the last ones shorter or empty), every rank's part of
    the gathered rows added in rank order, are the rows themselves, bit
    for bit (phantom index -1 gives zeros); two tensors go in one part."""
    a = torch.from_numpy(_data((10, 5), 7))
    b = torch.from_numpy(_data((10,), 8))
    idx = torch.tensor([9, 0, 3, 3, -1, 7, 4])
    per = td._shard_extent(10, parts)
    acc_a = acc_b = 0
    for di in range(parts):
        off, ext = td.shard_span(10, per, di)
        pa, pb = td.owned_rows((a[off:off + ext], b[off:off + ext]), off,
                               idx, None)
        acc_a, acc_b = acc_a + pa, acc_b + pb
    keep = (idx >= 0)[:, None]
    assert torch.equal(acc_a, torch.where(keep, a[idx.clamp(0)], 0.0))
    assert torch.equal(acc_b, torch.where(keep[:, 0], b[idx.clamp(0)], 0.0))


UPDATE_MESHES = [(2, 4), (2, 2), (1, 4), (4, 1)]


def _chained(shapes, major, key):
    """([JAX operators], [port operators]) of ``shapes``, Gaussian with
    ``major``: each but the last from the one before's next_state, the
    first and the last (the one-shot operator) from ``key``."""
    j, t = [], []
    js, ts = rb.RNGState.from_key(key), rt.RNGState.from_key(key)
    for i, shape in enumerate(shapes):
        if i == len(shapes) - 1:
            js, ts = rb.RNGState.from_key(key), rt.RNGState.from_key(key)
        j.append(rb.DenseSkOp(rb.DenseDist(*shape, rb.DenseDistName.Gaussian,
                                           rb.MajorAxis[major]), js))
        t.append(rt.DenseSkOp(rt.DenseDist(*shape, rt.DenseDistName.Gaussian,
                                           rt.MajorAxis[major]), ts))
        js, ts = j[-1].next_state, t[-1].next_state
    return j, t


def _update_close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol)


def _jleft(S, A, shape):
    return np.asarray(jpar.distributed_sketch(S, jnp.asarray(A),
                                              _jmesh(shape)))


def _jright(S, A, shape):
    return np.asarray(jpar.distributed_sketch_right(S, jnp.asarray(A),
                                                    _jmesh(shape)))


@pytest.mark.parametrize("shape", UPDATE_MESHES)
def test_update_scenario_1_grow_d(shape):
    """tests/test_distributed.py's scenario 1: a second sketch of more rows
    from S1's next_state stacks into the one-shot sketch of d1 + d2 rows
    (1e-6, the JAX test's); the one-shot and the stacked sketches against
    the JAX package's on the same mesh (1e-5)."""
    m, n, d1, d2 = 32, 6, 8, 12
    A = torch.from_numpy(_data((m, n), 0))
    (j1, j2, j), (S1, S2, S) = _chained([(d1, m), (d2, m), (d1 + d2, m)],
                                        "Long", 51)
    one_shot = left(S, A, shape)
    two_step = torch.cat([left(S1, A, shape), left(S2, A, shape)])
    _update_close(two_step, one_shot, 1e-6)
    _close(one_shot, _jleft(j, A, shape), STAGED_TOL)
    _close(two_step, np.vstack([_jleft(j1, A, shape), _jleft(j2, A, shape)]),
           STAGED_TOL)


@pytest.mark.parametrize("shape", UPDATE_MESHES)
def test_update_scenario_2_grow_m(shape):
    """Scenario 2: sketches of new rows of A from the chained state add up
    to the one-shot sketch of the stacked A (1e-5); both against the JAX
    package's (1e-5)."""
    d, n, m1, m2 = 8, 6, 32, 24
    rng = np.random.default_rng(1)
    A1 = torch.from_numpy(rng.normal(size=(m1, n)).astype(np.float32))
    A2 = torch.from_numpy(rng.normal(size=(m2, n)).astype(np.float32))
    (j1, j2, j), (S1, S2, S) = _chained([(d, m1), (d, m2), (d, m1 + m2)],
                                        "Short", 52)
    one_shot = left(S, torch.cat([A1, A2]), shape)
    summed = left(S1, A1, shape) + left(S2, A2, shape)
    _update_close(summed, one_shot, 1e-5)
    _close(one_shot, _jleft(j, torch.cat([A1, A2]), shape), STAGED_TOL)
    _close(summed, _jleft(j1, A1, shape) + _jleft(j2, A2, shape),
           STAGED_TOL)


@pytest.mark.parametrize("shape", UPDATE_MESHES)
def test_update_scenario_3_grow_d_right(shape):
    """Scenario 3: scenario 1 on the right, the columns stacked (1e-6);
    both against the JAX package's (1e-5)."""
    n, rows, d1, d2 = 32, 5, 8, 12
    A = torch.from_numpy(np.random.default_rng(2).normal(
        size=(rows, n)).astype(np.float32))
    (j1, j2, j), (S1, S2, S) = _chained([(n, d1), (n, d2), (n, d1 + d2)],
                                        "Long", 53)
    one_shot = right(S, A, shape)
    two_step = torch.cat([right(S1, A, shape), right(S2, A, shape)], dim=1)
    _update_close(two_step, one_shot, 1e-6)
    _close(one_shot, _jright(j, A, shape), STAGED_TOL)
    _close(two_step, np.hstack([_jright(j1, A, shape),
                                _jright(j2, A, shape)]), STAGED_TOL)


@pytest.mark.parametrize("shape", UPDATE_MESHES)
def test_update_scenario_4_new_data_right(shape):
    """Scenario 4: scenario 2 on the right, new columns of A (1e-5); both
    against the JAX package's (1e-5)."""
    d, rows, n1, n2 = 8, 5, 32, 24
    rng = np.random.default_rng(3)
    A1 = torch.from_numpy(rng.normal(size=(rows, n1)).astype(np.float32))
    A2 = torch.from_numpy(rng.normal(size=(rows, n2)).astype(np.float32))
    (j1, j2, j), (S1, S2, S) = _chained([(n1, d), (n2, d), (n1 + n2, d)],
                                        "Short", 54)
    one_shot = right(S, torch.cat([A1, A2], dim=1), shape)
    summed = right(S1, A1, shape) + right(S2, A2, shape)
    _update_close(summed, one_shot, 1e-5)
    _close(one_shot, _jright(j, torch.cat([A1, A2], dim=1), shape),
           STAGED_TOL)
    _close(summed, _jright(j1, A1, shape) + _jright(j2, A2, shape),
           STAGED_TOL)


def test_x64_seeds_raise_as_in_the_jax_package():
    """The JAX package's shard fill has no x64 generator; neither does the
    port's layer take one."""
    j = rb.DenseSkOp(rb.DenseDist(D, M), rb.RNGState.from_key(5, "philox4x64"))
    with pytest.raises(ValueError, match="philox4x64"):
        jpar.distributed_sketch(j, jnp.zeros((M, N)), _jmesh((2, 2)))
    t = rt.DenseSkOp(rt.DenseDist(D, M), rt.RNGState.from_key(5, "philox4x64"))
    for fn in (tpar.distributed_sketch, tpar.distributed_sketch_cols,
               tpar.distributed_sketch_sparse_data):
        with pytest.raises(ValueError, match="philox4x64"):
            fn(t, torch.zeros((M, N)), mesh=None)
    t_r = rt.DenseSkOp(rt.DenseDist(M, D),
                       rt.RNGState.from_key(5, "philox4x64"))
    with pytest.raises(ValueError, match="philox4x64"):
        tpar.distributed_sketch_right(t_r, torch.zeros((N, M)), mesh=None)


def test_forced_fused_on_an_unsupported_operator_raises():
    """A ColMajor-natural operator (wide, Short) has no K1 tile; forcing
    the fused route raises in both packages."""
    jS, tS = _dense((D, M), 5, major="Short")
    A = _data((M, N), 0)
    with pytest.raises(ValueError, match="forced but unsupported"):
        jpar.distributed_sketch(jS, jnp.asarray(A), _jmesh((2, 2)),
                                use_fused=True, interpret=True)
    with pytest.raises(ValueError, match="forced but unsupported"):
        left(tS, torch.from_numpy(A), (2, 2), use_fused=True)
    # "auto" on CPU tensors stays staged, like the JAX package off the TPU
    _close(left(tS, torch.from_numpy(A), (2, 2)),
           rt.sketch_general(tS, torch.from_numpy(A)), STAGED_TOL)


def test_shard_extents_follow_the_jax_package():
    """The contraction axis is cut at the counter width as the JAX
    package's _shard_extent cuts it; output axes in DTensor chunks."""
    from randblas_tpu.parallel.distributed import _shard_extent as j_extent
    for total, parts, align in ((40, 4, 4), (64, 4, 4), (65000, 2, 4),
                                (13, 3, 1), (1000, 4, 2)):
        assert td._shard_extent(total, parts, align) == j_extent(
            total, parts, align)
    _, tS = _dense((12, 40), 1)
    assert td.left_extents(tS, (2, 4)) == (6, 12)
    assert td.shard_span(40, 12, 3) == (36, 4)
    assert td.shard_span(12, 8, 2) == (16, 0)


def test_a_mesh_needs_a_process_group():
    with pytest.raises(ValueError, match="process group"):
        tpar.make_sketch_mesh(1, 1, device_type="cpu")
