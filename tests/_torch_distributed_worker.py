"""One rank of the live gloo group of tests/test_torch_distributed_live.py
(not collected by pytest). It imports torch and the port only.

    python tests/_torch_distributed_worker.py ADDRESS RANK WORLD OUT_DIR

Every rank joins a gloo group at tcp://ADDRESS, builds a 2 x 2 and a 1 x 4
('model', 'data') mesh over the same ranks and runs the cases of the JAX
package's dryrun_multichip (1-14) through the public entry points with
DTensor inputs, each against its oracle (float64 numpy, or the unsharded
call), and the gradient, the rangefinder family, sketch-and-precondition,
the tensor sketches of column-sharded factors and the host-contiguous
multi-host mesh. It writes
OUT_DIR/rank<RANK>.json: case name -> "ok" or the error.
"""

import contextlib
import json
import os
import sys
import traceback
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import (  # noqa: E402
    DTensor, Replicate, Shard, distribute_tensor)

import randblas_tpu_torch as rt  # noqa: E402
from randblas_tpu_torch import linalg as tla  # noqa: E402
from randblas_tpu_torch import parallel as par  # noqa: E402

CPU = "cpu"


def _close(got, want, rtol=1e-5, atol=1e-5):
    got = got.full_tensor() if isinstance(got, DTensor) else got
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@contextlib.contextmanager
def quiet():
    """Fail on a warning: the sharded paths run explicit collectives, and
    DTensor warns where an operation falls back to its own propagation."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        yield


def cases(mesh):
    """(name, function) of the cases on ``mesh``; each raises on a
    mismatch."""
    model, data = mesh.size(0), mesh.size(1)
    rows_data = [Replicate(), Shard(0)]
    cols_data = [Replicate(), Shard(1)]

    def by_rows(x):     # the long axis over 'data'
        return distribute_tensor(x, mesh, rows_data)

    def by_cols(x):
        return distribute_tensor(x, mesh, cols_data)

    d, m, n = 8 * model, 8 * data, 8
    S = rt.DenseSkOp(rt.DenseDist(d, m), rt.RNGState.from_key(1))
    A = torch.from_numpy(np.random.default_rng(1).normal(
        size=(m, n)).astype(np.float32))
    Sm = S.materialize(device=CPU).double().numpy()

    def left():
        B = par.distributed_sketch(S, by_rows(A), mesh)
        assert tuple(B.placements) == (Shard(0), Replicate())
        assert B.to_local().shape == (d // model, n)
        _close(B, Sm @ A.double().numpy())
        _close(par.distributed_sketch_jit(S, A, mesh, alpha=0.5),
               0.5 * Sm @ A.double().numpy())

    def right():
        S2 = rt.DenseSkOp(rt.DenseDist(m, d), rt.RNGState.from_key(2))
        A2 = torch.from_numpy(np.random.default_rng(2).normal(
            size=(n, m)).astype(np.float32))
        B2 = par.distributed_sketch_right(S2, by_cols(A2), mesh)
        assert tuple(B2.placements) == (Shard(1), Replicate())
        _close(B2, A2.double().numpy()
               @ S2.materialize(device=CPU).double().numpy())

    def sparse():
        S3 = rt.SparseSkOp(rt.SparseDist(4, m, vec_nnz=2),
                           rt.RNGState.from_key(3))
        A3 = torch.from_numpy(np.random.default_rng(3).normal(
            size=(m, n)).astype(np.float32))
        B3 = par.distributed_sparse_sketch(S3, by_rows(A3),
                                           mesh)
        _close(B3, S3.materialize(device=CPU).double().numpy()
               @ A3.double().numpy())

    def cols():
        A4 = torch.from_numpy(np.random.default_rng(4).normal(
            size=(m, 8 * data)).astype(np.float32))
        B4 = par.distributed_sketch_cols(S, by_cols(A4), mesh)
        assert tuple(B4.placements) == (Shard(0), Shard(1))
        _close(B4, Sm @ A4.double().numpy())

    def sparse_data():
        rng = np.random.default_rng(5)
        nnz = 4 * m
        A5 = rt.COOMatrix.from_arrays(
            m, 8, torch.from_numpy(rng.integers(0, m, nnz)),
            torch.from_numpy(rng.integers(0, 8, nnz)),
            torch.from_numpy(rng.normal(size=nnz).astype(np.float32)),
            device=CPU)
        dense = np.zeros((m, 8))
        np.add.at(dense, (A5.rows.numpy(), A5.cols.numpy()),
                  A5.vals.double().numpy())
        _close(par.distributed_sketch_sparse_data(S, A5, mesh), Sm @ dense)

    def pad_and_shard():
        S6 = rt.DenseSkOp(rt.DenseDist(12, 40), rt.RNGState.from_key(6))
        A6 = torch.from_numpy(np.random.default_rng(6).normal(
            size=(40, 7)).astype(np.float32))
        want = S6.materialize(device=CPU).double().numpy() \
            @ A6.double().numpy()
        _close(par.distributed_sketch(S6, A6, mesh), want)
        # a DTensor whose chunks are not the counter-aligned shards
        _close(par.distributed_sketch(S6, by_rows(A6), mesh),
               want)

    def srht_cols():
        d7 = 8 * model - 3 if model > 1 else 13
        S7 = rt.TrigSkOp(rt.TrigDist(d7, m), rt.RNGState.from_key(7))
        A4 = torch.from_numpy(np.random.default_rng(4).normal(
            size=(m, 8 * data)).astype(np.float32))
        B7 = par.distributed_sketch_cols(S7, by_cols(A4), mesh)
        _close(B7, S7.materialize(device=CPU).double().numpy()
               @ A4.double().numpy(), atol=1e-4)

    def gradient():
        """d sum(B^2) / dA = 2 S^T S A for the three layouts, through
        DTensor leaves (left, right) and a replicated plain leaf (cols)."""
        Sr = rt.DenseSkOp(rt.DenseDist(m, d), rt.RNGState.from_key(2))
        Srm = Sr.materialize(device=CPU).double().numpy()
        a = by_rows(A).requires_grad_(True)
        (par.distributed_sketch(S, a, mesh) ** 2).sum().backward()
        _close(a.grad, 2 * Sm.T @ Sm @ A.double().numpy())
        ar = torch.from_numpy(np.random.default_rng(7).normal(
            size=(5, m)).astype(np.float32))
        a = by_cols(ar).requires_grad_(True)
        (par.distributed_sketch_right(Sr, a, mesh) ** 2).sum().backward()
        _close(a.grad, 2 * ar.double().numpy() @ Srm @ Srm.T)
        ac = torch.from_numpy(np.random.default_rng(8).normal(
            size=(m, 6)).astype(np.float32)).requires_grad_(True)
        (par.distributed_sketch_cols(S, ac, mesh) ** 2).sum().backward()
        _close(ac.grad, 2 * Sm.T @ Sm @ ac.detach().double().numpy())

    rng8 = np.random.default_rng(8)
    r8 = 3
    u8, _ = np.linalg.qr(rng8.normal(size=(8 * data, r8)))
    v8, _ = np.linalg.qr(rng8.normal(size=(8, r8)))
    s8 = np.linspace(4.0, 1.0, r8)
    A8 = torch.from_numpy(((u8 * s8) @ v8.T).astype(np.float32))

    def rsvd():
        U8, S8, _ = tla.distributed_rsvd(by_rows(A8), r8,
                                         rt.RNGState.from_key(8), mesh,
                                         oversample=5)
        assert tuple(U8.placements) == (Replicate(), Shard(0))
        np.testing.assert_allclose(S8.numpy(), s8, rtol=1e-4)

    def rangefinder_qb():
        a = by_rows(A8)
        Q = tla.distributed_rangefinder(a, r8, rt.RNGState.from_key(8),
                                        mesh).full_tensor().double().numpy()
        np.testing.assert_allclose(Q.T @ Q, np.eye(r8), atol=1e-5)
        a8 = A8.double().numpy()
        assert np.abs(a8 - Q @ (Q.T @ a8)).max() < 1e-4
        Qd, Bq = tla.distributed_qb(a, r8, rt.RNGState.from_key(8), mesh)
        _close(Qd.full_tensor() @ Bq, a8, atol=1e-4)

    def krylov():
        Q9 = tla.distributed_krylov_rangefinder(
            by_rows(A8), r8, rt.RNGState.from_key(9), mesh,
            depth=1).full_tensor().double().numpy()
        assert Q9.shape[1] == r8, Q9.shape
        a8 = A8.double().numpy()
        assert np.abs(a8 - Q9 @ (Q9.T @ a8)).max() < 1e-4

    def fd():
        rng13 = np.random.default_rng(13)
        m13, n13, ell13 = 24 * data + 5, 24, 6
        a13 = torch.from_numpy(rng13.normal(size=(m13, n13)).astype(
            np.float32))
        fd13 = tla.distributed_fd(by_rows(a13), ell13, mesh)
        b13 = fd13.sketch().double().numpy()
        g13 = a13.double().numpy().T @ a13.double().numpy()
        err = np.linalg.norm(g13 - b13.T @ b13, 2)
        mass = float(fd13.shrink_mass)
        assert err <= mass * 1.01 + 1e-3 * np.linalg.norm(g13, 2), (err,
                                                                   mass)
        assert mass <= np.linalg.norm(a13.numpy(), "fro") ** 2 / ell13 * 1.01

    rng14 = np.random.default_rng(14)
    m14, n14 = 32 * data, 6
    a14 = torch.from_numpy(rng14.normal(size=(m14, n14)).astype(np.float32))
    b14 = torch.from_numpy(rng14.normal(size=m14).astype(np.float32))

    def ihs():
        x14, _ = tla.ihs_lsq(by_rows(a14),
                             by_rows(b14),
                             rt.RNGState.from_key(14), iters=20,
                             operator="gaussian", mesh=mesh)
        x_ref, _ = tla.ihs_lsq(a14, b14, rt.RNGState.from_key(14), iters=20,
                               operator="gaussian")
        _close(x14, x_ref.numpy(), rtol=1e-4, atol=1e-5)
        x_ls = np.linalg.lstsq(a14.double().numpy(), b14.double().numpy(),
                               rcond=None)[0]
        _close(x14, x_ls, rtol=1e-3, atol=1e-3)

    def precondition():
        for op in ("gaussian", "saso"):
            x, it, _ = tla.sketch_and_precondition(
                by_rows(a14), b14, rt.RNGState.from_key(15),
                operator=op, tol=1e-6, mesh=mesh)
            x_ref, it_ref, _ = tla.sketch_and_precondition(
                a14, b14, rt.RNGState.from_key(15), operator=op, tol=1e-6)
            _close(x, x_ref.numpy(), rtol=1e-4, atol=1e-5)
            assert abs(it - it_ref) <= 2, (it, it_ref)

    # -- the solver tier and the tensor sketches on sharded inputs (12b) --
    def sgmres():
        rng10 = np.random.default_rng(10)
        n10 = 8 * data
        a10 = torch.from_numpy((rng10.normal(size=(n10, n10)) / np.sqrt(n10)
                                + 3 * np.eye(n10)).astype(np.float32))
        b10 = torch.from_numpy(rng10.normal(size=n10).astype(np.float32))
        st = rt.RNGState.from_key(10)
        with quiet():
            x10, _, nxt = tla.sgmres(by_rows(a10), b10, st, basis=n10)
        x_ref, _, nxt_ref = tla.sgmres(a10, b10, st, basis=n10)
        assert tuple(x10.placements) == (Replicate(), Replicate())
        assert nxt.to_dict() == nxt_ref.to_dict()
        _close(x10, x_ref.numpy(), rtol=1e-4, atol=1e-5)
        x = x10.to_local().double().numpy()
        rel = (np.linalg.norm(a10.double().numpy() @ x - b10.double().numpy())
               / np.linalg.norm(b10.double().numpy()))
        assert rel < 1e-4, rel

    rng11 = np.random.default_rng(11)
    m11, n11 = 16 * data, 6
    a11 = torch.from_numpy(rng11.normal(size=(m11, n11)).astype(np.float32))
    xt11 = rng11.normal(size=n11).astype(np.float32)
    b11 = a11 @ torch.from_numpy(xt11)
    n12 = 8 * data
    m12 = 4 * n12
    a12 = torch.from_numpy(rng11.normal(size=(m12, n12)).astype(np.float32))
    b12 = torch.from_numpy(rng11.normal(size=m12).astype(np.float32))

    def kaczmarz():
        st = rt.RNGState.from_key(11)
        with quiet():
            x11, nxt = tla.block_kaczmarz(by_rows(a11), by_rows(b11), st,
                                          block=8, steps=24)
        x_ref, nxt_ref = tla.block_kaczmarz(a11, b11, st, block=8, steps=24)
        assert tuple(x11.placements) == (Replicate(), Replicate())
        assert nxt.to_dict() == nxt_ref.to_dict()
        _close(x11, x_ref.numpy(), rtol=1e-4, atol=1e-5)
        _close(x11, xt11, rtol=2e-3, atol=2e-3)

    def gauss_seidel():
        for sampling in ("shuffle", "colnorm"):
            st = rt.RNGState.from_key(12)
            with quiet():
                x12, nxt = tla.block_gauss_seidel(by_cols(a12), b12, st,
                                                  block=8, steps=40,
                                                  sampling=sampling)
            x_ref, nxt_ref = tla.block_gauss_seidel(a12, b12, st, block=8,
                                                    steps=40,
                                                    sampling=sampling)
            assert tuple(x12.placements) == (Replicate(), Replicate())
            assert nxt.to_dict() == nxt_ref.to_dict()
            _close(x12, x_ref.numpy(), rtol=1e-4, atol=1e-5)

    def ragged():
        """Extents that 'data' does not divide: data + 1 rows of the
        Kaczmarz system and columns of the Gauss-Seidel one, so on 1 x 4
        the last rank holds none (DTensor's chunks 2, 2, 1, 0; its offset
        6 clipped to 5)."""
        rng = np.random.default_rng(13)
        k = data + 1
        a = torch.from_numpy(rng.normal(size=(k, 3)).astype(np.float32))
        b = a @ torch.from_numpy(rng.normal(size=3).astype(np.float32))
        st = rt.RNGState.from_key(13)
        with quiet():
            x, nxt = tla.block_kaczmarz(by_rows(a), by_rows(b), st, block=3,
                                        steps=12)
        x_ref, nxt_ref = tla.block_kaczmarz(a, b, st, block=3, steps=12)
        assert nxt.to_dict() == nxt_ref.to_dict()
        _close(x, x_ref.numpy(), rtol=1e-4, atol=1e-5)
        a = torch.from_numpy(rng.normal(size=(4 * k, k)).astype(np.float32))
        b = torch.from_numpy(rng.normal(size=4 * k).astype(np.float32))
        for sampling in ("shuffle", "colnorm"):
            with quiet():
                x, nxt = tla.block_gauss_seidel(by_cols(a), b, st, block=3,
                                                steps=20, sampling=sampling)
            x_ref, nxt_ref = tla.block_gauss_seidel(a, b, st, block=3,
                                                    steps=20,
                                                    sampling=sampling)
            assert nxt.to_dict() == nxt_ref.to_dict()
            _close(x, x_ref.numpy(), rtol=1e-4, atol=1e-5)

    def column_sharded(sketch, seed, dims, key, exact):
        """The sketch of column-sharded factors against the unsharded
        call, and the same next_state (test_distributed.py's
        zero-communication tests): bitwise where ``exact``, else within
        1e-6 of max |want|."""
        rng = np.random.default_rng(seed)
        mats = [torch.from_numpy(rng.normal(size=(m, 16)).astype(np.float32))
                for m in dims]
        st = rt.RNGState.from_key(key)
        want, nxt = sketch(mats, 64, st)
        with quiet():
            got, nxt2 = sketch([by_cols(a) for a in mats], 64, st)
        assert tuple(got.placements) == (Replicate(), Shard(1))
        assert nxt2.to_dict() == nxt.to_dict()
        got, want = got.full_tensor().numpy(), want.numpy()
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            scale = np.abs(want).max()
            np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                       atol=1e-6)

    def tensor_sketch():
        # not bitwise on the CPU: PyTorch's complex64 product of the
        # spectra rounds an element in a vector lane and in the scalar tail
        # differently (2.98e-8 apart at 4 of 16 columns), so its bits
        # depend on where the element lies in the local block
        column_sharded(rt.tensor_sketch, 9, (48, 32), 11, exact=False)

    def kfjlt():
        column_sharded(rt.kfjlt_sketch, 10, (48, 20), 12, exact=True)

    return [("left", left), ("right", right), ("sparse", sparse),
            ("cols", cols), ("sparse_data", sparse_data),
            ("pad_and_shard", pad_and_shard), ("srht_cols", srht_cols),
            ("gradient", gradient), ("rsvd", rsvd),
            ("rangefinder_qb", rangefinder_qb), ("krylov", krylov),
            ("fd", fd), ("ihs", ihs), ("precondition", precondition),
            ("sgmres", sgmres), ("kaczmarz", kaczmarz),
            ("gauss_seidel", gauss_seidel), ("ragged", ragged),
            ("tensor_sketch", tensor_sketch),
            ("kfjlt", kfjlt)]


def multihost():
    """LOCAL_WORLD_SIZE=2 makes two "hosts" of two ranks: model=2 stays
    inside each, 'data' is host-major, and the sketch is the mesh-agnostic
    one."""
    mesh = par.make_multihost_sketch_mesh(model=2, device_type=CPU)
    assert mesh.mesh.tolist() == [[0, 2], [1, 3]], mesh.mesh.tolist()
    S = rt.DenseSkOp(rt.DenseDist(12, 40), rt.RNGState.from_key(9))
    A = torch.from_numpy(np.random.default_rng(1).normal(
        size=(40, 6)).astype(np.float32))
    _close(par.distributed_sketch(S, A, mesh),
           S.materialize(device=CPU).double().numpy() @ A.double().numpy())


def main() -> None:
    address, rank, world, out_dir = sys.argv[1:5]
    torch.set_num_threads(1)
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    par.initialize_multihost(address, num_processes=int(world),
                             process_id=int(rank), backend="gloo")
    results = {}
    meshes = {"2x2": par.make_sketch_mesh(2, 2, device_type=CPU),
              "1x4": par.make_sketch_mesh(1, 4, device_type=CPU)}
    todo = [(f"{name}[{label}]", fn) for label, mesh in meshes.items()
            for name, fn in cases(mesh)] + [("multihost", multihost)]
    for name, fn in todo:
        try:
            fn()
            results[name] = "ok"
        except Exception:  # every case reports; the test asserts each
            results[name] = traceback.format_exc()
        dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
