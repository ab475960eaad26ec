"""The application tier of the port (examples_torch/) against the JAX
examples (examples/), on the CPU, with the same numpy-seeded inputs.

Each example's ``run(..., device="cpu")`` is held against the JAX
example's own functions where it has them (``make_problem``,
``sketch_qrcp``, ``qb_svd``, ``solve_preconditioned``, ``cp_als``,
``rbf_kernel``, ``demo_mtx``) and otherwise against the library calls of
its ``main()`` on ``randblas_tpu``, at a small size. Tolerances, beside
each case: float32 solutions, singular values and fits 1e-4 relative in
the 2-norm (``_torch_parity.rel``); quantities that are themselves
relative errors (TLS, rank-k and TT errors, test RMSE) within 1e-4
absolute; float64 runs 1e-10; iteration counts and QRCP pivots equal.
The JAX modules of ``distributed_sketching.py`` (it switches platforms
at import) and ``multihost_cpu_demo.py`` are not loaded: their tests make
the JAX example's library calls, and run the port's processes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu import linalg as jla
from randblas_tpu.sparse_data import COOMatrix as JCOO

from _torch_parity import REPO, assert_rel, jax_example, to_np

F32 = 1e-4       # float32 results, relative in the 2-norm
ABS = 1e-4       # results that are relative errors themselves, absolute
F64 = 1e-10      # float64 results

EXAMPLES = ("total_least_squares", "low_rank_svd", "qrcp_low_rank",
            "svd_matrixmarket", "sketch_precondition_lsq", "kernel_ridge",
            "spectrum_exploration", "cp_als_tensor_sketch", "tt_compression",
            "distributed_sketching")


def _port(name):
    import importlib
    return importlib.import_module(f"examples_torch.{name}")


@pytest.fixture(scope="module")
def jex():
    """The JAX example modules, loaded once; JAX stays on the CPU."""
    mods = {}

    def get(name):
        if name not in mods:
            mods[name] = jax_example(name)
            assert jax.devices()[0].platform == "cpu"
        return mods[name]
    return get


def test_total_least_squares(jex):
    jm, pm = jex("total_least_squares"), _port("total_least_squares")
    m, n = 400, 20
    ab, x_true = jm.make_problem(m, n)
    ab_p, x_true_p = pm.make_problem(m, n)
    np.testing.assert_array_equal(ab_p, ab)
    np.testing.assert_array_equal(x_true_p, x_true)
    r = pm.run(m, n, device="cpu")
    d = 2 * (n + 1)
    abj = jnp.asarray(ab)
    want = {"classical": jla.tls_via_svd(abj),
            "dense": jla.sketched_tls(rb.DenseSkOp(
                rb.DenseDist(d, m), rb.RNGState.from_key(1)), abj),
            "saso": jla.sketched_tls(rb.SparseSkOp(
                rb.SparseDist(d, m, vec_nnz=8), rb.RNGState.from_key(2)),
                abj),
            "srht": jla.sketched_tls(rb.TrigSkOp(
                rb.TrigDist(d, m), rb.RNGState.from_key(3)), abj)}
    for name, x in want.items():
        assert_rel(r["x"][name], x, F32, name)                  # 1e-4
        err = np.linalg.norm(np.asarray(x) - x_true) / np.linalg.norm(x_true)
        assert abs(r["err"][name] - err) <= ABS, name           # 1e-4 abs
        assert r["seconds"][name] > 0


def test_low_rank_svd(jex):
    pm = _port("low_rank_svd")
    m, n = 200, 150
    r = pm.run(m, n, device="cpu")
    a, u, v = pm.make_problem(m, n, device="cpu")
    dense = to_np(a.to_dense())
    # the JAX example's main(), its calls at this size
    q, b = jla.qb_decompose(JCOO.from_dense(jnp.asarray(dense)), 8,
                            rb.RNGState.from_key(3), power_iters=2)
    u_hat, s_hat, vt_hat = jla.qb_to_svd(q, b)
    assert r["nnz"] == int(np.count_nonzero(dense))
    assert_rel(r["s"], s_hat, F32, "singular values")          # 1e-4
    cos_u = abs(float(np.dot(np.asarray(u_hat[:, 0]), u)))
    cos_v = abs(float(np.dot(np.asarray(vt_hat[0]), v)))
    assert abs(r["cos_u"] - cos_u) <= ABS                       # 1e-4 abs
    assert abs(r["cos_v"] - cos_v) <= ABS
    assert abs(r["sigma1_rel_err"]
               - abs(float(s_hat[0]) - 25.0) / 25.0) <= ABS


def test_low_rank_svd_direct_build_keeps_the_distribution(monkeypatch):
    """Past HOST_DRAWS_MAX the COO is drawn without a dense array: the
    planted spike is exact and the noise count is Binomial(m n, p)."""
    pm = _port("low_rank_svd")
    monkeypatch.setattr(pm, "HOST_DRAWS_MAX", 0)
    m, n, p = 2000, 1500, 1e-3
    a, u, v = pm.make_problem(m, n, p, device="cpu")
    dense = to_np(a.to_dense()).astype(np.float64)
    spike = 25.0 * np.outer(u, v)
    noise = dense - spike
    hits = np.count_nonzero(noise)
    sd = np.sqrt(m * n * p * (1 - p))
    assert abs(hits - m * n * p) < 5 * sd, hits
    vals = noise[noise != 0]
    assert abs(vals.mean()) < 0.1 and abs(vals.std() - 1.0) < 0.1
    np.testing.assert_array_equal(np.sort(to_np(a.rows)), to_np(a.rows))
    r = pm.run(m, n, device="cpu")
    assert r["cos_u"] > 0.99 and r["cos_v"] > 0.99


def test_low_rank_svd_direct_build_stays_sparse_on_the_host():
    """At (A2)'s 200000 x 150000 the rank-1 spike alone would be 120 GB
    dense (the first card run of phase 14 ran out of host memory there):
    the direct build keeps the host's numpy arrays at the entries' size."""
    import tracemalloc
    pm = _port("low_rank_svd")
    tracemalloc.start()
    try:
        a, u, v = pm.make_problem(200_000, 150_000, 1e-6, device="cpu")
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 64 * 2 ** 20, peak
    assert a.nnz >= 32 * 32
    rows, cols = to_np(a.rows), to_np(a.cols)
    vals = to_np(a.vals)
    su, sv = np.nonzero(u)[0], np.nonzero(v)[0]
    on_spike = np.isin(rows, su) & np.isin(cols, sv)
    assert on_spike.sum() >= 32 * 32 - 2


def test_qrcp_low_rank(jex, tmp_path):
    from scipy.io import mmwrite
    from scipy.sparse import coo_matrix
    jm, pm = jex("qrcp_low_rank"), _port("qrcp_low_rank")
    k = 8
    path = str(tmp_path / "small.mtx")
    mmwrite(path, coo_matrix(pm.synthetic(300, 120)))
    r = pm.run(path, k, device="cpu")
    a = jm.load_matrix(path)
    q, b, piv = jm.sketch_qrcp(a, k)
    np.testing.assert_array_equal(r["piv"][:k], np.asarray(piv)[:k])
    assert_rel(to_np(r["q"]) @ to_np(r["b"]), q @ b, F32, "QB")  # 1e-4
    dense = np.asarray(a.to_dense())
    err = np.linalg.norm(dense - q @ b) / np.linalg.norm(dense)
    assert abs(r["rel"] - err) <= ABS                           # 1e-4 abs
    # the stabilizer study, the JAX example's calls
    for stab, (rel_t, piv_t) in r["study"].items():
        qs, bs, ps = jla.sketch_qrcp(a, k, rb.RNGState.from_key(7),
                                     power_iters=2, stabilizer=stab)
        np.testing.assert_array_equal(piv_t[:k], np.asarray(ps)[:k])
        err = np.linalg.norm(dense - np.asarray(qs) @ np.asarray(bs)) \
            / np.linalg.norm(dense)
        assert abs(rel_t - err) <= ABS, stab


def test_qrcp_synthetic_matrix_is_the_jax_examples(jex):
    jm, pm = jex("qrcp_low_rank"), _port("qrcp_low_rank")
    a = jm.load_matrix()
    dense = pm.synthetic()
    rows, cols = np.nonzero(dense)
    np.testing.assert_array_equal(np.asarray(a.rows), rows)
    np.testing.assert_array_equal(np.asarray(a.cols), cols)
    np.testing.assert_array_equal(np.asarray(a.vals), dense[rows, cols])


def test_svd_matrixmarket(jex, tmp_path):
    """At the example's k = 32 and p = 2. The stable stabilizers ('qr',
    'sketch') compare every singular value at 1e-4 and the rank-k error
    at 1e-4 absolute. 'lu' and 'none' do not orthonormalize: after 2p+1
    products a direction with sigma_i keeps (sigma_i / sigma_1)^(2p+1) of
    the leading one, so float32 rounding (eps) leaves it a relative error
    eps (sigma_1 / sigma_i)^(2p+1) in both packages. They compare at 1e-4
    the singular values with eps (sigma_1 / sigma_i)^(2p+1) <= 1e-4; the
    rest, and so their rank-k errors, are set by rounding."""
    jm, pm = jex("svd_matrixmarket"), _port("svd_matrixmarket")
    path = pm.demo_mtx(str(tmp_path / "small.mtx"), m=200, n=150)
    k, p = 32, 2
    r = pm.run(path, k, p, device="cpu")
    A = jm.load_matrix_market(path, format="ell")
    dense = np.asarray(A.to_dense())
    norm = np.linalg.norm(dense)
    eps = np.finfo(np.float32).eps
    for stab, res in r["runs"].items():
        u, s, vt = jm.qb_svd(A, k, p, rb.RNGState.from_key(7), stab)
        s = np.asarray(s)
        if stab in ("lu", "none"):
            keep = eps * (s[0] / s) ** (2 * p + 1) <= F32
            assert keep[:4].all(), stab
            assert_rel(to_np(res["s"])[keep], s[keep], F32, stab)  # 1e-4
            continue
        assert_rel(res["s"], s, F32, stab)                      # 1e-4
        err = np.linalg.norm(dense - (np.asarray(u) * s) @ np.asarray(vt)) \
            / norm
        assert abs(res["err"] - err) <= ABS, stab               # 1e-4 abs
    sv = np.linalg.svd(dense.astype(np.float64), compute_uv=False)
    assert abs(r["best"] - np.sqrt((sv[k:] ** 2).sum()) / norm) <= ABS


def test_svd_matrixmarket_demo_file_is_the_jax_examples(tmp_path):
    """The demo matrix at the default arguments, byte for byte the file
    the JAX example writes (data/sparse_rank20.mtx is that file)."""
    pm = _port("svd_matrixmarket")
    path = pm.demo_mtx(str(tmp_path / "sparse_rank20.mtx"))
    with open(path, "rb") as f, open(REPO / "data" / "sparse_rank20.mtx",
                                     "rb") as g:
        assert f.read() == g.read()


def test_svd_matrixmarket_lu_stabilizer_on_a_singular_panel():
    """The LU stabilizer's factorization runs on the host, where LAPACK
    completes a panel with exact zero pivots (cuSOLVER's getrf on an H100
    returned non-finite factors for (A4)'s): finite rows with unit
    diagonal where the pivot is nonzero."""
    pm = _port("svd_matrixmarket")
    seen = []
    real = torch.linalg.lu

    def lu(a, *args, **kwargs):
        seen.append(a.device.type)
        return real(a, *args, **kwargs)
    y = torch.from_numpy(np.random.default_rng(3).normal(
        size=(3, 12)).astype(np.float32))
    y = torch.cat([y, y[:1] + y[1:2], torch.zeros(1, 12)])   # rank 3 of 5
    torch.linalg.lu, saved = lu, torch.linalg.lu
    try:
        out = pm.stab_lu(y, 0)
    finally:
        torch.linalg.lu = saved
    assert seen == ["cpu"]
    assert bool(torch.isfinite(out).all())
    d = torch.diagonal(out)
    np.testing.assert_allclose(d[d != 0].numpy(), 1.0, rtol=1e-6)


def test_sketch_precondition_lsq(jex):
    """Float64 at cond 1e6. Iteration counts equal; residual norms and the
    IHS solution (a fixed 40 steps) at 1e-10. CGLS stops at tol 1e-12 on
    the normal equations, which fixes the preconditioned solution only to
    ~3e-8 of float64 lstsq's in both packages: it compares at 1e-7 (they
    differ by 7e-9). Plain CGLS on cond 1e6 loses orthogonality, so its
    iterates carry eps * cond^2 = 1e-4 of rounding: its residual compares
    at 1e-5 (3.5e-6 apart)."""
    jm, pm = jex("sketch_precondition_lsq"), _port("sketch_precondition_lsq")
    m, n, cond = 2000, 40, 1e6
    r = pm.run(m, n, cond, device="cpu")
    assert r["A"].dtype == torch.float64 and r["x"].dtype == torch.float64
    A, b = jnp.asarray(to_np(r["A"])), jnp.asarray(to_np(r["b"]))
    assert A.dtype == jnp.float64

    def res(y):
        return float(jnp.linalg.norm(A @ y - b))

    x, iters = jm.solve_preconditioned(A, b)
    assert r["iters"] == int(iters)                             # equal
    assert abs(r["res"] - res(x)) <= F64 * res(x)               # 1e-10
    assert_rel(r["x"], x, 1e-7, "preconditioned CGLS")
    x_plain, iters_plain, _ = jla.cgls(lambda y: A @ y, lambda z: A.T @ z,
                                       b, n)
    assert r["iters_plain"] == int(iters_plain)                 # equal
    assert abs(r["res_plain"] - res(x_plain)) <= 1e-5 * res(x_plain)
    x_ihs = jla.ihs_lsq(A, b, rb.RNGState.from_key(1), iters=40)[0]
    assert_rel(r["x_ihs"], x_ihs, F64, "IHS")                   # 1e-10
    assert abs(r["res_ihs"] - res(x_ihs)) <= F64 * res(x_ihs)


def test_kernel_ridge(jex):
    jm, pm = jex("kernel_ridge"), _port("kernel_ridge")
    n, n_test, dim = 300, 50, 4
    r = pm.run(n, n_test, dim, device="cpu")
    # the JAX example's main() at this size
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
    x_test = rng.uniform(-1, 1, (n_test, dim)).astype(np.float32)
    y = (pm.target(x) + 0.05 * rng.normal(size=n)).astype(np.float32)
    k_mat = jm.rbf_kernel(jnp.asarray(x), jnp.asarray(x), 0.5)
    np.testing.assert_allclose(
        to_np(pm.rbf_kernel(torch.from_numpy(x), torch.from_numpy(x), 0.5)),
        k_mat, rtol=1e-6, atol=0)     # XLA's exp and sum: an ulp apart
    alpha, iters, _ = jla.nystrom_pcg(k_mat, jnp.asarray(y),
                                      rb.RNGState.from_key(1), d=200,
                                      mu=n * 1e-4, tol=1e-6)
    assert r["iters"] == int(iters)                             # equal
    assert_rel(r["alpha"], alpha, F32, "alpha")                 # 1e-4
    k_test = jm.rbf_kernel(jnp.asarray(x_test), jnp.asarray(x), 0.5)
    rmse = float(np.sqrt(np.mean((np.asarray(k_test @ alpha)
                                  - pm.target(x_test)) ** 2)))
    assert abs(r["rmse"] - rmse) <= ABS                         # 1e-4 abs


def test_spectrum_exploration(jex):
    pm = _port("spectrum_exploration")
    n = 128
    r = pm.run(n, device="cpu")
    a_np, _ = pm.make_problem(n)
    a = jnp.asarray(a_np)
    # the JAX example's main() at this size
    st = rb.RNGState.from_key(7)
    grid, dens, st = jla.spectral_density(a, st, probes=8, steps=48)
    assert_rel(r["slq"][0], grid, F32, "SLQ grid")              # 1e-4
    assert_rel(r["slq"][1], dens, F32, "SLQ density")
    gridk, densk, st = jla.kpm_density(a, st, degree=128, probes=8,
                                       bounds=(-1.5, 6.5))
    assert_rel(r["kpm"][1], densk, F32, "KPM density")
    count, st = jla.eig_count(a, 4.0, 7.0, st, probes=48, steps=64)
    assert abs(r["count"] - float(count)) <= F32 * float(count)
    k = int(round(float(count)))
    assert r["k"] == k
    w, _ = jla.rand_eigh(a, k, st)
    assert_rel(r["w"], w, F32, "rand_eigh")
    fd = jla.FrequentDirections(n, ell=64)
    for i in range(0, n, 256):
        fd.update(a[i:i + 256])
    fd.sketch()
    assert abs(r["fd_cert"] - float(fd.shrink_mass)) \
        <= F32 * float(fd.shrink_mass)
    # one shrink of 128 rows to 64: the certificate is tight (an equality
    # in exact arithmetic), so it holds to its float32 rounding
    assert r["fd_true"] <= r["fd_cert"] * (1 + F32) <= r["fd_worst"]


def test_cp_als_tensor_sketch(jex):
    jm, pm = jex("cp_als_tensor_sketch"), _port("cp_als_tensor_sketch")
    # d_ts = d_kf: the JAX package compiles one set of TensorSketch shapes
    shape, rank, sweeps, d_ts, d_kf = (10, 12, 12), 3, 2, 16, 16
    r = pm.run(shape, rank, sweeps, sweeps, d_ts, d_kf, device="cpu")
    xj = jnp.asarray(pm.make_tensor(shape, rank))
    runs = {"exact": jm.cp_als(xj, rank, sweeps),
            "ts": jm.cp_als(xj, rank, sweeps, d=d_ts,
                            state=rb.RNGState.from_key(7), sketch="ts"),
            "kfjlt": jm.cp_als(xj, rank, sweeps, d=d_kf,
                               state=rb.RNGState.from_key(7),
                               sketch="kfjlt"),
            "ts_small": jm.cp_als(xj, rank, sweeps, d=d_kf,
                                  state=rb.RNGState.from_key(7))}
    for name, abc in runs.items():
        assert abs(r["fit"][name] - jm.fit(xj, *abc)) \
            <= F32 * abs(jm.fit(xj, *abc)), name                 # 1e-4
        for got, want in zip(r["factors"][name], abc):
            assert_rel(got, want, F32, name)                    # 1e-4


def test_tt_compression(jex):
    pm = _port("tt_compression")
    n = 8
    r = pm.run(n, device="cpu")
    x = jnp.asarray(pm.hilbert(n))
    xn = float(jnp.linalg.norm(x))
    # the JAX example's main() at this size
    st = rb.RNGState.from_key(5)
    for rank in pm.RANKS:
        tt, st = jla.tt_from_dense(x, rank, st, power_iters=2)
        err = float(jnp.linalg.norm(tt.full() - x)) / xn
        assert abs(r["compress"][rank][0] - err) <= ABS, rank   # 1e-4 abs
        assert r["compress"][rank][1] == sum(g.size for g in tt.cores)
    tt, st = jla.tt_from_dense(x, pm.ROUND_RANK, st, power_iters=2)
    y = jla.tt_add(tt, jla.tt_scale(tt, 0.5))
    rt_, st = jla.tt_round(y, pm.ROUND_RANK, st)
    assert tuple(r["sum_ranks"]) == tuple(y.ranks)
    assert tuple(r["rounded_ranks"]) == tuple(rt_.ranks)
    err = float(jnp.linalg.norm(rt_.full() - 1.5 * x)) / (1.5 * xn)
    assert abs(r["round_err"] - err) <= ABS
    assert abs(r["tt_norm"] - float(jla.tt_norm(rt_))) \
        <= F32 * r["tt_norm"]                                   # 1e-4


def test_distributed_sketching():
    """The port's --cpu program (4 gloo processes: meshes 1x4 and 2x2)
    against the JAX example's calls on the 8 virtual CPU devices (meshes
    1x8 and 2x4): every mesh's sketch and the distributed rSVD's
    singular values, 1e-4 relative."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from randblas_tpu.parallel import distributed_sketch, make_sketch_mesh
    pm = _port("distributed_sketching")
    d, m, n = 32, 1024, 64
    r = pm.run(d, m, n, device="cpu", ranks=4)
    assert r["world"] == 4 and set(r["meshes"]) == {"1x4", "2x2"}
    S = rb.DenseSkOp(rb.DenseDist(d, m), rb.RNGState.from_key(42))
    A = jnp.asarray(np.random.default_rng(0).normal(
        size=(m, n)).astype(np.float32))
    ref = rb.sketch_general(S, A)
    for model in (1, 2):
        mesh = make_sketch_mesh(model, 8 // model)
        B = distributed_sketch(
            S, jax.device_put(A, NamedSharding(mesh, P("data", None))), mesh)
        for got in r["meshes"].values():
            assert_rel(np.asarray(got["B"]), B, F32, f"mesh {model}")
    for got in r["meshes"].values():
        assert_rel(np.asarray(got["B"]), ref, F32, "single device")
        assert got["placements"] == ["S(0)", "R"]
    rng = np.random.default_rng(1)
    u0, _ = np.linalg.qr(rng.normal(size=(m, 6)))
    v0, _ = np.linalg.qr(rng.normal(size=(n, 6)))
    M = jnp.asarray((u0 * np.linspace(5.0, 1.0, 6)) @ v0.T, jnp.float32)
    mesh = make_sketch_mesh(1, 8)
    _, s_hat, _ = jla.distributed_rsvd(
        jax.device_put(M, NamedSharding(mesh, P("data", None))), 6,
        rb.RNGState.from_key(7), mesh)
    assert_rel(np.asarray(r["s_hat"]), s_hat, F32, "distributed_rsvd")
    assert r["orth_err"] < 1e-5 and r["sv_err"] < 1e-4


def test_multihost_cpu_demo():
    """Two processes over gloo: each local block of both meshes against
    the JAX package's operator times the data, at the JAX example's
    tolerance (rtol 2e-5, atol 1e-5)."""
    pm = _port("multihost_cpu_demo")
    rc, outs = pm.run()
    assert rc == [0, 0]
    S = rb.DenseSkOp(rb.DenseDist(pm.D, pm.M), rb.RNGState.from_key(7))
    a = np.random.default_rng(0).normal(size=(pm.M, pm.N)).astype(np.float32)
    want = np.asarray(S.materialize()) @ a
    seen = {}
    for text in outs:
        res = next(json.loads(line[7:]) for line in text.splitlines()
                   if line.startswith("RESULT "))
        for shape, (row0, block) in res["blocks"].items():
            block = np.asarray(block)
            np.testing.assert_allclose(
                block, want[row0:row0 + block.shape[0]], rtol=2e-5,
                atol=1e-5)
            seen.setdefault(shape, set()).add(row0)
    assert seen == {"1x2": {0}, "2x1": {0, pm.D // 2}}


@pytest.mark.parametrize("name", EXAMPLES)
def test_runs_on_the_card_unless_asked_for_the_cpu(name, monkeypatch):
    """With no card and no device="cpu", run() raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _port(name).run()


@pytest.mark.parametrize("name,argv", [
    ("total_least_squares", ["300", "12"]),
    ("low_rank_svd", ["120", "100"]),
    ("sketch_precondition_lsq", ["600", "20"]),
    ("kernel_ridge", ["200"]),
    ("spectrum_exploration", ["64"]),
    ("tt_compression", ["6"]),
])
def test_main_parses_the_jax_arguments_and_cpu(name, argv, capsys):
    _port(name).main(argv + ["--cpu"])
    assert capsys.readouterr().out.strip()
