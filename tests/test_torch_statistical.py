"""The statistical gates of the port (counterpart of
tests/test_generators_generic.py, tests/test_vmap_ensemble.py and
tests/test_statistical.py), on the CPU.

- Generator genericity: operators over Threefry and the 2x32 generators,
  each against the JAX package's (Uniform values and indices bitwise,
  Gaussian values within the documented cross-platform tolerance).
- Ensembles: the port's RNGState keeps its words as Python ints, so an
  ensemble of operators is a loop over seeds (no batched-seed API). The
  loop is held against ``jax.vmap`` over the same seeds: the operators
  bit for bit where the values are Uniform, the sketches within 1e-5
  (float32 products summed in another order; Gaussian values an ulp or
  two apart), K1's plain version within 1e-4 of max |want| (its bf16
  operand rounding, the CPU tier's bound), gradients at the JAX test's
  rtol 1e-4, atol 1e-4.
- The statistical tier (marked ``slow``, as its JAX counterpart): KS tests
  of the scalar streams, chi-square tests of the index samplers,
  hypergeometric KS for Fisher-Yates, subspace-embedding distortion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

import randblas_tpu as rb
import randblas_tpu_torch as rt
from randblas_tpu_torch import (
    DenseDist, DenseDistName, DenseSkOp, MajorAxis, RNGState, SparseDist,
    SparseSkOp, fill_dense_submat, isometry_scale_factor, sketch_general,
    sample_indices_iid, sample_indices_iid_uniform, weights_to_cdf,
    repeated_fisher_yates,
)

from _torch_parity import assert_rel, states, to_np

CPU = "cpu"
GAUSS_TOL = dict(rtol=2e-3, atol=2e-3)   # cross-platform transcendentals
SKETCH_REL = 1e-5
K1_REL = 1e-4


# -- generator genericity (tests/test_generators_generic.py) ------------

@pytest.mark.parametrize("rng_name", ["threefry4x32", "philox2x32",
                                      "threefry2x32"])
def test_dense_fill_other_generators(rng_name):
    dist = DenseDist(6, 14)
    js, state = states(9, rng_name)
    full = fill_dense_submat(dist, state, 6, 14, device=CPU).numpy()
    assert np.isfinite(full).all()
    assert abs(full.mean()) < 0.5  # sanity, tiny sample
    # submatrix addressing must hold for any counter width
    block = fill_dense_submat(dist, state, 3, 5, 2, 4, device=CPU).numpy()
    np.testing.assert_array_equal(block, full[2:5, 4:9])
    want = np.asarray(rb.fill_dense_submat(rb.DenseDist(6, 14), js, 6, 14))
    np.testing.assert_allclose(full, want, **GAUSS_TOL)
    ju = np.asarray(rb.fill_dense_submat(
        rb.DenseDist(6, 14, rb.DenseDistName.Uniform), js, 6, 14))
    tu = fill_dense_submat(DenseDist(6, 14, DenseDistName.Uniform), state,
                           6, 14, device=CPU).numpy()
    np.testing.assert_array_equal(tu, ju)


def test_streams_differ_across_generators():
    dist = DenseDist(8, 8)
    a = fill_dense_submat(dist, RNGState.from_key(1), 8, 8, device=CPU)
    b = fill_dense_submat(dist, RNGState.from_key(1, rng="threefry4x32"),
                          8, 8, device=CPU)
    assert not torch.allclose(a, b)


def test_fisher_yates_threefry():
    js, state = states(3, "threefry4x32")
    idxs, vals = repeated_fisher_yates(state, 3, 10, 6, device=CPU)
    for row in idxs.numpy():
        assert len(set(row.tolist())) == 3
    assert set(np.unique(vals.numpy())) <= {-1.0, 1.0}
    jidx, jvals = rb.repeated_fisher_yates(js, 3, 10, 6)
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_sketch_with_threefry_operator():
    js, state = states(2, "threefry4x32")
    S = DenseSkOp(DenseDist(4, 20), state)
    A = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    got = sketch_general(S, torch.from_numpy(A)).numpy()
    want = S.materialize(device=CPU).numpy() @ A
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    jgot = rb.sketch_general(rb.DenseSkOp(rb.DenseDist(4, 20), js), A)
    assert_rel(got, jgot, SKETCH_REL, "against the JAX package")


@pytest.mark.parametrize("rng_name", ["philox2x32", "threefry2x32"])
def test_two_word_generators_never_reach_the_fused_kernels(rng_name,
                                                          monkeypatch):
    """The JAX package's fused kernel hardcodes Philox4x32 and keeps
    every other generator off it. The port's K1/K2 generate Philox4x32 and
    Threefry4x32 in the kernel (fused_sketch.SUPPORTED_RNGS); a 2x32
    generator must never be dispatched to them (it would silently change
    the stream): under "auto" its sketch is the staged product of the
    plain fill, and forcing the fused route raises."""
    from randblas_tpu_torch.ops import fused_sketch as fs
    assert set(fs.SUPPORTED_RNGS) == {"philox4x32", "threefry4x32"}

    def refuse(*_a, **_k):
        raise AssertionError("a 2x32 generator reached K1/K2")
    monkeypatch.setattr(fs, "fused_sketch", refuse)
    monkeypatch.setattr(fs, "fused_sketch_colmajor", refuse)
    S = DenseSkOp(DenseDist(64, 1024), RNGState.from_key(1, rng=rng_name))
    A = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1024, 8)).astype(np.float32))
    torch.testing.assert_close(sketch_general(S, A),
                               S.materialize(device=CPU) @ A)
    with rt.flags(use_fused=True), pytest.raises(ValueError,
                                                 match="4x32 generator"):
        sketch_general(S, A)


# -- ensembles over seeds (tests/test_vmap_ensemble.py) ------------------

DIST = (16, 64)
A_ENS = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
SEEDS = 3


def _jax_seeds(nb):
    ctrs = jnp.zeros((nb, 4), jnp.uint32)
    keys = jnp.zeros((nb, 2), jnp.uint32).at[:, 0].set(
        jnp.arange(nb, dtype=jnp.uint32))
    return ctrs, keys


def _port_state(i):
    return RNGState.from_arrays([0, 0, 0, 0], [i, 0])


@pytest.mark.parametrize("family", ["Gaussian", "Uniform"])
def test_ensemble_loop_matches_vmap_over_seeds(family):
    jdist = rb.DenseDist(*DIST, rb.DenseDistName[family])
    tdist = DenseDist(*DIST, DenseDistName[family])

    def one(ctr, key):
        return rb.sketch(rb.DenseSkOp(jdist, rb.RNGState.from_arrays(
            ctr, key)), jnp.asarray(A_ENS))

    def op(ctr, key):
        return rb.DenseSkOp(jdist, rb.RNGState.from_arrays(
            ctr, key)).materialize()

    ctrs, keys = _jax_seeds(SEEDS)
    batched = jax.vmap(one)(ctrs, keys)
    ops = jax.vmap(op)(ctrs, keys)
    A = torch.from_numpy(A_ENS)
    loop = torch.stack([rt.sketch(DenseSkOp(tdist, _port_state(i)), A)
                        for i in range(SEEDS)])
    assert_rel(loop, batched, SKETCH_REL, "ensemble")
    for i in range(SEEDS):
        got = DenseSkOp(tdist, _port_state(i)).materialize(device=CPU)
        if family == "Uniform":
            np.testing.assert_array_equal(got.numpy(), np.asarray(ops[i]))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(ops[i]),
                                       **GAUSS_TOL)


def test_ensemble_of_k1_plain_versions_matches_vmap_interpret():
    from randblas_tpu.ops import fused_sketch as jfs
    from randblas_tpu_torch.ops import fused_sketch as fs
    ctrs, keys = _jax_seeds(SEEDS)

    def one(ctr, key):
        S = rb.DenseSkOp(rb.DenseDist(*DIST), rb.RNGState.from_arrays(ctr,
                                                                    key))
        return jfs.fused_sketch(S, jnp.asarray(A_ENS), interpret=True)

    batched = np.asarray(jax.vmap(one)(ctrs, keys))
    A = torch.from_numpy(A_ENS)
    for i in range(SEEDS):
        got = fs.fused_sketch_reference(
            DenseSkOp(DenseDist(*DIST), _port_state(i)), A).numpy()
        err = np.abs(got - batched[i]).max() / np.abs(batched[i]).max()
        assert err <= K1_REL, (i, err)


def test_ensemble_composes_with_grad():
    ctrs, keys = _jax_seeds(SEEDS)

    def loss(a):
        ens = jax.vmap(lambda c, k: rb.sketch(rb.DenseSkOp(
            rb.DenseDist(*DIST), rb.RNGState.from_arrays(c, k)), a))(
            ctrs, keys)
        return jnp.sum(ens ** 2)

    g_jax = np.asarray(jax.grad(loss)(jnp.asarray(A_ENS)))
    A = torch.from_numpy(A_ENS).requires_grad_(True)
    sum(torch.sum(rt.sketch(DenseSkOp(DenseDist(*DIST), _port_state(i)),
                            A) ** 2) for i in range(SEEDS)).backward()
    np.testing.assert_allclose(A.grad.numpy(), g_jax, rtol=1e-4, atol=1e-4)
    # oracle: the sum of per-operator gradients of the materialized product
    g_ref = sum(2 * S.T @ (S @ torch.from_numpy(A_ENS)) for S in (
        DenseSkOp(DenseDist(*DIST), _port_state(i)).materialize(device=CPU)
        for i in range(SEEDS)))
    np.testing.assert_allclose(A.grad.numpy(), g_ref.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.slow
def test_ensemble_sparse_operator_apply():
    """Batched SASO sketching: a loop over pre-filled triplets against
    jax.vmap of the JAX package's COO apply."""
    from randblas_tpu.ops.coo_apply import coo_left_apply as jcoo
    from randblas_tpu_torch.ops.coo_apply import coo_left_apply
    ops = [rb.SparseSkOp(rb.SparseDist(8, 64, vec_nnz=4),
                         rb.RNGState.from_key(k)).filled() for k in range(3)]
    batched = jax.vmap(lambda r, c, v: jcoo(r, c, v, jnp.asarray(A_ENS), 8,
                                            64))(
        jnp.stack([o.rows for o in ops]), jnp.stack([o.cols for o in ops]),
        jnp.stack([o.vals for o in ops]))
    A = torch.from_numpy(A_ENS)
    for k in range(3):
        S = SparseSkOp(SparseDist(8, 64, vec_nnz=4),
                       RNGState.from_key(k)).filled(device=CPU)
        np.testing.assert_array_equal(S.rows.numpy(), np.asarray(ops[k].rows))
        got = coo_left_apply(S.rows, S.cols, S.vals, A, 8, 64)
        want = S.materialize(device=CPU).numpy() @ A_ENS
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(batched[k]),
                                   rtol=1e-5, atol=1e-5)


# -- the statistical tier (tests/test_statistical.py), slow --------------

SIG = 1e-4  # significance level for KS tests (reference sweeps 1e-2..1e-6)


def ks_threshold(n, sig=SIG):
    """Asymptotic two-sided KS critical value (what scipy/the reference's
    tables encode)."""
    return st.kstwobign.ppf(1 - sig) / np.sqrt(n)


@pytest.mark.slow
@pytest.mark.parametrize("key", [0, 7])
def test_ks_gaussian(key):
    n = 1 << 18
    dist = DenseDist(1 << 9, 1 << 9, DenseDistName.Gaussian)
    samples = fill_dense_submat(dist, RNGState.from_key(key), 1 << 9, 1 << 9,
                                device=CPU).numpy().reshape(-1)
    d_stat = st.ks_1samp(samples, st.norm.cdf).statistic
    assert d_stat < ks_threshold(n)


@pytest.mark.slow
@pytest.mark.parametrize("key", [1, 12])
def test_ks_uniform(key):
    n = 1 << 18
    dist = DenseDist(1 << 9, 1 << 9, DenseDistName.Uniform)
    samples = fill_dense_submat(dist, RNGState.from_key(key), 1 << 9, 1 << 9,
                                device=CPU).numpy().reshape(-1)
    r = np.sqrt(3.0)
    d_stat = st.ks_1samp(samples,
                         lambda x: st.uniform.cdf(x, -r, 2 * r)).statistic
    assert d_stat < ks_threshold(n)


@pytest.mark.slow
def test_ks_index_sampling_with_replacement():
    n, k = 50, 1 << 16
    w = np.linspace(1.0, 3.0, n).astype(np.float32)
    cdf = weights_to_cdf(torch.from_numpy(w))
    samples, _ = sample_indices_iid(cdf, k, RNGState.from_key(3))
    probs = w / w.sum()
    hist = np.bincount(samples.numpy(), minlength=n) / k
    # chi-square goodness of fit
    chi2 = k * np.sum((hist - probs) ** 2 / probs)
    assert chi2 < st.chi2.ppf(1 - SIG, df=n - 1)


@pytest.mark.slow
def test_ks_index_sampling_uniform():
    n, k = 64, 1 << 16
    samples, _ = sample_indices_iid_uniform(n, k, RNGState.from_key(9),
                                            device=CPU)
    hist = np.bincount(samples.numpy(), minlength=n) / k
    chi2 = k * np.sum((hist - 1.0 / n) ** 2 * n)
    assert chi2 < st.chi2.ppf(1 - SIG, df=n - 1)


@pytest.mark.slow
def test_fisher_yates_marginals_uniform():
    """Without-replacement sampling: each index equally likely per draw."""
    dim_major, vec_nnz, reps = 12, 4, 4096
    idxs, _ = repeated_fisher_yates(RNGState.from_key(5), vec_nnz,
                                    dim_major, reps, device=CPU)
    counts = np.bincount(idxs.numpy().reshape(-1), minlength=dim_major)
    expect = reps * vec_nnz / dim_major
    chi2 = np.sum((counts - expect) ** 2 / expect)
    assert chi2 < st.chi2.ppf(1 - SIG, df=dim_major - 1)


@pytest.mark.slow
@pytest.mark.parametrize("make_op", [
    lambda d, m: DenseSkOp(DenseDist(d, m), RNGState.from_key(21)),
    lambda d, m: SparseSkOp(SparseDist(d, m, vec_nnz=8,
                                       major_axis=MajorAxis.Short),
                            RNGState.from_key(22)).filled(device=CPU),
])
def test_subspace_embedding_distortion(make_op):
    """sigma(c S U) within 1 +- delta for orthonormal U
    (test_distortion.cc:49-116): N=256-dim subspace of R^4000, d=4N,
    delta=0.5 gives overwhelming success probability."""
    m, N = 4000, 256
    d = 4 * N
    rng = np.random.default_rng(0)
    U, _ = np.linalg.qr(rng.normal(size=(m, N)))
    U = torch.from_numpy(U.astype(np.float32))
    S = make_op(d, m)
    scale = isometry_scale_factor(S.dist)
    SU = sketch_general(S, U, alpha=scale).numpy()
    sv = np.linalg.svd(SU, compute_uv=False)
    delta = 0.5
    assert sv.max() < 1 + delta, f"sigma_max {sv.max()}"
    assert sv.min() > 1 - delta, f"sigma_min {sv.min()}"


def _scalar_stream(family, n, key):
    dist = DenseDist(n, 1, family, MajorAxis.Long)
    return fill_dense_submat(dist, RNGState.from_key(key), n, 1,
                             device=CPU).numpy().reshape(-1)


def _true_cdf(family):
    if family == DenseDistName.Gaussian:
        return st.norm.cdf
    r = np.sqrt(3.0)
    return lambda x: st.uniform.cdf(x, -r, 2 * r)


@pytest.mark.slow
@pytest.mark.parametrize("family", [DenseDistName.Gaussian,
                                    DenseDistName.Uniform])
@pytest.mark.parametrize("sig,n,keys", [
    (1e-2, 1_000, (0,)), (1e-2, 10_000, (0,)), (1e-2, 100_000, (0,)),
    (1e-4, 1_000, (0,)), (1e-4, 10_000, (0,)), (1e-4, 100_000, (0,)),
    (1e-6, 1_000, (999, 1000, 1001)),
    (1e-6, 10_000, (999, 1000, 1001)),
    (1e-6, 100_000, (999, 1000, 1001)),
])
def test_ks_significance_sweep(family, sig, n, keys):
    cdf = _true_cdf(family)
    for key in keys:
        d_stat = st.ks_1samp(_scalar_stream(family, n, key), cdf).statistic
        assert d_stat < ks_threshold(n, sig), (family, sig, n, key)


@pytest.mark.slow
def test_degenerate_distribution_even_support():
    """Mass only on even indices != 10: no sample may land elsewhere
    (test_discrete.cc:135-147)."""
    n = 100
    w = np.zeros(n, np.float32)
    w[::2] = 1.0 / (np.arange(0, n, 2) + 1.0)
    w[10] = 0.0
    cdf = weights_to_cdf(torch.from_numpy(w))
    samples, _ = sample_indices_iid(cdf, n * n, RNGState.from_key(13))
    samples = samples.numpy()
    assert not ((samples == 10) | (samples % 2 == 1)).any()


@pytest.mark.slow
def test_degenerate_distribution_delta_with_negative_weight():
    """Delta distribution plus a tiny negative weight that must be clipped
    without error (test_discrete.cc:149-161)."""
    n = 100
    w = np.zeros(n, np.float32)
    w[17] = 99.0
    w[3] = -np.finfo(np.float32).eps / 10
    cdf = weights_to_cdf(torch.from_numpy(w))
    assert float(cdf[17]) >= 0.0
    samples, _ = sample_indices_iid(cdf, n * n, RNGState.from_key(14))
    assert (samples.numpy() == 17).all()


@pytest.mark.slow
@pytest.mark.parametrize("N,K", [(20, 5), (50, 8)])
def test_fisher_yates_hypergeometric_ks(N, K):
    """Count of sampled indices below K follows Hypergeometric(N, K, K)
    (test_discrete.cc:166-237)."""
    num_samples = 4096
    idxs, _ = repeated_fisher_yates(RNGState.from_key(6), K, N, num_samples,
                                    device=CPU)
    below = (idxs.numpy() < K).sum(axis=1)
    emp_cdf = np.cumsum(np.bincount(below, minlength=K + 1)) / num_samples
    true_cdf = st.hypergeom(N, K, K).cdf(np.arange(K + 1))
    assert np.abs(emp_cdf - true_cdf).max() < ks_threshold(num_samples, 1e-4)


@pytest.mark.slow
def test_subspace_embedding_distortion_laso():
    """LASO (long-axis) sparse operator distortion case."""
    m, N = 4000, 256
    d = 4 * N
    rng = np.random.default_rng(1)
    U, _ = np.linalg.qr(rng.normal(size=(m, N)))
    S = SparseSkOp(SparseDist(d, m, vec_nnz=8, major_axis=MajorAxis.Long),
                   RNGState.from_key(23)).filled(device=CPU)
    scale = isometry_scale_factor(S.dist)
    SU = sketch_general(S, torch.from_numpy(U.astype(np.float32)),
                        alpha=scale).numpy()
    sv = np.linalg.svd(SU, compute_uv=False)
    assert sv.max() < 1.5 and sv.min() > 0.5, (sv.max(), sv.min())


@pytest.mark.slow
def test_ks_gaussian_fast_trig():
    """K1/K2's polynomial sincospi Box-Muller (boxmul_pair_i32
    fast_cos=True) passes the same KS test as the exact-trig path, and
    agrees with it to ~1 ulp."""
    from randblas_tpu_torch.rng.transforms import boxmul_pair_i32
    rng = np.random.default_rng(42)
    n = 1 << 17
    se = torch.from_numpy(rng.integers(-2**31, 2**31, size=n, dtype=np.int32))
    so = torch.from_numpy(rng.integers(-2**31, 2**31, size=n, dtype=np.int32))
    a, b = boxmul_pair_i32(se, so, fast_cos=True)
    samples = np.concatenate([to_np(a), to_np(b)])
    stat = st.kstest(samples, "norm").statistic
    assert stat < ks_threshold(samples.size)
    a0, b0 = boxmul_pair_i32(se, so)
    assert float((a - a0).abs().max()) < 2e-6
    assert float((b - b0).abs().max()) < 2e-6
