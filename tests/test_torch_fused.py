"""Parity of the plain versions of the port's kernels with the JAX package's
Pallas kernels, run in interpret mode on the CPU (the wrappers get CPU
tensors, and fills are asked for with device="cpu"):

- K1: randblas_tpu_torch.ops.fused_sketch.fused_sketch (on a CPU tensor it
  runs its plain version) vs randblas_tpu.ops.fused_sketch.fused_sketch(...,
  interpret=True). Both round the operands to bf16 and accumulate in
  float32; the sums run in another order and Gaussian values may differ by
  an ulp (libm), which can flip a bf16 rounding. Compared normalised by
  max |want| at 1e-4 (K1_TOL): the readings on these cases are 1.1e-7 to
  1.8e-7, one flipped bf16 rounding costs about 3e-5, and the same product
  with float32 operands (no bf16 rounding) is 2.0e-3 to 2.4e-3 away, so the
  limit separates a plain version that dropped the rounding; each case also
  asserts that separation.
- K2: fused_sketch_colmajor vs the JAX package's fused_sketch_colmajor(...,
  interpret=True), at the same limit and with the same separation from the
  float32-operand product, for the same reasons.
- K3: fill_block vs pallas_fill_block(..., interpret=True). Uniform values
  are exact; Gaussian values at rtol/atol 2e-3 (cross-platform log/sin/cos).

On CPU tensors the kernels' launch counters stay at 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu.base import Op as JOp
from randblas_tpu.ops import fused_sketch as jfs
import randblas_tpu_torch as rt
from randblas_tpu_torch.base import Op
from randblas_tpu_torch.ops import fused_sketch as tfs


def _ops(shape, family="Gaussian", key=1, rng="philox4x32", major="Long"):
    jS = rb.DenseSkOp(rb.DenseDist(*shape, rb.DenseDistName[family],
                                   rb.MajorAxis[major]),
                      rb.RNGState.from_key(key, rng))
    tS = rt.DenseSkOp(rt.DenseDist(*shape, rt.DenseDistName[family],
                                   rt.MajorAxis[major]),
                      rt.RNGState.from_key(key, rng))
    return jS, tS


def _data(m, n, seed):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


K1_TOL = 1e-4


def _norm_err(got, want):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _close(got, want, atol=K1_TOL):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol)


# (operator shape, family, rng, d, m, n, ro_s, co_s, alpha)
K1_CASES = [
    ((16, 2048), "Gaussian", "philox4x32", 16, 2048, 256, 0, 0, 1.0),
    ((20, 2100), "Gaussian", "philox4x32", 13, 1000, 100, 5, 3, 0.5),
    ((12, 1500), "Gaussian", "threefry4x32", 8, 512, 64, 2, 4, 1.0),
    ((16, 1030), "Uniform", "philox4x32", 16, 1024, 128, 0, 6, 2.0),
]


@pytest.mark.parametrize("shape,family,rng,d,m,n,ro_s,co_s,alpha", K1_CASES)
def test_k1_plain_matches_jax_interpret(shape, family, rng, d, m, n, ro_s,
                                        co_s, alpha):
    jS, tS = _ops(shape, family, rng=rng)
    A = _data(m, n, seed=d + m)
    want = jfs.fused_sketch(jS, A, alpha=alpha, interpret=True, rows_s=d,
                            cols_s=m, ro_s=ro_s, co_s=co_s)
    got = tfs.fused_sketch(tS, torch.from_numpy(A), alpha=alpha, rows_s=d,
                           cols_s=m, ro_s=ro_s, co_s=co_s)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    ref = tfs.fused_sketch_reference(tS, torch.from_numpy(A), alpha=alpha,
                                     rows_s=d, cols_s=m, ro_s=ro_s, co_s=co_s)
    _close(got.numpy(), ref.numpy(), atol=1e-5)
    # the limit tells the bf16-operand product from the float32 one
    f32 = alpha * (tS.submat(d, m, ro_s, co_s, device="cpu")
                   @ torch.from_numpy(A))
    assert _norm_err(f32.numpy(), want) > 10 * K1_TOL


def test_k1_plain_bf16_data_matches_jax_interpret():
    jS, tS = _ops((8, 512), key=4)
    A = _data(512, 128, seed=4)
    want = jfs.fused_sketch(jS, jnp.asarray(A, dtype=jnp.bfloat16),
                            interpret=True)
    got = tfs.fused_sketch(tS, torch.from_numpy(A).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    # the outputs are rounded to bf16: one bf16 ulp (2^-8) of slack on top
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           atol=1e-2)


def test_k1_plain_is_the_bf16_product_of_the_fill():
    # K1's operator values are the fill's up to one ulp (polynomial
    # sincospi, signed-view u01), so the bf16-rounded product agrees with
    # the float32 product of the materialized block to bf16 accuracy
    _, tS = _ops((24, 777), key=9)
    A = torch.from_numpy(_data(700, 40, seed=9))
    got = tfs.fused_sketch(tS, A, rows_s=20, cols_s=700, ro_s=3, co_s=77)
    dense = tS.submat(20, 700, 3, 77, device="cpu") @ A
    _close(got.numpy(), dense.numpy(), atol=2e-2)


# (operator shape, family, major, rng, d, m, n, ro_s, co_s, alpha): the
# ColMajor-natural dists (tall+Long, wide+Short, square+Long)
K2_CASES = [
    ((1000, 24), "Gaussian", "Long", "philox4x32", 1000, 24, 40, 0, 0, 1.0),
    ((40, 3000), "Uniform", "Short", "philox4x32", 33, 2900, 50, 5, 17, 0.5),
    ((300, 64), "Gaussian", "Long", "threefry4x32", 250, 60, 30, 3, 4, 2.0),
    ((1030, 48), "Uniform", "Long", "threefry4x32", 1027, 40, 64, 2, 8, 1.0),
    ((64, 64), "Gaussian", "Long", "philox4x32", 64, 64, 16, 0, 0, 1.0),
]


@pytest.mark.parametrize("shape,family,major,rng,d,m,n,ro_s,co_s,alpha",
                         K2_CASES)
def test_k2_plain_matches_jax_interpret(shape, family, major, rng, d, m, n,
                                        ro_s, co_s, alpha):
    jS, tS = _ops(shape, family, rng=rng, major=major)
    A = _data(m, n, seed=d + m)
    want = jfs.fused_sketch_colmajor(jS, A, alpha=alpha, interpret=True,
                                     rows_s=d, cols_s=m, ro_s=ro_s,
                                     co_s=co_s)
    got = tfs.fused_sketch_colmajor(tS, torch.from_numpy(A), alpha=alpha,
                                    rows_s=d, cols_s=m, ro_s=ro_s, co_s=co_s)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    ref = tfs.fused_sketch_colmajor_reference(
        tS, torch.from_numpy(A), alpha=alpha, rows_s=d, cols_s=m, ro_s=ro_s,
        co_s=co_s)
    assert torch.equal(got, ref)
    # the limit tells the bf16-operand product from the float32 one
    f32 = alpha * (tS.submat(d, m, ro_s, co_s, device="cpu")
                   @ torch.from_numpy(A))
    assert _norm_err(f32.numpy(), want) > 10 * K1_TOL


def test_k2_plain_bf16_data_matches_jax_interpret():
    jS, tS = _ops((500, 64), key=4)
    A = _data(64, 128, seed=4)
    want = jfs.fused_sketch_colmajor(jS, jnp.asarray(A, dtype=jnp.bfloat16),
                                     interpret=True, rows_s=497, ro_s=3)
    got = tfs.fused_sketch_colmajor(tS, torch.from_numpy(A).to(torch.bfloat16),
                                    rows_s=497, ro_s=3)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           atol=1e-2)


# (operator shape, family, major, rng, rows, cols, ro_s, co_s)
K3_CASES = [
    ((40, 300), "Gaussian", "Long", "philox4x32", 33, 150, 5, 7),
    ((300, 40), "Uniform", "Long", "philox4x32", 150, 33, 7, 5),
    ((40, 300), "Uniform", "Short", "threefry4x32", 17, 201, 3, 9),
    ((64, 512), "Gaussian", "Long", "threefry4x32", 64, 512, 0, 0),
]


@pytest.mark.parametrize("shape,family,major,rng,rows,cols,ro_s,co_s",
                         K3_CASES)
def test_k3_plain_matches_jax_interpret(shape, family, major, rng, rows,
                                        cols, ro_s, co_s):
    jS, tS = _ops(shape, family, key=6, rng=rng, major=major)
    want = np.asarray(jfs.pallas_fill_block(jS, rows, cols, ro_s, co_s,
                                            interpret=True))
    got = tfs.fill_block(tS, rows, cols, ro_s, co_s, device="cpu")
    assert tuple(got.shape) == (rows, cols)
    if family == "Uniform":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    ref = tfs.fill_block_reference(tS, rows, cols, ro_s, co_s, device="cpu")
    assert torch.equal(got, ref)
    # the same block of the staged fill: Uniform bitwise, Gaussian ~1 ulp
    staged = tS.submat(rows, cols, ro_s, co_s, device="cpu")
    if family == "Uniform":
        assert torch.equal(got, staged)
    else:
        torch.testing.assert_close(got, staged, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_launch_no_kernel():
    tfs.fused_sketch.launches = 0
    tfs.fused_sketch_colmajor.launches = 0
    tfs.fill_block.launches = 0
    _, tS = _ops((8, 256))
    _, tcol = _ops((256, 8))
    tfs.fused_sketch(tS, torch.ones(256, 16))
    tfs.fused_sketch_colmajor(tcol, torch.ones(8, 16))
    tfs.fill_block(tS, 8, 256, device="cpu")
    A = torch.ones(256, 16, requires_grad=True)
    with rt.flags(use_fused=True):
        rt.sketch_general(tS, A).sum().backward()
        rt.sketch_general(tcol, torch.ones(8, 16))
        rt.sketch_general(tS, torch.ones(8, 16), op_s="T")
        rt.sketch_general(tcol, torch.ones(16, 256), side="right")
    with rt.flags(use_fused=False, use_kernel_fill=True):
        rt.sketch_general(tS, torch.ones(256, 16))
    assert A.grad is not None
    assert tfs.fused_sketch.launches == 0
    assert tfs.fused_sketch_colmajor.launches == 0
    assert tfs.fill_block.launches == 0


def test_wrappers_raise_off_cpu_and_cuda():
    _, tS = _ops((8, 256))
    with pytest.raises(ValueError, match="no fused sketch kernel"):
        tfs.fused_sketch(tS, torch.ones(256, 16, device="meta"))
    with pytest.raises(ValueError, match="no fill kernel"):
        tfs.fill_block(tS, 8, 256, device="meta")
    _, t2 = _ops((8, 256), rng="philox2x32")
    with pytest.raises(ValueError, match="sketch kernels take"):
        tfs.fused_sketch(t2, torch.ones(256, 16))
    _, tcol = _ops((256, 8))
    with pytest.raises(ValueError, match="no fused sketch kernel"):
        tfs.fused_sketch_colmajor(tcol, torch.ones(8, 16, device="meta"))
    with pytest.raises(ValueError, match="RowMajor-natural"):
        tfs.fused_sketch(tcol, torch.ones(8, 16))
    with pytest.raises(ValueError, match="ColMajor-natural"):
        tfs.fused_sketch_colmajor(tS, torch.ones(256, 16))


def test_supported_matches_jax():
    for shape, major in [((16, 64), "Long"), ((64, 16), "Long"),
                         ((16, 64), "Short"), ((64, 16), "Short"),
                         ((32, 32), "Long")]:
        for family in ("Gaussian", "Uniform"):
            jS, tS = _ops(shape, family, major=major)
            for dt, jdt in [(torch.float32, jnp.float32),
                            (torch.bfloat16, jnp.bfloat16),
                            (torch.float64, jnp.float64)]:
                for op, jop in [(Op.NoTrans, JOp.NoTrans),
                                (Op.Trans, JOp.Trans)]:
                    for blk in [(8, 16, 0, 0), (8, 16, 8, 48), (16, 64, 1, 0),
                                (16, 8, 48, 8)]:
                        assert tfs.fused_sketch_supported(
                            tS.dist, *blk, op, dt) == \
                            jfs.fused_sketch_supported(jS.dist, *blk, jop,
                                                       jdt)
                        assert tfs.fused_sketch_colmajor_supported(
                            tS.dist, *blk, op, dt) == \
                            jfs.fused_sketch_colmajor_supported(
                                jS.dist, *blk, jop, jdt)
