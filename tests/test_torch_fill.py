"""The fill kernel K3 as the route of every lazy Gaussian or Uniform fill of
a 4x32 generator on the card (randblas_tpu_torch.dense.fill_dense_submat),
checked on the CPU through K3's plain version (the wrappers get CPU
tensors, and fills are asked for with device="cpu"):

- K3 with the staged fill's transform ("boxmul") makes the plain fill's
  values bit for bit, in both layouts, at unaligned offsets, in float32,
  float64 and bf16 (the route casts and scales as the plain fill does);
- it matches the JAX package's fill_dense_submat: Uniform values exactly,
  Gaussian values at rtol/atol 2e-3 (the cross-platform log/sin/cos
  tolerance of tests/test_torch_dense.py); with the TPU kernel's transform
  ("boxmul_i32") it matches pallas_fill_block(..., interpret=True), at the
  limits of tests/test_torch_fused.py;
- the math orientation of a ColMajor-natural block is its natural block
  (the block of the transposed, RowMajor-natural operator) transposed;
- the route takes K3 for a CUDA device and a 4x32 generator only;
- sketch_sparse, the staged route and the square operator's backward pass
  ask for the fill once per call.
"""

import math

import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu.ops import fused_sketch as jfs
import randblas_tpu_torch as rt
from randblas_tpu_torch import dense as tdense
from randblas_tpu_torch import sparse_data as tsd
from randblas_tpu_torch.ops import fused_sketch as tfs

GAUSS_TOL = dict(rtol=2e-3, atol=2e-3)

# (operator shape, family, major, rng, rows, cols, ro_s, co_s): RowMajor-
# and ColMajor-natural, aligned and unaligned offsets, both families
CASES = [
    ((40, 300), "Gaussian", "Long", "philox4x32", 33, 150, 5, 7),
    ((40, 300), "Uniform", "Long", "philox4x32", 40, 296, 0, 4),
    ((300, 40), "Gaussian", "Long", "philox4x32", 150, 33, 7, 5),
    ((300, 41), "Uniform", "Long", "threefry4x32", 297, 38, 2, 3),
    ((40, 300), "Gaussian", "Short", "threefry4x32", 17, 201, 3, 9),
    ((300, 40), "Uniform", "Short", "philox4x32", 299, 39, 1, 1),
    ((64, 64), "Gaussian", "Long", "philox4x32", 61, 62, 3, 2),
]
DTYPES = [torch.float32, torch.float64, torch.bfloat16]


def _ops(shape, family, major, rng, key=6):
    jS = rb.DenseSkOp(rb.DenseDist(*shape, rb.DenseDistName[family],
                                   rb.MajorAxis[major]),
                      rb.RNGState.from_key(key, rng))
    tS = rt.DenseSkOp(rt.DenseDist(*shape, rt.DenseDistName[family],
                                   rt.MajorAxis[major]),
                      rt.RNGState.from_key(key, rng))
    return jS, tS


def _card_route(dist, rng, device):
    """The route as it is on a CUDA device, for a CPU tensor."""
    return tfs.fill_block_supported(dist, torch.float32, rng)


@pytest.mark.parametrize("shape,family,major,rng,rows,cols,ro_s,co_s", CASES)
def test_staged_transform_is_the_plain_fill(shape, family, major, rng, rows,
                                            cols, ro_s, co_s):
    _, tS = _ops(shape, family, major, rng)
    got = tfs.fill_block(tS, rows, cols, ro_s, co_s, device="cpu",
                         transform="boxmul")
    want = rt.fill_dense_submat(tS.dist, tS.seed_state, rows, cols, ro_s,
                                co_s, device="cpu")
    assert got.is_contiguous() and got.dtype == torch.float32
    assert torch.equal(got, want)
    unscaled = tfs._fill(tS.dist, tS.seed_state, rows, cols, ro_s, co_s,
                         "cpu", "boxmul", scale=False)
    if family == "Uniform":
        assert not torch.equal(unscaled, got)
        assert torch.equal(unscaled * torch.tensor(math.sqrt(3.0)), got)
    else:
        assert torch.equal(unscaled, got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,family,major,rng,rows,cols,ro_s,co_s", CASES)
def test_route_through_k3_is_bitwise_the_plain_fill(
        monkeypatch, dtype, shape, family, major, rng, rows, cols, ro_s,
        co_s):
    _, tS = _ops(shape, family, major, rng)
    args = (tS.dist, tS.seed_state, rows, cols, ro_s, co_s, dtype, "cpu")
    want = tdense.fill_dense_submat_reference(*args)
    assert torch.equal(rt.fill_dense_submat(*args), want)
    calls = []
    real = tfs._fill

    def spy(*a, **kw):
        calls.append(a[7])  # the transform
        return real(*a, **kw)

    monkeypatch.setattr(tfs, "_fill", spy)
    monkeypatch.setattr(tdense, "_kernel_fill_route", _card_route)
    got = rt.fill_dense_submat(*args)
    assert calls == ["boxmul"]
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,family,major,rng,rows,cols,ro_s,co_s", CASES)
def test_staged_transform_matches_jax_fill(shape, family, major, rng, rows,
                                           cols, ro_s, co_s):
    jS, tS = _ops(shape, family, major, rng)
    want = np.asarray(rb.fill_dense_submat(jS.dist, jS.seed_state, rows,
                                           cols, ro_s, co_s))
    got = tfs.fill_block(tS, rows, cols, ro_s, co_s, device="cpu",
                         transform="boxmul").numpy()
    assert got.shape == want.shape
    if family == "Uniform":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **GAUSS_TOL)


@pytest.mark.parametrize("shape,family,major,rng,rows,cols,ro_s,co_s", CASES)
def test_tpu_transform_matches_jax_interpret(shape, family, major, rng, rows,
                                             cols, ro_s, co_s):
    jS, tS = _ops(shape, family, major, rng)
    want = np.asarray(jfs.pallas_fill_block(jS, rows, cols, ro_s, co_s,
                                            interpret=True))
    got = tfs.fill_block(tS, rows, cols, ro_s, co_s, device="cpu")
    assert tuple(got.shape) == want.shape and got.is_contiguous()
    if family == "Uniform":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, **GAUSS_TOL)
    ref = tfs.fill_block_reference(tS, rows, cols, ro_s, co_s, device="cpu")
    assert torch.equal(got, ref)


@pytest.mark.parametrize("transform", tfs.FILL_TRANSFORMS)
@pytest.mark.parametrize("shape,family,major,rng,rows,cols,ro_s,co_s",
                         [c for c in CASES if c[0][0] != c[0][1]])
def test_math_orientation_is_the_natural_block_transposed(
        transform, shape, family, major, rng, rows, cols, ro_s, co_s):
    # the transposed operator (same seed; a square one is its own) is
    # natural in the other layout: its block at the swapped offsets is this
    # block's natural one
    _, tS = _ops(shape, family, major, rng)
    _, tS_t = _ops(shape[::-1], family, major, rng)
    assert rt.dist_to_layout(tS_t.dist) != rt.dist_to_layout(tS.dist)
    math_blk = tfs.fill_block(tS, rows, cols, ro_s, co_s, device="cpu",
                              transform=transform)
    other = tfs.fill_block(tS_t, cols, rows, co_s, ro_s, device="cpu",
                           transform=transform)
    assert tuple(math_blk.shape) == (rows, cols) and math_blk.is_contiguous()
    assert torch.equal(math_blk, other.T)


def test_kernel_fill_route():
    cuda, cuda1, cpu = (torch.device("cuda"), torch.device("cuda:1"),
                        torch.device("cpu"))
    for family in ("Gaussian", "Uniform"):
        for major in ("Long", "Short"):
            dist = rt.DenseDist(16, 64, rt.DenseDistName[family],
                                rt.MajorAxis[major])
            for rng in ("philox4x32", "threefry4x32"):
                assert tdense._kernel_fill_route(dist, rng, cuda)
                assert tdense._kernel_fill_route(dist, rng, cuda1)
                assert tdense._kernel_fill_route(dist, rng, "cuda")
                assert not tdense._kernel_fill_route(dist, rng, cpu)
            for rng in ("philox2x32", "threefry2x32"):
                assert not tdense._kernel_fill_route(dist, rng, cuda)
                assert not tdense._kernel_fill_route(dist, rng, cpu)
    blackbox = rt.DenseDist(4, 5, rt.DenseDistName.BlackBox)
    assert not tdense._kernel_fill_route(blackbox, "philox4x32", cuda)


@pytest.mark.parametrize("rng", ["philox2x32", "threefry2x32"])
def test_2x32_generators_keep_the_plain_fill(monkeypatch, rng):
    _, tS = _ops((40, 300), "Gaussian", "Long", rng)
    with pytest.raises(ValueError, match="sketch kernels take"):
        tfs.fill_block(tS, 20, 100, device="cpu")
    monkeypatch.setattr(tdense, "_kernel_fill_route", _card_route)
    monkeypatch.setattr(tfs, "_fill", None)  # K3 is never asked
    got = rt.fill_dense_submat(tS.dist, tS.seed_state, 20, 100, 3, 5,
                               device="cpu")
    want = tdense.fill_dense_submat_reference(tS.dist, tS.seed_state, 20,
                                              100, 3, 5, device="cpu")
    assert torch.equal(got, want)


def test_fill_block_checks_its_arguments():
    _, tS = _ops((40, 300), "Gaussian", "Long", "philox4x32")
    with pytest.raises(ValueError, match="transforms are"):
        tfs.fill_block(tS, 8, 8, device="cpu", transform="boxmul_fast")
    with pytest.raises(ValueError, match="out of bounds"):
        tfs.fill_block(tS, 8, 300, 0, 1, device="cpu")
    with pytest.raises(ValueError, match="no fill kernel"):
        tfs.fill_block(tS, 8, 8, device="meta", transform="boxmul")


def _sparse_data(rows, cols, seed):
    rng = np.random.default_rng(seed)
    nnz = rows * cols // 8
    return tsd.COOMatrix.from_arrays(
        rows, cols, rng.integers(0, rows, nnz), rng.integers(0, cols, nnz),
        rng.standard_normal(nnz).astype(np.float32), device="cpu")


def _calls_and_results(monkeypatch, runs):
    """Each run's fill requests (their transforms) with the route as on the
    card, its results as on the CPU, and its results with the route as on
    the card."""
    on_cpu = [run() for run in runs]
    real = tfs._fill
    calls = []

    def spy(dist, state, rows_s, cols_s, ro_s, co_s, device, transform,
            scale):
        calls[-1].append(transform)
        return real(dist, state, rows_s, cols_s, ro_s, co_s, device,
                    transform, scale)

    monkeypatch.setattr(tfs, "_fill", spy)
    monkeypatch.setattr(tdense, "_kernel_fill_route", _card_route)
    routed = []
    for run in runs:
        calls.append([])
        routed.append(run())
    return calls, on_cpu, routed


def test_sketch_paths_ask_for_the_fill_once(monkeypatch):
    coo = _sparse_data(200, 100, seed=1)
    bell = tsd.ELLMatrix.from_coo(coo).blocked(word_major=4)
    S_f = rt.DenseSkOp(rt.DenseDist(32, 200), rt.RNGState.from_key(5))
    S_g = rt.DenseSkOp(rt.DenseDist(100, 32), rt.RNGState.from_key(6))
    S_u = rt.DenseSkOp(rt.DenseDist(24, 300, rt.DenseDistName.Uniform),
                       rt.RNGState.from_key(7))
    A = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (300, 20)).astype(np.float32))

    def staged(**flags):
        def run():
            with rt.flags(use_fused=False, **flags):
                return rt.sketch_general(S_u, A[:290], ro_s=3, co_s=7, d=20)
        return run

    def right_staged():
        with rt.flags(use_fused=False):
            return rt.sketch_general(S_g, A[:100, :17].T.contiguous(),
                                     side="right")

    runs = [lambda: rt.sketch_sparse(S_f, coo, side="left"),       # (f)
            lambda: rt.sketch_sparse(S_g, bell, side="right"),     # (g)
            lambda: rt.sketch_sparse(S_g, coo, side="right"),
            staged(), staged(use_kernel_fill=True), right_staged]
    calls, plain, routed = _calls_and_results(monkeypatch, runs)
    tpu, staged_fill = "boxmul_i32", "boxmul"
    assert calls == [[staged_fill], [staged_fill], [staged_fill],
                     [staged_fill], [tpu], [staged_fill]]
    for got, want in zip(routed, plain):
        assert torch.equal(got, want)


def test_square_backward_asks_for_the_fill_once(monkeypatch):
    S = rt.DenseSkOp(rt.DenseDist(64, 64), rt.RNGState.from_key(9))
    A0 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, 8)).astype(np.float32))
    G = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (64, 8)).astype(np.float32))

    def backward():
        A = A0.clone().requires_grad_(True)
        with rt.flags(use_fused=True):
            rt.sketch_general(S, A).backward(G)
        return A.grad

    calls, plain, routed = _calls_and_results(monkeypatch, [backward])
    assert calls == [["boxmul"]]
    assert torch.equal(routed[0], plain[0])
