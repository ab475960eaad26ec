"""The reference's frozen generators held against the port's plain
versions at tiny sizes (the test may import the port; the reference
never does)."""

import pytest
import torch

import randblas_tpu_torch as rt
from randblas_tpu_torch.rng import philox as port_philox
from portbench.reference import fisher_yates, gaussian, philox, sketch

CPU = torch.device("cpu")


def test_philox_words_bitwise():
    g = torch.Generator().manual_seed(3)
    ctr = torch.randint(0, 2 ** 32, (257, 4), generator=g, dtype=torch.int64)
    key = (0x9E3779B9, 0xDEADBEEF)
    want = port_philox.philox4x32(ctr, torch.tensor(key))
    got = philox.philox4x32(*ctr.unbind(-1), *key)
    assert torch.equal(torch.stack(got, -1), want)


def test_counter_carries_across_words():
    off = torch.tensor([0, 1, 2 ** 32 - 1, 2 ** 32, 2 ** 62])
    words = philox.counter_words((0xFFFFFFFF, 0xFFFFFFFF, 7, 0), off)
    total = [sum(int(w[i]) << (32 * j) for j, w in enumerate(words))
             for i in range(len(off))]
    base = 0xFFFFFFFF | (0xFFFFFFFF << 32) | (7 << 64)
    assert total == [base + int(o) for o in off]


@pytest.mark.parametrize("key,d,m,c0,cols", [
    (0, 8, 64, 0, 64), (12345, 6, 30, 3, 17), (2 ** 32 - 1, 5, 1001, 997, 4)])
def test_dense_gaussian_block(key, d, m, c0, cols):
    dist = rt.DenseDist(d, m)
    want = rt.dense.fill_dense_submat_reference(
        dist, rt.RNGState.from_key(key), d, cols, 0, c0, device=CPU)
    got = gaussian.dense_block(key, d, m, c0, cols, CPU)
    assert got.dtype == torch.float64 and got.shape == (d, cols)
    torch.testing.assert_close(got.float(), want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("key,d,k,m,j0", [
    (1, 16, 8, 200, 0), (77, 9, 9, 50, 13), (2 ** 31 + 3, 1024, 8, 64, 0)])
def test_saso_columns_bitwise(key, d, k, m, j0):
    idx, sgn = rt.repeated_fisher_yates(rt.RNGState.from_key(key), k, d,
                                        j0 + m, device=CPU)
    rows, signs = fisher_yates.saso_columns(key, d, k, j0, m, CPU)
    assert torch.equal(rows, idx[j0:].long())
    assert torch.equal(signs, sgn[j0:].double())
    assert all(len(set(r.tolist())) == k for r in rows)


@pytest.mark.parametrize("kind", ["dense", "saso"])
def test_exact_product_is_the_operator_times_a(kind, monkeypatch):
    monkeypatch.setattr(sketch, "BLOCK", 96)       # several blocks
    d, m, n, key = 16, 512, 8, 4242
    a = torch.randn(m, n, dtype=torch.float64)
    if kind == "dense":
        op = {"kind": "dense", "d": d, "m": m}
        S = rt.DenseSkOp(rt.DenseDist(d, m), rt.RNGState.from_key(key))
        dense = S.materialize(CPU).double()
    else:
        op = {"kind": "saso", "d": d, "m": m, "vec_nnz": 4}
        S = rt.SparseSkOp(rt.SparseDist(d, m, 4), rt.RNGState.from_key(key))
        dense = S.materialize(CPU).double()
    # the port's values are float32 Gaussians, the reference's float64
    tol = 2e-5 if kind == "dense" else 1e-12
    torch.testing.assert_close(sketch.exact(op, key, a), dense @ a,
                               rtol=tol, atol=tol)
    half = m // 2
    torch.testing.assert_close(sketch.exact(op, key, a[half:], half),
                               dense[:, half:] @ a[half:], rtol=tol, atol=tol)
