"""BlockedELL and K5 (the BlockedELL SpMM), the port against the JAX
package on the CPU, same numpy-seeded inputs.

Tolerances:
- ``from_ell`` tables, overflow arrays and static fields: equal, element
  for element (both convert on the host with the same numpy code).
- K5's plain version against JAX's Pallas kernel in interpret mode: 1e-5
  of max |want| on data without a repeated (row, column) inside one
  column block: both round B and the values to bf16, so every product is
  exact and only the order of the float32 sums differs. With a repeated
  column, 2^-8 of max |want|: JAX rounds the summed panel value to bf16,
  the port rounds each value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randblas_tpu.ops import ell_spmm as jell
from randblas_tpu.sparse_data import COOMatrix as JCOO, ELLMatrix as JELL
import randblas_tpu_torch as rt
from randblas_tpu_torch.ops import ell_spmm as tell
from randblas_tpu_torch.sparse_data import (COOMatrix as TCOO,
                                            ELLMatrix as TELL)


def _coo(m, k, nnz, seed, unique=True):
    """Random COO triplets; ``unique`` drops repeated (row, col) pairs."""
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, m, nnz), rng.integers(0, k, nnz)
    if unique:
        _, first = np.unique(r * k + c, return_index=True)
        first.sort()
        r, c = r[first], c[first]
    v = rng.standard_normal(len(r)).astype(np.float32)
    return (JCOO.from_arrays(m, k, r, c, v),
            TCOO.from_arrays(m, k, r, c, v, device="cpu"))


def _norm_err(got, want):
    got, want = got.numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


BLOCK_CASES = [
    dict(),                          # bw rounded up to 8
    dict(kb=64),
    dict(bw_cap=2),                  # two-tier: COO overflow
    dict(word_major=4),              # word-major storage order
    dict(word_major=4, bw_cap=1),
]


@pytest.mark.parametrize("kw", BLOCK_CASES, ids=str)
@pytest.mark.parametrize("m,k,nnz", [(300, 1000, 3000), (64, 501, 700),
                                     (2100, 333, 4000)])
def test_from_ell_tables_equal_jax(m, k, nnz, kw):
    jc, tc = _coo(m, k, nnz, seed=m + k, unique=False)
    jb, tb = JELL.from_coo(jc).blocked(**kw), TELL.from_coo(tc).blocked(**kw)
    for name in ("local_cols", "vals", "ovf_rows", "ovf_cols", "ovf_vals"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    for name in ("n_rows", "n_cols", "kb", "bw", "word_major", "b_rows",
                 "n_kblocks", "ovf_nnz"):
        assert getattr(tb, name) == getattr(jb, name), name
    np.testing.assert_array_equal(tb.to_dense().numpy(),
                                  np.asarray(jb.to_dense()))


@pytest.mark.parametrize("kw", BLOCK_CASES, ids=str)
@pytest.mark.parametrize("m,k,n", [(300, 1000, 40), (64, 500, 16),
                                   (513, 1025, 257)])
def test_k5_plain_matches_jax_kernel(m, k, n, kw):
    jc, tc = _coo(m, k, 4 * m, seed=7 * m + n)
    jb, tb = JELL.from_coo(jc).blocked(**kw), TELL.from_coo(tc).blocked(**kw)
    B = np.random.default_rng(n).standard_normal((jb.b_rows, n)).astype(
        np.float32)
    want = jell.blocked_ell_matmul(jb, jnp.asarray(B), alpha=-0.5,
                                   interpret=True)
    got = tell.blocked_ell_matmul(tb, torch.from_numpy(B), alpha=-0.5)
    assert got.dtype == torch.float32
    assert _norm_err(got, want) <= 1e-5


def _edge_coo(case, seed):
    """COO data at the edges of K5's compaction (64-slot chunks of one
    row's slots): rows with no entry, a row whose slots are all full
    (bw = kb), and a row whose entries run across many chunks."""
    rng = np.random.default_rng(seed)
    m, k = 70, 700
    if case == "empty_rows":      # only even rows have entries
        r, c = 2 * rng.integers(0, m // 2, 600), rng.integers(0, k, 600)
    elif case == "full_row":      # row 3 takes every column
        r = np.concatenate([np.full(k, 3), rng.integers(0, m, 300)])
        c = np.concatenate([np.arange(k), rng.integers(0, k, 300)])
    else:                         # row 5: 400 entries over every block
        r = np.concatenate([np.full(400, 5), rng.integers(0, m, 300)])
        c = np.concatenate([rng.choice(k, 400, replace=False),
                            rng.integers(0, k, 300)])
    _, first = np.unique(r * k + c, return_index=True)
    first.sort()
    r, c = r[first], c[first]
    v = rng.standard_normal(len(r)).astype(np.float32)
    return (JCOO.from_arrays(m, k, r, c, v),
            TCOO.from_arrays(m, k, r, c, v, device="cpu"))


@pytest.mark.parametrize("kw", [dict(), dict(word_major=4)], ids=str)
@pytest.mark.parametrize("case", ["empty_rows", "full_row", "long_row"])
def test_k5_plain_matches_jax_at_compaction_edges(case, kw):
    jc, tc = _edge_coo(case, seed=len(case))
    jb, tb = JELL.from_coo(jc).blocked(**kw), TELL.from_coo(tc).blocked(**kw)
    if case == "full_row":
        assert tb.bw == tb.kb       # every slot of row 3 is full
    B = np.random.default_rng(11).standard_normal((jb.b_rows, 40)).astype(
        np.float32)
    want = jell.blocked_ell_matmul(jb, jnp.asarray(B), interpret=True)
    got = tell.blocked_ell_matmul(tb, torch.from_numpy(B))
    assert _norm_err(got, want) <= 1e-5
    if case == "empty_rows":
        assert not got[1::2].any()


def test_k5_repeated_column_within_bf16():
    jc, tc = _coo(200, 700, 3000, seed=3, unique=False)
    jb, tb = JELL.from_coo(jc).blocked(), TELL.from_coo(tc).blocked()
    B = np.random.default_rng(4).standard_normal((700, 64)).astype(
        np.float32)
    want = jell.blocked_ell_matmul(jb, jnp.asarray(B), interpret=True)
    got = tell.blocked_ell_matmul(tb, torch.from_numpy(B))
    assert _norm_err(got, want) <= 2.0 ** -8


def test_k5_duplicates_accumulate():
    rows = np.array([0, 0, 1, 0], dtype=np.int32)
    cols = np.array([3, 3, 1, 2], dtype=np.int32)
    vals = np.array([1.0, 2.0, 5.0, -1.0], dtype=np.float32)
    coo = TCOO.from_arrays(2, 4, rows, cols, vals, device="cpu")
    got = tell.blocked_ell_matmul(TELL.from_coo(coo).blocked(), torch.eye(4))
    want = torch.zeros((2, 4))
    want[0, 3], want[0, 2], want[1, 1] = 3.0, -1.0, 5.0
    assert torch.equal(got, want)


@pytest.mark.parametrize("bw_cap", [None, 1])
def test_natural_order_equals_storage_order(bw_cap):
    """A word-major table reads natural-order B through the map; the
    result is the storage-order product's, bit for bit."""
    _, tc = _coo(150, 1001, 2000, seed=5)
    tb = TELL.from_coo(tc).blocked(word_major=4, bw_cap=bw_cap)
    B = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1001, 24)).astype(np.float32))
    storage = tell.to_word_major_rows(B, 4, 1001)
    assert storage.shape[0] == tb.b_rows == 1004
    got = tell.blocked_ell_matmul(tb, B, alpha=3.0, b_order="natural")
    want = tell.blocked_ell_matmul(tb, storage, alpha=3.0)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="operand height"):
        tell.blocked_ell_matmul(tb, B)


def test_to_word_major_rows_matches_jax():
    B = np.arange(30 * 3, dtype=np.float32).reshape(30, 3)
    np.testing.assert_array_equal(
        tell.to_word_major_rows(torch.from_numpy(B), 4, 30).numpy(),
        np.asarray(jell.to_word_major_rows(jnp.asarray(B), 4, 30)))


def test_blocked_to_coo_and_dense():
    _, tc = _coo(40, 300, 200, seed=8)
    tb = TELL.from_coo(tc).blocked(word_major=4)
    np.testing.assert_array_equal(tb.to_dense().numpy(),
                                  tc.to_dense().numpy())
    np.testing.assert_array_equal(tb.to_coo().to_dense().numpy(),
                                  tc.to_dense().numpy())


def test_k5_reference_is_the_plain_version_and_nothing_launches():
    tell.blocked_ell_matmul.launches = 0
    _, tc = _coo(100, 400, 500, seed=9)
    tb = TELL.from_coo(tc).blocked()
    B = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (400, 33)).astype(np.float32))
    assert torch.equal(tell.blocked_ell_matmul(tb, B, 0.25),
                       tell.blocked_ell_reference(tb, B, 0.25))
    assert tell.blocked_ell_matmul.launches == 0


def test_blocked_ell_from_jax_fields():
    jc, _ = _coo(120, 900, 800, seed=10, unique=False)
    jb = JELL.from_coo(jc).blocked(bw_cap=1, word_major=4)
    tb = rt.blocked_ell_from_jax(
        np.asarray(jb.local_cols), np.asarray(jb.vals), jb.n_rows, jb.n_cols,
        jb.kb, jb.bw, np.asarray(jb.ovf_rows), np.asarray(jb.ovf_cols),
        np.asarray(jb.ovf_vals), jb.word_major, device="cpu")
    np.testing.assert_array_equal(tb.to_dense().numpy(),
                                  np.asarray(jb.to_dense()))
    assert tb.ovf_nnz == jb.ovf_nnz > 0
