"""The port's H100 dispatch gates, on the CPU: each "auto" decision on both
sides of its swept boundary (gate_sweep.py's grids, PERF.md "H100 gates"),
the dispatchers following the gates when a CPU tensor stands in for a CUDA
one (``base.on_card`` patched; the kernel wrappers spied, which run their
plain versions here), CPU tensors keeping their routes under "auto", and
True/False still forcing.

Products are compared with float32 references at 1e-5 of max |want| (sums
in another order), or bit for bit where the same ops run.
"""

import importlib

import numpy as np
import pytest
import torch

import randblas_tpu_torch as rt
from randblas_tpu_torch import base, skge
from randblas_tpu_torch.ops import coo_apply, ell_spmm, hadamard
from randblas_tpu_torch.ops import fused_sketch as fs
from randblas_tpu_torch.ops import saso_sketch as saso
from randblas_tpu_torch.sparse_data import ELLMatrix

# the module (the package's ``spmm`` is the function of that name)
spmm = importlib.import_module("randblas_tpu_torch.sparse_data.spmm")

F32, BF16 = torch.float32, torch.bfloat16
TOL = 1e-5


def _data(shape, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


def _spy(monkeypatch, module, name):
    """Replace module.name by a wrapper that counts its calls in
    ``.launches`` (the CPU stand-in for a kernel launch)."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        spy.launches += 1
        return real(*args, **kwargs)
    spy.launches = 0
    monkeypatch.setattr(module, name, spy)
    return spy


@pytest.fixture
def on_card(monkeypatch):
    """CPU tensors count as lying on the card for every gate."""
    monkeypatch.setattr(base, "on_card", lambda t: True)


@pytest.fixture(autouse=True)
def _routes():
    skge.route_counts.clear()
    yield
    skge.route_counts.clear()


# ------------------------------------------------ K1 / K2 (fused_profitable)

@pytest.mark.parametrize("rows,contraction,n,dtype,kernel", [
    (1024, 65536, 4096, F32, True),    # the main path (G1)
    (65536, 1024, 4096, F32, True),    # path (b)'s adjoint, K2 (G3)
    (64, 32768, 2048, F32, True),      # G3: size ratio 1/16
    (8192, 32768, 2048, F32, True),    # G3: size ratio 8
    (1024, 65536, 4096, BF16, False),  # G1B: bf16 data
    (65536, 4096, 4096, BF16, False),  # G2B
    (64, 8192, 2048, F32, False),      # G1N: 2^31 operations
    (64, 65536, 2048, F32, True),      # G1N: past them
    (128, 2048, 4096, F32, False),     # G1: 2^31
    (128, 4096, 4096, F32, True),      # G1
    (2048, 256, 2048, F32, False),     # G2N: 2^31
    (2048, 1024, 2048, F32, True),     # G2N
    (16384, 65536, 64, F32, False),    # G1N: n = 64
    (65536, 4096, 64, F32, False),     # G2N: n = 64
    (8192, 65536, 256, F32, False),    # G1N: a cluster of 1
    (16384, 65536, 256, F32, True),
    (32768, 4096, 256, F32, True),     # G2N
    (2048, 65536, 512, F32, False),    # G1N: a cluster of 2
    (8192, 8192, 512, F32, True),
    (1024, 32768, 1024, F32, False),   # G3N: a cluster of 4
    (2048, 65536, 1024, F32, True),    # G1N
    (1024, 32768, 1, F32, False),      # G3N: a vector
])
def test_fused_gate(rows, contraction, n, dtype, kernel):
    assert skge.fused_profitable(rows, contraction, n, dtype) is kernel


def test_fused_gate_follows_the_launch_plan_clusters():
    """The narrow rule is keyed by the plan's cluster: 1, 2 and 4 CTAs up
    to 4 column tiles, 8 past them (no narrow rule)."""
    clusters = {n: fs.launch_plan(4096, 65536, n).cluster
                for n in (65, 256, 257, 512, 513, 1024, 1025, 2048)}
    assert clusters == {65: 1, 256: 1, 257: 2, 512: 2, 513: 4, 1024: 4,
                        1025: 8, 2048: 8}
    assert set(skge.FUSED_NARROW_ROWS) == {1, 2, 4}


def _dense_call(route, key=5):
    """(S, A, kwargs, (rows, contraction, n) of the kernel call) for each
    fused route, small shapes."""
    if route == "left_fused":           # wide+Long: RowMajor, K1
        S = rt.DenseSkOp(rt.DenseDist(24, 96), rt.RNGState.from_key(key))
        return S, _data((96, 40), 1), {}, (24, 96, 40)
    if route == "left_colmajor_fused":  # tall+Long: ColMajor, K2
        S = rt.DenseSkOp(rt.DenseDist(96, 24), rt.RNGState.from_key(key))
        return S, _data((24, 40), 2), {}, (96, 24, 40)
    if route == "left_trans_fused":     # S^T Y: K1 on the transposed dist
        S = rt.DenseSkOp(rt.DenseDist(96, 24), rt.RNGState.from_key(key))
        return S, _data((96, 40), 3), {"op_s": "T"}, (24, 96, 40)
    if route == "right_fused":          # A S: K1 on S^T, A^T's 40 columns
        S = rt.DenseSkOp(rt.DenseDist(96, 24), rt.RNGState.from_key(key))
        return S, _data((40, 96), 4), {"side": "right"}, (24, 96, 40)
    raise ValueError(route)


ROUTES = ("left_fused", "left_colmajor_fused", "left_trans_fused",
          "right_fused")
STAGED = {"left_fused": "left_staged", "left_colmajor_fused": "left_staged",
          "left_trans_fused": "left_staged", "right_fused": "right_staged"}
KERNEL = {"left_fused": "K1", "left_colmajor_fused": "K2",
          "left_trans_fused": "K1", "right_fused": "K1"}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("take", [True, False])
def test_fused_dispatch_follows_the_gate(monkeypatch, on_card, route, take):
    """Under "auto" on the card each fused route asks ``fused_profitable``
    with its kernel call's (rows, contraction, n, dtype) and takes the
    kernel (spied: its plain version here) or the staged route as told."""
    asked = []

    def gate(rows, contraction, n, dtype):
        asked.append((rows, contraction, n, dtype))
        return take
    monkeypatch.setattr(skge, "fused_profitable", gate)
    spies = {"K1": _spy(monkeypatch, fs, "fused_sketch"),
             "K2": _spy(monkeypatch, fs, "fused_sketch_colmajor")}
    S, A, kw, call = _dense_call(route)
    got = rt.sketch_general(S, A, **kw)
    assert asked == [call + (F32,)]
    want_route = route if take else STAGED[route]
    assert dict(skge.route_counts) == {want_route: 1}
    assert {k: s.launches for k, s in spies.items()} == {
        k: int(take and k == KERNEL[route]) for k in spies}
    with rt.flags(use_fused=False):
        want = rt.sketch_general(S, A, **kw)
    # the kernels' plain versions round the operands to bf16
    assert _rel(got, want) <= (4e-3 if take else 0.0)


@pytest.mark.parametrize("route", ROUTES)
def test_fused_forced_ignores_the_gate(monkeypatch, route):
    """use_fused=True takes the kernel route on CPU tensors whatever the
    gate says; False takes the staged route even where the gate would take
    the kernel on the card."""
    monkeypatch.setattr(skge, "fused_profitable", lambda *a: False)
    S, A, kw, _ = _dense_call(route)
    with rt.flags(use_fused=True):
        rt.sketch_general(S, A, **kw)
    assert dict(skge.route_counts) == {route: 1}
    skge.route_counts.clear()
    monkeypatch.setattr(skge, "fused_profitable", lambda *a: True)
    monkeypatch.setattr(base, "on_card", lambda t: True)
    with rt.flags(use_fused=False):
        rt.sketch_general(S, A, **kw)
    assert dict(skge.route_counts) == {STAGED[route]: 1}


@pytest.mark.parametrize("route", ROUTES)
def test_cpu_tensors_keep_the_staged_routes(monkeypatch, route):
    """On CPU tensors "auto" takes the staged routes, as before the gates:
    the gate is not even asked."""
    def gate(*args):
        raise AssertionError("the gate was asked on a CPU tensor")
    monkeypatch.setattr(skge, "fused_profitable", gate)
    S, A, kw, _ = _dense_call(route)
    rt.sketch_general(S, A, **kw)
    assert dict(skge.route_counts) == {STAGED[route]: 1}


# ---------------------------------------------------- K4 (saso_profitable)

@pytest.mark.parametrize("d,m,n,kernel", [
    (1024, 65536, 2048, True),     # config 3 (G4)
    (4096, 262144, 16, False),     # G4: the one losing corner
    (4096, 262144, 4, False),      # G4N
    (4096, 262144, 1, False),      # G4N
    (4096, 262144, 128, True),     # G4
    (4096, 65536, 1, True),        # G4N: d m = 2^28
    (1024, 262144, 1, True),       # G4N: d m = 2^28
    (128, 1024, 16, True),         # G4
    (4096, 131072, 1, False),      # (j)'s b: d m = 2^29 at n = 1
])
def test_saso_gate(d, m, n, kernel):
    assert skge.saso_profitable(d, m, n) is kernel


def _saso(d=32, m=256, k=4, key=7):
    return rt.SparseSkOp(rt.SparseDist(d, m, k, rt.MajorAxis.Short),
                         rt.RNGState.from_key(key)).filled("cpu")


@pytest.mark.parametrize("take", [True, False])
@pytest.mark.parametrize("side", ["left", "right"])
def test_saso_dispatch_follows_the_gate(monkeypatch, on_card, take, side):
    """The wide SASO (left) and the transposed tall one (right) ask the
    gate with (d, m, n) and take K4 or the fixed-nnz route as told."""
    asked = []

    def gate(d, m, n):
        asked.append((d, m, n))
        return take
    monkeypatch.setattr(skge, "saso_profitable", gate)
    k4 = _spy(monkeypatch, saso, "saso_sketch")
    if side == "left":
        S, A = _saso(), _data((256, 9), 8)
        got = rt.sketch_general(S, A)
        want = S.materialize("cpu") @ A
    else:
        S = rt.SparseSkOp(rt.SparseDist(256, 32, 4, rt.MajorAxis.Short),
                          rt.RNGState.from_key(9)).filled("cpu")
        A = _data((9, 256), 10)
        got = rt.sketch_general(S, A, side="right")
        want = A @ S.materialize("cpu")
    assert asked == [(32, 256, 9)]
    assert dict(skge.route_counts) == {
        "sparse_saso_kernel" if take else "sparse_fixed_nnz": 1}
    assert k4.launches == int(take)
    # K4's plain version rounds A to bf16
    assert _rel(got, want) <= (4e-3 if take else TOL)


def test_saso_cpu_and_forced(monkeypatch):
    """CPU tensors keep the fixed-nnz route under "auto" (the gate is not
    asked); True takes K4 whatever the gate says; False never, even on the
    card where the gate says yes."""
    def gate(*args):
        raise AssertionError("the gate was asked on a CPU tensor")
    monkeypatch.setattr(skge, "saso_profitable", gate)
    S, A = _saso(), _data((256, 5), 11)
    rt.sketch_general(S, A)
    assert dict(skge.route_counts) == {"sparse_fixed_nnz": 1}
    skge.route_counts.clear()
    monkeypatch.setattr(skge, "saso_profitable", lambda *a: False)
    with rt.flags(use_saso_kernel=True):
        rt.sketch_general(S, A)
    assert dict(skge.route_counts) == {"sparse_saso_kernel": 1}
    skge.route_counts.clear()
    monkeypatch.setattr(skge, "saso_profitable", lambda *a: True)
    monkeypatch.setattr(base, "on_card", lambda t: True)
    with rt.flags(use_saso_kernel=False):
        rt.sketch_general(S, A)
    assert dict(skge.route_counts) == {"sparse_fixed_nnz": 1}


@pytest.mark.parametrize("take", [True, False])
def test_distributed_saso_shard_shares_the_gate(monkeypatch, on_card, take):
    """The distributed layer's SASO shard asks the same gate with the
    shard's (d_per, m_per, n)."""
    from randblas_tpu_torch.parallel import distributed as dist
    asked = []

    def gate(d, m, n):
        asked.append((d, m, n))
        return take
    monkeypatch.setattr(skge, "saso_profitable", gate)
    k4 = _spy(monkeypatch, saso, "saso_sketch")
    S, A = _saso(), _data((256, 6), 12)
    parts = [dist.sparse_shard(S, A[c * 128:(c + 1) * 128], (0, c), (1, 2))
             for c in range(2)]
    assert asked == [(32, 128, 6)] * 2
    assert k4.launches == 2 * int(take)
    assert _rel(parts[0] + parts[1], S.materialize("cpu") @ A) <= (
        4e-3 if take else TOL)


@pytest.mark.parametrize("layout", ["left", "right", "cols"])
@pytest.mark.parametrize("take", [True, False])
def test_distributed_dense_shards_share_the_gate(monkeypatch, on_card,
                                                 layout, take):
    """Each dense shard asks ``fused_profitable`` with its kernel call's
    (rows, contraction, n, dtype) and takes K1 (spied) or the staged tile
    as told, so a 1 x 1 mesh routes as the single-device call does (a
    32 x 1024 sketch of 64 columns took K1 on a 1 x 1 NCCL mesh and the
    staged route alone on an H100, 0.26 apart in a sum of 1024 terms)."""
    from randblas_tpu_torch.parallel import distributed as dist
    asked = []

    def gate(rows, contraction, n, dtype):
        asked.append((rows, contraction, n, dtype))
        return take
    monkeypatch.setattr(skge, "fused_profitable", gate)
    k1 = _spy(monkeypatch, fs, "fused_sketch")
    if layout == "right":                  # A (40, 96) @ S (96, 24)
        S = rt.DenseSkOp(rt.DenseDist(96, 24), rt.RNGState.from_key(7))
        A = _data((40, 96), 13)
        got = dist.right_shard(S, A, (0, 0), (1, 1))
        want, call = A @ S.materialize("cpu"), (24, 96, 40)
    else:                                  # S (24, 96) @ A (96, 40)
        S = rt.DenseSkOp(rt.DenseDist(24, 96), rt.RNGState.from_key(7))
        A = _data((96, 40), 13)
        got = (dist.left_shard(S, A, (0, 0), (1, 1)) if layout == "left"
               else dist.cols_shard(S, A, (0, 0), (1, 1), 40))
        want, call = S.materialize("cpu") @ A, (24, 96, 40)
    assert asked == [call + (F32,)]
    assert k1.launches == int(take)
    # K1's plain version rounds the operands to bf16
    assert _rel(got, want) <= (4e-3 if take else TOL)


# ---------------------------------- K5 (blocked_ell_profitable, slot_width)

@pytest.mark.parametrize("n,bw,kernel", [
    (512, 8, True),       # config 4b (G5)
    (1, 8, True),         # G5: a vector, 2^12 to 1e6 entries
    (1, 16, True),
    (1, 32, False),       # G5: bw 32, a vector
    (8, 32, True),
    (2048, 64, False),    # G5: bw 64
    (2048, 136, False),   # the full row: bw 136
    (32, 136, False),
])
def test_blocked_ell_gate(n, bw, kernel):
    assert spmm.blocked_ell_profitable(n, bw) is kernel


@pytest.mark.parametrize("n,bw,slots,kernel", [
    (512, 8, 20000 * 79 * 8, True),          # config 4b: 1.3e7 slots
    (8, 8, 200000 * 1172 * 8, False),        # (A2s): 1.9e9 slots
    (8, 16, spmm.BLOCKED_ELL_MAX_SLOTS, True),
    (8, 16, spmm.BLOCKED_ELL_MAX_SLOTS + 1, False),
])
def test_blocked_ell_gate_caps_the_tables(n, bw, slots, kernel):
    assert spmm.blocked_ell_profitable(n, bw, slots) is kernel


def test_large_tables_declined_without_conversion(monkeypatch, on_card):
    """Past BLOCKED_ELL_MAX_SLOTS "auto" declines before building any
    table (phase 14's (A2s) spent 53 s and 16.8 GiB converting 3e7 entries
    into 1.9e9 slots): the product takes the COO route."""
    A = _coo()                              # 200 x 1000: 200 * 8 * 8 slots
    B = _data((1000, 64), 15)
    monkeypatch.setattr(spmm, "BLOCKED_ELL_MAX_SLOTS", 200 * 8 * 8 - 1)
    _no_conversion(monkeypatch)
    k5 = _spy(monkeypatch, ell_spmm, "blocked_ell_matmul")
    assert spmm._blocked_ell_or_none(A, B) is None
    got = rt.left_spmm(A, B)
    assert k5.launches == 0
    assert _rel(got, A.to_dense() @ B) <= TOL
    monkeypatch.undo()
    monkeypatch.setattr(base, "on_card", lambda t: True)
    monkeypatch.setattr(spmm, "BLOCKED_ELL_MAX_SLOTS", 200 * 8 * 8)
    assert spmm._blocked_ell_or_none(_coo(), B) is not None


def _coo(n_rows=200, n_cols=1000, nnz=600, seed=13, heavy=False,
         zeros=0, run=0):
    """Random COO data; ``heavy`` adds a full row 7 (bw 136), ``run`` a
    run of that many entries in row 3's first column block."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n_rows, nnz)
    c = rng.integers(0, n_cols, nnz)
    if heavy:
        r = np.concatenate([r, np.full(n_cols, 7)])
        c = np.concatenate([c, np.arange(n_cols)])
    if run:
        r = np.concatenate([r, np.full(run, 3)])
        c = np.concatenate([c, np.arange(run)])
    v = rng.standard_normal(len(r)).astype(np.float32)
    v[:zeros] = 0.0
    return rt.COOMatrix.from_arrays(n_rows, n_cols, r, c, v, device="cpu")


@pytest.mark.parametrize("heavy,zeros,seed", [
    (False, 0, 1), (True, 0, 2), (False, 50, 3), (True, 300, 4)])
def test_slot_width_is_the_conversions(heavy, zeros, seed):
    """slot_width counts, from the triplets alone, the bw that the
    conversion gives (zero-valued entries dropped, as it drops them)."""
    A = _coo(seed=seed, heavy=heavy, zeros=zeros)
    bw = ell_spmm.slot_width(A.rows, A.cols, A.vals, A.n_cols)
    assert bw == ell_spmm.BlockedELL.from_ell(ELLMatrix.from_coo(A)).bw
    assert (bw > spmm.BLOCKED_ELL_MAX_BW) is heavy


def _no_conversion(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a table was built")
    monkeypatch.setattr(ell_spmm.BlockedELL, "from_ell", refuse)
    monkeypatch.setattr(ELLMatrix, "from_coo", refuse)


def test_heavy_row_declined_without_conversion(monkeypatch, on_card):
    """A full row gives bw 136: "auto" declines before building any table
    and the product takes the COO route, exact to float32 sums."""
    A = _coo(heavy=True)
    B = _data((1000, 64), 14)
    _no_conversion(monkeypatch)
    k5 = _spy(monkeypatch, ell_spmm, "blocked_ell_matmul")
    assert spmm._blocked_ell_or_none(A, B) is None
    got = rt.left_spmm(A, B)
    assert k5.launches == 0
    assert _rel(got, A.to_dense() @ B) <= TOL
    assert A._bell_bw == 136 and getattr(A, "_bell_cache", None) is None


@pytest.mark.parametrize("run,n,kernel", [
    (0, 16, True), (0, 1, True), (30, 16, True), (30, 1, False)])
def test_blocked_ell_dispatch_follows_the_gate(monkeypatch, on_card, run, n,
                                               kernel):
    """A light matrix (bw 8) takes K5 through the cached conversion at any
    width; with a run of 30 entries in one block (bw 32) a vector takes
    the COO route without a conversion."""
    A, B = _coo(run=run), _data((1000, n), 15)
    assert ell_spmm.slot_width(A.rows, A.cols, A.vals, A.n_cols) == (
        32 if run else 8)
    if not kernel:
        _no_conversion(monkeypatch)
    k5 = _spy(monkeypatch, ell_spmm, "blocked_ell_matmul")
    got = rt.left_spmm(A, B)
    assert k5.launches == int(kernel)
    assert (getattr(A, "_bell_cache", None) is not None) is kernel
    # K5's plain version rounds B and the values to bf16
    assert _rel(got, A.to_dense() @ B) <= (1e-2 if kernel else TOL)


def test_blocked_ell_cpu_and_forced(monkeypatch):
    """CPU tensors under "auto" convert nothing; True converts even the
    heavy row (K5's plain version); False never, even on the card."""
    A, B = _coo(heavy=True), _data((1000, 16), 16)
    k5 = _spy(monkeypatch, ell_spmm, "blocked_ell_matmul")
    rt.left_spmm(A, B)
    assert k5.launches == 0 and getattr(A, "_bell_cache", None) is None
    with rt.flags(auto_blocked_ell=True):
        got = rt.left_spmm(A, B)
    assert k5.launches == 1 and A._bell_cache.bw == 136
    assert _rel(got, A.to_dense() @ B) <= 1e-2
    monkeypatch.setattr(base, "on_card", lambda t: True)
    light = _coo(seed=17)
    with rt.flags(auto_blocked_ell=False):
        rt.left_spmm(light, B)
    assert k5.launches == 1 and getattr(light, "_bell_cache", None) is None


# ------------------------------------------- the COO model (densify_wins)

@pytest.mark.parametrize("d,m,nnz,n,dense", [
    # G6 points on both sides, each agreed on by both runs of a call
    (512, 65536, 1 << 20, 16, True),
    (4096, 65536, 1 << 20, 16, False),
    (512, 65536, 1 << 16, 512, False),
    (4096, 4096, 1 << 20, 16, True),
    (64, 4096, 1 << 16, 64, False),      # the JAX model densifies
    (64, 4096, 1 << 20, 1, False),
    (4096, 65536, 1 << 20, 512, True),
    (4096, 65536, 1 << 16, 512, False),  # the JAX model densifies
    (4096, 65536, 1 << 20, 2048, True),  # dense 22.6 ms, gather 37
    (4096, 65536, 1 << 16, 2048, False),
    (64, 65536, 1 << 12, 2048, False),   # the JAX model densifies
    (64, 4096, 1 << 16, 2048, True),
    (10000, 20000, 10 ** 6, 512, True),  # path (f)
])
def test_coo_model_on_the_card(d, m, nnz, n, dense):
    assert coo_apply.densify_wins(nnz, n, d, m, cuda=True) is dense


@pytest.mark.parametrize("d,m,nnz,n", [
    (64, 4096, 1 << 16, 64), (4096, 65536, 1 << 16, 512),
    (512, 65536, 1 << 20, 16), (64, 4096, 4096, 512), (100, 100, 10, 3),
    (10000, 20000, 10 ** 6, 512)])
def test_coo_model_on_the_cpu_is_the_jax_packages(d, m, nnz, n):
    jax_model = nnz * n > 4 * d * m or (n >= 64 and nnz * n > (1 << 22))
    assert coo_apply.densify_wins(nnz, n, d, m, cuda=False) is jax_model


@pytest.mark.parametrize("card", [True, False])
def test_coo_dispatch_follows_the_model(monkeypatch, card):
    """At d = 64, m = 4096, 65536 entries, n = 64 the card gathers and the
    CPU densifies (the JAX model); both give the product."""
    monkeypatch.setattr(base, "on_card", lambda t: card)
    dense = _spy(monkeypatch, coo_apply, "coo_left_apply_dense")
    gather = _spy(monkeypatch, coo_apply, "coo_left_apply")
    rng = np.random.default_rng(18)
    r = torch.from_numpy(rng.integers(0, 64, 1 << 16)).int()
    c = torch.from_numpy(rng.integers(0, 4096, 1 << 16)).int()
    v = _data((1 << 16,), 19)
    B = _data((4096, 64), 20)
    got = coo_apply.coo_left_apply_auto(r, c, v, B, 64, 4096)
    assert (gather.launches, dense.launches) == ((1, 0) if card else (0, 1))
    want = coo_apply.coo_densify(r, c, v, 64, 4096).double() @ B.double()
    assert _rel(got, want) <= TOL


# ------------------------------------------ the SRHT's Hadamard stage cap

def test_srht_cap(monkeypatch):
    x = torch.zeros(8, 2)
    assert hadamard.srht_max_factor(x) == 512
    monkeypatch.setattr(base, "on_card", lambda t: True)
    assert hadamard.srht_max_factor(x) == hadamard.SRHT_CUDA_MAX_FACTOR == 64
    assert hadamard.hadamard_transform.__defaults__ == (512,)


@pytest.mark.parametrize("card", [False, True])
@pytest.mark.parametrize("side", ["left", "right"])
def test_srht_sketch_uses_the_cap(monkeypatch, card, side):
    """The SRHT sketches run their transforms at 512 on CPU tensors (as
    before) and at the swept cap on the card, bit for bit the transform
    called with that cap; the two caps agree to float32 rounding."""
    monkeypatch.setattr(base, "on_card", lambda t: card)
    caps = []
    real = hadamard.hadamard_transform

    def spy(x, max_factor=512):
        caps.append(max_factor)
        return real(x, max_factor)
    from randblas_tpu_torch import tensor, trig
    monkeypatch.setattr(trig, "hadamard_transform", spy)
    monkeypatch.setattr(tensor, "hadamard_transform", spy)
    m = 1 << 13    # 13 stages' worth: caps 64 and 512 split it differently
    S = rt.TrigSkOp(rt.TrigDist(40, m), rt.RNGState.from_key(21))
    A = _data((m, 3), 22)
    got = (rt.sketch_general(S, A) if side == "left"
           else rt.sketch_general(S, A.T.contiguous(), side="right",
                                  op_s="T"))
    cap = 64 if card else 512
    assert caps == [cap]
    signs, idx = S._sample("cpu")
    want = real(signs[:, None] * A, cap)[idx.long()]
    if side == "right":
        want = want.T
    assert torch.equal(got, want)
    other = real(signs[:, None] * A, 512 if card else 64)[idx.long()]
    assert _rel(got, other.T if side == "right" else other) <= TOL


def test_kfjlt_passes_the_cap(monkeypatch, on_card):
    caps = []
    real = hadamard.hadamard_transform

    def spy(x, max_factor=512):
        caps.append(max_factor)
        return real(x, max_factor)
    from randblas_tpu_torch import tensor
    monkeypatch.setattr(tensor, "hadamard_transform", spy)
    f = [_data((64, 3), 23), _data((32, 3), 24)]
    rt.kfjlt_sketch(f, 16, rt.RNGState.from_key(25))
    x = _data((64 * 32, 3), 26)
    rt.kfjlt_sketch_explicit(x, (64, 32), 16, rt.RNGState.from_key(25))
    assert caps == [64] * 4
