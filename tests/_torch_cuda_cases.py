"""The cases of the port's card tier, shared by the tier on the card
(``tests/test_torch_cuda_hardware.py``) and by its CPU twins
(``tests/test_torch_cuda_tier.py``). Imports torch, numpy, the port and
``tests/oracle.py`` (numpy only): no JAX, no JAX package, no pytest.

A case is a function of ``(device, scale)``, plus ``mesh`` for the
distributed ones. ``scale="card"`` is the shape of the TPU tier's test
(``tests/test_tpu_hardware.py``) or of the Hopper branch it holds;
``scale="cpu"`` a reduced shape for the CPU twin. It builds its inputs from
a seed with numpy, calls the port, and returns an ``Outcome``: its checks
(got, want and the bound of each), the kernel launches and ``skge`` routes
counted over the calls under test, the launches and routes it must show on
the card, and the port's own oracles (``PortOracle``), which the CPU twins
hold against the JAX package. ``verify`` runs the checks and compares the
counts: on a CUDA device with the expectations, on the CPU with none (the
wrappers run their plain versions there, and no kernel launches).

- ``COUNTERPARTS``: every test function of ``tests/test_tpu_hardware.py``
  -> the ids of the cases that port it (30 cases for 29 functions).
- ``BRANCHES``: the Hopper branches of K1-K7, each held against its plain
  version (K1 and K2 launched twice, bit for bit the same), with
  ``branch_facts`` (load mode, launch plan, slots, order)
  computed from the card-scale shapes and the recorded card's occupancy.
- ``load_mode``: the rule of ``a_map`` in ``csrc/fused_sketch.cu`` and
  ``csrc/saso_sketch.cu`` by which K1, K2 and K4 read A.

The bounds are the TPU tier's (the componentwise bound of
``oracle.assert_componentwise_close`` with float32's eps, and each test's
own) and ``chip_smoke.py``'s for a kernel against its plain version
(copied, not imported). A componentwise bound takes the operands the route
multiplies: rounded to bf16 where it rounds them (K1, K2, K4, K5), as they
are on a float32 route; the operator's values come from the plain fill on
the case's device, since the card's sin, cos and log differ from the
CPU's by an ulp.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
from typing import Any, Callable, Optional

import numpy as np
import torch

import randblas_tpu_torch as rt
from randblas_tpu_torch import skge
from randblas_tpu_torch.ops import ell_spmm as ell
from randblas_tpu_torch.ops import fused_sketch as fs
from randblas_tpu_torch.ops import saso_fill
from randblas_tpu_torch.ops import saso_sketch as saso
from randblas_tpu_torch.ops import x64_fill
from oracle import assert_componentwise_close

F32_EPS = float(np.finfo(np.float32).eps)
K1_REL_TOL = 1e-3    # K1/K2 vs their plain versions: both round the
                     # operands to bf16 and sum in float32, in another order
BF16_REL_TOL = 1e-2  # bf16 output: one bf16 ulp of the output (2^-8)
K4_REL_TOL = 1e-5    # K4 vs its plain version: the same bf16-rounded data
                     # times exact signs, float32 sums in another order
K5_REL_TOL = 1e-6    # K5 vs its plain version: the same products (exact in
                     # float32) summed in the same order
COO_REL_TOL = 1e-4   # two float32 COO products whose sums run in other
                     # orders (index_put_ accumulates with atomics)

# The card whose occupancy the branch grid was laid out for (nvidia-smi
# --query-gpu=name,power.limit --format=csv,noheader), and what it reported:
# fs.max_active_clusters (cluster size -> cudaOccupancyMaxActiveClusters of
# K1's launch shape) and saso.max_active_ctas, as chip_smoke.py prints them
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
CARD_MAX_ACTIVE_CLUSTERS = {8: 15, 16: 7}
CARD_MAX_ACTIVE_CTAS = 132

KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")


def _wrappers():
    return {"K1": fs.fused_sketch, "K2": fs.fused_sketch_colmajor,
            "K3": fs.fill_block, "K4": saso.saso_sketch,
            "K5": ell.blocked_ell_matmul, "K6": x64_fill.fill_block64,
            "K7": saso_fill.saso_fill}


# ------------------------------------------------------------ the checks


def as_np(x) -> np.ndarray:
    """A tensor (CUDA, bf16 or a DTensor) or array as a numpy array
    (bf16 as float32)."""
    full = getattr(x, "full_tensor", None)
    if full is not None:
        x = full()
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def bf16(x) -> np.ndarray:
    """float32 values rounded to bf16 (to nearest even), as float32."""
    t = torch.from_numpy(np.ascontiguousarray(as_np(x), dtype=np.float32))
    return t.to(torch.bfloat16).float().numpy()


@dataclasses.dataclass
class Check:
    """One comparison: ``kind`` is "componentwise" (got against alpha *
    lhs @ rhs, ``want`` = (lhs, rhs), under the componentwise bound with
    float32's eps), "rel" (max |got - want| / max |want| <= tol), "equal"
    (bit for bit), "at_most" (the number got <= tol) or "holds" (got is
    true)."""
    label: str
    kind: str
    got: Any
    want: Any = None
    tol: float = 0.0
    alpha: float = 1.0

    def verify(self):
        what = self.label
        if self.kind == "componentwise":
            lhs, rhs = self.want
            assert_componentwise_close(as_np(self.got), lhs, rhs,
                                       alpha=self.alpha, eps=F32_EPS)
        elif self.kind == "rel":
            got = as_np(self.got).astype(np.float64)
            want = as_np(self.want).astype(np.float64)
            assert got.shape == want.shape, (what, got.shape, want.shape)
            assert np.isfinite(got).all(), f"{what}: non-finite values"
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= self.tol, f"{what}: normalised err {err:.3g} > " \
                                    f"{self.tol}"
        elif self.kind == "equal":
            got, want = as_np(self.got), as_np(self.want)
            assert got.shape == want.shape, (what, got.shape, want.shape)
            bad = int((got != want).sum())
            assert bad == 0, f"{what}: {bad} of {got.size} values differ"
        elif self.kind == "at_most":
            assert float(self.got) <= self.tol, \
                f"{what}: {float(self.got):.4g} > {self.tol}"
        elif self.kind == "holds":
            assert bool(self.got), what
        else:
            raise ValueError(self.kind)


def componentwise(label, got, lhs, rhs, alpha=1.0) -> Check:
    return Check(label, "componentwise", got, (lhs, rhs), alpha=alpha)


def rel(label, got, want, tol) -> Check:
    return Check(label, "rel", got, want, tol)


def equal(label, got, want) -> Check:
    return Check(label, "equal", got, want)


def at_most(label, value, limit) -> Check:
    return Check(label, "at_most", value, tol=limit)


def holds(label, cond) -> Check:
    return Check(label, "holds", cond)


@dataclasses.dataclass
class PortOracle:
    """An oracle the port computed itself (``value``), which the CPU twin
    rebuilds with the JAX package from ``spec``: "dense" (a block of a
    DenseSkOp), "sparse" (a materialised SparseSkOp), "trig" (a
    materialised TrigSkOp), "fill" (K3's plain fill), "fill64" (K6's plain
    fill of an x64 seed), "fy" (a SparseSkOp's triplets, as its plain fill
    gives them), "k1", "k2" (the plain K1 and K2), "k4" (the plain K4),
    "k5" (the plain K5) and "kfjlt" (the KFJLT's signs and samples)."""
    kind: str
    spec: dict
    value: Any


@dataclasses.dataclass
class Outcome:
    checks: list
    launches: dict
    routes: dict
    expect: Optional[dict] = None         # launches on the card
    expect_routes: Optional[dict] = None  # skge routes on the card
    oracles: list = dataclasses.field(default_factory=list)


class Tally:
    """Counts kernel launches (each wrapper's ``.launches``) and
    ``skge.route_counts`` over the ``with`` blocks it encloses."""

    def __init__(self):
        self.launches = dict.fromkeys(KERNELS, 0)
        self.routes = collections.Counter()

    def __enter__(self):
        self._l0 = {k: w.launches for k, w in _wrappers().items()}
        self._r0 = collections.Counter(skge.route_counts)
        return self

    def __exit__(self, *exc):
        for k, w in _wrappers().items():
            self.launches[k] += w.launches - self._l0[k]
        self.routes.update(collections.Counter(skge.route_counts)
                           - self._r0)
        return False

    def outcome(self, checks, expect=None, expect_routes=None, **kw):
        return Outcome(checks, dict(self.launches), dict(self.routes),
                       expect, expect_routes, **kw)


def verify(out: Outcome, device) -> None:
    """Run the checks; on a CUDA device the launches (every kernel the
    expectation does not name: 0) and routes must be the expected ones, on
    the CPU no kernel may have launched."""
    for check in out.checks:
        check.verify()
    if torch.device(device).type == "cuda":
        if out.expect is not None:
            want = {k: out.expect.get(k, 0) for k in KERNELS}
            assert out.launches == want, \
                f"launches {out.launches}, expected {want}"
        if out.expect_routes is not None:
            assert out.routes == out.expect_routes, \
                f"routes {out.routes}, expected {out.expect_routes}"
    else:
        assert not any(out.launches.values()), \
            f"a kernel launched on the CPU: {out.launches}"


@contextlib.contextmanager
def spy(module, name, calls):
    """Wrap ``module.name`` so that each call appends its arguments to
    ``calls``; restored on exit."""
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


# ------------------------------------------------------------ inputs


def normal(seed, shape) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def on(x, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return t if dtype is None else t.to(dtype)


def dense_op(rows, cols, key, family="Gaussian", rng="philox4x32",
             major="Long"):
    dist = rt.DenseDist(rows, cols, rt.DenseDistName[family],
                        rt.MajorAxis[major])
    return rt.DenseSkOp(dist, rt.RNGState.from_key(key, rng))


def dense_block(S, device, rows=None, cols=None, ro=0, co=0):
    """(the block by the plain fill on ``device``, as numpy, its
    PortOracle). On the card the plain fill runs the card's sin, cos and
    log, whose values the kernels' products must be held to."""
    rows = S.dist.n_rows if rows is None else rows
    cols = S.dist.n_cols if cols is None else cols
    blk = as_np(rt.dense.fill_dense_submat_reference(
        S.dist, S.seed_state, rows, cols, ro, co, device=device))
    d = S.dist
    spec = dict(shape=(d.n_rows, d.n_cols), family=d.family.name,
                major=d.major_axis.name, state=S.seed_state.to_dict(),
                block=(rows, cols, ro, co))
    return blk, PortOracle("dense", spec, blk)


def sparse_op(d, m, k, key, major="Short"):
    return rt.SparseSkOp(rt.SparseDist(d, m, vec_nnz=k,
                                       major_axis=rt.MajorAxis[major]),
                         rt.RNGState.from_key(key))


def sparse_dense(S):
    """(the materialised SparseSkOp on the CPU, its PortOracle)."""
    mat = S.materialize(device="cpu").numpy()
    d = S.dist
    spec = dict(shape=(d.n_rows, d.n_cols), k=d.vec_nnz,
                major=d.major_axis.name, state=S.seed_state.to_dict())
    return mat, PortOracle("sparse", spec, mat)


def pick(scale, card, cpu):
    return card if scale == "card" else cpu


# ------------------------------------------------------------ the counterparts

CASES = {}
NEEDS_MESH = set()


def case(name, mesh=False, **param):
    """Register ``fn(device, scale[, mesh=])`` under ``name``; with one
    keyword ``param=values``, ``fn(device, scale, param=value)`` under
    ``name-value`` for each value."""
    def register(fn):
        (key, values), = param.items() if param else ((None, (None,)),)
        for v in values:
            cid = name if v is None else f"{name}-{v}"
            CASES[cid] = fn if v is None else functools.partial(fn,
                                                                **{key: v})
            if mesh:
                NEEDS_MESH.add(cid)
        return fn
    return register


@case("rowmajor_fused", rng=("philox4x32", "threefry4x32"))
def _rowmajor_fused(device, scale, rng):
    d, m, n = pick(scale, (256, 4096, 512), (32, 512, 64))
    S = dense_op(d, m, 1, rng=rng)
    A = normal(0, (m, n))
    with Tally() as t:
        B = fs.fused_sketch(S, on(A, device))
    blk, orc = dense_block(S, device)
    return t.outcome([componentwise("K1 vs the bf16 bound", B, bf16(blk),
                                    bf16(A))], {"K1": 1}, oracles=[orc])


@case("rowmajor_fused_submatrix")
def _rowmajor_fused_submatrix(device, scale):
    (pd, pm), (rows, cols, ro, co) = pick(
        scale, ((300, 4500), (192, 4096, 64, 101)),
        ((40, 600), (32, 512, 8, 5)))          # unaligned co
    S = dense_op(pd, pm, 2)
    A = normal(1, (cols, pick(scale, 384, 48)))
    with Tally() as t:
        B = fs.fused_sketch(S, on(A, device), rows_s=rows, cols_s=cols,
                            ro_s=ro, co_s=co)
    blk, orc = dense_block(S, device, rows, cols, ro, co)
    return t.outcome([componentwise("K1 submatrix vs the bf16 bound", B,
                                    bf16(blk), bf16(A))], {"K1": 1},
                     oracles=[orc])


@case("colmajor_fused")
def _colmajor_fused(device, scale):
    d, m, n = pick(scale, (1024, 512, 512), (600, 512, 16))
    S = dense_op(d, m, 3)          # tall + Long: ColMajor-natural
    A = normal(2, (m, n))
    with Tally() as t:
        B = fs.fused_sketch_colmajor(S, on(A, device))
    blk, orc = dense_block(S, device)
    return t.outcome([
        holds("tall + Long is ColMajor-natural",
              rt.dist_to_layout(S.dist) == rt.Layout.ColMajor),
        componentwise("K2 vs the bf16 bound", B, bf16(blk), bf16(A))],
        {"K2": 1}, oracles=[orc])


def coo_data(m, k, nnz, seed):
    """(rows, cols, vals, the (m, k) densified float32 matrix, the same
    densified in float64 from the values rounded to bf16). K5 rounds each
    stored entry to bf16, so a repeated (row, column) adds rounded values:
    its bf16 operand is the second matrix, not the first one rounded."""
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, m, nnz), rng.integers(0, k, nnz)
    v = rng.normal(size=nnz).astype(np.float32)
    dense = np.zeros((m, k), np.float32)
    np.add.at(dense, (r, c), v)
    dense_b = np.zeros((m, k), np.float64)
    np.add.at(dense_b, (r, c), bf16(v))
    return r, c, v, dense, dense_b


def operands(rounded: bool, lhs, rhs):
    """The operands of a product's componentwise bound: rounded to bf16
    where the route rounds them (K1, K2, K4), else as they are (a float32
    route: the fixed-nnz or COO apply, the staged product)."""
    return (bf16(lhs), bf16(rhs)) if rounded else (lhs, rhs)


def blocked(m, k, r, c, v, device, **kw):
    from randblas_tpu_torch.sparse_data import COOMatrix, ELLMatrix
    coo = COOMatrix.from_arrays(m, k, r, c, v, device=device)
    return ELLMatrix.from_coo(coo).blocked(**kw)


@case("blocked_ell")
def _blocked_ell(device, scale):
    m, k, nnz, n = pick(scale, (2048, 4096, 40_000, 256),
                        (128, 512, 2000, 32))
    r, c, v, _, dense_b = coo_data(m, k, nnz, 4)
    bell = blocked(m, k, r, c, v, device)
    b = normal(5, (k, n))
    with Tally() as t:
        got = ell.blocked_ell_matmul(bell, on(b, device))
    return t.outcome([componentwise("K5 vs the bf16 bound", got, dense_b,
                                    bf16(b))], {"K5": 1})


def transposed_op(S):
    d = S.dist
    return rt.DenseSkOp(rt.DenseDist(d.n_cols, d.n_rows, d.family,
                                     d.major_axis), S.seed_state)


def fill_oracle(S, rows, cols, ro, co, transform, device):
    """(K3's plain fill on ``device``, its PortOracle)."""
    want = fs.fill_block_reference(S, rows, cols, ro, co, device=device,
                                   transform=transform)
    d = S.dist
    spec = dict(shape=(d.n_rows, d.n_cols), family=d.family.name,
                major=d.major_axis.name, state=S.seed_state.to_dict(),
                block=(rows, cols, ro, co), transform=transform)
    return want, PortOracle("fill", spec, as_np(want))


@case("word_plane_fill")
def _word_plane_fill(device, scale):
    """The ColMajor block through fill_block_T_kernel equals the transpose
    of the RowMajor block through fill_block_kernel, bit for bit, and
    both equal the plain fill; (parent columns, rows, cols, pointer) as
    ops/dense_fill.py's fill_rowmajor takes them."""
    first = pick(scale, (4096, 512, 1000, 0), (300, 24, 261, 0))
    cases = [("Gaussian", first), ("Uniform", first),
             ("Gaussian", (1030, 200, 515, 2060))]  # odd, column offset
    checks, oracles = [], []
    t = Tally()
    for family, (pd, rows, cols, ptr) in cases:
        ro, co = divmod(ptr, pd)
        R = dense_op(rows + ro, pd, 7, family)     # wide + Long: RowMajor
        C = transposed_op(R)                       # tall + Long: ColMajor
        with t:
            row = fs.fill_block(R, rows, cols, ro, co, device=device,
                                transform="boxmul")
            col = fs.fill_block(C, cols, rows, co, ro, device=device,
                                transform="boxmul")
        want, orc = fill_oracle(R, rows, cols, ro, co, "boxmul", device)
        what = f"{family} {pd}x{rows}x{cols} at {ptr}"
        checks += [equal(f"K3 ColMajor block vs the RowMajor block's "
                         f"transpose, {what}", col.T, row),
                   equal(f"K3 RowMajor block vs the plain fill, {what}",
                         row, want)]
        oracles.append(orc)
    return t.outcome(checks, {"K3": 2 * len(cases)}, oracles=oracles)


@case("word_major_blocked_ell")
def _word_major_blocked_ell(device, scale):
    m, k, nnz, d = pick(scale, (2048, 4100, 40_000, 256),
                        (64, 262, 800, 24))   # k % 4 != 0
    r, c, v, _, dense_b = coo_data(m, k, nnz, 6)
    bell = blocked(m, k, r, c, v, device, word_major=4)
    S = dense_op(k, d, 11)          # tall + Long: ColMajor-natural
    with Tally() as t:
        got = rt.sketch_sparse(S, bell, side="right")
    blk, orc = dense_block(S, device)
    return t.outcome([componentwise("word-major K5 sketch vs the bf16 bound",
                                    got, dense_b, bf16(blk))],
                     {"K3": 1, "K5": 1}, oracles=[orc])


@case("fused_grad")
def _fused_grad(device, scale):
    """torch.autograd through K1 (its backward pass is K2) against the
    gradient of the staged product of the materialised operator."""
    d, m, n = pick(scale, (256, 4096, 512), (32, 512, 64))
    S = dense_op(d, m, 21)
    A = on(normal(9, (m, n)), device).requires_grad_(True)
    with Tally() as t:
        (fs.fused_sketch(S, A) ** 2).sum().backward()
    blk, orc = dense_block(S, device)
    Smat = on(blk, device)
    A_ref = A.detach().clone().requires_grad_(True)
    ((Smat @ A_ref) ** 2).sum().backward()
    g, g_ref = as_np(A.grad), as_np(A_ref.grad)
    err = np.abs(g - g_ref).max() / np.abs(g_ref).max()
    return t.outcome([at_most("grad vs the staged gradient", err, 1e-2)],
                     {"K1": 1, "K2": 1}, oracles=[orc])


@case("f64_hiprec")
def _f64_hiprec(device, scale):
    rng = np.random.default_rng(5)
    a = rng.normal(size=(130, 1000))
    b = rng.normal(size=(1000, 77))
    with Tally() as t:
        got = as_np(torch.matmul(on(a, device), on(b, device)))
    want = a @ b
    err = np.abs(got - want).max() / np.abs(want).max()
    return t.outcome([holds("float64 product", got.dtype == np.float64),
                      at_most("float64 product vs numpy", err, 1e-14)], {})


@case("srht")
def _srht(device, scale):
    """The port's SRHT runs its stages in float32 (no bf16 stage
    precision): the 'highest' bound of the TPU test, then the public
    sketch calls at its relative bound."""
    d, m, n = pick(scale, (512, 6000, 256), (64, 600, 32))
    S = rt.TrigSkOp(rt.TrigDist(d, m), rt.RNGState.from_key(3))
    A = normal(0, (m, n))
    y = np.random.default_rng(1).normal(size=(d, 8)).astype(np.float32)
    s_dense = S.materialize(device="cpu").numpy().astype(np.float64)
    with Tally() as t:
        hi = S.lmult(on(A, device))
        hi_t = S.lmult_t(on(y, device))
        B = rt.sketch(S, on(A, device))
        Bt = rt.sketch_general(S, on(y, device), op_s="T")
    checks = [componentwise("lmult vs the float32 bound", hi, s_dense, A),
              componentwise("lmult_t vs the float32 bound", hi_t, s_dense.T,
                            y)]
    for label, got, want in (("sketch", B, s_dense @ A.astype(np.float64)),
                             ("sketch_general op_s=T", Bt,
                              s_dense.T @ y.astype(np.float64))):
        err = np.linalg.norm(as_np(got) - want) / np.linalg.norm(want)
        checks.append(at_most(f"{label} vs the float64 product", err, 3e-2))
    spec = dict(d=d, m=m, state=S.seed_state.to_dict())
    return t.outcome(checks, {}, {"srht": 2},
                     oracles=[PortOracle("trig", spec, s_dense)])


@case("saso_onehot_panel")
def _saso_onehot_panel(device, scale):
    """The config-3 wide SASO through the public sketch: on the card K7
    fills the lazy operator and the gate takes K4 (the TPU's one-hot
    panels' place), on the CPU the plain fill and the fixed-nnz route."""
    d, m, n, k = pick(scale, (512, 16384, 512, 8), (64, 1024, 32, 2))
    S = sparse_op(d, m, k, 31)
    A = normal(12, (m, n))
    with Tally() as t:
        got = rt.sketch(S, on(A, device))
    mat, orc = sparse_dense(S)
    kernel = "sparse_saso_kernel" in t.routes
    checks = [componentwise(f"wide SASO ({dict(t.routes)}) vs its bound",
                            got, *operands(kernel, mat, A))]
    if torch.device(device).type == "cuda":
        checks.append(holds("saso_profitable takes K4 at config 3",
                            skge.saso_profitable(d, m, n)))
    return t.outcome(checks, {"K4": 1, "K7": 1}, {"sparse_saso_kernel": 1},
                     oracles=[orc])


@case("saso_row_gather")
def _saso_row_gather(device, scale):
    d, m, n, k = pick(scale, (4096, 1024, 384, 8), (1024, 64, 24, 2))
    S = sparse_op(d, m, k, 32)
    A = normal(13, (m, n))
    with Tally() as t:
        got = rt.sketch(S, on(A, device))
    mat, orc = sparse_dense(S)
    return t.outcome([componentwise("tall SASO vs the float32 bound", got,
                                    mat, A)],
                     {"K7": 1}, {"sparse_row_gather": 1}, oracles=[orc])


@case("coo_flat_scatter_densify")
def _coo_densify(device, scale):
    """coo_apply's densify route, the auto choice (which must densify at
    this shape) and the public spmm, which on the card converts the COO
    data to BlockedELL for K5 (its gate) and on the CPU takes the COO
    route."""
    from randblas_tpu_torch import base
    from randblas_tpu_torch.ops import coo_apply
    from randblas_tpu_torch.sparse_data import COOMatrix
    from randblas_tpu_torch.sparse_data.spmm import spmm
    d, m, nnz, n = pick(scale, (2048, 8192, 200_000, 512),
                        (128, 512, 3000, 128))
    r, c, v, dense, dense_b = coo_data(d, m, nnz, 14)
    b = normal(15, (m, n))
    B = on(b, device)
    rows, cols, vals = on(r, device), on(c, device), on(v, device)
    calls = []
    t = Tally()
    with t:
        got = coo_apply.coo_left_apply_dense(rows, cols, vals, B, d, m)
        with spy(coo_apply, "coo_left_apply_dense", calls):
            got_auto = coo_apply.coo_left_apply_auto(rows, cols, vals, B, d,
                                                     m)
    checks = [componentwise("densify route (float32) vs its bound", got,
                            dense, b),
              holds("the auto rule densifies at this shape",
                    coo_apply.densify_wins(nnz, n, d, m, base.on_card(B))),
              holds("the auto choice called the densify route",
                    len(calls) == 1),
              rel("auto vs the densify route", got_auto, got, COO_REL_TOL)]
    t_spmm = Tally()
    with t, t_spmm:
        got_spmm = spmm(COOMatrix.from_arrays(d, m, r, c, v, device=device),
                        B)
    lhs, rhs = (dense_b, bf16(b)) if t_spmm.launches["K5"] else (dense, b)
    checks.append(componentwise(f"spmm (launches {t_spmm.launches}) vs its "
                                "bound", got_spmm, lhs, rhs))
    return t.outcome(checks, {"K5": 1})


@case("tensor_sketch")
def _tensor_sketch(device, scale):
    from randblas_tpu_torch.tensor import _countsketch
    d, m1, m2, n = 256, 96, 80, 16
    rng = np.random.default_rng(15)
    a1 = rng.normal(size=(m1, n)).astype(np.float32)
    a2 = rng.normal(size=(m2, n)).astype(np.float32)
    st = rt.RNGState.from_key(33)
    with Tally() as t:
        out, _ = rt.tensor_sketch([on(a1, device), on(a2, device)], d, st)
    C1 = _countsketch(d, m1, st)
    C2 = _countsketch(d, m2, C1.next_state)
    (c1, o1), (c2, o2) = sparse_dense(C1), sparse_dense(C2)
    c1, c2 = c1.astype(np.float64), c2.astype(np.float64)
    r1, r2 = np.abs(c1).argmax(axis=0), np.abs(c2).argmax(axis=0)
    g1, g2 = c1[r1, np.arange(m1)], c2[r2, np.arange(m2)]
    oracle = np.zeros((d, n))
    a1n, a2n = a1.astype(np.float64), a2.astype(np.float64)
    for i1 in range(m1):   # CountSketch of the Kronecker product
        np.add.at(oracle, (r1[i1] + r2) % d,
                  (g1[i1] * g2)[:, None] * a1n[i1] * a2n)
    err = np.linalg.norm(as_np(out) - oracle) / np.linalg.norm(oracle)
    # on the card each factor's CountSketch (d > m: Long, the COO route) is
    # filled by one K7 launch
    return t.outcome([at_most("tensor_sketch vs the Kronecker CountSketch",
                              err, 1e-3)], {"K7": 2}, oracles=[o1, o2])


@case("sgmres_pipeline")
def _sgmres(device, scale):
    from randblas_tpu_torch.linalg import sgmres
    n = 1024
    rng = np.random.default_rng(16)
    a = (rng.normal(size=(n, n)) / np.sqrt(n) + 4 * np.eye(n)).astype(
        np.float32)
    b = rng.normal(size=n).astype(np.float32)
    with Tally() as t:
        x, res_est, _ = sgmres(on(a, device), on(b, device),
                               rt.RNGState.from_key(34), basis=80)
    x = as_np(x).astype(np.float64)
    true_rel = (np.linalg.norm(a.astype(np.float64) @ x - b)
                / np.linalg.norm(b))
    # on the card the lazy SASO is filled by K7 for each of its three
    # sketches (A Q, b, the refined residual), each taken by K4
    return t.outcome([at_most("true relative residual", true_rel, 1e-3),
                      at_most("sketched residual estimate", float(res_est),
                              2e-3)], {"K4": 3, "K7": 3})


@case("single_pass_svd")
def _single_pass_svd(device, scale):
    from randblas_tpu_torch.linalg import single_pass_svd
    m, n, r = 2048, 512, 16
    rng = np.random.default_rng(17)
    u, _ = np.linalg.qr(rng.normal(size=(m, r)))
    v, _ = np.linalg.qr(rng.normal(size=(n, r)))
    s_true = np.linspace(10.0, 1.0, r)
    a_np = ((u * s_true) @ v.T).astype(np.float32)
    a = a_np + 1e-4 * rng.normal(size=(m, n)).astype(np.float32)
    with Tally() as t:
        uu, ss, vt, _ = single_pass_svd(on(a, device), r,
                                        rt.RNGState.from_key(35),
                                        oversample=8)
    ss = as_np(ss)
    approx = as_np(uu) @ np.diag(ss) @ as_np(vt)
    err = np.linalg.norm(a_np - approx) / np.linalg.norm(a_np)
    return t.outcome([
        at_most("singular values, max relative err",
                np.abs(ss / s_true - 1).max(), 1e-2),
        at_most("reconstruction", err, 1.1e-2)])


@case("rand_geigh")
def _rand_geigh(device, scale):
    from randblas_tpu_torch.linalg import rand_geigh
    n, k = 512, 6
    rng = np.random.default_rng(18)
    g = rng.normal(size=(n, n)).astype(np.float32)
    b = g @ g.T / n + np.eye(n, dtype=np.float32)
    ell_ = np.linalg.cholesky(b.astype(np.float64))
    u, _ = np.linalg.qr(rng.normal(size=(n, k)))
    theta = np.linspace(5.0, -3.0, k)
    a = (ell_ @ ((u * theta) @ u.T) @ ell_.T).astype(np.float32)
    with Tally() as t:
        w, x = rand_geigh(on(a, device), on(b, device), k,
                          rt.RNGState.from_key(36))
    xn, bn = as_np(x).astype(np.float64), b.astype(np.float64)
    return t.outcome([
        at_most("eigenvalues, max abs err",
                np.abs(np.sort(as_np(w)) - np.sort(theta)).max(), 5e-3),
        at_most("X^T B X - I, max abs",
                np.abs(xn.T @ bn @ xn - np.eye(k)).max(), 5e-3)])


@case("xtrace_xdiag")
def _xtrace_xdiag(device, scale):
    from randblas_tpu_torch.linalg import xdiag, xtrace
    n = 1024
    rng = np.random.default_rng(19)
    u, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = 2.0 ** (-np.arange(n) / 8.0)
    a64 = (u * lam) @ u.T
    a = on(a64.astype(np.float32), device)
    want_tr, want_d = float(lam.sum()), np.diag(a64)
    with Tally() as t:
        est, se, _ = xtrace(a, n, 96, rt.RNGState.from_key(37))
        dg, _ = xdiag(a, n, 96, rt.RNGState.from_key(38))
    err = np.linalg.norm(as_np(dg) - want_d) / np.linalg.norm(want_d)
    return t.outcome([
        at_most("xtrace error / max(6 se, 5e-3 tr)",
                abs(float(est) - want_tr) / max(6 * float(se),
                                                5e-3 * want_tr), 1.0),
        at_most("xdiag relative error", err, 0.08)])


@case("kaczmarz")
def _kaczmarz(device, scale):
    from randblas_tpu_torch.linalg import block_gauss_seidel, block_kaczmarz
    rng = np.random.default_rng(20)
    m, n = 4096, 256
    a = rng.standard_normal((m, n)).astype(np.float32)
    xt = rng.standard_normal(n).astype(np.float32)
    A = on(a, device)
    b = A @ on(xt, device)
    noise = rng.standard_normal(m).astype(np.float32)
    with Tally() as t:
        x, _ = block_kaczmarz(A, b, rt.RNGState.from_key(39), block=256,
                              steps=30)
        bn = b + on(noise, device)
        xg, _ = block_gauss_seidel(A, bn, rt.RNGState.from_key(40),
                                   block=128, steps=60)
    xls = np.linalg.lstsq(a.astype(np.float64), as_np(bn).astype(np.float64),
                          rcond=None)[0]
    return t.outcome([
        at_most("block Kaczmarz, relative error",
                np.linalg.norm(as_np(x) - xt) / np.linalg.norm(xt), 1e-3),
        at_most("block Gauss-Seidel vs lstsq",
                np.linalg.norm(as_np(xg) - xls) / np.linalg.norm(xls),
                5e-3)])


@case("rgs_qr")
def _rgs_qr(device, scale):
    from randblas_tpu_torch.linalg.rgs import rgs_qr
    rng = np.random.default_rng(21)
    m, k = 8192, 128
    u, _ = np.linalg.qr(rng.standard_normal((m, k)))
    v, _ = np.linalg.qr(rng.standard_normal((k, k)))
    s = 3e7 ** (-np.arange(k) / (k - 1))
    a = ((u * s) @ v.T).astype(np.float32)
    with Tally() as t:
        q, r, _ = rgs_qr(on(a, device), rt.RNGState.from_key(41), block=64)
    an = a.astype(np.float64)
    qn, rn = as_np(q).astype(np.float64), as_np(r).astype(np.float64)
    return t.outcome([
        at_most("||QR - A|| / ||A||",
                np.linalg.norm(qn @ rn - an) / np.linalg.norm(an), 2e-4),
        at_most("||Q^T Q - I||_2", np.linalg.norm(qn.T @ qn - np.eye(k), 2),
                2e-3),
        holds("R upper triangular", np.allclose(rn, np.triu(rn)))],
        {"K3": 1})   # the Gaussian operator materialized by K3; no K7


def _masses(grid, dens, counts, label):
    checks = [holds(f"{label}: finite", np.all(np.isfinite(dens)))]
    n = sum(counts.values())
    total = np.trapezoid(dens, grid)
    checks.append(at_most(f"{label}: |integral - n| / n", abs(total - n) / n,
                          0.05))
    for c, k in counts.items():
        mask = (grid >= c - 1.0) & (grid <= c + 1.0)
        mass = np.trapezoid(np.where(mask, dens, 0.0), grid)
        checks.append(at_most(f"{label}: cluster {c} mass", abs(mass - k) / k,
                              0.10))
    return checks


@case("spectral_density")
def _spectral_density(device, scale):
    from randblas_tpu_torch.linalg import (eig_count, kpm_density,
                                           spectral_density)
    rng = np.random.default_rng(22)
    n = 1024
    counts = {-2.0: 200, 0.5: 500, 3.0: 324}
    lam = np.concatenate([c + 0.02 * rng.standard_normal(k)
                          for c, k in counts.items()])
    u, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = on(((u * lam) @ u.T).astype(np.float32), device)
    with Tally() as t:
        grid, dens, _ = spectral_density(a, rt.RNGState.from_key(50),
                                         probes=16, steps=80)
        cnt, _ = eig_count(a, -0.5, 1.5, rt.RNGState.from_key(51),
                           probes=16, steps=80)
        gridk, densk, _ = kpm_density(
            a, rt.RNGState.from_key(52), degree=256, probes=16, npts=801,
            bounds=(float(lam.min()) - 0.3, float(lam.max()) + 0.3))
    g, dd = as_np(grid).astype(np.float64), as_np(dens).astype(np.float64)
    checks = [holds("SLQ density >= -1e-6", np.all(dd > -1e-6))]
    checks += _masses(g, dd, counts, "SLQ")
    checks.append(at_most("eig_count on the middle cluster",
                          abs(float(cnt) - 500) / 500, 0.10))
    checks += _masses(as_np(gridk).astype(np.float64),
                      as_np(densk).astype(np.float64), counts, "KPM")
    return t.outcome(checks)


def _fd_checks(a64, b, mass, ell_, tight):
    gram_err = np.linalg.norm(a64.T @ a64 - b.T @ b, 2)
    fro2 = np.linalg.norm(a64, "fro") ** 2
    checks = [at_most("||A^T A - B^T B||_2 - 1.02 shrink mass",
                      gram_err - (mass * 1.02 + 1e-3 * fro2), 0.0),
              at_most("shrink mass * ell / ||A||_F^2", mass * ell_ / fro2,
                      1.02)]
    if tight:
        checks.append(at_most("certificate tightness", mass * ell_ / fro2,
                              0.6))
    return checks


@case("frequent_directions")
def _frequent_directions(device, scale):
    from randblas_tpu_torch.linalg import FrequentDirections
    rng = np.random.default_rng(23)
    m, n, ell_ = 2048, 256, 64
    a64 = rng.standard_normal((m, n)) * 2.0 ** (-np.arange(n) / 16.0)
    a = on(a64.astype(np.float32), device)
    with Tally() as t:
        fd = FrequentDirections(n, ell_, device=device)
        for i in range(0, m, 160):                 # ragged chunks
            fd.update(a[i:i + 160])
        b = as_np(fd.sketch()).astype(np.float64)
        mass = float(fd.shrink_mass)
    return t.outcome(_fd_checks(a64, b, mass, ell_, tight=True))


@case("distributed_fd", mesh=True)
def _distributed_fd(device, scale, mesh):
    from randblas_tpu_torch.linalg import distributed_fd
    rng = np.random.default_rng(29)
    m, n, ell_ = 2048 + 37, 256, 64            # ragged m: padding path
    a64 = rng.standard_normal((m, n)) * 2.0 ** (-np.arange(n) / 16.0)
    with Tally() as t:
        fd = distributed_fd(on(a64.astype(np.float32), device), ell_, mesh)
        b = as_np(fd.sketch()).astype(np.float64)
        mass = float(fd.shrink_mass)
    return t.outcome(_fd_checks(a64, b, mass, ell_, tight=False))


@case("shard_map_fused_sketch", mesh=True)
def _shard_map_fused_sketch(device, scale, mesh):
    """distributed_sketch on a one-rank mesh, K1 forced, then under "auto",
    whose H100 gate (skge.fused_profitable) sends this 2^30-operation
    call to the staged route (K3 fills the tile) on the card."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from randblas_tpu_torch.parallel import distributed_sketch
    d, m, n = pick(scale, (256, 4096, 512), (32, 512, 64))
    S = dense_op(d, m, 60)
    A = normal(24, (m, n))
    A_dt = distribute_tensor(on(A, device), mesh, [Replicate(), Shard(0)])
    blk, orc = dense_block(S, device)
    t, t1, t2 = Tally(), Tally(), Tally()
    with t, t1:
        B = distributed_sketch(S, A_dt, mesh, use_fused=True)
    with t, t2:
        B2 = distributed_sketch(S, A_dt, mesh)
    card = torch.device(device).type == "cuda"
    checks = [componentwise("forced K1 vs the bf16 bound", B,
                            *operands(True, blk, A)),
              componentwise("auto (staged, float32) vs its bound", B2, blk,
                            A),
              holds("the H100 gate declines K1 at this shape", not card
                    or not skge.fused_profitable(d, m, n, torch.float32))]
    if card:
        checks.append(holds(f"launches: forced {t1.launches} (K1 1), auto "
                            f"{t2.launches} (K3 1)",
                            t1.launches["K1"] == 1
                            and t2.launches["K3"] == 1))
    return t.outcome(checks, {"K1": 1, "K3": 1}, oracles=[orc])


@case("distributed_cholqr_rsvd", mesh=True)
def _distributed_cholqr_rsvd(device, scale, mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from randblas_tpu_torch.linalg import cholqr, distributed_rsvd
    rng = np.random.default_rng(25)
    m, n, k = 4096, 384, 16
    u, _ = np.linalg.qr(rng.standard_normal((m, k)))
    v, _ = np.linalg.qr(rng.standard_normal((n, k)))
    s = np.linspace(10.0, 1.0, k)
    a64 = (u * s) @ v.T + 1e-4 * rng.standard_normal((m, n))
    rows = [Replicate(), Shard(0)]
    a = distribute_tensor(on(a64.astype(np.float32), device), mesh, rows)
    y = on((u * s).astype(np.float32), device)
    with Tally() as t:
        q, r = cholqr(y)
        uu, ss, vt = distributed_rsvd(a, k, rt.RNGState.from_key(61), mesh,
                                      power_iters=1)
    qn = as_np(q).astype(np.float64)
    rec = (as_np(uu).astype(np.float64) * as_np(ss)) @ as_np(vt)
    return t.outcome([
        at_most("||Q^T Q - I||_2", np.linalg.norm(qn.T @ qn - np.eye(k), 2),
                1e-4),
        at_most("QR vs Y, max abs", np.abs(qn @ as_np(r) - u * s).max(),
                5e-3),
        at_most("singular values, max relative err",
                np.abs(as_np(ss)[:k] / s - 1).max(), 2e-2),
        at_most("reconstruction", np.linalg.norm(rec - a64)
                / np.linalg.norm(a64), 2e-2)])


@case("saso_kernel", mesh=True)
def _saso_kernel(device, scale, mesh):
    """K4 through its wrapper at a config-3 shape and a ragged one, then
    the public sketch_general (the route under "auto": K4 on the card) and
    distributed_sparse_sketch on a one-rank mesh (its shard asks K4's
    gate), each of these two filling the lazy operator by K7 on the
    card."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from randblas_tpu_torch.parallel import distributed_sparse_sketch
    checks, oracles = [], []
    t = Tally()
    shapes = pick(scale, [(1024, 16384, 512, 8, 70), (1000, 8192, 129, 8, 71)],
                  [(64, 1024, 32, 2, 70), (64, 1024, 17, 2, 71)])
    for d, m, n, k, seed in shapes:
        S = sparse_op(d, m, k, seed)
        s = S.filled(device)
        A = normal(seed, (m, n))
        with t:
            B = saso.saso_sketch(s.rows.reshape(m, k), s.vals.reshape(m, k),
                                 on(A, device), d)
        mat, orc = sparse_dense(S)
        oracles.append(orc)
        checks.append(componentwise(f"K4 {d}x{m}x{n} vs the bf16 bound", B,
                                    bf16(mat), bf16(A)))
    t2, t3 = Tally(), Tally()
    with t, t2:
        B2 = rt.sketch_general(S, on(A, device))
    with t, t3:
        B3 = distributed_sparse_sketch(S, distribute_tensor(
            on(A, device), mesh, [Replicate(), Shard(0)]), mesh)
    checks += [componentwise(f"sketch_general ({dict(t2.routes)}) vs its "
                             "bound", B2, *operands(
                                 "sparse_saso_kernel" in t2.routes, mat, A)),
               componentwise(f"distributed_sparse_sketch ({t3.launches}) vs "
                             "its bound", B3, *operands(
                                 t3.launches["K4"] == 1, mat, A))]
    return t.outcome(checks, {"K4": 4, "K7": 2}, {"sparse_saso_kernel": 1},
                     oracles=oracles)


@case("kfjlt")
def _kfjlt(device, scale):
    """The port's KFJLT runs its stages in float32: the structured and the
    explicit forms both at the TPU test's 'highest' bound."""
    from randblas_tpu_torch.tensor import _kfjlt_sample, kfjlt_scale
    d, dims, n = 256, (96, 80), 16      # non-pow2 modes: padding path
    rng = np.random.default_rng(16)
    mats = [rng.normal(size=(m, n)).astype(np.float32) for m in dims]
    st = rt.RNGState.from_key(34)
    parts, _ = _kfjlt_sample(dims, d, st, torch.float32, "cpu")
    rows = None
    for m, (sgn, m_pad, idx) in zip(dims, parts):
        h = rt.hadamard_matrix(m_pad, device="cpu").numpy().astype(np.float64)
        blk = h[idx.numpy(), :m] * sgn.numpy().astype(np.float64)[None, :]
        rows = blk if rows is None else \
            (rows[:, :, None] * blk[:, None, :]).reshape(d, -1)
    kr = np.einsum("ik,jk->ijk", mats[0].astype(np.float64),
                   mats[1].astype(np.float64)).reshape(-1, n)
    want = kfjlt_scale(dims, d) * (rows @ kr)
    wn = np.linalg.norm(want)
    with Tally() as t:
        got = rt.kfjlt_sketch([on(x, device) for x in mats], d, st)[0]
        ex = rt.kfjlt_sketch_explicit(on(kr.astype(np.float32), device),
                                      dims, d, st)[0]
    spec = dict(dims=dims, d=d, state=st.to_dict())
    value = [(p[0].numpy(), p[1], p[2].numpy()) for p in parts]
    return t.outcome([
        at_most("kfjlt_sketch vs the float64 oracle",
                np.linalg.norm(as_np(got) - want) / wn, 1e-5),
        at_most("kfjlt_sketch_explicit vs the float64 oracle",
                np.linalg.norm(as_np(ex) - want) / wn, 1e-5)],
        oracles=[PortOracle("kfjlt", spec, value)])


def tt_svd_oracle(x, ranks):
    """Deterministic TT-SVD (Oseledets 2011) in float64 numpy, the
    quasi-optimality baseline (tests/test_tt.py's oracle)."""
    x = np.asarray(x, np.float64)
    shape = x.shape
    p = len(shape)
    ranks = (ranks,) * (p - 1) if isinstance(ranks, int) else tuple(ranks)
    cores = []
    carry = x.reshape(1, -1)
    r_prev = 1
    for k in range(p - 1):
        mat = carry.reshape(r_prev * shape[k], -1)
        u, s, vt = np.linalg.svd(mat, full_matrices=False)
        r = min(ranks[k], len(s))
        cores.append(u[:, :r].reshape(r_prev, shape[k], r))
        carry = s[:r, None] * vt[:r, :]
        r_prev = r
    cores.append(carry.reshape(r_prev, shape[-1], 1))
    out = cores[0]
    for g in cores[1:]:
        out = np.einsum("a...b,bic->a...ic", out, g)
    return out[0, ..., 0]


def st_hosvd_oracle(x, ranks):
    """Deterministic ST-HOSVD in float64 numpy (tests/test_tucker.py's
    oracle)."""
    x = np.asarray(x, np.float64)
    p = x.ndim
    ranks = (ranks,) * p if isinstance(ranks, int) else tuple(ranks)
    cur = x.copy()
    fac = []
    for k in range(p):
        mat = np.moveaxis(cur, k, 0).reshape(cur.shape[k], -1)
        u = np.linalg.svd(mat, full_matrices=False)[0]
        uk = u[:, :min(ranks[k], u.shape[1])]
        fac.append(uk)
        cur = np.moveaxis((uk.T @ mat).reshape(
            (uk.shape[1],) + cur.shape[:k] + cur.shape[k + 1:]), 0, k)
    rec = cur
    for k, u in enumerate(fac):
        rec = np.moveaxis(np.tensordot(u, rec, axes=(1, k)), 0, k)
    return rec


def rank_one_sum(rng, shape, terms):
    """sum_t 0.5^t a_t o b_t o c_t in float64 numpy."""
    y = np.zeros(shape, np.float64)
    for t in range(terms):
        a, b, c = (rng.standard_normal(sz) for sz in shape)
        y += (0.5 ** t) * np.einsum("i,j,k->ijk", a, b, c)
    return y


@case("tt_round")
def _tt_round(device, scale):
    from randblas_tpu_torch.linalg import (tt_add, tt_from_dense,
                                           tt_gaussian, tt_round, tt_scale)
    with Tally() as t:
        x, _ = tt_gaussian((8, 9, 7, 6), (3, 4, 2), rt.RNGState.from_key(1),
                           device=device)
        dense = as_np(x.full()).astype(np.float64)
        tt2, _ = tt_from_dense(on(dense.astype(np.float32), device),
                               (3, 4, 2), rt.RNGState.from_key(2))
        r, _ = tt_round(tt_add(x, tt_scale(x, 2.0)), (3, 4, 2),
                        rt.RNGState.from_key(3))
        y = rank_one_sum(np.random.default_rng(8), (9, 10, 11), 8)
        ty, _ = tt_from_dense(on(y.astype(np.float32), device), 8,
                              rt.RNGState.from_key(12), power_iters=2)
        ry, _ = tt_round(ty, 3, rt.RNGState.from_key(13), oversample=4)
    nd = np.linalg.norm(dense)
    got = np.linalg.norm(as_np(ry.full()).astype(np.float64) - y)
    base = np.linalg.norm(tt_svd_oracle(y, 3) - y)
    return t.outcome([
        at_most("tt_from_dense exact rank",
                np.linalg.norm(as_np(tt2.full()) - dense) / nd, 1e-2),
        at_most("tt_round of x + 2x",
                np.linalg.norm(as_np(r.full()) - 3 * dense) / (3 * nd), 1e-2),
        at_most("truncation error / (3 TT-SVD's + 5e-2 ||y||)",
                got / (3 * base + 5e-2 * np.linalg.norm(y)), 1.0)])


@case("tucker")
def _tucker(device, scale):
    from randblas_tpu_torch.linalg import tucker_from_dense, tucker_full
    y = rank_one_sum(np.random.default_rng(2), (12, 13, 14), 10)
    with Tally() as t:
        cc, ff, _ = tucker_from_dense(on(y.astype(np.float32), device), 4,
                                      rt.RNGState.from_key(2), power_iters=2)
    got = np.linalg.norm(as_np(tucker_full(cc, ff)).astype(np.float64) - y)
    base = np.linalg.norm(st_hosvd_oracle(y, 4) - y)
    checks = [at_most("error / (2 ST-HOSVD's + 5e-2 ||y||)",
                      got / (2 * base + 5e-2 * np.linalg.norm(y)), 1.0)]
    for i, u in enumerate(ff):
        g = as_np(u.T @ u)
        checks.append(at_most(f"factor {i}: U^T U - I, max abs",
                              np.abs(g - np.eye(g.shape[0])).max(), 2e-2))
    return t.outcome(checks)


@case("ihs_lsq")
def _ihs_lsq(device, scale):
    from randblas_tpu_torch.linalg import ihs_lsq
    rng = np.random.default_rng(22)
    m, n = 8192, 256
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = 1e2 ** (-np.arange(n) / (n - 1))
    a = ((u * s) @ v.T).astype(np.float32)
    xt = rng.standard_normal(n).astype(np.float32)
    noise = rng.standard_normal(m).astype(np.float32)
    A = on(a, device)
    b = A @ on(xt, device) + 1e-4 * on(noise, device)
    xls = np.linalg.lstsq(a.astype(np.float64), as_np(b).astype(np.float64),
                          rcond=None)[0]
    with Tally() as t:
        x, _ = ihs_lsq(A, b, rt.RNGState.from_key(42), iters=24)
    # on the card the lazy SASO is filled by one K7 launch
    return t.outcome([at_most(
        "||x - x_ls|| / ||x_ls||",
        np.linalg.norm(as_np(x) - xls) / np.linalg.norm(xls), 1e-4)],
        {"K4": 1, "K7": 1})


# every test function of tests/test_tpu_hardware.py -> its cases here
COUNTERPARTS = {
    "test_rowmajor_fused_on_hardware": ("rowmajor_fused-philox4x32",
                                        "rowmajor_fused-threefry4x32"),
    "test_rowmajor_fused_submatrix_on_hardware": ("rowmajor_fused_submatrix",),
    "test_colmajor_fused_on_hardware": ("colmajor_fused",),
    "test_blocked_ell_on_hardware": ("blocked_ell",),
    "test_word_plane_fill_bit_identity_on_hardware": ("word_plane_fill",),
    "test_word_major_blocked_ell_on_hardware": ("word_major_blocked_ell",),
    "test_fused_grad_on_hardware": ("fused_grad",),
    "test_f64_hiprec_on_hardware": ("f64_hiprec",),
    "test_srht_on_hardware": ("srht",),
    "test_saso_onehot_panel_on_hardware": ("saso_onehot_panel",),
    "test_saso_row_gather_on_hardware": ("saso_row_gather",),
    "test_coo_flat_scatter_densify_on_hardware": ("coo_flat_scatter_densify",),
    "test_tensor_sketch_on_hardware": ("tensor_sketch",),
    "test_sgmres_pipeline_on_hardware": ("sgmres_pipeline",),
    "test_single_pass_svd_on_hardware": ("single_pass_svd",),
    "test_rand_geigh_on_hardware": ("rand_geigh",),
    "test_xtrace_xdiag_on_hardware": ("xtrace_xdiag",),
    "test_kaczmarz_on_hardware": ("kaczmarz",),
    "test_rgs_qr_on_hardware": ("rgs_qr",),
    "test_spectral_density_on_hardware": ("spectral_density",),
    "test_frequent_directions_on_hardware": ("frequent_directions",),
    "test_distributed_fd_on_hardware": ("distributed_fd",),
    "test_shard_map_fused_sketch_on_hardware": ("shard_map_fused_sketch",),
    "test_distributed_cholqr_rsvd_on_hardware": ("distributed_cholqr_rsvd",),
    "test_saso_kernel_on_hardware": ("saso_kernel",),
    "test_kfjlt_on_hardware": ("kfjlt",),
    "test_tt_round_on_hardware": ("tt_round",),
    "test_tucker_on_hardware": ("tucker",),
    "test_ihs_lsq_on_hardware": ("ihs_lsq",),
}
COUNTERPART_CASES = tuple(c for cs in COUNTERPARTS.values() for c in cs)


# ------------------------------------------------------------ the branches


def load_mode(a: torch.Tensor) -> str:
    """How K1, K2 and K4 read A, by the rule of ``a_map``
    (csrc/fused_sketch.cu, csrc/saso_sketch.cu): a TMA map of row-major A
    ("tma_rows": unit column stride, a row stride of a multiple of 16
    bytes) or of column-major A ("tma_cols": the transposed rule), each on
    a 16-byte-aligned base; anything else the kernel loads element by
    element ("direct")."""
    es = a.element_size()
    m, n = a.shape
    sk, sn = a.stride()
    rows = sn == 1 and (sk * es) % 16 == 0
    cols = not rows and sk == 1 and (sn * es) % 16 == 0
    if not (rows or cols) or a.data_ptr() % 16 or m <= 0 or m >= 2 ** 31 \
            or n >= 2 ** 31:
        return "direct"
    return "tma_rows" if rows else "tma_cols"


def kernel_operand(kernel: str, a: torch.Tensor, co: int) -> torch.Tensor:
    """The A that the kernel reads: K1 pads an unaligned co_s with co_s % 4
    zero rows on top of A (ops/fused_sketch.py::_fused_plan), a new
    contiguous tensor (an empty stand-in here); K2 and K4 read A as it
    is."""
    if kernel == "K1" and co % 4:
        return torch.empty((a.shape[0] + co % 4, a.shape[1]), dtype=a.dtype)
    return a


def layout_view(make: Callable, layout: str, m: int, n: int):
    """An (m, n) A from ``make(shape)``: "rows" row-major, "cols" the
    transpose of a row-major (n, m), "offset" X[:, 1:] of a row-major
    (m, n + 1) (a base one element past an aligned one)."""
    if layout == "cols":
        return make((n, m)).T
    if layout == "offset":
        return make((m, n + 1))[:, 1:]
    return make((m, n))


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class FusedBranch:
    """B = alpha * S[ro:ro+d, co:co+m] @ A through K1 and through K2, with
    A (m, n) of ``dtype`` laid out as ``layout`` (``layout_view``) and S
    of the parent (d + ro + 3, m + co + 5) (a RowMajor-natural
    distribution for K1, a ColMajor-natural one for K2). ``mode``,
    ``cluster`` and ``splits`` are what the recorded card's occupancy
    gives (``branch_facts``)."""
    name: str
    d: int
    m: int
    n: int
    mode: str
    cluster: int
    splits: int
    dtype: str = "float32"
    layout: str = "rows"
    rng: str = "philox4x32"
    family: str = "Gaussian"
    alpha: float = 1.0
    ro: int = 0
    co: int = 0


FUSED_BRANCHES = (
    FusedBranch("cluster1", 200, 1000, 252, "tma_rows", 1, 1),
    FusedBranch("cluster2_cols_bf16_uniform", 130, 2000, 504, "tma_cols", 2,
                1, dtype="bfloat16", layout="cols", family="Uniform", ro=4,
                co=8),
    FusedBranch("cluster4_threefry_unaligned", 257, 1500, 1000, "tma_rows", 4,
                1, rng="threefry4x32", alpha=-0.75, ro=5, co=3),
    FusedBranch("cluster8_splits_uniform", 300, 4096, 1500, "tma_rows", 8, 4,
                family="Uniform", alpha=-0.75, co=4),
    FusedBranch("cluster8_cols", 300, 1000, 1600, "tma_cols", 8, 1,
                layout="cols"),
    FusedBranch("cluster16_splits_bf16", 100, 4096, 2104, "tma_rows", 16, 4,
                dtype="bfloat16", rng="threefry4x32", family="Uniform",
                alpha=-0.75, ro=3, co=8),
    FusedBranch("cluster16", 100, 1000, 2100, "tma_rows", 16, 1),
    FusedBranch("direct_ragged_n", 256, 2048, 4093, "direct", 16, 2),
    FusedBranch("direct_offset_base", 250, 3000, 700, "direct", 4, 1,
                layout="offset", ro=2, co=4),
    FusedBranch("direct_bf16", 129, 2500, 1001, "direct", 4, 1,
                dtype="bfloat16", rng="threefry4x32", alpha=-0.75),
    FusedBranch("below_one_tile", 50, 40, 100, "tma_rows", 1, 1, ro=1, co=2),
    # the panel ring steps PK = 2 TK: a last panel step half used, a
    # contraction shorter than one panel step or than one step of A, and
    # splits whose last range is short and ends inside a panel step
    FusedBranch("odd_steps_cols", 200, 7 * 64, 300, "tma_cols", 2, 1,
                layout="cols", ro=2),
    FusedBranch("below_one_panel_step", 130, 96, 2100, "tma_rows", 16, 1,
                ro=1),
    FusedBranch("below_one_step_cluster8", 130, 24, 1500, "tma_rows", 8, 1,
                ro=3),
    FusedBranch("splits_short_last", 300, 4096 + 3 * 64, 1500, "tma_rows",
                8, 4),
)


@dataclasses.dataclass(frozen=True)
class SasoBranch:
    """alpha * S @ A through K4 for a wide SASO (d, m) with k entries a
    column, A (m, n) of ``dtype`` laid out as ``layout``. ``mode``,
    ``kmax`` (the kernel's instantiation: 8 for k <= 8, else 16) and
    ``splits`` as on the recorded card."""
    name: str
    d: int
    m: int
    n: int
    k: int
    mode: str
    kmax: int
    splits: int
    dtype: str = "float32"
    layout: str = "rows"
    alpha: float = 1.0


SASO_BRANCHES = (
    SasoBranch("k1_splits", 513, 8192, 64, 1, "tma_rows", 8, 8),
    SasoBranch("k8_cols_bf16", 1000, 4096, 129, 8, "tma_cols", 8, 4,
               dtype="bfloat16", layout="cols", alpha=-0.5),
    SasoBranch("k16_direct", 1000, 1500, 130, 16, "direct", 16, 1),
    SasoBranch("k8_offset_bf16", 256, 3000, 200, 8, "direct", 8, 2,
               dtype="bfloat16", layout="offset"),
    SasoBranch("k16_bf16_d4000", 4000, 8192, 256, 16, "tma_rows", 16, 4,
               dtype="bfloat16"),
)


@dataclasses.dataclass(frozen=True)
class FillBranch:
    """A (rows, cols) block at (ro, co) of the operator (shape, family,
    major, rng) through K3, in each transform, bit for bit against the
    plain fill. A RowMajor-natural operator runs fill_block_kernel, a
    ColMajor-natural one fill_block_T_kernel. At the CPU scale every
    block of one layout has one shape (``_fill_geometry``)."""
    name: str
    shape: tuple
    block: tuple
    family: str = "Gaussian"
    major: str = "Long"
    rng: str = "philox4x32"


FILL_BRANCHES = (
    FillBranch("rows_unaligned_co", (1024, 8192), (64, 4001, 0, 3)),
    FillBranch("rows_wide_stores_threefry", (1024, 8192), (1000, 3000, 7, 4),
               "Uniform", rng="threefry4x32"),
    FillBranch("rows_few", (8, 5000), (5, 4999, 3, 1)),
    FillBranch("rows_past_grid_y", (300_000, 8), (299_990, 7, 5, 1),
               major="Short"),
    FillBranch("cols_natural", (3000, 500), (2999, 400, 1, 7)),
    FillBranch("cols_shift2_odd", (3000, 501), (2998, 397, 2, 3)),
    FillBranch("cols_few", (5000, 8), (4999, 5, 1, 3)),
    FillBranch("cols_past_grid_y_threefry", (4, 2_200_000),
               (3, 2_199_990, 1, 6), major="Short", rng="threefry4x32"),
    FillBranch("cols_wide_stores", (3000, 512), (2000, 256, 4, 0), "Uniform"),
)


@dataclasses.dataclass(frozen=True)
class Fill64Branch:
    """A (rows, cols) block at (ro, co) of the operator (shape, major) of
    an x64 seed of ``rng`` through K6, in each family, bit for bit against
    its plain version. A RowMajor-natural operator runs
    fill_block64_kernel, a ColMajor-natural one fill_block64_T_kernel.
    ``carry``: counter word 0 starts short of 2^64 by half the counters the
    block spans, so they carry into word 1 partway through it. The CPU
    scale takes ``_fill_geometry``'s shapes."""
    name: str
    shape: tuple
    block: tuple
    rng: str
    major: str = "Long"
    carry: bool = False


# K6's geometry, as csrc/x64_fill.cu sets it (test_torch_cuda_tier.py
# checks): natural rows a thread of fill_block64_kernel, counter blocks a
# CTA's step in fill_block64_T_kernel
K6_ROWS = 2
K6_T_STEP = 16

# a generator a geometry, each geometry in both families: each kernel runs
# its 8 instantiations (4 generators x 2 families)
FILL64_BRANCHES = (
    Fill64Branch("rows_shift3", (1024, 8192), (64, 4001, 0, 3),
                 "philox4x64"),
    Fill64Branch("rows_wide_stores", (1024, 8192), (1000, 3000, 7, 2),
                 "threefry4x64"),
    Fill64Branch("rows_carry", (512, 4096), (300, 4095, 5, 1), "philox2x64",
                 carry=True),
    Fill64Branch("rows_past_grid_y", (300_000, 8), (299_990, 6, 5, 2),
                 "threefry2x64", major="Short"),
    Fill64Branch("cols_wide_stores", (3000, 500), (2999, 400, 1, 7),
                 "philox4x64"),
    Fill64Branch("cols_shift2_odd", (3000, 501), (2998, 397, 2, 3),
                 "threefry4x64"),
    Fill64Branch("cols_carry", (5000, 64), (4999, 64, 1, 0), "philox2x64",
                 carry=True),
    Fill64Branch("cols_past_grid_y", (2_200_000, 3), (2_199_990, 3, 6, 0),
                 "threefry2x64"),
    # the redesign's geometry: odd row counts (a row past the edge in the
    # last group of K6_ROWS) under 16-byte stores of four- and two-word
    # blocks; T steps that end on the edge, and whose second blocks are
    # partly past it
    Fill64Branch("rows_wide_stores_tail", (1024, 8192), (63, 4990, 1, 6),
                 "philox4x64"),
    Fill64Branch("rows_pairs_odd", (1024, 8192), (101, 3000, 3, 4),
                 "philox2x64"),
    Fill64Branch("cols_step_whole", (3000, 500), (2048, 400, 0, 3),
                 "philox4x64"),
    Fill64Branch("cols_step_second_partly", (3000, 500), (2003, 64, 1, 0),
                 "threefry2x64"),
)


@dataclasses.dataclass(frozen=True)
class EllBranch:
    """alpha * E @ B through K5 for COO data (m, k, nnz entries seeded
    from the shapes; ``heavy``: row 3 also takes columns 0..25, 26 more
    entries in its first column block), B of n columns of ``dtype``;
    ``order`` "plain" (tables in natural order), "storage" (word-major
    tables, B in storage order) or "natural" (word-major tables, B in
    natural order)."""
    name: str
    m: int
    k: int
    nnz: int
    n: int
    bw: int
    order: str = "plain"
    heavy: bool = False
    dtype: str = "float32"
    alpha: float = 1.0


ELL_BRANCHES = (
    EllBranch("bw8", 2048, 4096, 40_000, 256, 8),
    EllBranch("bw32_vector", 1000, 2000, 20_000, 1, 32, heavy=True,
              alpha=-0.5),
    EllBranch("word_major_storage", 2048, 4100, 40_000, 64, 8,
              order="storage", alpha=-0.5),
    EllBranch("word_major_natural_bf16", 2048, 4100, 40_000, 33, 8,
              order="natural", dtype="bfloat16"),
)



@dataclasses.dataclass(frozen=True)
class FyBranch:
    """A lazy SparseSkOp (shape, k, major) seeded with ``rng``, filled
    through K7 by ``SparseSkOp.filled`` and by ``repeated_fisher_yates``,
    each bit for bit against the plain version on the same device, one K7
    launch a fill. ``carry``: counter word 0 (and word 1 of a four-word
    counter) starts just below its top, so the vectors' counters carry
    across words. ``index`` and ``dtype``: the operator's types. ``cpu``:
    (shape, k) of the CPU twin, the same axis and orientation, k at most
    12 (the JAX fill's compile time grows with k squared)."""
    name: str
    shape: tuple
    k: int
    cpu: tuple
    rng: str = "philox4x32"
    major: str = "Short"
    carry: bool = False
    index: str = "int32"
    dtype: str = "float32"


# each generator; k = 1, 8, 16 and past the register log (40, 100); whole
# permutations (k = dim_major) in registers and in scratch; dim_minor off
# K7's 256-thread block; int64 indices, float64 and float16 values; SASO
# and LASO, wide and tall
FY_BRANCHES = (
    FyBranch("philox4x32_saso_wide_k8", (1024, 65536), 8, ((64, 700), 8)),
    FyBranch("philox2x32_saso_tall_carry", (5000, 300), 4, ((300, 40), 4),
             rng="philox2x32", carry=True),
    FyBranch("threefry4x32_saso_wide_k16_carry", (200, 3001), 16,
             ((12, 301), 12), rng="threefry4x32", carry=True),
    FyBranch("threefry2x32_k1_float16", (256, 10007), 1, ((16, 333), 1),
             rng="threefry2x32", dtype="float16"),
    FyBranch("saso_tall_whole_permutation", (5000, 16), 16, ((300, 6), 6),
             carry=True),
    FyBranch("laso_wide_k40_int64_float64", (500, 4000), 40,
             ((12, 300), 10), major="Long", index="int64",
             dtype="float64"),
    FyBranch("laso_tall_whole_permutation", (100, 37), 100, ((7, 5), 7),
             rng="threefry4x32", major="Long", carry=True),
)

FILL_TRANSFORMS = ("boxmul_i32", "boxmul")
BRANCHES = {}
for _b in FUSED_BRANCHES:
    for _k in ("K1", "K2"):
        BRANCHES[f"{_k}-{_b.name}"] = (_k, _b)
for _b in SASO_BRANCHES:
    BRANCHES[f"K4-{_b.name}"] = ("K4", _b)
for _b in FILL_BRANCHES:
    for _x in FILL_TRANSFORMS:
        BRANCHES[f"K3-{_b.name}-{_x}"] = ("K3", (_b, _x))
for _b in ELL_BRANCHES:
    BRANCHES[f"K5-{_b.name}"] = ("K5", _b)
for _b in FILL64_BRANCHES:
    for _f in ("Gaussian", "Uniform"):
        BRANCHES[f"K6-{_b.name}-{_f}"] = ("K6", (_b, _f))
for _b in FY_BRANCHES:
    BRANCHES[f"K7-{_b.name}"] = ("K7", _b)


def _fused_dims(b: FusedBranch, scale):
    if scale == "card":
        return b.d, b.m, b.n, b.ro, b.co
    return 24, 260, 40, b.ro % 8, b.co % 8


def _fused_op(kernel, b: FusedBranch, scale, key):
    """S of the parent (d + ro + 3, m + co + 5) with the natural layout
    the kernel takes; at the CPU scale one parent for every branch, so
    that the JAX package's kernels (whose counter stride is static)
    compile once a configuration."""
    d, m, _, ro, co = _fused_dims(b, scale)
    rows, cols = (d + ro + 3, m + co + 5) if scale == "card" else (40, 280)
    if rows == cols:
        cols += 1
    major = "Long" if (rows < cols) == (kernel == "K1") else "Short"
    return dense_op(rows, cols, key, b.family, b.rng, major)


def _saso_dims(b: SasoBranch, scale):
    return (b.d, b.m, b.n) if scale == "card" else (100, 300, 17)


def _fill_geometry(b, scale):
    """(operator shape, major axis, block) of a K3 or K6 branch: at the
    CPU scale a (24, 261) block of a (40, 300) operator, or its transpose,
    with the card's layout and shift."""
    dist = rt.DenseDist(*b.shape, major_axis=rt.MajorAxis[b.major])
    if scale == "card":
        return b.shape, b.major, b.block
    ro, co = b.block[2] % 8, b.block[3] % 8
    if rt.dist_to_layout(dist) == rt.Layout.ColMajor:
        return (300, 40), "Long", (261, 24, ro, co)
    return (40, 300), "Long", (24, 261, ro, co)


def _fill_natural(b, w=4):
    """(colmajor, natural rows, natural cols, shift) of a K3 or K6 branch
    at its card shape, with w values a counter block."""
    dist = rt.DenseDist(*b.shape, major_axis=rt.MajorAxis[b.major])
    rows, cols, ro, co = b.block
    if rt.dist_to_layout(dist) == rt.Layout.ColMajor:
        return True, cols, rows, ro % w
    return False, rows, cols, co % w


def _fill64_facts(b: Fill64Branch, family) -> dict:
    """K6's kernel, generator, family, shift, store width (16-byte where
    the launcher's ``vec`` holds for an aligned output), carry and whether
    its loop passes grid.y's 65535 (natural: K6_ROWS rows a CTA;
    transposed: K6_T_STEP counter blocks), at the card shape; natural:
    whether the row count leaves a partial group of K6_ROWS; transposed:
    the last step's blocks ("whole", or its second blocks all or partly
    past the edge)."""
    w = rt.RNGState.from_key(0, b.rng).block_width
    colmajor, rows, cols, shift = _fill_natural(b, w)
    if colmajor:
        nblk = -(-(shift + cols) // w)
        tail = nblk % K6_T_STEP
        return dict(kernel="fill_block64_T_kernel", rng=b.rng, family=family,
                    shift=shift, wide_stores=rows % 2 == 0, carry=b.carry,
                    past_grid_y=-(-nblk // K6_T_STEP) > 65535,
                    last_step="whole" if tail == 0 else
                    "second blocks past" if tail <= K6_T_STEP // 2
                    else "second blocks partly past")
    wide = shift % 2 == 0 and cols % 2 == 0
    return dict(kernel="fill_block64_kernel", rng=b.rng, family=family,
                shift=shift, wide_stores=wide, carry=b.carry,
                past_grid_y=-(-rows // K6_ROWS) > 65535,
                row_tail=rows % K6_ROWS != 0)


# K7's block, as csrc/saso_fill.cu sets it (test_torch_cuda_tier.py
# checks): threads a CTA, one minor-axis vector a thread
K7_THREADS = 256


def _fy_op(b: FyBranch, scale) -> "rt.SparseSkOp":
    """The branch's lazy operator at ``scale``."""
    shape, k = (b.shape, b.k) if scale == "card" else b.cpu
    state = rt.RNGState.from_key(len(b.name) + k, b.rng)
    if b.carry:   # the low words just below their top
        words = list(state.counter)
        words[0] = 0xFFFFFFF0
        if len(words) == 4:
            words[1] = 0xFFFFFFFF
        state = rt.RNGState(tuple(words), state.key, b.rng)
    return rt.SparseSkOp(rt.SparseDist(*shape, k, rt.MajorAxis[b.major]),
                         state, dtype=getattr(torch, b.dtype),
                         index_dtype=getattr(torch, b.index))


def _fy_facts(b: FyBranch) -> dict:
    """K7's generator, k, log ("registers" or "scratch"), axis and
    orientation, whether the counters carry, whether the last CTA is
    partly past dim_minor, whether a vector is a whole permutation, and
    the types, at the card shape."""
    S = _fy_op(b, "card")
    dim_major, dim_minor = rt.sparse._dims(S.dist)
    return dict(rng=b.rng, k=b.k,
                log="registers" if saso_fill.log_in_registers(b.k)
                else "scratch",
                major=b.major,
                orientation="wide" if b.shape[0] <= b.shape[1] else "tall",
                carry=b.carry, block_tail=dim_minor % K7_THREADS != 0,
                whole_permutation=b.k == dim_major, index=b.index,
                dtype=b.dtype)


def _ell_dims(b: EllBranch, scale):
    if scale == "card":
        return b.m, b.k, b.nnz, b.n
    # word-major tables with k % 4 != 0 (phantom storage rows), as at 4100
    return 64, 300 if b.order == "plain" else 302, 600, min(b.n, 16)


def _ell_coo(b: EllBranch, scale):
    m, k, nnz, n = _ell_dims(b, scale)
    rng = np.random.default_rng(m + k + nnz)
    r, c = rng.integers(0, m, nnz), rng.integers(0, k, nnz)
    if b.heavy:
        r = np.concatenate([r, np.full(26, 3)])
        c = np.concatenate([c, np.arange(26)])
    v = rng.normal(size=r.shape[0]).astype(np.float32)
    return m, k, n, r, c, v


def branch_facts(bid: str, max_active=None, max_ctas=None) -> dict:
    """What branch ``bid`` reaches at its card shape on a card with the
    given occupancy (the recorded card's by default): K1/K2 the load mode
    and the launch plan's cluster and splits; K4 the load mode, KMAX and
    splits; K3 the kernel, the transform, the natural shift, whether its
    stores are 16-byte, its tile (K3T: 4 x 256 below 32 natural rows) and
    whether its row tiles pass grid.y's 65535; K5 the slot width, n, the
    order and alpha. Builds no data: A is an empty CPU stand-in."""
    kernel, b = BRANCHES[bid]
    max_active = CARD_MAX_ACTIVE_CLUSTERS if max_active is None \
        else max_active
    max_ctas = CARD_MAX_ACTIVE_CTAS if max_ctas is None else max_ctas
    if kernel in ("K1", "K2"):
        a = layout_view(lambda s: torch.empty(s, dtype=_DTYPES[b.dtype]),
                        b.layout, b.m, b.n)
        a = kernel_operand(kernel, a, b.co)
        shift = b.ro % 4 if kernel == "K2" else 0
        plan = fs.launch_plan(b.d, a.shape[0], b.n, shift, max_active)
        return dict(mode=load_mode(a), cluster=plan.cluster,
                    splits=plan.splits)
    if kernel == "K4":
        a = layout_view(lambda s: torch.empty(s, dtype=_DTYPES[b.dtype]),
                        b.layout, b.m, b.n)
        plan = saso.launch_plan(b.d, b.m, b.n, max_ctas)
        return dict(mode=load_mode(a), kmax=8 if b.k <= 8 else 16,
                    splits=plan.splits)
    if kernel == "K6":
        return _fill64_facts(*b)
    if kernel == "K7":
        return _fy_facts(b)
    if kernel == "K3":
        b, transform = b
        colmajor, rows, cols, shift = _fill_natural(b)
        if colmajor:
            tile_rows = 4 if rows < 32 else 32
            return dict(kernel="fill_block_T_kernel", transform=transform,
                        shift=shift, wide_stores=rows % 4 == 0,
                        tile=f"{tile_rows}x{1024 // tile_rows}",
                        past_grid_y=-(-rows // tile_rows) > 65535)
        return dict(kernel="fill_block_kernel", transform=transform,
                    shift=shift, wide_stores=cols % 4 == 0, tile="4 rows",
                    past_grid_y=-(-rows // 4) > 65535)
    m, k, n, r, c, v = _ell_coo(b, "card")
    bell = blocked(m, k, r, c, v, "cpu",
                   word_major=0 if b.order == "plain" else 4)
    return dict(bw=bell.bw, n=n, order=b.order, alpha=b.alpha)


def _branch_fused(kernel, b: FusedBranch, device, scale):
    d, m, n, ro, co = _fused_dims(b, scale)
    S = _fused_op(kernel, b, scale, key=len(b.name) + d)
    dtype = _DTYPES[b.dtype]
    A = layout_view(lambda s: on(normal(d + m, s), device, dtype), b.layout,
                    m, n)
    wrapper, reference = (
        (fs.fused_sketch, fs.fused_sketch_reference) if kernel == "K1" else
        (fs.fused_sketch_colmajor, fs.fused_sketch_colmajor_reference))
    kw = dict(alpha=b.alpha, rows_s=d, cols_s=m, ro_s=ro, co_s=co)
    with Tally() as t:
        got = wrapper(S, A, **kw)
        again = wrapper(S, A, **kw)
    want = reference(S, A, **kw)
    layout = rt.Layout.RowMajor if kernel == "K1" else rt.Layout.ColMajor
    dist = S.dist
    spec = dict(shape=(dist.n_rows, dist.n_cols), family=dist.family.name,
                major=dist.major_axis.name, state=S.seed_state.to_dict(),
                a=as_np(A), dtype=b.dtype, alpha=b.alpha,
                block=(d, m, ro, co))
    return t.outcome(
        [holds(f"S is {layout.name}-natural",
               rt.dist_to_layout(dist) == layout),
         holds(f"output {got.dtype} {tuple(got.shape)}",
               got.dtype == dtype and tuple(got.shape) == (d, n)),
         rel(f"{kernel} vs its plain version", got, want,
             BF16_REL_TOL if dtype == torch.bfloat16 else K1_REL_TOL),
         equal(f"{kernel} launched again, bit for bit", again, got)],
        {kernel: 2},
        oracles=[PortOracle(kernel.lower(), spec, as_np(want))])


def _branch_saso(b: SasoBranch, device, scale):
    d, m, n = _saso_dims(b, scale)
    S = sparse_op(d, m, b.k, d + m + b.k)
    s = S.filled(device)
    idx, vals = s.rows.reshape(m, b.k), s.vals.reshape(m, b.k)
    A = layout_view(lambda sh: on(normal(n + b.k, sh), device,
                                  _DTYPES[b.dtype]), b.layout, m, n)
    with Tally() as t:
        got = saso.saso_sketch(idx, vals, A, d, b.alpha)
    want = saso.saso_sketch_reference(idx, vals, A, d, b.alpha)
    spec = dict(idx=as_np(idx), vals=as_np(vals), a=as_np(A), d=d,
                alpha=b.alpha, dtype=b.dtype)
    return t.outcome([rel("K4 vs its plain version", got, want,
                          K4_REL_TOL)], {"K4": 1},
                     oracles=[PortOracle("k4", spec, as_np(want))])


def _branch_fill(b: FillBranch, transform, device, scale):
    shape, major, (rows, cols, ro, co) = _fill_geometry(b, scale)
    S = dense_op(*shape, len(b.name), b.family, b.rng, major)
    with Tally() as t:
        got = fs.fill_block(S, rows, cols, ro, co, device=device,
                            transform=transform)
    want, orc = fill_oracle(S, rows, cols, ro, co, transform, device)
    return t.outcome([holds("K3's block is contiguous", got.is_contiguous()),
                      equal(f"K3 vs the plain fill, {transform}", got, want)],
                     {"K3": 1}, oracles=[orc])


def _branch_fill64(b: Fill64Branch, family, device, scale):
    shape, major, block = _fill_geometry(b, scale)
    dist = rt.DenseDist(*shape, rt.DenseDistName[family], rt.MajorAxis[major])
    state = rt.RNGState.from_key(len(b.name), b.rng)
    if b.carry:  # word 0 wraps halfway through the block's counters
        p = x64_fill._plan64(dist, state, *block)
        span = (p.first.counter[0] | p.first.counter[1] << 32) \
            + p.rows * p.ctr_stride // 2
        words = [2 ** 64 - span, 7] + [0] * (p.w - 2)
        state = rt.RNGState.from_arrays(
            [v >> s & 0xFFFFFFFF for v in words for s in (0, 32)],
            state.key, b.rng)
    S = rt.DenseSkOp(dist, state)
    with Tally() as t:
        got = x64_fill.fill_block64(S, *block, device=device)
    want = x64_fill.fill_block64_reference(S, *block, device=device)
    spec = dict(shape=shape, family=family, major=major,
                state=state.to_dict(), block=block)
    return t.outcome([holds("K6's block is contiguous float64",
                            got.is_contiguous()
                            and got.dtype == torch.float64),
                      equal("K6 vs its plain version", got, want)],
                     {"K6": 1}, oracles=[PortOracle("fill64", spec,
                                                    as_np(want))])


def _branch_fy(b: FyBranch, device, scale):
    S = _fy_op(b, scale)
    d, st = S.dist, S.seed_state
    dim_major, dim_minor = rt.sparse._dims(d)
    types = dict(dtype=S.dtype, index_dtype=S.index_dtype)
    with Tally() as t:
        s = S.filled(device)
        idx, vals = rt.repeated_fisher_yates(st, d.vec_nnz, dim_major,
                                             dim_minor, device=device,
                                             **types)
    want_idx, want_vals = rt.sparse.repeated_fisher_yates_reference(
        st, d.vec_nnz, dim_major, dim_minor, device=device, **types)
    want_minor = torch.arange(dim_minor, dtype=S.index_dtype,
                              device=device).repeat_interleave(d.vec_nnz)
    # the sampling's major axis is the rows for a wide SASO and a tall LASO
    wide = d.n_rows <= d.n_cols
    major, minor = ((s.rows, s.cols) if wide == (b.major == "Short")
                    else (s.cols, s.rows))
    spec = dict(shape=(d.n_rows, d.n_cols), k=d.vec_nnz, major=b.major,
                state=st.to_dict(), index=b.index, dtype=b.dtype)
    value = tuple(as_np(x) for x in (s.rows, s.cols, s.vals))
    return t.outcome(
        [holds("filled: canonical triplets of the operator's types",
               s.canonical and s.rows.dtype == s.cols.dtype == S.index_dtype
               and s.vals.dtype == S.dtype),
         equal("filled: major indices vs the plain version", major,
               want_idx.reshape(-1)),
         equal("filled: minor indices", minor, want_minor),
         equal("filled: signs vs the plain version", s.vals,
               want_vals.reshape(-1)),
         equal("repeated_fisher_yates: indices vs the plain version", idx,
               want_idx),
         equal("repeated_fisher_yates: signs vs the plain version", vals,
               want_vals)],
        {"K7": 2}, oracles=[PortOracle("fy", spec, value)])


def _branch_ell(b: EllBranch, device, scale):
    m, k, n, r, c, v = _ell_coo(b, scale)
    word_major = 0 if b.order == "plain" else 4
    bell = blocked(m, k, r, c, v, device, word_major=word_major)
    rows = k if b.order == "natural" else bell.b_rows
    B = on(normal(n, (rows, n)), device, _DTYPES[b.dtype])
    order = "natural" if b.order == "natural" else "storage"
    with Tally() as t:
        got = ell.blocked_ell_matmul(bell, B, b.alpha, b_order=order)
    want = ell.blocked_ell_reference(bell, B, b.alpha, b_order=order)
    storage = B if b.order != "natural" else ell.to_word_major_rows(B, 4, k)
    spec = dict(m=m, k=k, rows=r, cols=c, vals=v, word_major=word_major,
                b=as_np(storage), alpha=b.alpha)
    return t.outcome([holds(f"slot width {bell.bw}", bell.bw == b.bw
                            or scale != "card"),
                      rel("K5 vs its plain version", got, want, K5_REL_TOL)],
                     {"K5": 1}, oracles=[PortOracle("k5", spec, as_np(want))])


def run_branch(bid: str, device, scale) -> Outcome:
    kernel, b = BRANCHES[bid]
    if kernel in ("K1", "K2"):
        return _branch_fused(kernel, b, device, scale)
    if kernel == "K4":
        return _branch_saso(b, device, scale)
    if kernel == "K3":
        return _branch_fill(*b, device, scale)
    if kernel == "K6":
        return _branch_fill64(*b, device, scale)
    if kernel == "K7":
        return _branch_fy(b, device, scale)
    return _branch_ell(b, device, scale)


def declared_facts(bid: str) -> dict:
    """The facts a branch declares for the recorded card (K3's, K5's, K6's
    and K7's follow from the shapes alone)."""
    kernel, b = BRANCHES[bid]
    if kernel in ("K1", "K2"):
        return dict(mode=b.mode, cluster=b.cluster, splits=b.splits)
    if kernel == "K4":
        return dict(mode=b.mode, kmax=b.kmax, splits=b.splits)
    if kernel == "K5":
        return dict(bw=b.bw, n=b.n, order=b.order, alpha=b.alpha)
    return branch_facts(bid)


def _panel_facts(kernel, b: FusedBranch, max_active) -> dict:
    """Where a K1/K2 branch's contraction ends against the panel ring's
    step PK: shorter than one step of A, than one panel step, or longer;
    its last panel step whole or part used; with several splits, the last
    range whole or short."""
    max_active = CARD_MAX_ACTIVE_CLUSTERS if max_active is None \
        else max_active
    a = kernel_operand(kernel, torch.empty((b.m, 0)), b.co)
    m = a.shape[0]
    shift = b.ro % 4 if kernel == "K2" else 0
    plan = fs.launch_plan(b.d, m, b.n, shift, max_active)
    steps = -(-m // fs.TK)
    last = steps - (plan.splits - 1) * plan.split_steps
    facts = {"contraction": ("< TK" if m < fs.TK else
                             "< PK" if m < fs.PK else ">= PK"),
             "last panel step": ("part" if last % (fs.PK // fs.TK)
                                 else "whole")}
    if plan.splits > 1:
        facts["last split"] = ("short" if last < plan.split_steps
                               else "whole")
    return facts


def grid_reach(max_active=None, max_ctas=None) -> dict:
    """(kernel, property) -> the values the branch grid reaches on a card
    with the given occupancy (the recorded card's by default)."""
    reach = collections.defaultdict(set)
    for bid, (kernel, b) in BRANCHES.items():
        f = branch_facts(bid, max_active, max_ctas)

        def add(prop, value):
            reach[kernel, prop].add(value)
        if kernel in ("K1", "K2"):
            add("mode", f["mode"])
            add("cluster", f["cluster"])
            add("splits", "1" if f["splits"] == 1 else ">1")
            add("dtype", b.dtype)
            add("rng", b.rng)
            add("family", b.family)
            add("alpha", "1" if b.alpha == 1 else "other")
            off = b.co if kernel == "K1" else b.ro   # K2's shift: ro % 4
            if off:
                add("offset", "aligned" if off % 4 == 0 else "unaligned")
            for dim, tile in (("d", fs.TI), ("m", fs.TK), ("n", fs.TN)):
                if getattr(b, dim) % tile:
                    add("off tile", dim)
            for prop, value in _panel_facts(kernel, b, max_active).items():
                add(prop, value)
        elif kernel == "K4":
            add("mode", f["mode"])
            add("splits", "1" if f["splits"] == 1 else ">1")
            add("k", b.k)
            add("kmax", f["kmax"])
            add("dtype", b.dtype)
        elif kernel == "K3":
            name = f["kernel"]
            add("kernel x transform", (name, f["transform"]))
            add(f"{name} shift", "0" if f["shift"] == 0 else ">0")
            add(f"{name} stores", "16-byte" if f["wide_stores"]
                else "4-byte")
            add(f"{name} tile", f["tile"])
            add(f"{name} past grid.y", f["past_grid_y"])
        elif kernel == "K6":
            name = f["kernel"]
            add("kernel x rng x family", (name, f["rng"], f["family"]))
            add(f"{name} shift", "0" if f["shift"] == 0 else ">0")
            add(f"{name} stores", "16-byte" if f["wide_stores"]
                else "8-byte")
            add(f"{name} carry", f["carry"])
            add(f"{name} past grid.y", f["past_grid_y"])
            for fact in ("row_tail", "last_step"):
                if fact in f:
                    add(f"{name} {fact}", f[fact])
        elif kernel == "K7":
            for fact, value in f.items():
                add(fact, value)
            add("axis x orientation", (f["major"], f["orientation"]))
            if f["whole_permutation"]:
                add("whole permutation log", f["log"])
        else:
            add("bw", f["bw"])
            add("n", "1" if f["n"] == 1 else ">1")
            add("order", f["order"])
            add("alpha", "1" if f["alpha"] == 1 else "other")
            add("dtype", b.dtype)
    return reach


def grid_required(max_active=None) -> dict:
    """What the grid must reach: every load mode, cluster size (16 only
    where the card runs clusters of 16) and split count of K1 and K2, with
    both data types, generators and families, alpha != 1, aligned and
    unaligned offsets and shapes off the tiles, contractions shorter than
    a step of A and than a panel step, a last panel step part used and a
    short last split; K4's load modes, splits,
    k in {1, 8, 16} (both KMAX) and bf16; K3's two kernels in both
    transforms, each with a shift, both store widths, its tiles and row
    tiles past grid.y; K5's bw 8 and 32, n = 1, every order, alpha != 1
    and bf16 B; K6's two kernels in each generator and family, each with
    and without a shift, both store widths, a carry past counter word 0
    and its loop past grid.y; the natural kernel's row count with and
    without a partial group; the transposed kernel's last step whole, with
    its second blocks past the edge, and partly past it; K7's four
    generators, k = 1, 8 and 16 in registers and k past them in scratch,
    SASO and LASO each wide and tall, counters with and without a carry, a
    partial last CTA, a whole permutation in registers and in scratch,
    both index types and 2-, 4- and 8-byte values."""
    max_active = CARD_MAX_ACTIVE_CLUSTERS if max_active is None \
        else max_active
    modes = {"tma_rows", "tma_cols", "direct"}
    need = {}
    for k in ("K1", "K2"):
        need.update({
            (k, "mode"): modes,
            (k, "cluster"): {1, 2, 4, 8} | ({16} if max_active.get(16)
                                           else set()),
            (k, "splits"): {"1", ">1"}, (k, "dtype"): set(_DTYPES),
            (k, "rng"): {"philox4x32", "threefry4x32"},
            (k, "family"): {"Gaussian", "Uniform"},
            (k, "alpha"): {"1", "other"},
            (k, "offset"): {"aligned", "unaligned"},
            (k, "off tile"): {"d", "m", "n"},
            (k, "contraction"): {"< TK", "< PK", ">= PK"},
            (k, "last panel step"): {"whole", "part"},
            (k, "last split"): {"whole", "short"}})
    need.update({("K4", "mode"): modes, ("K4", "splits"): {"1", ">1"},
                 ("K4", "k"): {1, 8, 16}, ("K4", "kmax"): {8, 16},
                 ("K4", "dtype"): set(_DTYPES)})
    kernels = ("fill_block_kernel", "fill_block_T_kernel")
    need[("K3", "kernel x transform")] = {(k, x) for k in kernels
                                          for x in FILL_TRANSFORMS}
    for k in kernels:
        need[("K3", f"{k} shift")] = {"0", ">0"}
        need[("K3", f"{k} stores")] = {"16-byte", "4-byte"}
        need[("K3", f"{k} past grid.y")] = {False, True}
    need[("K3", "fill_block_T_kernel tile")] = {"4x256", "32x32"}
    kernels64 = ("fill_block64_kernel", "fill_block64_T_kernel")
    need[("K6", "kernel x rng x family")] = {
        (k, g, f) for k in kernels64 for g in x64_fill.GEN_CODES
        for f in ("Gaussian", "Uniform")}
    for k in kernels64:
        need[("K6", f"{k} shift")] = {"0", ">0"}
        need[("K6", f"{k} stores")] = {"16-byte", "8-byte"}
        need[("K6", f"{k} carry")] = {False, True}
        need[("K6", f"{k} past grid.y")] = {False, True}
    need[("K6", "fill_block64_kernel row_tail")] = {False, True}
    need[("K6", "fill_block64_T_kernel last_step")] = {
        "whole", "second blocks past", "second blocks partly past"}
    need.update({("K7", "rng"): set(saso_fill.GEN_CODES),
                 ("K7", "k"): {1, 8, 16},
                 ("K7", "log"): {"registers", "scratch"},
                 ("K7", "axis x orientation"): {
                     (a, o) for a in ("Short", "Long")
                     for o in ("wide", "tall")},
                 ("K7", "carry"): {False, True},
                 ("K7", "block_tail"): {True},
                 ("K7", "whole permutation log"): {"registers", "scratch"},
                 ("K7", "index"): {"int32", "int64"},
                 ("K7", "dtype"): {"float16", "float32", "float64"}})
    need.update({("K5", "bw"): {8, 32}, ("K5", "n"): {"1", ">1"},
                 ("K5", "order"): {"plain", "storage", "natural"},
                 ("K5", "alpha"): {"1", "other"},
                 ("K5", "dtype"): set(_DTYPES)})
    return need
