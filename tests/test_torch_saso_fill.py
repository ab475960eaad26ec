"""K7, the one-launch sparse-sign fill (``ops/saso_fill.py``), on the CPU:
the route (a CPU fill takes the plain version and never loads the kernel
library; a CUDA fill hands its arguments to K7's wrapper, stood in for here
by the plain version, and never takes the plain path), the wrapper's
pure-Python choices (the register or scratch log, the seed's words, the
sign patterns), the argument checks that raise before any launch, and the
SASS census that gives K7's operations bound (kernel_variants.py) on a
canned excerpt. The kernel itself runs only on a card:
tests/test_torch_cuda_hardware.py holds its ``K7-*`` branches bit for bit
against the plain version there, and their CPU twins
(tests/test_torch_cuda_tier.py) hold the plain version against the JAX
package.
"""

import io
import sys
from pathlib import Path

import pytest
import torch

import randblas_tpu_torch as rt
from randblas_tpu_torch import sparse
from randblas_tpu_torch.ops import _build, saso_fill

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import kernel_variants as kv  # noqa: E402

# two K7 instantiations: Threefry4x32 with the register log (straight
# line: an early exit, a forward branch, the trap loop after EXIT), and
# Philox4x32 with the scratch log, which the census leaves out
K7_SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_116saso_fill_kernelILi2ELi16EEEvNS_3OutEN4r1234SeedElijP5uint2
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
        /*0010*/              @P0 EXIT ;                                   /* 0x000000000000094d */
        /*0020*/                   IADD3 R4, R2, R3, RZ ;                  /* 0x0000000000007919 */
        /*0030*/                   LOP3.LUT R5, R4, R6, R7, 0x96, !PT ;    /* 0x0000000000007919 */
        /*0040*/              @!P1 BRA `(.L_x_1) ;                         /* 0x0000000000007919 */
        /*0050*/                   I2F.U32.RP R8, R9 ;                     /* 0x0000000000007919 */
        /*0060*/                   MUFU.RCP R8, R8 ;                       /* 0x0000000000007919 */
.L_x_1:
        /*0070*/                   IMAD.HI.U32 R10, R8, R9, RZ ;           /* 0x0000000000007919 */
        /*0080*/                   SEL R11, R10, R12, !P2 ;                /* 0x0000000000007919 */
        /*0090*/                   STG.E desc[UR4][R2.64], R11 ;           /* 0x0000000000007919 */
        /*00a0*/                   EXIT ;                                  /* 0x0000000000007919 */
.L_x_2:
        /*00b0*/                   BRA `(.L_x_2);                          /* 0x0000000000007919 */
        /*00c0*/                   NOP;                                    /* 0x0000000000007919 */
		..........
		Function : _ZN12_GLOBAL__N_116saso_fill_kernelILi0ELi0EEEvNS_3OutEN4r1234SeedElijP5uint2
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   IADD3 R4, R2, R3, RZ ;                  /* 0x0000000000007919 */
        /*0010*/                   EXIT ;                                  /* 0x0000000000007919 */
		..........
"""


def _op(shape, k, major="Short", rng="philox4x32", **types):
    return rt.SparseSkOp(rt.SparseDist(*shape, k, rt.MajorAxis[major]),
                         rt.RNGState.from_key(11, rng), **types)


@pytest.fixture
def no_library(monkeypatch):
    def load():
        raise AssertionError("the kernel library was loaded")
    monkeypatch.setattr(_build, "load", load)


def test_cpu_fill_takes_the_plain_version(no_library):
    """Every CPU fill (filled, fill_sparse, repeated_fisher_yates,
    materialize, transpose, print_sparse) runs the plain version: no K7
    launch, no library."""
    before = saso_fill.saso_fill.launches
    S = _op((12, 300), 5)
    s = S.filled("cpu")
    idx, vals = sparse.repeated_fisher_yates_reference(
        S.seed_state, 5, 12, 300, device="cpu")
    assert torch.equal(s.rows, idx.reshape(-1))
    assert torch.equal(s.vals, vals.reshape(-1))
    got = rt.repeated_fisher_yates(S.seed_state, 5, 12, 300, device="cpu")
    assert torch.equal(got[0], idx) and torch.equal(got[1], vals)
    rt.fill_sparse(S, device="cpu")
    S.materialize(device="cpu")
    S.transpose(device="cpu")
    rt.print_sparse(S, file=io.StringIO(), device="cpu")
    assert saso_fill.saso_fill.launches == before


@pytest.mark.parametrize("k,registers", [(1, True), (2, True), (3, True),
                                         (8, True), (9, True), (16, True),
                                         (17, False), (40, False),
                                         (5000, False)])
def test_log_follows_k(k, registers):
    """K7 keeps the log of up to 16 steps in registers, in scratch past
    that."""
    assert saso_fill.log_in_registers(k) is registers


def test_census_counts_each_register_log_kernel_whole():
    """The census takes the register-log instantiations only, each whole
    (no loop), by pipe class. 132 * 64 vectors at 1 kHz: the alu pipe's 3
    operations a vector take 3 ms at 64 a clock and SM, the mufu pipe's
    one 4 ms at 16, and the busiest pipe bounds."""
    census = kv.k7_census_of(K7_SASS)
    assert set(census) == {("threefry4x32", 16)}
    c = census[("threefry4x32", 16)]
    assert not c["loop"]
    assert c["per_vector"] == {"alu": 3, "branch": 4, "conv": 1, "imad": 1,
                               "mem": 2, "mufu": 1}
    assert c["instructions"] == 12
    ms = kv.operations_ms(c["per_vector"], 132 * 64, 1e3)
    assert ms["alu"] == pytest.approx(3.0)
    assert kv.operations_bound(c["per_vector"], 132 * 64, 1e3) == (
        pytest.approx(4.0), "mufu")


def test_census_generators_and_guard_are_the_kernels():
    """The census' generator order is the wrapper's codes, and the step
    guard it fixes at k is in csrc/saso_fill.cu once: in the unrolled
    register-log steps."""
    assert {g: i for i, g in enumerate(kv.K7_GEN_NAMES)} == \
        saso_fill.GEN_CODES
    src = (REPO / "randblas_tpu_torch" / "csrc" / "saso_fill.cu").read_text()
    assert src.count(kv.K7_STEP_GUARD) == 1


def test_seed_words_pad_each_generator():
    st = rt.RNGState((1, 2), (3,), "philox2x32")
    assert saso_fill.seed_words(st) == (1, 2, 0, 0, 3, 0, 0, 0)
    st = rt.RNGState((1, 2, 3, 4), (5, 6, 7, 8), "threefry4x32")
    assert saso_fill.seed_words(st) == (1, 2, 3, 4, 5, 6, 7, 8)


@pytest.mark.parametrize("dtype,plus,minus", [
    (torch.float32, 0x3F800000, 0xBF800000),
    (torch.float64, 0x3FF0000000000000, 0xBFF0000000000000),
    (torch.float16, 0x3C00, 0xBC00),
    (torch.bfloat16, 0x3F80, 0xBF80),
])
def test_sign_bits(dtype, plus, minus):
    assert saso_fill._sign_bits(dtype) == (plus, minus)


@pytest.mark.parametrize("change,match", [
    (dict(state=rt.RNGState.from_key(1, "philox4x64")), "generators"),
    (dict(vec_nnz=0), "vec_nnz"),
    (dict(vec_nnz=13), "vec_nnz"),
    (dict(dim_major=2 ** 31, vec_nnz=4), "dim_major"),
    (dict(dim_minor=-1), "dim_minor"),
    (dict(index_dtype=torch.int16), "int32 or int64"),
    (dict(dim_minor=2 ** 31 + 1), "dim_minor <= 2\\*\\*31"),
    (dict(dtype=torch.int32), "floating type"),
    (dict(dtype=torch.complex64), "floating type"),
    (dict(device="cpu"), "CUDA device"),
])
def test_wrapper_rejects_what_k7_does_not_take(no_library, change, match):
    args = dict(state=rt.RNGState.from_key(1), vec_nnz=4, dim_major=12,
                dim_minor=30, dtype=torch.float32, index_dtype=torch.int32,
                device="cuda")
    args.update(change)
    before = saso_fill.saso_fill.launches
    with pytest.raises(ValueError, match=match):
        saso_fill.saso_fill(**args)
    assert saso_fill.saso_fill.launches == before


@pytest.mark.parametrize("shape,major", [
    ((12, 300), "Short"), ((300, 12), "Short"),   # SASO wide, tall
    ((12, 300), "Long"), ((300, 12), "Long"),     # LASO wide, tall
])
def test_cuda_fill_takes_k7(monkeypatch, shape, major):
    """On a CUDA device ``filled`` and ``repeated_fisher_yates`` call K7's
    wrapper once a fill with the operator's draw and types, and orient its
    output as the plain fill does; the plain version does not run."""
    calls = []
    plain = sparse.repeated_fisher_yates_reference

    def stand_in(state, k, dim_major, dim_minor, dtype, index_dtype, device):
        calls.append((k, dim_major, dim_minor, dtype, index_dtype,
                      torch.device(device).type))
        idx, vals = plain(state, k, dim_major, dim_minor, dtype, index_dtype,
                          "cpu")
        mnr = torch.arange(dim_minor, dtype=index_dtype).repeat_interleave(k)
        return idx.reshape(-1), mnr, vals.reshape(-1)

    def no_plain(*args, **kwargs):
        raise AssertionError("a CUDA fill took the plain version")

    types = dict(dtype=torch.float64, index_dtype=torch.int64)
    S = _op(shape, 7, major, "threefry2x32", **types)
    want = S.filled("cpu")
    dims = sparse._dims(S.dist)
    monkeypatch.setattr(saso_fill, "saso_fill", stand_in)
    monkeypatch.setattr(sparse, "repeated_fisher_yates_reference", no_plain)
    got = S.filled("cuda")
    idx, vals = rt.repeated_fisher_yates(S.seed_state, 7, *dims,
                                         device="cuda", **types)
    for name in ("rows", "cols", "vals"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert got.canonical
    monkeypatch.setattr(sparse, "repeated_fisher_yates_reference", plain)
    w_idx, w_vals = plain(S.seed_state, 7, *dims, device="cpu", **types)
    assert torch.equal(idx, w_idx) and torch.equal(vals, w_vals)
    assert calls == [(7, *dims, *types.values(), "cuda")] * 2


@pytest.mark.parametrize("failure", ["no_nvcc", "build_fails"])
def test_cuda_fill_raises_when_the_library_fails(monkeypatch, failure):
    """No fallback: when the kernel library cannot be built, a CUDA fill
    raises, and the plain version does not fill instead."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def build_fails():
        raise RuntimeError("nvcc failed (exit 1)")

    def no_plain(*args, **kwargs):
        raise AssertionError("a CUDA fill took the plain version")

    monkeypatch.setattr(sparse, "repeated_fisher_yates_reference", no_plain)
    monkeypatch.setattr(_build, "_lib", None)
    if failure == "no_nvcc":
        monkeypatch.setattr(_build, "_nvcc", no_nvcc)
        monkeypatch.setattr(_build, "_digest", lambda: "never built")
    else:
        monkeypatch.setattr(_build, "_ensure_built", build_fails)
    before = saso_fill.saso_fill.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        _op((16, 64), 4).filled("cuda")
    assert saso_fill.saso_fill.launches == before
