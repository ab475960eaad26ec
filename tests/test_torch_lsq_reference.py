"""The port's sketch-and-precondition least squares against the benchmark's
plain float64 reference (``portbench/reference/lstsq.py``), on the CPU at
4096 x 64 with cond(A) ~ 1e3, the system the ``lsq_saso`` configuration
states at a size a CPU test holds; and the solver's spans.

Bounds, each with its reason:

- ``X_REL_ERR`` 5e-3 on ||x - x*|| / ||x*||: CGLS stops at 100 eps of
  float32 of the preconditioned normal residual, and cond(A) ~ 1e3
  carries that into x (``chip_smoke.py`` (j) allows 1e-2); seeds 0-5
  read 4.8e-4 - 1.2e-3 here.
- ``RESID_EXCESS`` 1e-2 on ||b - A x|| / ||b - A x*|| - 1: a solve stopped
  by that rule leaves the residual within 5e-4 of the optimum here; the
  tf32 control reads 0.04 - 0.29 and sketch-and-solve alone 0.33 - 0.63.
"""

import sys
from pathlib import Path

import pytest
import torch

import randblas_tpu_torch as rt
from randblas_tpu_torch import linalg, profiling

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from portbench.reference import lstsq as reflsq  # noqa: E402

M, N, D, K = 4096, 64, 128, 8
X_REL_ERR = 5e-3
RESID_EXCESS = 1e-2
EPS = torch.finfo(torch.float32).eps


def _system(seed):
    """float32 A (M, N), N(0, 1) columns scaled by logspace(0, -3), and
    b = A x + 1e-3 e."""
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(M, N, generator=gen) * torch.logspace(0, -3, N)
    x = torch.randn(N, generator=gen)
    return a, a @ x + 1e-3 * torch.randn(M, generator=gen)


def _numbers(a, b, x, x_star):
    x = x.to(torch.float64)
    return (float((x - x_star).norm() / x_star.norm()),
            reflsq.residual(a, x, b) / reflsq.residual(a, x_star, b) - 1.0)


def _solve(a, b, seed):
    return linalg.sketch_and_precondition(
        a, b, rt.RNGState.from_key(100 + seed), operator="saso",
        vec_nnz=K, d=D)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sketch_and_precondition_reaches_the_float64_optimum(seed):
    a, b = _system(seed)
    x, steps, _ = _solve(a, b, seed)
    err, excess = _numbers(a, b, x, reflsq.exact(a, b))
    assert steps >= 1
    assert err <= X_REL_ERR and excess <= RESID_EXCESS, (err, excess)


@pytest.mark.parametrize("seed", [0, 1])
def test_exact_is_float64_lstsq(seed):
    a, b = _system(seed)
    got = reflsq.exact(a, b, reflsq.factor(a))
    want = torch.linalg.lstsq(a.double(), b.double()[:, None]).solution
    assert float((got - want[:, 0]).norm() / want.norm()) <= 1e-10


@pytest.mark.parametrize("seed", [0, 1])
def test_the_control_reads_worse_than_the_limit(seed):
    """The reference in TF32, one step below the call's float32, fails the
    residual bound that the program meets."""
    a, b = _system(seed)
    x = reflsq.control(a, b, 100 + seed, "tf32", d=D, vec_nnz=K,
                       tol=100 * EPS, maxiter=200)
    _, excess = _numbers(a, b, x, reflsq.exact(a, b))
    assert excess > RESID_EXCESS


def _kids(spans, index):
    return [s for s in spans if s.parent == index]


def _ancestors(spans, span):
    names = []
    while span.parent is not None:
        span = spans[span.parent]
        names.append(span.name)
    return names


def test_solver_span_tree():
    """sketch_and_precondition holds precondition and cgls; cgls holds one
    cgls.step a step, numbered, and records the count returned; the
    sketch's own spans sit under precondition."""
    a, b = _system(0)
    with profiling.recording() as rec:
        x, steps, _ = _solve(a, b, 0)
    spans = rec.spans
    outer = [i for i, s in enumerate(spans)
             if s.name == "sketch_and_precondition"]
    assert len(outer) == 1 and spans[outer[0]].parent is None
    assert spans[outer[0]].args == {"operator": "saso", "d": D}
    top = [s.name for s in _kids(spans, outer[0])]
    assert top == ["precondition", "cgls"]
    cgls = next(i for i, s in enumerate(spans) if s.name == "cgls")
    assert spans[cgls].args == {"steps": steps}
    step_spans = _kids(spans, cgls)
    assert [s.name for s in step_spans] == ["cgls.step"] * steps
    assert [s.args["j"] for s in step_spans] == list(range(steps))
    sketches = [s for s in spans if s.name in ("sketch", "route", "fill")]
    assert sketches
    assert all("precondition" in _ancestors(spans, s) for s in sketches)
    assert all(s.start_ns <= s.end_ns for s in spans)


def test_ridge_records_the_cgls_spans():
    a, b = _system(1)
    with profiling.recording() as rec:
        _, steps, _ = linalg.ridge_lsq(a, b, 1e-3, rt.RNGState.from_key(7),
                                       d=D)
    names = [s.name for s in rec.spans]
    assert "sketch_and_precondition" not in names
    assert names.count("cgls") == 1 and names.count("cgls.step") == steps
    cgls = next(s for s in rec.spans if s.name == "cgls")
    assert cgls.args == {"steps": steps}


def test_spans_off_record_nothing_and_change_nothing():
    a, b = _system(2)
    assert profiling.span("cgls") is profiling.span("cgls.step", j=0)
    x_off, steps_off, _ = _solve(a, b, 2)
    assert profiling._recording is None
    with profiling.recording() as rec:
        x_on, steps_on, _ = _solve(a, b, 2)
    assert rec.spans
    assert steps_on == steps_off
    assert torch.equal(x_on, x_off)
