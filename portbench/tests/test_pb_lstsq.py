"""The ``lsq_saso.solve`` cell on the CPU at 16384 x 256, d = 512 (every
other setting as the benchmark states it): found by name, run through the
harness untraced and traced, its spans and counts read, its work counted
from the steps, and not correct under its control and under each fault a
solve can have. The cell's limits are the full size's: smaller systems
read the program's ``x_rel_err`` up to 2e-3 and the control's
``resid_excess`` down to 0.03 (2048 x 64), so neither limit would mean
there what it means at 131072 x 2048."""

import copy
import json
import time

import pytest
import torch

from randblas_tpu_torch import linalg, profiling
from portbench import harness, roofline, run as prun
from portbench.reference import sketch as refsketch

CELL = "lsq_saso.solve"
SEED = 2 ** 31 + 23
SOUND = linalg.sketch_and_precondition
SOLVER_SPANS = ("sketch_and_precondition", "precondition", "cgls",
                "cgls.step")
M, N, D = 16384, 256, 512


def tiny() -> dict:
    """The cell's spec at M x N, d = D, stating the routes the CPU
    takes (the plain fixed-nnz sketch of A and of b) and no launch."""
    spec = harness.find_cell(CELL)
    call = spec.pop("call")
    spec = copy.deepcopy(spec)
    spec["call"] = call
    spec["config"]["system"].update(rows=M, cols=N)
    spec["config"]["operator"].update(m=M, d=D)
    spec["expect"].update(routes={"sparse_fixed_nnz": 2}, launches={})
    return spec


def _run(spec, traced, seed=SEED):
    part = harness.run(spec, seed, 0.2, traced, "cpu", time.time())
    return part, prun.result(spec, [part], traced, "cpu")


def test_the_cell_is_found_by_name():
    spec = harness.find_cell(CELL)
    assert spec["call"].__file__ == str(harness.ROOT / "calls" / "lstsq.py")
    assert spec["config"]["call"] == "lstsq"
    assert spec["config"]["reduced"] == [] and spec["cell"]["chips"] == 1
    assert {m["name"] for m in spec["end_to_end"]} == {
        "call_ms.host_paced", "call_p95_ms.host_paced", "peak_mem_gib",
        "setup_s"}
    # the accepted host-paced trace metrics list no cells, so they are
    # this cell's too; the solver's own list this cell alone
    assert [m["name"] for m in spec["per_layer"]] == [
        "idle_pct.host_paced", "roofline_pct.host_paced",
        "kernels_per_call.host_paced", "cgls_steps", "precond_ms",
        "cgls_step_ms"]
    for m in spec["per_layer"][3:]:
        assert m["workloads"] == [CELL]
        assert m["layer"] == "solver (linalg/lstsq.py)"
    assert spec["call"].precision(spec["config"], spec["expect"]) == \
        "float32"
    assert refsketch.BELOW["float32"] == "tf32"


@pytest.mark.parametrize("fault", ["mesh", "operator", "traffic",
                                   "limits"])
def test_check_refuses_what_a_solve_cannot_take(fault):
    spec = tiny()
    if fault == "mesh":
        spec["config"]["chips"] = 4
    elif fault == "operator":
        spec["config"]["operator"]["kind"] = "dense"
    elif fault == "traffic":
        spec["traffic"]["rhs"] = "reused"
    else:
        spec["expect"]["limits"] = {"rel_fro": 1e-3, "max_rel": 1e-2}
    with pytest.raises(ValueError):
        spec["call"].check(spec)


def test_every_call_gets_a_key_and_a_b_of_its_own():
    spec = tiny()
    wl = spec["call"].Call(spec["config"], spec["traffic"], SEED, "cpu")
    assert len({wl.key(i) for i in range(-2, 40)}) == 42
    b0, b16 = wl.rhs(0), wl.rhs(16)
    assert torch.equal(wl.rhs(0), b0)          # made again for the judge
    assert not torch.equal(b0, b16)            # one bank column, new noise
    noise = spec["config"]["system"]["noise"]
    assert float((b0 - b16).abs().max()) < 20 * noise


def test_untraced_run_is_correct_and_counts_nothing():
    spec = tiny()
    part, res = _run(spec, False)
    assert res["correct"] and res["attempted"] > 0
    assert set(res["checks"]) == {"x_rel_err", "resid_excess"}
    assert set(res["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert part["spans"] == {} and part["counts"] == {}
    assert prun._route_line(spec, [part])[1] is False


def test_traced_run_reads_the_solver():
    """The span window gives each solve's time up to its first convergence
    test and each step's; the traced window counts the steps, which the
    least time counts."""
    spec = tiny()
    part, res = _run(spec, True)
    assert res["correct"]
    spans, steps = part["spans"], part["counts"]["cgls_steps"]
    assert len(steps) == part["window"]["attempted"] and min(steps) >= 1
    span_calls = part["attempted"] - part["window"]["attempted"]
    assert len(spans["precondition"]) == span_calls > 0
    assert len(spans["cgls_step"]) >= span_calls
    assert min(spans["precondition"] + spans["cgls_step"]) > 0
    mean = sum(steps) / len(steps)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got["cgls_steps"] == mean
    assert got["precond_ms"] == pytest.approx(
        1e3 * sum(spans["precondition"]) / span_calls)
    assert got["cgls_step_ms"] == pytest.approx(
        1e3 * sum(spans["cgls_step"]) / len(spans["cgls_step"]))
    ops, nbytes = spec["call"].work(spec["config"], part["counts"])
    assert nbytes == (1 + 2 * mean) * M * N * 4
    assert ops > mean * 4 * M * N
    assert prun._summary(spec, [part])["least_s"] == \
        roofline.least_seconds(ops, nbytes, 1, "float32")
    assert harness.least_seconds(spec, {}) < \
        harness.least_seconds(spec, part["counts"])


def test_a_port_without_the_solver_spans_reads_none_of_them(monkeypatch):
    """A version of the port whose solver records no span (the one before
    them) runs the cell correct, traced too; its line leaves out the span
    metrics and keeps the step count, which the solver returns."""
    plain = profiling.span

    def span(name, **args):
        return profiling._OFF if name in SOLVER_SPANS else plain(name,
                                                                 **args)
    monkeypatch.setattr(profiling, "span", span)
    part, res = _run(tiny(), True)
    assert res["correct"] and part["spans"] == {}
    assert "cgls_steps" in res["metrics"]
    assert not {"precond_ms", "cgls_step_ms"} & set(res["metrics"])


def test_spans_that_disagree_with_the_steps_raise():
    spec = tiny()
    wl = spec["call"].Call(spec["config"], spec["traffic"], SEED, "cpu")
    spans = {}
    wl.call(0, spans)
    with profiling.recording() as rec:
        _, steps, _ = wl.solve(wl.rhs(1), wl.key(1))
    with pytest.raises(RuntimeError):
        spec["call"]._read_spans(rec.spans, steps + 1, spans)
    assert len(spans["precondition"]) == 1


def test_the_control_is_not_correct():
    """The reference one precision below the call's (TF32 products over A
    and a TF32 sketch) fails the cell's limits, where the program meets
    them."""
    spec = tiny()
    limits = spec["expect"]["limits"]
    wl = spec["call"].Call(spec["config"], spec["traffic"], SEED, "cpu")
    for i in range(3):
        exact = wl.exact_part(i)
        prog = wl.judge(i, wl.call(i), exact)
        assert all(prog[k] <= v for k, v in limits.items()), prog
        got = wl.judge(i, wl.control_part(i, "tf32"), exact, control=True)
        assert any(got[k] > v for k, v in limits.items()), got


def stopped_early(a, b, state, **kw):
    """CGLS stopped at 1e4 times the stated tolerance."""
    return SOUND(a, b, state, **dict(kw, tol=kw["tol"] * 1e4))


def warm_start_only(a, b, state, **kw):
    """The warm start's sketch-and-solve x, returned without CGLS."""
    x, nxt = linalg.sketch_and_solve_lsq(a, b, kw["d"], state,
                                         operator=kw["operator"],
                                         vec_nnz=kw["vec_nnz"])
    return x, 0, nxt


def altered(a, b, state, **kw):
    """One entry of x moved by the solution's own spread."""
    x, steps, nxt = SOUND(a, b, state, **kw)
    x = x.clone()
    x[3] += x.std()
    return x, steps, nxt


@pytest.mark.parametrize("fault", [stopped_early, warm_start_only,
                                   altered])
def test_fault_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(linalg, "sketch_and_precondition", fault)
    _, res = _run(tiny(), False)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_the_config_states_its_source_and_cuts():
    conf = json.loads((harness.ROOT / "configs" /
                       "lsq_saso.json").read_text())
    bench = json.loads(harness.BENCHMARK.read_text())
    entry = {c["name"]: c for c in bench["configs"]}["lsq_saso"]
    assert conf["source"] == entry["source"] and conf["reduced"] == []
    assert len(conf["assumed"]) == 4
    assert conf["solver"] == {
        "entry": "randblas_tpu_torch.linalg.sketch_and_precondition",
        "warm_start": True, "tol_eps": 100, "maxiter": 200}
    assert conf["operator"]["d"] == 2 * conf["system"]["cols"]
