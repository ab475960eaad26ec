"""The last line's keys and what decides ``correct``."""

import json
import math

import pytest

from portbench import harness, run as prun

CELL = "dense_gauss_f32.whole"


def _part(checks, traced=False, failed=0):
    summary = {"window_s": 10.0, "busy_s": 9.0, "kernels": 2000,
               "ops_s": {"k1": 8.5, "reduce": 0.5},
               "gaps_s": {"cudaStreamSynchronize": 1.0}} if traced else None
    return {"rank": 0, "setup_s": 6.5,
            "window": {"seconds": 10.0, "attempted": 1000, "failed": failed},
            "attempted": 1000, "failed": failed,
            "call_p95_s": 0.0105, "peak_setup": 2 << 30,
            "peak_window": 3 << 29, "routes": {"left_fused": 1000},
            "launches": {"K1": 1000}, "summary": summary,
            "spans": {}, "counts": {}, "checks": checks, "lines": [],
            "forbidden": []}


GOOD = {"rel_fro": 0.0024, "max_rel": 0.014}


def test_trace0_line():
    spec = harness.find_cell(CELL)
    res = prun.result(spec, [_part(GOOD)], False, "NVIDIA H100 80GB HBM3")
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True
    assert set(res["metrics"]) == {"call_ms", "call_p95_ms", "peak_mem_gib",
                                   "setup_s"}
    assert res["metrics"]["call_ms"] == {"value": 10.0, "unit": "ms"}
    assert res["metrics"]["peak_mem_gib"]["value"] == 1.5
    assert res["device"] == {"platform": "gpu",
                             "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                             "memory_peak_bytes": 2 << 30}
    assert set(res["checks"]) == set(spec["expect"]["limits"])
    json.dumps(res)


def test_trace1_line():
    spec = harness.find_cell(CELL)
    res = prun.result(spec, [_part(GOOD, traced=True)], True, "card")
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert set(res["metrics"]) == {"idle_pct", "roofline_pct",
                                   "kernels_per_call"}
    assert res["device"]["busy_s"] == 9.0
    assert res["device"]["window_s"] == 10.0
    assert res["breakdown"]["device_ops"][0] == ["k1", 8.5]
    assert res["metrics"]["kernels_per_call"]["value"] == 2.0


@pytest.mark.parametrize("checks,failed", [
    ({"rel_fro": 0.5, "max_rel": 0.014}, 0),
    ({"rel_fro": 0.0024, "max_rel": math.inf}, 0),
    ({"rel_fro": math.nan, "max_rel": 0.014}, 0),
    (GOOD, 1)])
def test_incorrect(checks, failed):
    spec = harness.find_cell(CELL)
    assert prun.result(spec, [_part(checks, failed=failed)], False,
                       "card")["correct"] is False


def test_a_failed_call_of_the_span_window_counts():
    """A traced run's untraced span window adds its calls to the part's
    totals; one that raised there makes the run not correct."""
    spec = harness.find_cell(CELL)
    part = dict(_part(GOOD), attempted=2100, failed=1)
    res = prun.result(spec, [part], False, "card")
    assert res["attempted"] == 2100 and res["failed"] == 1
    assert res["correct"] is False


@pytest.mark.parametrize("where", ["this process", "a rank"])
def test_jax_loaded_refuses_the_result(where, monkeypatch, capsys):
    spec = harness.find_cell(CELL)
    parts = [_part(GOOD), _part(GOOD)]
    if where == "a rank":
        parts[1]["forbidden"] = ["jax"]
    else:
        monkeypatch.setattr(harness, "forbidden_modules", lambda: ["jaxlib"])
    assert prun.finish(spec, parts, False, "card") == 3
    out, err = capsys.readouterr()
    assert out == "" and "JAX" in err


def test_route_mismatch_is_reported():
    spec = harness.find_cell(CELL)
    part = _part(GOOD)
    assert prun._route_line(spec, [part])[1] is False
    part["routes"] = {"left_staged": 1000}
    assert prun._route_line(spec, [part])[1] is True


def test_stated_routes_count_each_route_a_call():
    """A cell that states ``routes`` is held to each route's count a call;
    one that states a ``route`` to that route once a call."""
    spec = dict(harness.find_cell(CELL))
    spec["expect"] = {"routes": {"sparse_fixed_nnz": 2, "left_fused": 1},
                      "launches": {"K1": 1}}
    part = dict(_part(GOOD), routes={"sparse_fixed_nnz": 2000,
                                     "left_fused": 1000})
    line, mismatch = prun._route_line(spec, [part])
    assert mismatch is False
    assert json.loads(line)["portbench_calls"]["stated"] == spec["expect"]
    part["routes"] = {"sparse_fixed_nnz": 1000, "left_fused": 1000}
    assert prun._route_line(spec, [part])[1] is True


@pytest.mark.parametrize("launches,mismatch", [
    ({"K4": 1000, "K7": 1000}, False),
    ({"K4": 1000}, True)])
def test_fresh_states_its_fill_kernel(launches, mismatch):
    """K7, the operator fill, launches once a call of ``fresh`` beside K4,
    and is counted."""
    spec = harness.find_cell("saso_k8_f32.fresh")
    part = dict(_part(GOOD), routes={"sparse_saso_kernel": 1000},
                launches=launches)
    line, bad = prun._route_line(spec, [part])
    assert bad is mismatch
    assert json.loads(line)["portbench_calls"]["stated"] == {
        "route": "sparse_saso_kernel", "launches": {"K4": 1, "K7": 1}}


def test_the_fill_kernel_is_counted(monkeypatch):
    from randblas_tpu_torch.ops import saso_fill
    monkeypatch.setattr(saso_fill.saso_fill, "launches", 3)
    assert harness._read_counters()[1]["K7"] == 3
