"""BENCHMARK.json against the contract's limits, and every piece of a cell
found by its name, a new one by adding files alone."""

import json
import math
import re
import shutil
import time

import pytest

from portbench import harness, run as prun
from portbench.workload import Workload

BENCH = json.loads(harness.BENCHMARK.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert all(_line(w) for w in BENCH["command"])
    assert len(harness.BENCHMARK.read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)


def test_cells_counts_and_budget():
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_found_by_name(cell):
    spec = harness.find_cell(cell)
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]
    assert {m["moves"] for m in spec["per_layer"]} <= names
    quantities = [harness.quantity(n) for n in names]
    assert len(set(quantities)) == len(quantities)
    assert set(quantities) <= {"call_ms", "call_p95_ms", "peak_mem_gib",
                               "setup_s"}
    for m in spec["per_layer"]:
        assert callable(harness.reader(m["name"]))
    conf = {c["name"]: c for c in BENCH["configs"]}[spec["cell"]["config"]]
    assert spec["config"]["name"] == conf["name"]
    assert spec["config"]["reduced"] == conf["reduced"]
    assert spec["config"]["chips"] == spec["cell"]["chips"]
    assert spec["expect"]["route"] in spec["config"]["precision"]
    assert spec["traffic"]["fill"] in ("lazy", "explicit")
    assert set(spec["expect"]["limits"]) >= {"rel_fro", "max_rel"}


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    """A dummy configuration, mix, metric and cell, added as files and
    entries beside copies of the benchmark's, run on the CPU by name."""
    here = tmp_path / "portbench"
    shutil.copytree(harness.ROOT, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    for c in bench["configs"]:
        c["file"] = str(here / "configs" / c["file"].split("/")[-1])
    conf = json.loads((here / "configs" / "saso_k8_f32.json").read_text())
    conf.update(name="dummy_saso", operator=dict(conf["operator"], d=32,
                                                  m=512, vec_nnz=4),
                data=dict(conf["data"], rows=512, cols=64))
    (here / "configs" / "dummy_saso.json").write_text(json.dumps(conf))
    (here / "traffic" / "dummy_reused.json").write_text(json.dumps(
        {"fill": "explicit"}))
    (here / "metrics" / "dummy_calls.py").write_text(
        "def read(s):\n    return s['calls']\n")
    (here / "cells" / "dummy_saso.dummy_reused.json").write_text(
        json.dumps({"route": "sparse_fixed_nnz", "launches": {},
                    "samples": 2, "limits": {"rel_fro": 1e-3,
                                             "max_rel": 1e-2}}))
    bench["configs"].append({"name": "dummy_saso", "source": "test",
                             "file": str(here / "configs/dummy_saso.json"),
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy_saso.dummy_reused",
                               "config": "dummy_saso",
                               "traffic": "dummy_reused", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "call_ms.reused", "unit": "ms",
                                "better": "lower", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["dummy_saso.dummy_reused"]})
    bench["per_layer"].append({"name": "dummy_calls", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "call_ms.reused",
                               "workloads": ["dummy_saso.dummy_reused"]})
    bench["per_layer"].append({"name": "idle_pct.reused", "unit": "%",
                               "better": "lower", "source": "device_trace",
                               "layer": "device (H100)",
                               "moves": "call_ms.reused"})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    spec = harness.find_cell("dummy_saso.dummy_reused", path, here)
    assert [m["name"] for m in spec["per_layer"]] == ["dummy_calls",
                                                      "idle_pct.reused"]
    assert harness.reader("dummy_calls", here)({"calls": 7}) == 7
    assert harness.reader("idle_pct.reused", here)(
        {"window_s": 2.0, "busy_s": 1.0}) == 50.0
    part = harness.run(spec, 2 ** 31 + 5, 0.2, False, "cpu", time.time())
    res = prun.result(spec, [part], False, "cpu")
    assert res["correct"] and res["attempted"] > 0
    assert set(res["metrics"]) == {"call_ms.reused", "peak_mem_gib",
                                   "setup_s"}
    assert prun._route_line(spec, [part])[1] is False


def test_traffic_keys_drive_the_calls():
    """Every call, warm-up calls too, gets a key of its own; ``explicit``
    fills the sparse operator before the sketch and times it in a span,
    ``lazy`` does not."""
    from _pb_tiny import tiny
    spec = tiny("saso_k8_f32.fresh")
    wl = Workload(spec["config"], spec["traffic"], 11, "cpu")
    assert wl.a.shape == (2048, 128)
    assert len({wl.key(i) for i in range(-2, 50)}) == 52
    assert not math.isnan(float(wl.a.sum()))
    spans = {}
    wl.call(0, spans)
    wl.call(1)
    assert len(spans["fill"]) == 1
    spec = tiny("dense_gauss_f32.whole")
    wl = Workload(spec["config"], spec["traffic"], 11, "cpu")
    spans = {}
    wl.call(0, spans)
    assert spans == {}
