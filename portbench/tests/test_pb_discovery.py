"""BENCHMARK.json against the contract's limits, and every piece of a cell
found by its name, a new one by adding files alone: a new sketch, and a
new kind of call."""

import json
import math
import re
import shutil
import time

import pytest

from portbench import harness, roofline, run as prun

BENCH = json.loads(harness.BENCHMARK.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
# the cells that make one sketch a call, named, so that a cell of another
# call joins none of their tests
SKETCH_CELLS = ["dense_gauss_f32.whole", "saso_k8_f32.fresh",
                "dense_gauss_rows_x4.whole"]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def _keys_and_command(bench, size):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert all(_line(w) for w in bench["command"])
    assert size <= 64 * 1024


def _names_units_and_entry_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)


def _cells_counts_and_budget(bench):
    assert 1 <= len(bench["configs"]) <= 24
    assert 1 <= len(bench["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


def _found_by_name(cell, path=harness.BENCHMARK, here=harness.ROOT):
    """The cell's pieces, found by name (``find_cell`` also runs its call
    module's ``check``), against what the harness can report."""
    bench = json.loads(path.read_text())
    spec = harness.find_cell(cell, path, here)
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]
    assert {m["moves"] for m in spec["per_layer"]} <= names
    quantities = [harness.quantity(n) for n in names]
    assert len(set(quantities)) == len(quantities)
    assert set(quantities) <= {"call_ms", "call_p95_ms", "peak_mem_gib",
                               "setup_s"}
    for m in spec["per_layer"]:
        assert callable(harness.reader(m["name"], here))
    conf = {c["name"]: c for c in bench["configs"]}[spec["cell"]["config"]]
    assert spec["config"]["name"] == conf["name"]
    assert spec["config"]["reduced"] == conf["reduced"]
    assert spec["config"]["chips"] == spec["cell"]["chips"]
    return spec


def _every_check(path, here):
    """This file's checks of the benchmark and of each of its cells, over
    the benchmark at ``path`` whose files are under ``here``."""
    bench = json.loads(path.read_text())
    _keys_and_command(bench, len(path.read_bytes()))
    _names_units_and_entry_keys(bench)
    _cells_counts_and_budget(bench)
    for w in bench["workloads"]:
        _found_by_name(w["name"], path, here)


def test_top_level_keys_and_command():
    _keys_and_command(BENCH, len(harness.BENCHMARK.read_bytes()))


def test_names_units_and_entry_keys():
    _names_units_and_entry_keys(BENCH)


def test_cells_counts_and_budget():
    _cells_counts_and_budget(BENCH)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_found_by_name(cell):
    _found_by_name(cell)


@pytest.mark.parametrize("cell", SKETCH_CELLS)
def test_the_sketch_cells_call_sketch(cell):
    """These cells' configurations name no call, so each makes one sketch,
    and the sketch call takes their files (``find_cell`` runs its
    ``check``)."""
    spec = harness.find_cell(cell)
    assert "call" not in spec["config"]
    assert spec["call"].__file__ == str(harness.ROOT / "calls" / "sketch.py")


@pytest.mark.parametrize("fault", ["fill", "route", "rel_fro", "max_rel"])
def test_sketch_check_refuses_what_a_sketch_cannot_take(fault):
    """The pins every sketch cell is held to: a traffic ``fill`` of
    ``lazy`` or ``explicit``, a route with a stated precision, limits on
    ``rel_fro`` and ``max_rel``."""
    from _pb_tiny import tiny
    spec = tiny("saso_k8_f32.fresh")
    if fault == "fill":
        spec["traffic"]["fill"] = "reused"
    elif fault == "route":
        spec["expect"]["route"] = "left_staged"
    else:
        del spec["expect"]["limits"][fault]
    with pytest.raises(ValueError):
        spec["call"].check(spec)


def _copy(tmp_path):
    """(the copied benchmark directory, a copy of BENCHMARK.json whose
    configurations are the copies') under ``tmp_path``."""
    here = tmp_path / "portbench"
    shutil.copytree(harness.ROOT, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    for c in bench["configs"]:
        c["file"] = str(here / "configs" / c["file"].split("/")[-1])
    return here, bench


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    """A dummy configuration, mix, metric and cell, added as files and
    entries beside copies of the benchmark's, run on the CPU by name."""
    here, bench = _copy(tmp_path)
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
    _every_check(path, here)
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


DUMMY_LSQ = '''"""A call that is no sketch: sketch-and-precondition least squares,
which counts its CGLS iterations, and its work from them."""

import torch

from portbench import roofline
from portbench.reference import sketch as refsketch
from portbench.workload import derive, randn


class Call:
    def __init__(self, config, traffic, seed, device, rank=0, world=1,
                 mesh=None):
        from randblas_tpu_torch import linalg
        self.lsq = linalg.sketch_and_precondition
        self.sys, self.seed, self.tol = config["system"], seed, traffic["tol"]
        self.device = torch.device(device)
        m, n = self.sys["rows"], self.sys["cols"]
        self.a = randn((m, n), derive(seed, "A"), device)
        x0 = randn((n,), derive(seed, "x"), device)
        self.b = self.a @ x0 + traffic["noise"] * randn(
            (m,), derive(seed, "b"), device)

    def key(self, i):
        return derive(self.seed, "op", i)

    def call(self, i, spans=None, counts=None):
        import randblas_tpu_torch as rt
        x, iters, _ = self.lsq(self.a, self.b,
                               rt.RNGState.from_key(self.key(i)),
                               d=self.sys["d"], operator="saso",
                               vec_nnz=self.sys["vec_nnz"], tol=self.tol)
        if counts is not None:
            counts.setdefault("iterations", []).append(iters)
        return x

    def local(self, out):
        return out

    def _solve(self, a, b):
        return torch.linalg.lstsq(a, b[:, None]).solution[:, 0]

    def exact_part(self, i):
        return self._solve(self.a.double(), self.b.double())

    def control_part(self, i, precision):
        return self._solve(refsketch._round(self.a, precision).double(),
                           refsketch._round(self.b, precision).double())

    def judge(self, i, out, exact, control=False):
        err = torch.linalg.vector_norm(out.double() - exact)
        return {"x_rel_err": (err / torch.linalg.vector_norm(exact)).item()}


def work(config, counts):
    # the sketches of A and b, the QR, Q^T S b and the triangular solve,
    # then the CGLS steps, as many a call as the window counted: each
    # reads A twice (A v, A^T r) and solves with R twice
    s = config["system"]
    m, n, d, k = s["rows"], s["cols"], s["d"], s["vec_nnz"]
    its = counts.get("iterations") or [0]
    steps = sum(its) / len(its)
    ops = 2 * k * m * (n + 1) + 4 * d * n * n + 2 * d * n + n * n \
        + steps * (4 * m * n + 2 * n * n)
    nbytes = m * n + m + n + steps * 2 * m * n
    return ops, nbytes * roofline.ITEMSIZE["float32"]


def precision(config, expect):
    return config["precision"]


def check(spec):
    if set(spec["expect"]["limits"]) != {"x_rel_err"}:
        raise ValueError("dummy_lsq compares x_rel_err alone")
'''


def test_a_new_call_needs_only_new_files_and_entries(tmp_path):
    """A call that is no sketch (sketch-and-precondition least squares:
    two sketches, a QR and CGLS iterations a call), with its own numbers
    compared, its routes, its count of work and a per-layer metric read
    from a count it reports, added as files and entries beside copies of
    the benchmark's and run on the CPU by name, untraced and traced."""
    here, bench = _copy(tmp_path)
    (here / "calls" / "dummy_lsq.py").write_text(DUMMY_LSQ)
    (here / "metrics" / "dummy_iterations.py").write_text(
        "def read(s):\n"
        "    its = s['counts'].get('iterations')\n"
        "    return sum(its) / len(its) if its else None\n")
    conf = {"name": "dummy_lsq", "call": "dummy_lsq",
            "system": {"rows": 1024, "cols": 32, "d": 64, "vec_nnz": 8},
            "precision": "float32", "chips": 1, "reduced": []}
    (here / "configs" / "dummy_lsq.json").write_text(json.dumps(conf))
    (here / "traffic" / "dummy_noisy.json").write_text(json.dumps(
        {"noise": 1e-3, "tol": 1e-6}))
    (here / "cells" / "dummy_lsq.dummy_noisy.json").write_text(json.dumps(
        {"routes": {"sparse_fixed_nnz": 2}, "launches": {}, "samples": 2,
         "limits": {"x_rel_err": 1e-4}}))
    bench["configs"].append({"name": "dummy_lsq", "source": "test",
                             "file": str(here / "configs/dummy_lsq.json"),
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy_lsq.dummy_noisy",
                               "config": "dummy_lsq",
                               "traffic": "dummy_noisy", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "call_ms.solve", "unit": "ms",
                                "better": "lower", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["dummy_lsq.dummy_noisy"]})
    bench["per_layer"].append({"name": "dummy_iterations", "unit": "steps",
                               "better": "lower",
                               "source": "program_counter", "layer": "test",
                               "moves": "call_ms.solve",
                               "workloads": ["dummy_lsq.dummy_noisy"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    _every_check(path, here)
    spec = harness.find_cell("dummy_lsq.dummy_noisy", path, here)
    assert spec["call"].__file__ == str(here / "calls" / "dummy_lsq.py")
    part = harness.run(spec, 2 ** 31 + 9, 0.2, False, "cpu", time.time())
    res = prun.result(spec, [part], False, "cpu")
    assert res["correct"] and res["attempted"] > 0
    assert set(res["checks"]) == {"x_rel_err"}
    assert 0 < res["checks"]["x_rel_err"]["value"] <= 1e-4
    assert set(res["metrics"]) == {"call_ms.solve", "peak_mem_gib",
                                   "setup_s"}
    line, mismatch = prun._route_line(spec, [part])
    assert mismatch is False
    assert json.loads(line)["portbench_calls"]["per_call_by_rank"][0][
        "routes"] == {"sparse_fixed_nnz": 2.0}
    assert part["counts"] == {}             # counted in a traced run only
    # traced: the counts come from the traced window, with no window of
    # its own (the cell has no host-clock metric), and the least time
    # counts the CGLS steps they report
    part = harness.run(spec, 2 ** 31 + 10, 0.2, True, "cpu", time.time())
    res = prun.result(spec, [part], True, "cpu")
    assert res["correct"] and part["spans"] == {}
    assert part["attempted"] == part["window"]["attempted"]
    its = part["counts"]["iterations"]
    assert len(its) == part["window"]["attempted"] and min(its) >= 1
    assert res["metrics"]["dummy_iterations"]["value"] == \
        sum(its) / len(its)
    ops, nbytes = spec["call"].work(spec["config"], part["counts"])
    least = prun._summary(spec, [part])["least_s"]
    assert least == roofline.least_seconds(ops, nbytes, 1, "float32") == \
        max(ops / 67e12, nbytes / 3.35e12)
    assert least > harness.least_seconds(spec, {})


def test_a_missing_call_fails_in_find_cell(tmp_path):
    """A configuration that names a call with no module is refused where
    the cell is found, with the file that is missing named."""
    here, bench = _copy(tmp_path)
    conf = json.loads((here / "configs" / "saso_k8_f32.json").read_text())
    conf["call"] = "no_such_call"
    (here / "configs" / "saso_k8_f32.json").write_text(json.dumps(conf))
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    with pytest.raises(FileNotFoundError,
                       match=re.escape(str(here / "calls" /
                                           "no_such_call.py"))):
        harness.find_cell("saso_k8_f32.fresh", path, here)
    harness.find_cell("dense_gauss_f32.whole", path, here)


def test_traffic_keys_drive_the_calls():
    """Every call, warm-up calls too, gets a key of its own; ``explicit``
    fills the sparse operator before the sketch and times it in a span,
    ``lazy`` does not."""
    from _pb_tiny import tiny
    spec = tiny("saso_k8_f32.fresh")
    wl = spec["call"].Call(spec["config"], spec["traffic"], 11, "cpu")
    assert wl.a.shape == (2048, 128)
    assert len({wl.key(i) for i in range(-2, 50)}) == 52
    assert not math.isnan(float(wl.a.sum()))
    spans = {}
    wl.call(0, spans)
    wl.call(1)
    assert len(spans["fill"]) == 1
    spec = tiny("dense_gauss_f32.whole")
    wl = spec["call"].Call(spec["config"], spec["traffic"], 11, "cpu")
    spans = {}
    wl.call(0, spans)
    assert spans == {}
