"""On the card: each cell the machine holds cards for, run as the driver
runs it (a short window), with ``--trace 0`` and ``--trace 1``: the last
line is the contract's and ``correct`` is true. Skips where there is no
card (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = json.loads(harness.BENCHMARK.read_text())
SKETCH_CELLS = ["dense_gauss_f32.whole", "saso_k8_f32.fresh",
                "dense_gauss_rows_x4.whole"]


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(cell, traced):
    import torch
    chips = harness.find_cell(cell)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA device(s)")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 1000 + traced), "--seconds", "2", "--trace",
         str(traced)], cwd=ROOT, capture_output=True, text=True,
        timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    spec = harness.find_cell(cell)
    want = spec["per_layer"] if traced else spec["end_to_end"]
    assert {m["name"] for m in want} >= set(res["metrics"])
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["count"] == chips
    if traced:
        assert res["device"]["busy_s"] > 0
        got = {harness.quantity(n): v["value"]
               for n, v in res["metrics"].items()}
        # a device-trace metric that lists no cells is every cell's
        every = {harness.quantity(m["name"]) for m in want
                 if m["source"] == "device_trace" and "workloads" not in m}
        assert every <= set(got)
        if cell in SKETCH_CELLS:
            assert {"idle_pct", "roofline_pct",
                    "kernels_per_call"} <= set(got)
        if "roofline_pct" in got:
            assert 0 < got["roofline_pct"] <= 100
    else:
        assert set(res["metrics"]) == {m["name"] for m in want}
