"""No module a benchmark process loads is JAX's or the JAX package's, and
the reference loads nothing of the measured program."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _top_names(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_traffic_metrics_and_reference_load_no_jax():
    names = _top_names(
        "import glob, os, runpy\n"
        "from portbench import run, harness, launch, trace, workload\n"
        "import portbench.reference.sketch, portbench.reference.compare\n"
        "import randblas_tpu_torch, randblas_tpu_torch.parallel\n"
        "for p in sorted(glob.glob('portbench/metrics/*.py')):\n"
        "    harness.reader(os.path.basename(p)[:-3])\n"
        "for c in harness.json.load(open('BENCHMARK.json'))['workloads']:\n"
        "    harness.find_cell(c['name'])\n")
    assert "randblas_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "randblas_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = _top_names("import portbench.reference.sketch\n"
                       "import portbench.reference.compare")
    assert not names & {"randblas_tpu_torch", "randblas_tpu", "jax"}


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, "randblas_tpu_torch_like", sys)
    assert "randblas_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert harness.forbidden_modules() == ["jaxlib"]
