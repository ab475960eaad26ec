"""One run of one cell in one process (one rank of a mesh): set-up, warm-up,
the measured window, the trace, and the comparison with the reference.

Everything a cell is made of is found by name: ``BENCHMARK.json`` names
the cell's configuration (its ``file``), its traffic mix
(``traffic/<mix>.json``) and its metrics (``metrics/<metric>.py``, each
with ``read(summary)``); the configuration's ``call`` (``sketch`` where
it names none) names the module of what a call does
(``calls/<call>.py``); ``cells/<cell>.json`` gives the route (or
``routes``: each route's count a call) and launches the cell states, the
number of calls the reference checks, and the limit of each number
compared.

A call module has four members:

- ``Call(config, traffic, seed, device, rank=0, world=1, mesh=None)``,
  the calls of one cell on one process, on its ``device``: ``key(i)``,
  ``call(i, spans=None, counts=None)``, ``exact_part(i)``,
  ``control_part(i, precision)``, ``local(out)`` and
  ``judge(i, out, exact, control=False) -> dict`` (the numbers compared,
  by the names the cell's limits use). Where ``spans`` is a dict, a call
  appends to it the seconds of its host-clock spans by name; it is given
  only in an untraced window of its own, where the profiler's cost is not
  in them. Where ``counts`` is a dict, a call appends to it what it
  counted (say, the steps of a solve) by name; it is given in the traced
  window. ``metrics/`` readers read them as ``summary["spans"]`` and
  ``summary["counts"]``;
- ``work(config, counts) -> (operations, bytes)``: one call's count of
  work for the roofline, the mean over the traced window's calls, which
  reported ``counts`` (work that depends on the data is counted from
  them);
- ``precision(config, expect) -> str``: the precision that bounds a call;
  the control runs one step below it;
- ``check(spec) -> None``: raises ValueError on a configuration, traffic
  or cell file that the call cannot take.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import random
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from . import roofline, trace
from .reference import compare
from .workload import derive, p95, sync as _sync

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"
KERNELS = {"K1": ("fused_sketch", "fused_sketch"),
           "K2": ("fused_sketch", "fused_sketch_colmajor"),
           "K3": ("fused_sketch", "fill_block"),
           "K4": ("saso_sketch", "saso_sketch"),
           "K5": ("ell_spmm", "blocked_ell_matmul"),
           "K6": ("x64_fill", "fill_block64"),
           "K7": ("saso_fill", "saso_fill")}
FORBIDDEN = ("jax", "jaxlib", "flax", "randblas_tpu")
GIB = float(1 << 30)


# -- finding a cell by name ---------------------------------------------


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, bench_path: Path = BENCHMARK,
              here: Path = ROOT) -> dict:
    """The cell ``name`` of the benchmark at ``bench_path`` with everything
    it is made of: its entry, configuration (the ``file`` the benchmark
    names), its call's module, traffic and stated expectations (under
    ``here``, which the spec keeps for the metrics' readers) and the
    metrics it reports. Raises where the call module is
    missing or its ``check`` refuses the cell."""
    bench = _json(bench_path)
    root = bench_path.parent
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path.name}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}

    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    # a per-layer metric with no list of cells is every cell's that
    # reports the end-to-end metric it moves
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [])
                 or ("workloads" not in m and m["moves"] in moved)]
    config = _json(root / configs[cell["config"]]["file"])
    spec = {
        "cell": cell,
        "config": config,
        "call": _load("calls", config.get("call", "sketch"), here),
        "traffic": _json(here / "traffic" / f"{cell['traffic']}.json"),
        "expect": _json(here / "cells" / f"{name}.json"),
        "end_to_end": e2e,
        "per_layer": per_layer,
        "run_seconds": bench["run_seconds"],
        "here": here,
    }
    spec["call"].check(spec)
    return spec


def _load(kind: str, name: str, here: Path):
    """The module ``<kind>/<name>.py`` under ``here``."""
    path = here / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind[:-1]}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def least_seconds(spec: dict, counts: dict) -> float:
    """The least time of one call of the cell on its cards, from its call
    module's ``work`` (given what the window's calls ``counts``) and
    ``precision``."""
    call, config = spec["call"], spec["config"]
    return roofline.least_seconds(*call.work(config, counts),
                                  config["chips"],
                                  call.precision(config, spec["expect"]))


def quantity(metric: str) -> str:
    """What a metric measures: its name up to the first dot. A quantity
    split over groups of cells (``call_ms`` and ``call_ms.host_paced``) is
    one quantity with a bound for each group."""
    return metric.split(".")[0]


def reader(metric: str, here: Path = ROOT):
    """The ``read`` function of ``metrics/<quantity>.py`` under ``here``:
    a metric split over groups of cells has one reader."""
    return _load("metrics", quantity(metric), here).read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


# -- what the card says -------------------------------------------------


def card_lines(tag: str) -> list:
    """nvidia-smi's name, SM clock, power draw and limit of each card."""
    query = "index,name,clocks.sm,clocks.max.sm,power.draw,power.limit"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable: {e}"
    return [f"portbench card {tag}: {line.strip()}"
            for line in out.strip().splitlines()]


def _counters():
    """The program's route counter and its kernels' launch counters."""
    from randblas_tpu_torch import skge
    fns = {k: getattr(importlib.import_module(f"randblas_tpu_torch.ops.{m}"),
                      fn) for k, (m, fn) in KERNELS.items()}
    return skge.route_counts, fns


def _reset_counters():
    routes, fns = _counters()
    routes.clear()
    for f in fns.values():
        f.launches = 0


def _read_counters() -> tuple:
    routes, fns = _counters()
    return dict(routes), {k: f.launches for k, f in fns.items()
                          if f.launches}


# -- the measured window ------------------------------------------------


class Reservoir:
    """A uniform sample of ``size`` calls' outputs over a window of unknown
    length, drawn from the seed (reservoir sampling). Outputs are held as
    the program returned them: nothing is copied inside the window."""

    def __init__(self, size: int, seed: int, first: int = 0):
        self.size, self.seen, self.kept = size, 0, []
        self.rng = random.Random(derive(seed, "sample", first))

    def offer(self, i: int, out) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append((i, out))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.kept[j] = (i, out)


class Ranks:
    """The mesh's collectives the harness needs; one card: none."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        if mesh is None:
            self.rank, self.world = 0, 1
        else:
            import torch.distributed as dist
            self.dist = dist
            self.rank, self.world = dist.get_rank(), dist.get_world_size()

    def barrier(self):
        if self.mesh is not None:
            self.dist.barrier()

    def agree(self, go: bool) -> bool:
        """Rank 0's decision, on every rank; also the end-of-call barrier.
        A host tensor, so it goes over the group's CPU backend and puts no
        kernel of the benchmark's own on the cards."""
        if self.mesh is None:
            return go
        flag = torch.tensor([int(go) if self.rank == 0 else 1])
        self.dist.all_reduce(flag, op=self.dist.ReduceOp.MIN)
        return bool(flag.item())

    def gather(self, obj) -> list:
        if self.mesh is None:
            return [obj]
        out = [None] * self.world
        self.dist.all_gather_object(out, obj)
        return out

    def total(self, part: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``part``, added in rank order."""
        if self.mesh is None:
            return part
        parts = [torch.empty_like(part) for _ in range(self.world)]
        self.dist.all_gather(parts, part.contiguous())
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out


def window(wl, ranks: Ranks, seconds: float, samples: int,
           seed: int, spans=None, first: int = 0, counts=None) -> dict:
    """Closed loop, one caller: call after call of ``wl`` (a call module's
    ``Call``), from call ``first`` on, until ``seconds`` have passed on
    rank 0's clock; each call ends when its output is ready (a
    synchronize, and on a mesh the barrier that follows). ``spans`` and
    ``counts`` go to every call (``Call.call``)."""
    device = wl.device
    res = Reservoir(samples, seed, first)
    lat, failed, i = [], 0, first
    t_begin = time.perf_counter()
    while True:
        tc = time.perf_counter()
        try:
            out = wl.call(i, spans, counts)
            _sync(device)
        except Exception:       # a call that raises counts as failed
            if not failed:
                traceback.print_exc()
            failed += 1
            out = None
        go = ranks.agree(time.perf_counter() - t_begin < seconds)
        lat.append(time.perf_counter() - tc)
        if out is not None:
            res.offer(i, out)
        i += 1
        if not go:
            break
    return {"seconds": time.perf_counter() - t_begin,
            "attempted": i - first, "failed": failed, "latencies": lat, "samples": res.kept}


def judge(wl, ranks: Ranks, samples, control=None) -> tuple:
    """(program readings, control readings or None) over the sampled
    calls of ``wl`` (a call module's ``Call``): each output against the
    exact one, and with ``control`` (a precision) the control in the
    program's place, both by the call's ``judge``."""
    prog, ctrl = [], []
    for i, out in samples:
        exact = ranks.total(wl.exact_part(i))
        prog.append(wl.judge(i, out, exact))
        if control is not None:
            got = ranks.total(wl.control_part(i, control))
            ctrl.append(wl.judge(i, got, exact, control=True))
        _sync(wl.device)
    gather = ranks.gather((prog, ctrl))
    prog = [r for p, _ in gather for r in p]
    ctrl = [r for _, c in gather for r in c]
    return compare.worst(prog), (compare.worst(ctrl) if ctrl else None)


def run(spec: dict, seed: int, seconds: float, traced: bool, device,
        t0_wall: float, mesh=None) -> dict:
    """One run on this process; every rank returns its own part."""
    device = torch.device(device)
    ranks = Ranks(mesh)
    steps = [("start", time.time() - t0_wall)]
    wl = spec["call"].Call(spec["config"], spec["traffic"], seed, device,
                           ranks.rank, ranks.world, mesh)
    _sync(device)
    steps.append(("data", time.time() - t0_wall))
    for j in (1, 2):                       # warm-up: every shape it uses
        wl.call(-j)
        _sync(device)
        ranks.barrier()
        steps.append((f"warm-up call {j}", time.time() - t0_wall))
    lines = card_lines("before") if ranks.rank == 0 else []
    _sync(device)
    ranks.barrier()
    setup_s = time.time() - t0_wall
    if ranks.rank == 0:
        lines.append("portbench set-up (s from process start, rank 0): "
                     + json.dumps(dict(steps + [("window", setup_s)])))
    cuda = device.type == "cuda"
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    samples = spec["expect"]["samples"]
    spans, taken = None, []
    if traced and any(m["source"] == "host_clock" for m in spec["per_layer"]):
        # host-clock spans are read in an untraced window of their own:
        # the profiler's cost a launch would be in them
        spans = {}
        taken.append(window(wl, ranks, seconds, samples, seed, spans))
    # counts read the same under the profiler: the traced window takes them
    counts = {} if traced else None
    _reset_counters()
    rec = trace.Recorder() if traced else contextlib.nullcontext()
    with rec:
        with (rec.window() if traced else contextlib.nullcontext()):
            w = window(wl, ranks, seconds, samples, seed,
                       first=sum(t["attempted"] for t in taken),
                       counts=counts)
    taken.append(w)
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    routes, launches = _read_counters()
    summary = rec.summary() if traced else None
    if ranks.rank == 0:
        lines += card_lines("after")
    lat = w.pop("latencies")
    samples = [s for t in taken for s in t.pop("samples")]
    del rec
    t_ref = time.perf_counter()
    worst, _ = judge(wl, ranks, samples)
    if ranks.rank == 0:
        lines.append(f"portbench reference: {len(samples)} sampled calls "
                     f"checked in {time.perf_counter() - t_ref:.3f} s")
    return {"rank": ranks.rank, "setup_s": setup_s, "window": w,
            "attempted": sum(t["attempted"] for t in taken),
            "failed": sum(t["failed"] for t in taken),
            "call_p95_s": p95(lat) if lat else None,
            "peak_setup": peak_setup, "peak_window": peak_window,
            "routes": routes, "launches": launches, "summary": summary,
            "spans": spans or {}, "counts": counts or {}, "checks": worst,
            "lines": lines, "forbidden": forbidden_modules()}


def calibrate(spec: dict, seeds, seconds: float, controls: int, device,
              mesh=None):
    """The readings that limits are set from: for each seed a window of
    ``seconds`` at the cell's load, the program's numbers over its sampled
    calls, and on the first ``controls`` seeds the control's, in the
    precision just below the one that bounds the call (its module's
    ``precision``).
    Yields one dict a seed (on every rank; rank 0 prints)."""
    from .reference.sketch import BELOW
    device = torch.device(device)
    ranks = Ranks(mesh)
    precision = spec["call"].precision(spec["config"], spec["expect"])
    for n, seed in enumerate(seeds):
        wl = spec["call"].Call(spec["config"], spec["traffic"], seed, device,
                               ranks.rank, ranks.world, mesh)
        wl.call(-1)
        _sync(device)
        ranks.barrier()
        _reset_counters()
        w = window(wl, ranks, seconds, spec["expect"]["samples"], seed)
        routes, launches = _read_counters()
        prog, ctrl = judge(wl, ranks, w["samples"],
                           BELOW[precision] if n < controls else None)
        yield {"seed": seed, "calls": w["attempted"], "failed": w["failed"],
               "routes": routes, "launches": launches, "program": prog,
               "control": ctrl, "control_precision":
               BELOW[precision] if n < controls else None}
        del wl, w
        if device.type == "cuda":
            torch.cuda.empty_cache()
