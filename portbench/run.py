"""Run one cell of the benchmark of randblas_tpu_torch once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the package. The cell, its
configuration, traffic and metrics are found by name from
``BENCHMARK.json`` (``harness.find_cell``). The run makes its data on the
card from the seed, warms up, measures a closed loop of calls for
``--seconds``, checks a sample of the window's outputs against the plain
reference, and prints one JSON object as the last line of its standard
output: the cell's end-to-end metrics with ``--trace 0``, its per-layer
metrics with ``--trace 1``. The numbers compared, each with its limit, are
the last lines of standard error and the last key of that line. A cell on
several cards runs one process a card (``launch.py``).

``--calibrate K`` instead reads the program's numbers on K seeds from
``--seed`` on (a window of ``--seconds`` each) and the control's on the
first ``--controls`` of them, one JSON line a seed: the readings the
limits in ``cells/<cell>.json`` are set from.
"""

import time

T0 = time.time()      # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness, launch, trace  # noqa: E402

T_IMPORTS = time.time()


def _die(msg: str, code: int = 2) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def _end_to_end(spec: dict, parts: list) -> dict:
    p0 = parts[0]
    w = p0["window"]
    done = w["attempted"] - w["failed"]
    return {"call_ms": w["seconds"] / done * 1e3,
            "call_p95_ms": p0["call_p95_s"] * 1e3,
            "peak_mem_gib": max(p["peak_window"] for p in parts) / harness.GIB,
            "setup_s": p0["setup_s"]}


def _summary(spec: dict, parts: list) -> dict:
    """What the per-layer readers read: the trace of every rank (busy and
    window averaged over the cards), rank 0's spans and counts, and the
    call's least time (from its call module's ``work``, given those
    counts, and ``precision``)."""
    p0 = parts[0]
    w = p0["window"]
    sums = [p["summary"] for p in parts]
    return {
        "calls": w["attempted"] - w["failed"],
        "chips": len(parts),
        "window_s": sum(s["window_s"] for s in sums) / len(sums),
        "busy_s": sum(s["busy_s"] for s in sums) / len(sums),
        "busy_s_rank0": sums[0]["busy_s"],
        "kernels": sums[0]["kernels"],
        "ops_s": sums[0]["ops_s"],
        "gaps_s": sums[0]["gaps_s"],
        "spans": p0["spans"],
        "counts": p0["counts"],
        "least_s": harness.least_seconds(spec, p0["counts"]),
    }


def result(spec: dict, parts: list, traced: bool, kind: str) -> dict:
    """The last line's object from every rank's part."""
    p0 = parts[0]
    w = p0["window"]
    done = w["attempted"] - w["failed"]
    metrics = {}
    if done:
        if traced:
            s = _summary(spec, parts)
            for m in spec["per_layer"]:
                v = harness.reader(m["name"], spec["here"])(s)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            vals = _end_to_end(spec, parts)
            for m in spec["end_to_end"]:
                metrics[m["name"]] = {
                    "value": vals[harness.quantity(m["name"])],
                    "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": len(parts),
              "memory_peak_bytes": max(max(p["peak_setup"], p["peak_window"])
                                       for p in parts)}
    failed = max(p["failed"] for p in parts)
    out = {"correct": False, "attempted": p0["attempted"],
           "failed": failed, "metrics": metrics, "device": device}
    if traced:
        sums = [p["summary"] for p in parts]
        device["busy_s"] = sum(s["busy_s"] for s in sums) / len(sums)
        device["window_s"] = sum(s["window_s"] for s in sums) / len(sums)
        out["breakdown"] = {"device_ops": trace.top(sums[0]["ops_s"]),
                            "idle_gaps": trace.top(sums[0]["gaps_s"])}
    limits = spec["expect"]["limits"]
    checks = {k: {"value": p0["checks"].get(k, math.inf), "limit": lim}
              for k, lim in limits.items()}
    out["correct"] = bool(done and not failed and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    out["checks"] = checks
    return out


def _route_line(spec: dict, parts: list) -> tuple:
    """(line, mismatch) of the routes and launches a call took on each
    rank against the ones the cell states: ``routes`` (each route's count
    a call) where it gives them, else its one ``route`` once a call."""
    want = spec["expect"]
    routes_want = {k: float(v) for k, v in
                   want.get("routes", {want.get("route"): 1}).items()}
    per_rank, bad = [], False
    for p in parts:
        done = max(1, p["window"]["attempted"] - p["window"]["failed"])
        routes = {k: v / done for k, v in p["routes"].items()}
        launches = {k: v / done for k, v in p["launches"].items()}
        per_rank.append({"routes": routes, "launches": launches})
        if routes and routes != routes_want:
            bad = True
        if launches != {k: float(v) for k, v in want["launches"].items()}:
            bad = True
    line = json.dumps({"portbench_calls": {
        "stated": {k: want[k] for k in ("route", "routes", "launches")
                   if k in want},
        "per_call_by_rank": per_rank,
        "window": parts[0]["window"]}})
    return line, bad


def finish(spec: dict, parts: list, traced: bool, kind: str) -> int:
    """Print a run's lines and its result, or refuse to (exit 3) where
    this process or any rank had loaded JAX or the JAX package once its
    window had closed."""
    res = result(spec, parts, traced, kind)
    bad = sorted(set(harness.forbidden_modules()).union(
        *(p["forbidden"] for p in parts)))
    if bad:
        return _die(f"JAX or the JAX package was loaded: {bad}", 3)
    for line in parts[0]["lines"]:
        print(line)
    line, mismatch = _route_line(spec, parts)
    print(line)
    if traced:
        print("portbench trace by rank: " + json.dumps(
            [{k: p["summary"][k] for k in ("window_s", "busy_s", "kernels")}
             for p in parts]))
    if mismatch:
        print("portbench: the cell took another route or launch count "
              "than it states: " + line, file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"portbench check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


def _mesh(spec: dict):
    from randblas_tpu_torch import parallel
    parallel.initialize_multihost()
    shape = spec["config"]["mesh"]
    return parallel.make_sketch_mesh(shape["model"], shape["data"])


def rank_main(args, spec: dict) -> int:
    import torch
    import torch.distributed as dist
    mesh = _mesh(spec)
    device = torch.device("cuda", torch.cuda.current_device())
    t0 = float(os.environ["PORTBENCH_T0"])
    code = 0
    if args.calibrate:
        for r in harness.calibrate(spec, _seeds(args), args.seconds,
                                   args.controls, device, mesh):
            if dist.get_rank() == 0:
                print(json.dumps(r), flush=True)
    else:
        part = harness.run(spec, args.seed, args.seconds, bool(args.trace),
                           device, t0, mesh)
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, part)
        if dist.get_rank() == 0:
            code = finish(spec, parts, bool(args.trace),
                          torch.cuda.get_device_name(device))
    dist.barrier()
    dist.destroy_process_group()
    return code


def _cards(chips: int):
    """None where this machine has the cards a cell needs, else why not."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} CUDA device(s); this machine has "
                f"{torch.cuda.device_count()}")
    return None


def _seeds(args) -> list:
    return [args.seed + i for i in range(args.calibrate)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--calibrate", type=int, default=0, metavar="K")
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--rank", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    try:
        spec = harness.find_cell(args.workload)
    except (KeyError, OSError, ValueError) as e:
        return _die(f"cannot find the cell: {e}")
    chips = spec["cell"]["chips"]
    if args.rank:
        return rank_main(args, spec)
    if chips > 1:
        # the ranks start at once; this process checks the cards meanwhile
        cmd = [sys.executable, os.path.abspath(__file__),
               *(sys.argv[1:] if argv is None else argv), "--rank"]
        code, out = launch.run(cmd, chips, T0, check=lambda: _cards(chips))
        if code:
            return _die(f"a rank failed (exit {code})", code)
        bad = harness.forbidden_modules()
        if bad:
            return _die(f"JAX or the JAX package was loaded: {bad}", 3)
        sys.stdout.write(out)
        sys.stdout.flush()
        return 0
    problem = _cards(chips)
    if problem:
        return _die(problem)
    import torch
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    print("portbench process (s from its start): " + json.dumps(
        {"imports": T_IMPORTS - T0, "CUDA context": time.time() - T0}))
    if args.calibrate:
        for r in harness.calibrate(spec, _seeds(args), args.seconds,
                                   args.controls, device):
            print(json.dumps(r), flush=True)
        return 0
    part = harness.run(spec, args.seed, args.seconds, bool(args.trace),
                       device, T0)
    return finish(spec, [part], bool(args.trace),
                  torch.cuda.get_device_name(device))


if __name__ == "__main__":
    sys.exit(main())
