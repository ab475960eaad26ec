"""The port's distributed layer in a live 4-rank gloo group on the CPU.

One module-scoped group of four OS processes (tests/_torch_distributed_worker.py,
which imports torch and the port only, one thread a rank) runs, on a 2 x 2
and a 1 x 4 ('model', 'data') DeviceMesh over the same ranks, the cases of
the JAX package's ``dryrun_multichip`` with its shapes and oracles, through
the public entry points with DTensor inputs: the five sketches and
pad-and-shard against the float64 product (1e-5; SRHT 1e-4), the gradient
of sum(B^2) in the three layouts, the rangefinder, QB, rSVD (the planted
spectrum to 1e-4), the block Krylov rangefinder (basis width 3, residual <
1e-4), Frequent Directions (its certificate), ``ihs_lsq(mesh=)`` (equal to
the unsharded run to 1e-4) and ``sketch_and_precondition(mesh=)`` (1e-4,
CGLS iterations within 2); the solver tier on sharded inputs, cases 10-12:
``sgmres`` on a row-sharded A (the unsharded run to rtol 1e-4, atol 1e-5, a
true residual below 1e-4), ``block_kaczmarz`` on a row-sharded system and
``block_gauss_seidel`` ('shuffle' and 'colnorm') on a column-sharded one
(the unsharded run to rtol 1e-4, atol 1e-5; Kaczmarz and 'colnorm' are
bitwise on this CPU, not asserted, while 'shuffle' sums the residual
update over the ranks), both again at extents that 'data' does not divide,
so that on 1 x 4 one rank holds no rows or columns; ``tensor_sketch`` and ``kfjlt_sketch`` of column-sharded factors
against the unsharded call (test_distributed.py's zero-communication tests:
KFJLT bitwise, TensorSketch within 1e-6 of max |want|, the reason beside the
case), each with the unsharded ``next_state`` and with no warning (no
operation falls back to DTensor's own propagation); and a host-contiguous
multi-host mesh of two "hosts" (LOCAL_WORLD_SIZE=2). Each case is one test,
which reads what all four ranks wrote.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

WORLD = 4
CASES = ("left", "right", "sparse", "cols", "sparse_data", "pad_and_shard",
         "srht_cols", "gradient", "rsvd", "rangefinder_qb", "krylov", "fd",
         "ihs", "precondition", "sgmres", "kaczmarz", "gauss_seidel",
         "ragged", "tensor_sketch", "kfjlt")
NAMES = [f"{c}[{mesh}]" for mesh in ("2x2", "1x4") for c in CASES] \
    + ["multihost"]
TIMEOUT = 240   # seconds a rank may take; the group takes about 10


def _spawn(out_dir: Path):
    worker = Path(__file__).with_name("_torch_distributed_worker.py")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_WORLD_SIZE", "OMP_NUM_THREADS")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), f"localhost:{port}", str(rank),
         str(WORLD), str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(worker.parent.parent)) for rank in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return procs, outs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each rank wrote: a list of {case: "ok" or its traceback}."""
    out_dir = tmp_path_factory.mktemp("gloo")
    procs, outs = _spawn(out_dir)
    if any(p.returncode for p in procs) and any(
            "address already in use" in o.lower() for o in outs):
        procs, outs = _spawn(out_dir)   # the port was taken after the probe
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(WORLD)]


@pytest.mark.parametrize("name", NAMES)
def test_live_case(ranks, name):
    for rank, results in enumerate(ranks):
        assert results.get(name) == "ok", \
            f"rank {rank}, {name}:\n{results.get(name, 'not run')}"


def test_every_case_ran(ranks):
    for results in ranks:
        assert sorted(results) == sorted(NAMES)
