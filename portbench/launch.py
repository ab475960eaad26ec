"""The launcher of a cell that spans several cards: one process a card with
torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
MASTER_ADDR, MASTER_PORT on a free localhost port), each joining one NCCL
group. A rank that fails fails the run, and the others are stopped; only
rank 0's standard output is passed on, and only once every rank has
ended well.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time

TIMEOUT_S = 330


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(cmd: list, world: int, t0_wall: float, check=None) -> tuple:
    """Start ``world`` ranks of the command ``cmd``; (exit code, rank 0's
    standard output). Ranks other than 0 write theirs to standard error.
    ``check``, called once the ranks have started, returns None or why the
    run cannot go on; then the ranks are stopped and the code is 2."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   PORTBENCH_T0=repr(t0_wall))
        procs.append(subprocess.Popen(
            cmd, env=env,
            stdout=subprocess.PIPE if rank == 0 else sys.stderr))
    out = []
    pump = threading.Thread(target=lambda: out.append(
        procs[0].stdout.read().decode()), daemon=True)
    pump.start()
    deadline = time.monotonic() + TIMEOUT_S
    code = 0
    try:
        problem = check() if check else None
        if problem:
            print(f"portbench: {problem}", file=sys.stderr, flush=True)
            return 2, ""
        while any(p.poll() is None for p in procs):
            bad = [p.returncode for p in procs if p.returncode]
            if bad or time.monotonic() > deadline:
                code = bad[0] if bad else 124
                break
            time.sleep(0.2)
        else:
            code = next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    pump.join(timeout=20)
    return code, "".join(out)
