"""Multi-host sketching demo you can run on one machine, on the
PyTorch/CUDA port (counterpart of examples/multihost_cpu_demo.py).

Spawns TWO OS processes, each standing for a host with one rank, connects
them with ``torch.distributed`` (gloo) over a localhost rendezvous, builds
the host-contiguous ('model', 'data') meshes from
``make_multihost_sketch_mesh`` and runs one ``distributed_sketch`` on each:
on the 1 x 2 mesh its all-reduce over 'data' crosses the process boundary,
on the 2 x 1 mesh 'model' spans the two hosts. It is the program shape
launched one process per GPU on every host of a cluster (torchrun, then
``initialize_multihost()`` with no arguments and the NCCL backend). A CPU
program by design: it never asks for the card.

Run: python examples_torch/multihost_cpu_demo.py
"""

import json
import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROCESSES = 2
TIMEOUT = 300      # seconds a process may take
D, M, N = 16, 64, 8


def worker(addr: str, pid: int, nproc: int) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    import randblas_tpu_torch as rb
    from randblas_tpu_torch.parallel import (
        distributed_sketch, initialize_multihost, make_multihost_sketch_mesh)

    torch.set_num_threads(1)
    # 1. join the cluster (under torchrun: no arguments, env-discovered)
    initialize_multihost(addr, num_processes=nproc, process_id=pid,
                         backend="gloo")
    try:
        print(f"[proc {pid}] rank {dist.get_rank()} of "
              f"{dist.get_world_size()}", flush=True)
        # 2. every process builds the SAME data (each would produce its
        #    own rows on a cluster; distribute_tensor keeps its shard)
        a_np = np.random.default_rng(0).normal(size=(M, N)).astype(
            np.float32)
        S = rb.DenseSkOp(rb.DenseDist(D, M), rb.RNGState.from_key(7))
        want = S.materialize(device="cpu").numpy() @ a_np
        blocks = {}
        for model in (1, PROCESSES):
            # 3. the same global mesh on every process
            mesh = make_multihost_sketch_mesh(model=model, device_type="cpu")
            A = distribute_tensor(torch.from_numpy(a_np), mesh,
                                  [Replicate(), Shard(0)])
            # 4. one distributed sketch: the operator tiles are generated
            #    per rank, the all-reduce over 'data' rides gloo
            B = distributed_sketch(S, A, mesh)
            # 5. verify the local output shard against the oracle
            mi = mesh.get_coordinate()[0]
            per = D // model
            local = B.to_local().numpy()
            np.testing.assert_allclose(local, want[mi * per:(mi + 1) * per],
                                       rtol=2e-5, atol=1e-5)
            blocks[f"{model}x{nproc // model}"] = [mi * per, local.tolist()]
        print(f"[proc {pid}] sketch verified against the single-device "
              f"oracle on meshes {sorted(blocks)}", flush=True)
        print("RESULT " + json.dumps({"pid": pid, "blocks": blocks}),
              flush=True)
    finally:
        dist.destroy_process_group()


def _run_once():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    # each process is a host of one rank
    env = dict(os.environ, LOCAL_WORLD_SIZE="1", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker",
         f"localhost:{port}", str(i), str(PROCESSES)], env=env,
        stdout=subprocess.PIPE, text=True) for i in range(PROCESSES)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:          # never leak a gloo-holding orphan
            p.kill()
        for p in procs:
            p.wait()
        return [1] * PROCESSES, []
    return [p.returncode for p in procs], outs


def run():
    """Start the processes (one retry: the probed port can be taken before
    the rendezvous binds it). Returns (exit codes, each process's output)."""
    rc, outs = _run_once()
    if any(rc):
        rc, outs = _run_once()
    return rc, outs


def main() -> None:
    rc, outs = run()
    for text in outs:
        print("\n".join(line for line in text.splitlines()
                        if not line.startswith("RESULT ")))
    if any(rc):
        raise SystemExit(f"worker exit codes: {rc}")
    print("both processes verified")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        main()
