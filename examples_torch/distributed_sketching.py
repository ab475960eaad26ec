"""Multi-device sketching on the PyTorch/CUDA port: one global operator,
zero-communication generation, one all-reduce for the contraction
(counterpart of examples/distributed_sketching.py).

On the card it joins the process group of the ranks present (an NCCL
group of one rank and a 1 x 1 mesh when started alone; under torchrun,
every rank's GPU). With ``--cpu`` it starts ``--ranks`` processes (8, as
the JAX example's virtual CPU devices) in a gloo group on localhost. Shows:
mesh-shape invariance of the generated operator (each model x data mesh
the JAX example loops over, against ``sketch_general``), the sharded
sketch, and a distributed rangefinder step and randomized SVD.

Run: python examples_torch/distributed_sketching.py [--cpu [--ranks R]]
"""

import argparse
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples_torch._common import (                        # noqa: E402
    HOST_DRAWS_MAX, timed)
from randblas_tpu_torch.dense import default_device   # noqa: E402
from randblas_tpu_torch import (                              # noqa: E402
    DenseDist, DenseSkOp, RNGState, sketch_general,
)
from randblas_tpu_torch.linalg import distributed_rsvd        # noqa: E402
from randblas_tpu_torch.parallel import (                     # noqa: E402
    distributed_sketch, initialize_multihost, make_sketch_mesh,
)

CPU_RANKS = 8
TIMEOUT = 300      # seconds a CPU rank may take
RSVD_RANK = 6


def body(d, m, n, dev):
    """On every rank of the initialized group: the sketch on each model x
    data mesh against sketch_general, the rangefinder step and
    distributed_rsvd. Returns the results (floats and lists) and "call",
    the timed distributed sketch."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    world = dist.get_world_size()
    rows = [Replicate(), Shard(0)]
    S = DenseSkOp(DenseDist(d, m), RNGState.from_key(42))
    if m * n <= HOST_DRAWS_MAX:
        A = torch.from_numpy(np.random.default_rng(0).normal(
            size=(m, n)).astype(np.float32)).to(dev)
    else:
        A = torch.randn(m, n, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0))
    reference = sketch_general(S, A)

    out = {"world": world, "meshes": {}}
    for model in (1, 2):
        data = world // model
        if model * data != world or d % model or m % data:
            continue
        mesh = make_sketch_mesh(model, data, device_type=dev.type)
        B = distributed_sketch(S, distribute_tensor(A, mesh, rows), mesh)
        full = B.full_tensor()
        out["meshes"][f"{model}x{data}"] = {
            "placements": [str(p) for p in B.placements],
            "max_abs_diff": float((full - reference).abs().max()),
            "B": full.cpu().tolist()}

    # distributed rangefinder step: sketch then orthonormalize
    mesh = make_sketch_mesh(1, world, device_type=dev.type)
    A_sh = distribute_tensor(A, mesh, rows)
    out["call"] = lambda: distributed_sketch(S, A_sh, mesh)
    B, sec = timed(out["call"], A)
    _, sec_single = timed(lambda: sketch_general(S, A), A)
    q, _ = torch.linalg.qr(B.full_tensor().T)
    eye = torch.eye(q.shape[1], device=dev)
    out["orth_err"] = float((q.T @ q - eye).abs().max())
    out["seconds"], out["seconds_single"] = sec, sec_single

    # full distributed randomized SVD: the m-sized factors stay sharded
    # end to end (CholQR Gram all-reduces are the only collectives)
    rng = np.random.default_rng(1)
    u0, _ = np.linalg.qr(rng.normal(size=(m, RSVD_RANK)))
    v0, _ = np.linalg.qr(rng.normal(size=(n, RSVD_RANK)))
    s_true = np.linspace(5.0, 1.0, RSVD_RANK)
    M = (torch.from_numpy(u0 * s_true).to(dev)
         @ torch.from_numpy(v0.T).to(dev)).float()
    U, s_hat, _ = distributed_rsvd(distribute_tensor(M, mesh, rows),
                                   RSVD_RANK, RNGState.from_key(7), mesh)
    out["U_placements"] = [str(p) for p in U.placements]
    out["s_hat"] = s_hat.cpu().tolist()
    out["sv_err"] = float(np.abs(s_hat.cpu().numpy() - s_true).max())
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(d, m, n, ranks):
    """``ranks`` CPU processes in one gloo group; rank 0's results, or
    None if a rank failed or timed out."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    addr = f"localhost:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", addr,
         str(r), str(ranks), str(d), str(m), str(n)], env=env, text=True,
        stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL)
        for r in range(ranks)]
    try:
        text, _ = procs[0].communicate(timeout=TIMEOUT)
        rcs = [procs[0].returncode] + [p.wait(timeout=TIMEOUT)
                                       for p in procs[1:]]
    except subprocess.TimeoutExpired:
        for p in procs:          # never leak a gloo-holding orphan
            p.kill()
        for p in procs:
            p.wait()
        return None
    if any(rcs):
        return None
    return next(json.loads(line[7:]) for line in text.splitlines()
                if line.startswith("RESULT "))


def run(d=32, m=1024, n=64, device=None, ranks=CPU_RANKS):
    """The results of ``body`` (rank 0's; no "call" on the CPU). On the
    CPU: ``ranks`` processes
    in a gloo group (one retry: the probed port can be taken before the
    store binds it). On the card: the initialized process group, else an
    NCCL group of this one rank, torn down afterwards."""
    dev = default_device(device)
    if dev.type == "cpu":
        out = _spawn(d, m, n, ranks) or _spawn(d, m, n, ranks)
        if out is None:
            raise RuntimeError("a CPU rank failed or timed out")
        return out
    own = not dist.is_initialized()
    if own:
        initialize_multihost(f"localhost:{_free_port()}", num_processes=1,
                             process_id=0)
    try:
        return body(d, m, n, dev)
    finally:
        if own:
            dist.destroy_process_group()


def _worker(addr, rank, world, d, m, n):
    torch.set_num_threads(1)
    initialize_multihost(addr, num_processes=world, process_id=rank,
                         backend="gloo")
    try:
        out = body(d, m, n, torch.device("cpu"))
    finally:
        dist.destroy_process_group()
    out.pop("call")
    if rank == 0:
        print("RESULT " + json.dumps(out), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cpu", action="store_true",
                   help="CPU processes in a gloo group (default: the card)")
    p.add_argument("--ranks", type=int, default=CPU_RANKS,
                   help="processes with --cpu")
    args = p.parse_args(argv)
    r = run(device="cpu" if args.cpu else None, ranks=args.ranks)
    print(f"ranks: {r['world']} ({'cpu, gloo' if args.cpu else 'cuda'})")
    for shape, res in r["meshes"].items():
        print(f"mesh {shape}: B ({len(res['B'])}, {len(res['B'][0])}) "
              f"placements {res['placements']}, max |diff| vs "
              f"single-device = {res['max_abs_diff']:.2e}")
    print(f"rangefinder Q orthonormality error {r['orth_err']:.2e}")
    print(f"distributed_rsvd: U placements {r['U_placements']}, "
          f"singular-value error {r['sv_err']:.2e}")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        _worker(sys.argv[2], *map(int, sys.argv[3:8]))
    else:
        main()
