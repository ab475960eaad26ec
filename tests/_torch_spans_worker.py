"""One rank of the two-rank gloo group of tests/test_torch_profiling.py (not
collected by pytest). It imports torch and the port only.

    python tests/_torch_spans_worker.py ADDRESS RANK WORLD OUT_DIR

Every rank joins a gloo group at tcp://ADDRESS, builds a 1 x WORLD
('model', 'data') mesh, runs ``distributed_sketch`` once with span
recording off and once with it on, and writes OUT_DIR/rank<RANK>.json: the
recorded spans (name, start_ns, end_ns, parent, call) and whether the two
outputs are bitwise equal.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import randblas_tpu_torch as rt  # noqa: E402
from randblas_tpu_torch import parallel as par  # noqa: E402
from randblas_tpu_torch import profiling  # noqa: E402


def main() -> None:
    address, rank, world, out_dir = sys.argv[1:5]
    torch.set_num_threads(1)
    par.initialize_multihost(address, num_processes=int(world),
                             process_id=int(rank), backend="gloo")
    mesh = par.make_sketch_mesh(1, int(world), device_type="cpu")
    S = rt.DenseSkOp(rt.DenseDist(12, 40), rt.RNGState.from_key(9))
    A = torch.randn(40, 6, generator=torch.Generator().manual_seed(1))
    off = par.distributed_sketch(S, A, mesh).to_local()
    with profiling.recording() as rec:
        on = par.distributed_sketch(S, A, mesh).to_local()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"spans": [list(s[:5]) for s in rec.spans],
                   "bitwise": torch.equal(off, on)}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
