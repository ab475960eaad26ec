"""A rank of a four-process gloo rehearsal of the four-card cell on the
CPU: the harness's run on a tiny copy of the cell, with the exchange
between ranks left out when ``PB_FAULT=exchange``, and with ``jax`` put
into rank 2's modules when ``PB_FAULT=jax``. Rank 0 finishes the run as
the benchmark does: it prints the last line, or exits with another code
than 0."""

import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from _pb_tiny import tiny  # noqa: E402
from portbench import harness, run as prun  # noqa: E402


def main():
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    from randblas_tpu_torch import parallel
    from randblas_tpu_torch.parallel import distributed
    if os.environ.get("PB_FAULT") == "exchange":
        distributed._all_reduce = lambda t, group: t
    mesh = parallel.make_sketch_mesh(1, 4, device_type="cpu")
    if os.environ.get("PB_FAULT") == "jax" and dist.get_rank() == 2:
        sys.modules["jax"] = types.ModuleType("jax")
    spec = tiny("dense_gauss_rows_x4.whole")
    part = harness.run(spec, 2 ** 31 + 17, 0.3, False, "cpu", time.time(),
                       mesh)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, part)
    code = 0
    if dist.get_rank() == 0:
        code = prun.finish(spec, parts, False, "cpu")
    dist.barrier()
    dist.destroy_process_group()
    return code


if __name__ == "__main__":
    sys.exit(main())
