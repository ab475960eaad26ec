"""A rank of a two-process gloo rehearsal of ``spans.py`` on the CPU: its
windows on a tiny copy of the four-card cell on a 1 x 2 mesh; rank 0
prints the tool's line."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from _pb_tiny import tiny  # noqa: E402
from portbench import spans  # noqa: E402


def main():
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    from randblas_tpu_torch import parallel
    mesh = parallel.make_sketch_mesh(1, 2, device_type="cpu")
    spec = tiny("dense_gauss_rows_x4.whole")
    part = spans.measure(spec, 2 ** 31 + 23, 0.2, 1, "cpu", mesh)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, part)
    if dist.get_rank() == 0:
        print(json.dumps(spans.report(spec, parts)), flush=True)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
