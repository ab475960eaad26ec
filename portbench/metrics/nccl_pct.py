"""nccl_pct: the share of rank 0's device busy time spent in NCCL's
kernels (names that start with ``nccl``): the all-reduce over 'data' and
its wait for the slowest rank."""


def read(s):
    nccl = sum(v for k, v in s["ops_s"].items() if k.startswith("nccl"))
    if not nccl or not s["busy_s_rank0"]:
        return None
    return 100.0 * nccl / s["busy_s_rank0"]
