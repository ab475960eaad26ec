"""allreduce_wait_ms: how long the cards wait for the slowest at the
all-reduce. For each rank, the device time a call of the NCCL kernels
launched inside the program's ``sum_over`` span; the mean over the ranks
of that time less the least rank's (whose kernel waits for no one), in
ms."""


def read(s):
    per = s["allreduce_s"]
    if len(per) < 2:
        return None
    least = min(per)
    return 1e3 * sum(x - least for x in per) / len(per)
