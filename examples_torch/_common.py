"""What the examples share: how they are timed and where their data are
drawn. Each runs on ``randblas_tpu_torch.dense.default_device(device)``:
the card unless asked for the CPU, raising without one."""

from __future__ import annotations

import torch

from randblas_tpu_torch import profiling

# Entries up to which an example draws its data from the JAX example's
# numpy generator (and so its inputs equal the JAX example's for the same
# seed); past it, numpy would take seconds, and the data are drawn with the
# same distribution on the device from a torch generator of the same seed.
HOST_DRAWS_MAX = 2 ** 25


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        local = getattr(out, "to_local", None)
        return local() if local is not None else out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        for x in out:
            t = _first_tensor(x)
            if t is not None:
                return t
    cores = getattr(out, "cores", None)
    return None if cores is None else _first_tensor(list(cores))


def timed(fn, *tensors):
    """``(fn(), seconds of one call)`` by ``profiling.time_op``: a warm-up
    call, then one timed call, with CUDA events when one of ``tensors``
    lies on the card and the host clock otherwise (as the JAX examples
    time the second call, after compilation). The result feeds the
    carry, so no call is skipped."""
    result = []

    def step(i, carry, *_):
        out = fn()
        result[:] = [out]
        t = _first_tensor(out)
        if t is None or t.numel() == 0:
            return carry
        return carry + t.reshape(-1)[0].detach().to(carry.dtype) * 0

    t = profiling.time_op(step, *tensors, flops=0.0, iters_large=1)
    return result[0], t.seconds
