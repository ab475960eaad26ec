"""Multi-host process groups and meshes (counterpart of
randblas_tpu/parallel/multihost.py).

Nothing in ``distributed.py`` depends on where a rank runs: counter
addressing gives each rank its tile of the global operator from (seed,
mesh coordinates) alone. What changes across hosts is the cost of the one
collective the sketches issue, the all-reduce over 'data': links between
hosts are an order of magnitude slower than NVLink inside one. So the rank
order inside the mesh decides whether that all-reduce can run
hierarchically (inside each host first).

torch.distributed runs one rank per GPU, and a host is a group of ranks
(``LOCAL_WORLD_SIZE`` of them under torchrun). The meshes built here are
host-contiguous:

* 'model' stays inside a host whenever it divides the ranks per host;
* 'data' is host-major: consecutive blocks of the 'data' axis belong to
  one host.

Launch, one process per GPU on every host:

    torchrun --nnodes=H --nproc-per-node=G --rdzv-endpoint=HOST0:29500 prog.py

    # in prog.py
    import randblas_tpu_torch.parallel as par
    par.initialize_multihost()               # torchrun's environment, or
    # par.initialize_multihost("host0:29500", num_processes=H * G,
    #                          process_id=rank)
    mesh = par.make_multihost_sketch_mesh(model=2)
    B = par.distributed_sketch(S, A, mesh)   # as on one host
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..base import require
from .distributed import MESH_DIMS

DEFAULT_BACKEND = "cuda:nccl,cpu:gloo"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         **kwargs) -> None:
    """Initialize the default process group (a thin wrapper of
    ``torch.distributed.init_process_group``), once, at program start.

    With ``coordinator_address`` ("host:port" of rank 0's store) the group
    meets there (``tcp://``) with ``num_processes`` ranks, this one
    ``process_id``. Without it, torchrun's environment (``env://``: MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK) says. The backend is NCCL for CUDA
    tensors and gloo for CPU ones unless ``backend=`` says otherwise; other
    keywords go to ``init_process_group``. Under torchrun each rank takes
    the GPU of its ``LOCAL_RANK``."""
    kwargs.setdefault("backend", DEFAULT_BACKEND)
    if coordinator_address is not None:
        addr = coordinator_address
        init = addr if "://" in addr else f"tcp://{addr}"
    else:
        init = "env://"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    if "LOCAL_RANK" in os.environ and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(init_method=init, **kwargs)


def _local_world_size() -> int:
    """Ranks per host: torchrun's ``LOCAL_WORLD_SIZE``, else all ranks on
    one host."""
    env = os.environ.get("LOCAL_WORLD_SIZE")
    if env is not None:
        return int(env)
    return dist.get_world_size() if dist.is_initialized() else 1


def _group_by_host(ranks, process_index_of=None):
    """Ordered {host: [ranks in ascending order]}; every host must hold as
    many ranks (a mesh is a full grid)."""
    if process_index_of is None:
        per_host = _local_world_size()
        process_index_of = lambda r: r // per_host  # noqa: E731
    groups = {}
    for r in ranks:
        groups.setdefault(process_index_of(r), []).append(r)
    hosts = sorted(groups)
    per = len(groups[hosts[0]])
    require(all(len(groups[h]) == per for h in hosts),
            "every process must expose the same number of devices "
            f"(got {[len(groups[h]) for h in hosts]})")
    return {h: sorted(groups[h]) for h in hosts}


def arrange_multihost_devices(devices, model: int,
                              data: Optional[int] = None, *,
                              process_index_of=None) -> np.ndarray:
    """A (model, data) array of ranks, host-contiguous.

    * ``model`` divides the ranks per host: each host contributes a (model,
      per/model) tile, tiles side by side along 'data' in host order.
      'model' never crosses a host; 'data' is host-major.
    * ``model`` spans whole hosts (``model % per == 0``): hosts stack along
      'model' in groups of ``model/per`` (host r -> model group r // data,
      data column r % data), each host's ranks contiguous along 'model'.

    Anything else would split a host across both axes and is rejected.
    ``devices`` are ranks; ``process_index_of`` maps a rank to its host
    (default: rank // ``LOCAL_WORLD_SIZE``)."""
    groups = _group_by_host(devices, process_index_of)
    hosts = list(groups)
    per = len(groups[hosts[0]])
    n = per * len(hosts)
    if data is None:
        require(n % model == 0, f"{n} devices not divisible by model={model}")
        data = n // model
    require(model * data == n,
            f"mesh {model}x{data} != {n} devices across "
            f"{len(hosts)} processes")
    arr = np.empty((model, data), dtype=np.int64)
    if per % model == 0:
        dpp = per // model                       # data shards per host
        for i, h in enumerate(hosts):
            arr[:, i * dpp:(i + 1) * dpp] = np.array(
                groups[h]).reshape(model, dpp)
    elif model % per == 0:
        ppg = model // per                       # hosts per model column
        require(len(hosts) == ppg * data,
                f"model={model} spanning {ppg} processes/column needs "
                f"{ppg * data} processes, have {len(hosts)}")
        for i, h in enumerate(hosts):
            g, j = divmod(i, data)
            arr[g * per:(g + 1) * per, j] = groups[h]
    else:
        require(False,
                f"model={model} neither divides nor is divisible by the "
                f"per-process device count {per}; such a mesh would split "
                "a process across both axes")
    return arr


def make_multihost_sketch_mesh(model: int = 1, data: Optional[int] = None,
                               *, devices=None, process_index_of=None,
                               device_type: str = "cuda") -> DeviceMesh:
    """A ('model', 'data') DeviceMesh over all ranks (or ``devices``) in
    host-contiguous order (``arrange_multihost_devices``): the multi-host
    counterpart of ``make_sketch_mesh``, to which it reduces on one host.
    Call after ``initialize_multihost()``, on every rank with the same
    arguments."""
    require(dist.is_available() and dist.is_initialized(),
            "make_multihost_sketch_mesh needs an initialized process group "
            "(initialize_multihost)")
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    arr = arrange_multihost_devices(ranks, model, data,
                                    process_index_of=process_index_of)
    return DeviceMesh(device_type, torch.from_numpy(arr),
                      mesh_dim_names=MESH_DIMS)
