"""Multi-host meshes of the port (parallel/multihost.py) with mocked host
maps: the arrangement tests of tests/test_multihost.py over ranks, each
arrangement also held against the JAX package's on the same map (a rank
standing for a device whose process is its host), and the arguments
``initialize_multihost`` hands ``torch.distributed``. The live case (four
gloo ranks as two "hosts" of LOCAL_WORLD_SIZE=2) is
tests/test_torch_distributed_live.py::test_live_case[multihost]."""

import numpy as np
import pytest

from randblas_tpu.parallel import (
    arrange_multihost_devices as j_arrange)
from randblas_tpu_torch import parallel as tpar
from randblas_tpu_torch.parallel import multihost as tmh


class FakeDev:
    def __init__(self, id, process_index):
        self.id = id
        self.process_index = process_index


def _fleet(num_procs, per):
    """Ranks and their hosts, interleaved so that "sorted by rank" and
    "grouped by host" differ (rank p + num_procs * i lives on host p)."""
    host = {p + num_procs * i: p for p in range(num_procs)
            for i in range(per)}
    return sorted(host), host.__getitem__


def _same_as_jax(ranks, host, model, data=None):
    arr = tpar.arrange_multihost_devices(ranks, model, data,
                                         process_index_of=host)
    jarr = j_arrange([FakeDev(r, host(r)) for r in ranks], model, data)
    assert arr.tolist() == [[d.id for d in row] for row in jarr]
    return arr


def test_model_within_process_data_process_major():
    ranks, host = _fleet(num_procs=4, per=4)
    arr = _same_as_jax(ranks, host, model=2)
    assert arr.shape == (2, 8)
    for i in range(4):   # each data block of width per/model is one host
        assert {host(r) for r in arr[:, 2 * i:2 * i + 2].ravel()} == {i}
    for j in range(8):   # 'model' never crosses a host
        assert len({host(r) for r in arr[:, j]}) == 1
    assert sorted(arr.ravel().tolist()) == ranks


def test_model_spanning_whole_processes():
    ranks, host = _fleet(num_procs=4, per=2)
    arr = _same_as_jax(ranks, host, model=4, data=2)
    assert arr.shape == (4, 2)
    for g in range(2):
        for j in range(2):
            assert len({host(r) for r in arr[2 * g:2 * g + 2, j]}) == 1
    assert [host(arr[0, 0]), host(arr[0, 1]), host(arr[2, 0])] == [0, 1, 2]
    assert sorted(arr.ravel().tolist()) == ranks


def test_single_process_matches_make_sketch_mesh_layout():
    ranks = list(range(8))
    arr = _same_as_jax(ranks, lambda r: 0, model=2)
    assert arr.tolist() == np.arange(8).reshape(2, 4).tolist()


def test_rejects_uneven_and_straddling_configs():
    with pytest.raises(ValueError, match="same number"):
        tpar.arrange_multihost_devices([0, 1, 2], 1,
                                       process_index_of=lambda r: r // 2)
    ranks, host = _fleet(num_procs=3, per=4)   # 12 ranks
    with pytest.raises(ValueError, match="split a process"):
        tpar.arrange_multihost_devices(ranks, 6, 2, process_index_of=host)
    with pytest.raises(ValueError, match="mesh"):
        tpar.arrange_multihost_devices(ranks, 2, 2, process_index_of=host)
    with pytest.raises(ValueError, match="not divisible"):
        tpar.arrange_multihost_devices(ranks, 5, process_index_of=host)


def test_hosts_default_to_local_world_size(monkeypatch):
    """Without a host map a rank's host is rank // LOCAL_WORLD_SIZE
    (torchrun's)."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    arr = tpar.arrange_multihost_devices(list(range(8)), model=2)
    assert arr.tolist() == [[0, 2, 4, 6], [1, 3, 5, 7]]
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    arr = tpar.arrange_multihost_devices(list(range(8)), model=4, data=2)
    assert arr.tolist() == [[0, 4], [1, 5], [2, 6], [3, 7]]


def test_initialize_multihost_arguments(monkeypatch):
    calls = []
    monkeypatch.setattr(tmh.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    tpar.initialize_multihost("host0:8476", num_processes=4, process_id=1)
    tpar.initialize_multihost(backend="gloo", timeout=None)
    tpar.initialize_multihost("tcp://10.0.0.1:29500", 2, 0)
    assert calls == [
        dict(init_method="tcp://host0:8476", world_size=4, rank=1,
             backend="cuda:nccl,cpu:gloo"),
        dict(init_method="env://", backend="gloo", timeout=None),
        dict(init_method="tcp://10.0.0.1:29500", world_size=2, rank=0,
             backend="cuda:nccl,cpu:gloo")]


def test_meshes_need_a_process_group():
    with pytest.raises(ValueError, match="process group"):
        tpar.make_multihost_sketch_mesh(model=1, device_type="cpu")
