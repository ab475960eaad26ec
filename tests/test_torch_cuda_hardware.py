"""The port's card tier: its kernels and entry points on a CUDA device, the
counterpart of tests/test_tpu_hardware.py. Run on a machine with an NVIDIA
H100 from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda_hardware.py

``--noconftest`` keeps pytest from loading tests/conftest.py, which imports
JAX to pin the JAX suite to the CPU; this file and the cases it runs
(tests/_torch_cuda_cases.py) import neither JAX nor the JAX package. Every
test is marked ``cuda`` and skips only where ``torch.cuda.is_available()``
is False. On a card a kernel that does not build or launch fails its test;
no case falls back to a plain version.

- ``test_counterpart``: one test per case of ``COUNTERPARTS``, each a test
  function of tests/test_tpu_hardware.py at its shapes and bounds (30
  tests for 29 functions), each with the launches and routes it must show.
- ``test_branch``: the Hopper branches of K1-K6 (``BRANCHES``), each held
  against its plain version on the card, with its launch and the facts
  (load mode, launch plan) it must reach on the recorded card.
- ``test_branch_grid_on_this_card``: the grid reaches every branch value
  with the occupancy this card reports.

The distributed cases run on a one-rank NCCL process group and a 1 x 1
mesh, made once for the module and torn down after it. TF32 is off for
float32 products while the module runs.
"""

import socket

import pytest
import torch

import _torch_cuda_cases as cases

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.fixture(scope="module")
def nccl_mesh(card):
    import torch.distributed as dist
    from randblas_tpu_torch import parallel as par
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    par.initialize_multihost(f"localhost:{port}", num_processes=1,
                             process_id=0)
    try:
        mesh = par.make_sketch_mesh(1, 1)
        assert "nccl" in str(dist.get_backend(mesh.get_group("data")))
        yield mesh
    finally:
        dist.destroy_process_group()


def _counterpart_params():
    for name, cids in cases.COUNTERPARTS.items():
        for cid in cids:
            suffix = cid.split("-", 1)[1:]
            yield pytest.param(cid, id="-".join([name[5:]] + suffix))


@pytest.mark.parametrize("cid", list(_counterpart_params()))
def test_counterpart(cid, card, request):
    kw = ({"mesh": request.getfixturevalue("nccl_mesh")}
          if cid in cases.NEEDS_MESH else {})
    out = cases.CASES[cid](card, "card", **kw)
    torch.cuda.synchronize()
    cases.verify(out, card)


def _occupancy(device):
    from randblas_tpu_torch.ops import fused_sketch as fs
    from randblas_tpu_torch.ops import saso_sketch as saso
    return fs.max_active_clusters(device), saso.max_active_ctas(device)


@pytest.mark.parametrize("bid", list(cases.BRANCHES))
def test_branch(bid, card):
    active, ctas = _occupancy(card)
    facts = cases.branch_facts(bid, active, ctas)
    if (active, ctas) == (cases.CARD_MAX_ACTIVE_CLUSTERS,
                          cases.CARD_MAX_ACTIVE_CTAS):
        assert facts == cases.declared_facts(bid)
    else:   # another card: the grid as a whole is checked below
        assert facts.get("mode") == cases.declared_facts(bid).get("mode")
    out = cases.run_branch(bid, card, "card")
    torch.cuda.synchronize()
    cases.verify(out, card)


def test_branch_grid_on_this_card(card):
    active, ctas = _occupancy(card)
    reach = cases.grid_reach(active, ctas)
    for key, values in cases.grid_required(active).items():
        assert values <= reach[key], (key, values - reach[key])
