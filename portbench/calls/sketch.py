"""The call ``sketch``: one ``sketch_general`` (on a mesh one
``parallel.distributed_sketch``) of the whole resident A, the call of a
configuration that names no other.

Traffic parameters (``traffic/<mix>.json``):

- ``fill``: ``lazy`` hands the unfilled operator to the sketch (a dense
  one is then generated inside the kernel); ``explicit`` fills a sparse
  operator first (``fill_sparse``), the step the ``fill`` span times.

Every call sketches the whole resident A with an operator of its own key,
drawn from (seed, call index), so no call can be served from what an
earlier one left behind; the data is made on the card from the seed at
set-up, in a few large calls.
"""

from __future__ import annotations

import time

import torch

from portbench import roofline
from portbench.reference import compare, sketch as refsketch
from portbench.workload import derive, randn, sync


class Call:
    """The calls of one cell on one process (one rank of a mesh)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 rank: int = 0, world: int = 1, mesh=None):
        import randblas_tpu_torch as rt
        self.rt = rt
        self.op, data = config["operator"], config["data"]
        self.fill = traffic["fill"]
        self.seed, self.device = seed, torch.device(device)
        self.rank, self.world, self.mesh = rank, world, mesh
        m, n = data["rows"], data["cols"]
        if m != self.op["m"] or m % world:
            raise ValueError("the data must have the operator's m rows, "
                             "split evenly over the ranks")
        self.rows = m // world          # this rank's rows of A
        self.row0 = rank * self.rows
        self.a = randn((self.rows, n), derive(seed, "A", rank), self.device)

    # -- the calls ------------------------------------------------------

    def key(self, i: int) -> int:
        """The operator key of call i (negative i: warm-up calls)."""
        return derive(self.seed, "op", i)

    def operator(self, key: int):
        rt, op = self.rt, self.op
        state = rt.RNGState.from_key(key)
        if op["kind"] == "dense":
            return rt.DenseSkOp(rt.DenseDist(op["d"], op["m"]), state)
        return rt.SparseSkOp(rt.SparseDist(op["d"], op["m"], op["vec_nnz"]),
                             state)

    def call(self, i: int, spans=None, counts=None):
        """Call i: its operator (filled first where the traffic says so)
        applied to A. ``spans``, where given, gets the seconds of the
        explicit fill, ended by a synchronize; a sketch counts nothing."""
        S = self.operator(self.key(i))
        if self.fill == "explicit":
            t0 = time.perf_counter()
            S = self.rt.fill_sparse(S, device=self.device)
            if spans is not None:
                sync(self.device)
                spans.setdefault("fill", []).append(time.perf_counter() - t0)
        a = self.a
        if self.mesh is None:
            return self.rt.sketch_general(S, a)
        from randblas_tpu_torch import parallel
        from torch.distributed.tensor import DTensor, Replicate, Shard
        a_dt = DTensor.from_local(a, self.mesh, [Replicate(), Shard(0)],
                                  run_check=False,
                                  shape=(self.op["m"], a.shape[1]),
                                  stride=(a.shape[1], 1))
        return parallel.distributed_sketch(S, a_dt, self.mesh)

    # -- what the reference needs ---------------------------------------

    def local(self, out) -> torch.Tensor:
        """This rank's part of an output, as a plain tensor."""
        return out.to_local() if hasattr(out, "to_local") else out

    def exact_part(self, i: int) -> torch.Tensor:
        """This rank's float64 share of call i's exact product (the whole
        of it on one card)."""
        return refsketch.exact(self.op, self.key(i), self.a, self.row0)

    def control_part(self, i: int, precision: str) -> torch.Tensor:
        """This rank's share of call i by the control in ``precision``."""
        return refsketch.control(self.op, self.key(i), self.a, precision,
                                 self.row0)

    def judge(self, i: int, out, exact: torch.Tensor,
              control: bool = False) -> dict:
        """The numbers of call i's output against the exact product; on a
        mesh also ``placement``: 1 where the output is not a DTensor of the
        full (d, n) shape laid out [Shard(0), Replicate()], else 0. The
        control's output (``control``) is the reference's plain sum over
        the ranks, and has no placement to read."""
        got = compare.gaps(self.local(out), exact)
        if self.mesh is not None and not control:
            from torch.distributed.tensor import Replicate, Shard
            ok = (hasattr(out, "placements")
                  and tuple(out.placements) == (Shard(0), Replicate())
                  and tuple(out.shape) == tuple(exact.shape))
            got["placement"] = 0 if ok else 1
        return got


def work(config: dict, counts: dict) -> tuple:
    """(operations, bytes) of one call: B = S @ A with S the
    configuration's (d, m) operator and A its (m, n) data, the same in
    every call."""
    op, data = config["operator"], config["data"]
    d, m, n = op["d"], op["m"], data["cols"]
    if op["kind"] == "dense":
        ops = 2 * d * m * n
    else:                     # k nonzeros in each of the m columns
        ops = 2 * op["vec_nnz"] * m * n
    size = roofline.ITEMSIZE[data["dtype"]]
    return ops, (m * n + d * n) * size


def precision(config: dict, expect: dict) -> str:
    """The precision the configuration states for the cell's one route."""
    return config["precision"][expect["route"]]


def check(spec: dict) -> None:
    """Raise ValueError where the cell's configuration, traffic or stated
    expectations are not a sketch's."""
    config, traffic, expect = spec["config"], spec["traffic"], spec["expect"]
    if traffic.get("fill") not in ("lazy", "explicit"):
        raise ValueError(f"traffic fill {traffic.get('fill')!r} is neither "
                         "'lazy' nor 'explicit'")
    if expect.get("route") not in config["precision"]:
        raise ValueError(f"the cell's route {expect.get('route')!r} has no "
                         "precision in the configuration")
    missing = {"rel_fro", "max_rel"} - set(expect["limits"])
    if missing:
        raise ValueError(f"the cell states no limit of {sorted(missing)}")
