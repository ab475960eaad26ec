"""The one generator of calls: a configuration (operator, data, cards)
under a traffic mix (data parameters only) becomes a closed loop of calls
into the measured program, ``randblas_tpu_torch``.

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

import hashlib
import math
import time

import torch

from .reference import compare, sketch as refsketch

CHUNK = 1 << 30           # elements of one randn call


def derive(seed: int, *what, bits: int = 32) -> int:
    """A ``bits``-wide integer drawn from (seed, what)."""
    h = hashlib.blake2b(repr((int(seed),) + what).encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") & ((1 << bits) - 1)


def randn(shape, seed: int, device) -> torch.Tensor:
    """float32 N(0, 1) data of ``shape`` from a generator on ``device``
    seeded from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "data", bits=63))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        flat[i:i + CHUNK].normal_(generator=gen)
    return out


def sync(device) -> None:
    """Wait for the card's work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Workload:
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

    def call(self, i: int, spans=None):
        """Call i: its operator (filled first where the traffic says so)
        applied to A. ``spans``, where given, gets the seconds of the
        explicit fill, ended by a synchronize."""
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

    def judge(self, i: int, out, exact: torch.Tensor) -> dict:
        """The numbers of call i's output against the exact product; on a
        mesh also ``placement``: 1 where the output is not a DTensor of the
        full (d, n) shape laid out [Shard(0), Replicate()], else 0."""
        got = compare.gaps(self.local(out), exact)
        if self.mesh is not None:
            from torch.distributed.tensor import Replicate, Shard
            ok = (hasattr(out, "placements")
                  and tuple(out.placements) == (Shard(0), Replicate())
                  and tuple(out.shape) == tuple(exact.shape))
            got["placement"] = 0 if ok else 1
        return got


def p95(values) -> float:
    """The 95th percentile, interpolated between order statistics."""
    xs = sorted(values)
    pos = 0.95 * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
