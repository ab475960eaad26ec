"""The call ``lstsq``: one solve of an overdetermined least-squares system
to solver accuracy by sketch-and-precondition, through the port's
``linalg.sketch_and_precondition`` (Blendenpik, LSRN: a SASO sketch of A
and b to d rows, the sketch's QR S A = Q R, the sketch-and-solve warm
start, CGLS on min ||A R^-1 y - b||, x = R^-1 y).

The configuration states the system (``system``: A's rows and columns,
its columns N(0, 1) scaled by ``logspace(0, -log10(cond), n)``, the noise
of b and the bank of solutions b is drawn from), the operator
(``operator``) and the solver's settings (``solver``). A is drawn on the
card from the seed at set-up, with a bank X of ``bank`` solutions and
A X; call i solves b_i = (A X)[:, i mod bank] + noise e_i against the
resident A, e_i drawn on the card from (seed, i), with an operator of its
own key, so no call can be served from what an earlier one left behind
and no pass over A is made outside the solver.

Traffic parameters (``traffic/<mix>.json``): ``operator`` and ``rhs``,
both ``fresh`` (a new key and a new b each call; nothing else is
offered).
"""

from __future__ import annotations

import math

import torch

from portbench import roofline
from portbench.reference import lstsq as reflsq
from portbench.workload import derive, randn

NUMBERS = ("x_rel_err", "resid_excess")


class Call:
    """The calls of one cell on its one card."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 rank: int = 0, world: int = 1, mesh=None):
        if mesh is not None or world != 1:
            raise ValueError("the lstsq call runs on one card")
        import randblas_tpu_torch as rt
        from randblas_tpu_torch import linalg, profiling
        self.rt, self.linalg, self.profiling = rt, linalg, profiling
        self.seed, self.device = seed, torch.device(device)
        system, op = config["system"], config["operator"]
        solver = config["solver"]
        m, n = system["rows"], system["cols"]
        self.op, self.noise = op, system["noise"]
        self.settings = {
            "d": op["d"], "operator": op["kind"], "vec_nnz": op["vec_nnz"],
            "tol": solver["tol_eps"] * torch.finfo(torch.float32).eps,
            "maxiter": solver["maxiter"],
            "warm_start": solver["warm_start"]}
        self.a = randn((m, n), derive(seed, "A"), self.device)
        self.a.mul_(torch.logspace(0, -math.log10(system["cond"]), n,
                                   device=self.device))
        bank = randn((n, system["bank"]), derive(seed, "X"), self.device)
        self.ax = self.a @ bank
        self._qr = None             # A's float64 QR, made by the first judge

    # -- the calls ------------------------------------------------------

    def key(self, i: int) -> int:
        """The operator key of call i (negative i: warm-up calls)."""
        return derive(self.seed, "op", i)

    def rhs(self, i: int) -> torch.Tensor:
        """b_i, made on the card: a column of the bank and fresh noise."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(derive(self.seed, "e", i, bits=63))
        e = torch.randn(self.a.shape[0], generator=gen, device=self.device)
        return self.ax[:, i % self.ax.shape[1]] + self.noise * e

    def solve(self, b: torch.Tensor, key: int):
        """(x, CGLS steps, next state) of the port's solver."""
        return self.linalg.sketch_and_precondition(
            self.a, b, self.rt.RNGState.from_key(key), **self.settings)

    def call(self, i: int, spans=None, counts=None):
        """Call i: x of b_i. ``counts``, where given, gets the CGLS steps
        the solver returned (``cgls_steps``). ``spans``, where given, gets
        from the port's own spans the seconds up to the first convergence
        test's return (``precondition``: the outer span less its steps)
        and each step's (``cgls_step``)."""
        b, key = self.rhs(i), self.key(i)
        if spans is None:
            x, steps, _ = self.solve(b, key)
        else:
            with self.profiling.recording() as rec:
                x, steps, _ = self.solve(b, key)
            _read_spans(rec.spans, steps, spans)
        if counts is not None:
            counts.setdefault("cgls_steps", []).append(steps)
        return x

    # -- what the reference needs ---------------------------------------

    def local(self, out) -> torch.Tensor:
        return out

    def exact_part(self, i: int) -> torch.Tensor:
        """float64 x* of call i (A's QR made once and kept)."""
        if self._qr is None:
            self._qr = reflsq.factor(self.a)
        return reflsq.exact(self.a, self.rhs(i), self._qr)

    def control_part(self, i: int, precision: str) -> torch.Tensor:
        """x of call i by the control in ``precision``."""
        s = self.settings
        return reflsq.control(self.a, self.rhs(i), self.key(i), precision,
                              d=s["d"], vec_nnz=s["vec_nnz"], tol=s["tol"],
                              maxiter=s["maxiter"])

    def judge(self, i: int, out, exact: torch.Tensor,
              control: bool = False) -> dict:
        """``x_rel_err`` = ||x - x*|| / ||x*|| and ``resid_excess`` =
        ||b - A x|| / ||b - A x*|| - 1 of call i's x; infinite where the
        shape differs or a value is not finite."""
        if tuple(out.shape) != tuple(exact.shape):
            return {k: math.inf for k in NUMBERS}
        x = out.to(torch.float64)
        b = self.rhs(i)
        got = {"x_rel_err": float(torch.linalg.vector_norm(x - exact)
                                  / torch.linalg.vector_norm(exact)),
               "resid_excess": reflsq.residual(self.a, x, b)
               / reflsq.residual(self.a, exact, b) - 1.0}
        if not all(math.isfinite(v) for v in got.values()):
            return {k: math.inf for k in NUMBERS}
        return got


def _read_spans(recorded, steps: int, spans: dict) -> None:
    """Append one solve's span readings to ``spans``: nothing where the
    program records no ``sketch_and_precondition`` span (a version of the
    port without the solver's spans); raise where the ``cgls`` span's
    count or its steps' spans disagree with ``steps``."""
    outer = [s for s in recorded if s.name == "sketch_and_precondition"]
    if not outer:
        return
    cgls = [s for s in recorded if s.name == "cgls"]
    step_s = [(s.end_ns - s.start_ns) * 1e-9 for s in recorded
              if s.name == "cgls.step"]
    if (len(outer) != 1 or len(cgls) != 1 or len(step_s) != steps
            or cgls[0].args.get("steps") != steps):
        raise RuntimeError(f"the solver's spans do not hold its {steps} "
                           "CGLS steps")
    whole = (outer[0].end_ns - outer[0].start_ns) * 1e-9
    spans.setdefault("precondition", []).append(whole - sum(step_s))
    spans.setdefault("cgls_step", []).extend(step_s)


def work(config: dict, counts: dict) -> tuple:
    """(operations, bytes) of one solve, the steps the mean over the
    traced window's calls (``counts["cgls_steps"]``; none counted: no
    step). Only what no correct solve of this problem can skip: one pass
    over A for its sketch, two for each CGLS step (A v and A^T r);
    operations the sketch's 2 k m n, the sketch's QR 2 d n^2 - 2/3 n^3, and
    a step's 4 m n + 2 n^2 (two passes, two triangular solves with R).
    Left out: the warm start's residual passes and the A^T b that the
    stopping rule takes as its scale, which a later solver may drop, so
    that such a solver cannot read over 100%."""
    system, op = config["system"], config["operator"]
    m, n, d, k = system["rows"], system["cols"], op["d"], op["vec_nnz"]
    got = counts.get("cgls_steps") or [0]
    steps = sum(got) / len(got)
    ops = 2 * k * m * n + 2 * d * n * n - 2 * n ** 3 / 3 \
        + steps * (4 * m * n + 2 * n * n)
    nbytes = (1 + 2 * steps) * m * n * roofline.ITEMSIZE[system["dtype"]]
    return ops, nbytes


def precision(config: dict, expect: dict) -> str:
    """The precision the configuration states for a solve: CGLS's
    products over A are float32 (K4's bf16 rounding of A shapes only the
    preconditioner)."""
    return config["precision"]


def check(spec: dict) -> None:
    """Raise ValueError where the configuration, traffic or stated
    expectations are not a solve this call makes."""
    config, traffic, expect = spec["config"], spec["traffic"], spec["expect"]
    if config.get("chips") != 1 or config.get("mesh") is not None:
        raise ValueError("the lstsq call runs on one card, with no mesh")
    if config.get("operator", {}).get("kind") != "saso":
        raise ValueError("the lstsq call sketches with a SASO")
    if config["system"].get("dtype") != "float32" \
            or config.get("precision") != "float32":
        raise ValueError("the lstsq call solves a float32 system")
    if (traffic.get("operator"), traffic.get("rhs")) != ("fresh", "fresh"):
        raise ValueError("the lstsq call takes a fresh operator and a "
                         "fresh b each call")
    if set(expect.get("limits", {})) != set(NUMBERS):
        raise ValueError(f"the lstsq call compares {list(NUMBERS)}")
