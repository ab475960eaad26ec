"""What every call shares: keys and data drawn from the seed, the wait
for the card, the 95th percentile. A call itself (``calls/<call>.py``)
turns a configuration under a traffic mix into a closed loop of calls
into the measured program, ``randblas_tpu_torch``.
"""

from __future__ import annotations

import hashlib
import math

import torch

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


def p95(values) -> float:
    """The 95th percentile, interpolated between order statistics."""
    xs = sorted(values)
    pos = 0.95 * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
