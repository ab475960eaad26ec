"""RNGState: the serializable snapshot of a counter-based RNG stream
(counterpart of randblas_tpu/rng/state.py).

A value of an operator is a function of (seed, position) alone, bit-identical
to Random123, so the state is just the counter and key words plus the
generator's name. The words are Python ints: advancing a state or handing
its seed to a kernel never touches a device. ``torch.Generator`` is not
used for operators.

The counter is read as a little-endian base-2**32 integer, matching the
Random123 ``ctr.incr`` carry semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from . import philox, threefry

# generator name -> (counter words, key words, generator, rounds)
_GENERATORS = {
    "philox4x32": (4, 2, philox.philox4x32, 10),
    "philox2x32": (2, 1, philox.philox2x32, 10),
    "threefry4x32": (4, 4, threefry.threefry4x32, 20),
    "threefry2x32": (2, 2, threefry.threefry2x32, 20),
}

# 64-bit-counter generators (the reference's native-float64 streams,
# random_gen.hh:121-173), generated on the host (rng/x64.py, native.py).
# Their words are stored as the little-endian uint32 limbs of the uint64
# words (word i -> limbs 2i, 2i+1), so the multiword ``incr`` below is
# Random123's ctr.incr over the uint64 words. name -> (counter limbs,
# key limbs, None: no generator on a device, rounds)
_GENERATORS_X64 = {
    "philox4x64": (8, 4, None, 10),
    "philox2x64": (4, 2, None, 10),
    "threefry4x64": (8, 8, None, 20),
    "threefry2x64": (4, 4, None, 20),
}

DEFAULT_RNG = "philox4x32"
DEFAULT_RNG_X64 = "philox4x64"


def generator_info(name: str):
    """(counter words, key words, generator function, default rounds) of a
    generator, as the JAX package's; 32-bit words (limbs) and no function
    for the x64 generators (K6 and the host engines of rng/x64.py and
    native.py generate them)."""
    try:
        return _GENERATORS.get(name) or _GENERATORS_X64[name]
    except KeyError:
        raise ValueError(
            f"unknown counter-based RNG {name!r}; supported: "
            f"{sorted(_GENERATORS) + sorted(_GENERATORS_X64)}") from None


def _words(values, n: int, what: str) -> Tuple[int, ...]:
    words = tuple(int(w) for w in values)
    if len(words) != n:
        raise ValueError(f"{what} must have {n} words")
    if any(not 0 <= w <= 0xFFFFFFFF for w in words):
        raise ValueError(f"{what} words must lie in [0, 2**32)")
    return words


def _add_words(words: Tuple[int, ...], amount: int) -> Tuple[int, ...]:
    """Little-endian multiword add, wrapping at the top word."""
    amount = int(amount)
    if not 0 <= amount < 2 ** 64:
        raise ValueError("counter increments must lie in [0, 2**64)")
    n = len(words)
    total = sum(w << (32 * i) for i, w in enumerate(words)) + amount
    total &= (1 << (32 * n)) - 1
    return tuple((total >> (32 * i)) & 0xFFFFFFFF for i in range(n))


@dataclasses.dataclass(frozen=True)
class RNGState:
    """Counter + key snapshot of a counter-based RNG (default Philox4x32)."""

    counter: Tuple[int, ...]
    key: Tuple[int, ...]
    rng: str = DEFAULT_RNG

    def __post_init__(self):
        len_c, len_k = generator_info(self.rng)[:2]
        object.__setattr__(self, "counter",
                           _words(self.counter, len_c, "counter"))
        object.__setattr__(self, "key", _words(self.key, len_k, "key"))

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_key(key_scalar: int = 0, rng: str = DEFAULT_RNG) -> "RNGState":
        """Counter all-zero; key word 0 = key_scalar, the rest zero. An x64
        generator's key word is 64-bit: two limbs."""
        len_c, len_k = generator_info(rng)[:2]
        key = [0] * len_k
        key[0] = int(key_scalar) & 0xFFFFFFFF
        if rng in _GENERATORS_X64:
            key[1] = (int(key_scalar) >> 32) & 0xFFFFFFFF
        return RNGState((0,) * len_c, tuple(key), rng)

    @staticmethod
    def from_arrays(counter, key, rng: str = DEFAULT_RNG) -> "RNGState":
        """From sequences of words (lists, numpy arrays, tensors)."""
        return RNGState(tuple(int(w) for w in counter),
                        tuple(int(w) for w in key), rng)

    # -- info --------------------------------------------------------------

    @property
    def len_c(self) -> int:
        """Stored counter words (uint32 limbs for x64 generators)."""
        return len(self.counter)

    @property
    def len_k(self) -> int:
        return len(self.key)

    @property
    def is_x64(self) -> bool:
        """True for the 64-bit-counter generators (float64 streams)."""
        return self.rng in _GENERATORS_X64

    @property
    def block_width(self) -> int:
        """Values generated per counter block: the reference's ``ctr_size``,
        counter words (not limbs), so x32 and x64 streams share one set of
        submatrix and next-state arithmetic."""
        return self.len_c // 2 if self.is_x64 else self.len_c

    # -- counter arithmetic ------------------------------------------------

    def incr(self, amount: int = 1) -> "RNGState":
        """Advance the counter by ``amount`` (< 2**64) with carries."""
        return RNGState(_add_words(self.counter, amount), self.key, self.rng)

    def incr_key(self, amount: int = 1) -> "RNGState":
        """Advance the key words (same little-endian semantics)."""
        return RNGState(self.counter, _add_words(self.key, amount), self.rng)

    # -- checkpoint / resume -----------------------------------------------

    def to_dict(self) -> dict:
        """Plain-python snapshot, the same format as the JAX package's."""
        return {"rng": self.rng, "counter": list(self.counter),
                "key": list(self.key)}

    @staticmethod
    def from_dict(d: dict) -> "RNGState":
        return RNGState.from_arrays(d["counter"], d["key"], d["rng"])

    def __repr__(self) -> str:
        return (f"RNGState<{self.rng}>(counter={list(self.counter)}, "
                f"key={list(self.key)})")


def default_state(key: int = 0, rng: str = DEFAULT_RNG) -> RNGState:
    """``RNGState.from_key(key, rng)``."""
    return RNGState.from_key(key, rng)
