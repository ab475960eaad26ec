"""The CUDA sources keep one copy of what they share.

``csrc/hopper.cuh`` holds the Hopper plumbing of K1, K2, K4 and K5 and
``csrc/random123.cuh`` the 32-bit generators of K1, K2, K3 and K7. A source
that defines again a function, kernel, struct or constant of a header, or a
function that another source defines word for word, has forked a copy that
nothing keeps equal. And the launchers' generator codes are the header's
constants, which ``ops/_build.py`` mirrors for the wrappers.
"""

import re
from pathlib import Path

import pytest

from randblas_tpu_torch.ops import _build

CSRC = Path(_build.__file__).resolve().parents[1] / "csrc"
SOURCES = sorted(p.name for p in CSRC.glob("*.cu"))
HEADERS = sorted(CSRC.glob("*.cuh"))

# a definition at the top level: return type (after qualifiers) and name
_FUNCTION = re.compile(
    r"^(?:(?:inline|static|__host__|__device__|__global__|__forceinline__)"
    r"\s+)*[\w:<>]+[*&]?\s+(\w+)\s*\(", re.M)
_CONSTANT = re.compile(r"\bconstexpr\s+[\w:]+\s+(\w+)\s*=")
_STRUCT = re.compile(r"^struct\s+(\w+)", re.M)


def _names(text):
    """The functions, kernels, structs and constants that ``text``
    defines."""
    functions = {n for n in _FUNCTION.findall(text) if not n.startswith("__")}
    return functions | set(_CONSTANT.findall(text)) | set(
        _STRUCT.findall(text))


def _bodies(text):
    """{whitespace-normalised text: name} of the top-level functions that
    ``text`` defines with a body."""
    out = {}
    for match in _FUNCTION.finditer(text):
        if match.group(1).startswith("__"):
            continue
        open_at = text.find("{", match.end())
        if open_at < 0 or ";" in text[match.end():open_at]:
            continue   # a declaration, or a call inside an expression
        depth, i = 0, open_at
        while True:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            if depth == 0:
                break
            i += 1
        out[" ".join(text[match.start():i + 1].split())] = match.group(1)
    return out


def test_generator_codes_are_the_headers():
    src = (CSRC / "random123.cuh").read_text()
    codes = {f"{m[0].lower()}{m[1]}": int(m[2]) for m in re.findall(
        r"constexpr int k(Philox|Threefry)(\dx32) = (\d+);", src)}
    assert codes == _build.GEN_CODES
    assert len(set(codes.values())) == len(codes) == 4


@pytest.mark.parametrize("source", SOURCES)
def test_source_keeps_no_copy(source):
    text = (CSRC / source).read_text()
    names = _names(text)
    for header in HEADERS:
        again = names & _names(header.read_text())
        assert not again, f"{source} defines {sorted(again)} of {header.name}"
    bodies = _bodies(text)
    for other in SOURCES:
        if other != source:
            same = bodies.keys() & _bodies((CSRC / other).read_text()).keys()
            assert not same, (f"{source} and {other} both define "
                              f"{sorted(bodies[b] for b in same)}")
