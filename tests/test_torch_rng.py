"""Parity of the port's RNG core (randblas_tpu_torch.rng) with Random123 and
with the JAX package: generator words, counter carries, state snapshots and
the float transforms. Inputs come from numpy seeds; both packages run on the
CPU in this process."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu.rng as jrng
from randblas_tpu.rng import transforms as jtr
import randblas_tpu_torch.rng as trng
from randblas_tpu_torch.rng import transforms as ttr
from randblas_tpu_torch.rng.bits import mulhilo32, to_signed

_KAT_FILE = Path(__file__).parent / "data" / "r123_kat_vectors.txt"
_PORTED = {
    "philox4x32": trng.philox4x32, "philox2x32": trng.philox2x32,
    "threefry4x32": trng.threefry4x32, "threefry2x32": trng.threefry2x32,
}
_WIDTHS = {"philox4x32": (4, 2), "philox2x32": (2, 1),
           "threefry4x32": (4, 4), "threefry2x32": (2, 2)}


def _kat_rows():
    rows = []
    for line in _KAT_FILE.read_text().splitlines():
        parts = line.split()
        if not parts or parts[0] not in _PORTED:
            continue
        name, rounds = parts[0], int(parts[1])
        w, k = _WIDTHS[name]
        words = [int(x, 16) for x in parts[2:]]
        rows.append((name, rounds, words[:w], words[w:w + k],
                     words[w + k:w + k + w]))
    return rows


_KAT = _kat_rows()


def _t(words):
    return torch.tensor(np.asarray(words, dtype=np.int64))


def _random_words(rng, shape):
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def test_kat_file_covers_the_four_generators():
    assert {r[0] for r in _KAT} == set(_PORTED)
    assert len(_KAT) >= 30


@pytest.mark.parametrize("name,rounds,ctr,key,expected", _KAT,
                         ids=[f"{r[0]}-{r[1]}-{i}" for i, r in
                              enumerate(_KAT)])
def test_kat_replay(name, rounds, ctr, key, expected):
    out = _PORTED[name](_t(ctr), _t(key), rounds)
    assert out.tolist() == expected


@pytest.mark.parametrize("name", sorted(_PORTED))
def test_words_match_jax_bitwise(name):
    rng = np.random.default_rng(11)
    w, k = _WIDTHS[name]
    ctr = _random_words(rng, (257, w))
    key = _random_words(rng, (k,))
    want = np.asarray(getattr(jrng, name)(jnp.asarray(ctr), jnp.asarray(key)))
    got = _PORTED[name](_t(ctr), _t(key)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_mulhilo32_full_product():
    rng = np.random.default_rng(1)
    a = _random_words(rng, (1000,)).astype(object)
    b = _random_words(rng, (1000,)).astype(object)
    edge = [0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF]
    a = np.concatenate([a, edge, edge])
    b = np.concatenate([b, edge, edge[::-1]])
    hi, lo = mulhilo32(_t(a.astype(np.int64)), _t(b.astype(np.int64)))
    prod = [int(x) * int(y) for x, y in zip(a, b)]
    assert hi.tolist() == [p >> 32 for p in prod]
    assert lo.tolist() == [p & 0xFFFFFFFF for p in prod]


@pytest.mark.parametrize("rng_name", ["philox4x32", "threefry4x32",
                                      "philox2x32", "threefry2x32"])
def test_incr_matches_jax(rng_name):
    jstate = jrng.RNGState.from_key(9, rng_name)
    tstate = trng.RNGState.from_key(9, rng_name)
    for amount in (0xFFFFFFFF, 1, 2 ** 32 - 1, 2 ** 63 + 5, 2 ** 64 - 1, 7):
        jstate = jstate.incr(amount)
        tstate = tstate.incr(amount)
        assert list(tstate.counter) == [int(w) for w in
                                        np.asarray(jstate.counter)]
    jstate = jstate.incr_key(2 ** 40 + 3)
    tstate = tstate.incr_key(2 ** 40 + 3)
    assert tstate.to_dict() == jstate.to_dict()


def test_incr_carries_across_words():
    s = trng.RNGState.from_key(0)
    s = s.incr(0xFFFFFFFF).incr(1)
    assert s.counter == (0, 1, 0, 0)
    s = trng.RNGState.from_arrays([0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0],
                                  [0, 0]).incr(1)
    assert s.counter == (0, 0, 0, 1)
    top = trng.RNGState.from_arrays([0xFFFFFFFF] * 4, [0, 0]).incr(1)
    assert top.counter == (0, 0, 0, 0)  # wraps at the top word
    with pytest.raises(ValueError):
        s.incr(-1)


def test_state_dict_round_trip_with_jax():
    jstate = jrng.RNGState.from_key(123, "threefry4x32").incr(2 ** 40 + 17)
    tstate = trng.RNGState.from_dict(jstate.to_dict())
    assert tstate.to_dict() == jstate.to_dict()
    back = jrng.RNGState.from_dict(tstate.to_dict())
    np.testing.assert_array_equal(np.asarray(back.counter),
                                  np.asarray(jstate.counter))
    np.testing.assert_array_equal(np.asarray(back.key),
                                  np.asarray(jstate.key))
    assert back.rng == jstate.rng


def test_x64_generators_are_not_ported_yet():
    """The x64 generators are ported now: each constructs with the JAX
    package's limb layout, and an unknown name still raises ValueError."""
    for name in ("philox4x64", "philox2x64", "threefry4x64",
                 "threefry2x64"):
        jstate = jrng.RNGState.from_key(2 ** 40 + 9, name)
        tstate = trng.RNGState.from_key(2 ** 40 + 9, name)
        assert tstate.is_x64 and tstate.to_dict() == jstate.to_dict()
        assert trng.state.generator_info(name)[:2] == (tstate.len_c,
                                                       tstate.len_k)
    with pytest.raises(ValueError):
        trng.RNGState.from_key(0, "nosuchrng")


def test_uniform_transforms_match_jax_exactly():
    rng = np.random.default_rng(2)
    bits = np.concatenate([_random_words(rng, (4096,)),
                           np.array([0, 1, 2 ** 31 - 1, 2 ** 31,
                                     2 ** 32 - 1], dtype=np.uint32)])
    tb = _t(bits)
    np.testing.assert_array_equal(ttr.u01(tb).numpy(),
                                  np.asarray(jtr.u01(bits)))
    np.testing.assert_array_equal(ttr.uneg11(tb).numpy(),
                                  np.asarray(jtr.uneg11(bits)))
    signed = jnp.asarray(bits.view(np.int32))
    np.testing.assert_array_equal(ttr.u01_i32(to_signed(tb)).numpy(),
                                  np.asarray(jtr.u01_i32(signed)))


@pytest.mark.parametrize("variant", ["boxmul", "i32", "i32_fast"])
def test_gaussian_transforms_match_jax(variant):
    # rtol/atol 2e-3: log/sin/cos are float32 library calls whose results
    # differ across math libraries (rng/transforms.py of the JAX package)
    rng = np.random.default_rng(3)
    a, b = _random_words(rng, (4096,)), _random_words(rng, (4096,))
    if variant == "boxmul":
        got = ttr.boxmul_pair(_t(a), _t(b))
        want = jtr.boxmul_pair(a, b)
    else:
        fast = variant == "i32_fast"
        got = ttr.boxmul_pair_i32(to_signed(_t(a)), to_signed(_t(b)),
                                  fast_cos=fast)
        want = jtr.boxmul_pair_i32(jnp.asarray(a.view(np.int32)),
                                   jnp.asarray(b.view(np.int32)),
                                   fast_cos=fast)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-3)


def test_rng_exports_cover_the_jax_package():
    assert set(jrng.__all__) <= set(trng.__all__)
    assert all(callable(getattr(trng, n)) or n == "DEFAULT_RNG"
               for n in trng.__all__)


def test_generator_info_matches_jax():
    for name in ("philox4x32", "philox2x32", "threefry4x32", "threefry2x32",
                 "philox4x64", "philox2x64", "threefry4x64",
                 "threefry2x64"):
        len_c, len_k, fn, rounds = trng.generator_info(name)
        jlen_c, jlen_k, jfn, jrounds = jrng.generator_info(name)
        assert (len_c, len_k, rounds) == (jlen_c, jlen_k, jrounds)
        assert (fn is None) == (jfn is None)
        assert fn is None or fn is getattr(trng, jfn.__name__)
    with pytest.raises(ValueError):
        trng.generator_info("nosuchrng")


def test_mul32_wide_and_hi_match_jax_bitwise():
    rng = np.random.default_rng(4)
    a = np.concatenate([_random_words(rng, (2048,)),
                        np.array([0, 1, 0xFFFF, 0x10000, 2 ** 32 - 1],
                                 np.uint32)])
    b = np.concatenate([_random_words(rng, (2048,)),
                        np.array([2 ** 32 - 1, 0, 0xFFFF, 0x10000,
                                  2 ** 32 - 1], np.uint32)])
    hi, lo = trng.mul32_wide(a, b)
    jhi, jlo = jrng.mul32_wide(a, b)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi, np.int64))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo, np.int64))
    np.testing.assert_array_equal(trng.mul32_hi(_t(a), _t(b)).numpy(),
                                  np.asarray(jrng.mul32_hi(a, b), np.int64))
    # a Python-int multiplier, as Philox's
    np.testing.assert_array_equal(
        trng.mul32_hi(a, 0xD2511F53).numpy(),
        np.asarray(jrng.mul32_hi(a, np.uint32(0xD2511F53)), np.int64))


@pytest.mark.parametrize("width", [2, 4])
def test_ctr_add64_matches_jax_bitwise(width):
    rng = np.random.default_rng(5 + width)
    ctr = _random_words(rng, (width,))
    ctr[0] = 2 ** 32 - 3                     # a carry out of word 0
    lo = np.concatenate([_random_words(rng, (64,)),
                         np.array([0, 2, 3, 2 ** 32 - 1], np.uint32)])
    hi = np.concatenate([_random_words(rng, (64,)),
                         np.array([0, 0, 2 ** 32 - 1, 2 ** 32 - 1],
                                  np.uint32)])
    got = trng.ctr_add64(ctr, _t(lo), _t(hi))
    want = np.asarray(jrng.ctr_add64(jnp.asarray(ctr), jnp.asarray(lo),
                                     jnp.asarray(hi)))
    assert got.shape == want.shape == (lo.shape[0], width)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    top = np.full(width, 2 ** 32 - 1, np.uint32)   # wraps at the top word
    np.testing.assert_array_equal(
        trng.ctr_add64(top, 1).numpy(),
        np.asarray(jrng.ctr_add64(jnp.asarray(top), 1)).astype(np.int64))


def test_uneg11_block_matches_jax_bitwise():
    rng = np.random.default_rng(6)
    block = _random_words(rng, (64, 4))
    np.testing.assert_array_equal(trng.uneg11_block(_t(block)).numpy(),
                                  np.asarray(jrng.uneg11_block(block)))


def test_boxmul_block_pairs_the_words():
    """Pairs (2i, 2i + 1) of each block row: bitwise the port's
    boxmul_pair; against JAX within 2e-3, as boxmul_pair is held
    (log/sin/cos differ across float32 math libraries)."""
    rng = np.random.default_rng(7)
    block = _random_words(rng, (64, 4))
    got = trng.boxmul_block(_t(block))
    assert got.shape == (64, 4) and got.dtype == torch.float32
    for i in range(2):
        x, y = ttr.boxmul_pair(_t(block[:, 2 * i]), _t(block[:, 2 * i + 1]))
        assert torch.equal(got[:, 2 * i], x)
        assert torch.equal(got[:, 2 * i + 1], y)
    np.testing.assert_allclose(got.numpy(), np.asarray(jrng.boxmul_block(
        block)), rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError):
        trng.boxmul_block(_t(block[:, :3]))
