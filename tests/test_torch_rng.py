"""The port's counter-seeded xorshift128 RNG against repro.core.rng.

The RNG words are integers, so the port must agree with the reference
bit for bit (no tolerance), over full-range 32-bit seeds and over ids
that straddle 2**32 with a non-zero high word.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import rng as jrng  # noqa: E402
from repro_torch.core import rng as trng  # noqa: E402

_SEEDS = np.random.default_rng(2024).integers(0, 2**32, size=6,
                                              dtype=np.uint64)


def _ids(n, start):
    """n consecutive 64-bit ids from ``start`` as (lo, hi) uint32 words."""
    full = np.arange(n, dtype=np.uint64) + np.uint64(start)
    return ((full & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (full >> np.uint64(32)).astype(np.uint32))


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("start", [0, 2**32 - 100, 5 * 2**32 + 7,
                                   2**64 - 200])
@pytest.mark.parametrize("seed", [int(s) for s in _SEEDS[:3]] + [0,
                                                                 2**32 - 1])
def test_seed_state_bit_equal(seed, start):
    lo, hi = _ids(200, start)
    ref = np.asarray(jrng.seed_state(
        jnp.uint32(seed), jrng.PhotonId(jnp.asarray(lo), jnp.asarray(hi))))
    got = trng.seed_state(seed, trng.PhotonId(_t(lo), _t(hi)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)


def test_seed_state_full_range_random_ids():
    # random full-range words exercise every product of the splitmix
    # chain beyond 2**63 before masking
    r = np.random.default_rng(5)
    lo = r.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    hi = r.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    for seed in (int(s) for s in _SEEDS):
        ref = np.asarray(jrng.seed_state(
            jnp.uint32(seed), jrng.PhotonId(jnp.asarray(lo), jnp.asarray(hi))))
        got = trng.seed_state(seed, trng.PhotonId(_t(lo), _t(hi)))
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)
        assert got.min() >= 0 and got.max() <= 0xFFFFFFFF


def test_plain_ids_mean_hi_zero():
    lo, _ = _ids(300, 2**31)
    ref = np.asarray(jrng.seed_state(7, jnp.asarray(lo)))
    got = trng.seed_state(7, _t(lo))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)


def test_next_u32_and_uniform_bit_equal():
    lo, hi = _ids(1024, 2**32 - 512)
    js = jrng.seed_state(jnp.uint32(int(_SEEDS[4])),
                         jrng.PhotonId(jnp.asarray(lo), jnp.asarray(hi)))
    ts = trng.seed_state(int(_SEEDS[4]), trng.PhotonId(_t(lo), _t(hi)))
    for _ in range(12):
        js, jw = jrng.next_u32(js)
        ts, tw = trng.next_u32(ts)
        np.testing.assert_array_equal(tw.numpy().astype(np.uint32),
                                      np.asarray(jw))
        js, ju = jrng.next_uniform(js)
        ts, tu = trng.next_uniform(ts)
        assert tu.dtype == torch.float32
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                  np.asarray(js))


def test_zero_state_fix_up(monkeypatch):
    # no known id reaches an all-zero chain, so force one in both
    # packages: a splitmix that returns 0 must give 0xDEADBEEF words
    monkeypatch.setattr(jrng, "splitmix32", lambda x: x ^ x)
    monkeypatch.setattr(trng, "splitmix32", lambda x: x ^ x)
    ref = np.asarray(jrng.seed_state(3, jnp.arange(5, dtype=jnp.uint32)))
    got = trng.seed_state(3, torch.arange(5))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)
    assert (got == 0xDEADBEEF).all()
    monkeypatch.undo()
    # and the real seeding never yields an all-zero state
    lo, hi = _ids(4096, 0)
    got = trng.seed_state(0, trng.PhotonId(_t(lo), _t(hi)))
    assert not (got == 0).all(dim=-1).any()


def test_mul32_matches_wrapping_product():
    r = np.random.default_rng(9)
    x = r.integers(0, 2**32, size=10000, dtype=np.uint64)
    for c in (0x85EBCA6B, 0xC2B2AE35, 0x85EBCA77, 0x9E3779B1, 0xFFFFFFFF):
        want = (x.astype(object) * c) % 2**32
        got = trng.mul32(torch.as_tensor(x.astype(np.int64)), c).numpy()
        np.testing.assert_array_equal(got, np.asarray(want, np.int64))


def test_split_id64():
    assert trng.split_id64(0) == (0, 0)
    assert trng.split_id64(2**32) == (0, 1)
    assert trng.split_id64(3 * 2**32 + 17) == (17, 3)
    for v in (0, 2**32 - 1, 2**40 + 5, 2**64 - 1):
        assert trng.split_id64(v) == tuple(int(w)
                                           for w in jrng.split_id64(v))
    with pytest.raises(ValueError):
        trng.split_id64(-1)
    with pytest.raises(ValueError):
        trng.split_id64(2**64)


def test_add_id_carries_into_the_high_word():
    # exact integer arithmetic: the 64-bit sum, split back into words
    r = np.random.default_rng(11)
    starts = [0, 2**32 - 3, 5 * 2**32 + 2**32 - 1, 2**64 - 2**32]
    deltas = r.integers(0, 2**32, size=64).tolist() + [0, 1, 2, 2**32 - 1]
    for s in starts:
        lo, hi = trng.split_id64(s)
        got = trng.add_id(lo, hi, torch.tensor(deltas, dtype=torch.int64))
        want = [trng.split_id64((s + d) % 2**64) for d in deltas]
        assert got.lo.tolist() == [w[0] for w in want]
        assert got.hi.tolist() == [w[1] for w in want]


@pytest.mark.parametrize("n", [0, 1, 2, 7, 640, 5 * 4095])
def test_skip_equals_drawing(n):
    """``skip`` (the plain photon step's jump past a dead lane's draws)
    gives the state of ``n`` draws of the reference's ``next_u32``."""
    lo, hi = _ids(64, 2**32 - 30)
    ref = jrng.seed_state(jnp.uint32(int(_SEEDS[0])),
                          jrng.PhotonId(jnp.asarray(lo), jnp.asarray(hi)))
    start = _t(ref)
    ref = jax.jit(lambda s: jax.lax.fori_loop(
        0, n, lambda i, s: jrng.next_u32(s)[0], s))(ref)
    np.testing.assert_array_equal(trng.skip(start, n).numpy(),
                                  np.asarray(ref).astype(np.int64))
