"""The port's seven photon sources against repro.sources.

Each source of the reference's demo menu (all seven types, the planar
one with a pattern, the line source both collimated and isotropic) is
sampled by both packages for the same 64-bit photon ids, straddling
2**32, and the same seed.

Tolerances: the RNG words (in-flight stream) and the launch-stream draw
counts (``N_DRAWS``) never depend on float arithmetic and are exact, as
are the launch weights (ones, or pattern weights picked by an integer
cell index) and the staged dicts (float64 host derivations rounded once
to float32 in both).  Positions and directions come from float32
arithmetic with log / sin / cos, which XLA's CPU code contracts into
FMAs and evaluates with its own polynomials: they agree within 2 ulps
of their magnitude (measured: 1 ulp, 1.9e-6 on positions near 30,
6e-8 on unit directions).

The batched form (``sample_staged`` on a leading scenario axis) is
held bit-equal to each scenario sampled alone.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import sources as JS  # noqa: E402
from repro.core import rng as jrng  # noqa: E402
from repro_torch import sources as TS  # noqa: E402
from repro_torch.core import rng as trng  # noqa: E402
from repro_torch.sources import base as tbase  # noqa: E402

SIZE, N, SEED = 24, 256, 0xBEEF
NAMES = sorted(JS.demo_menu(SIZE))


def _ids(n=N, start=2**32 - N // 2):
    full = np.arange(n, dtype=np.uint64) + np.uint64(start)
    lo = (full & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (full >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def _tids(lo, hi):
    return trng.PhotonId(torch.as_tensor(lo.astype(np.int64)),
                         torch.as_tensor(hi.astype(np.int64)))


def _ulps(x):
    """Two float32 ulps of |x|, elementwise."""
    return 2.0 * np.spacing(np.abs(np.asarray(x, np.float32)))


@pytest.mark.parametrize("name", NAMES)
def test_launch_states_match_reference(name):
    jsrc, tsrc = JS.demo_menu(SIZE)[name], TS.demo_menu(SIZE)[name]
    assert TS.to_dict(tsrc) == JS.to_dict(jsrc)
    assert type(tsrc).N_DRAWS == type(jsrc).N_DRAWS
    lo, hi = _ids()
    assert hi.min() == 0 and hi.max() == 1  # ids straddle 2**32
    ref = jsrc.sample(jrng.PhotonId(jnp.asarray(lo), jnp.asarray(hi)),
                      jnp.uint32(SEED))
    got = tsrc.sample(_tids(lo, hi), SEED)
    pos, direc, w0, rng = (x.numpy() for x in got)
    rpos, rdir, rw0, rrng = (np.asarray(x) for x in ref)
    assert pos.dtype == direc.dtype == w0.dtype == np.float32
    np.testing.assert_array_equal(rng.astype(np.uint32), rrng)
    np.testing.assert_array_equal(w0, rw0)
    assert (np.abs(pos - rpos) <= _ulps(rpos)).all()
    assert (np.abs(direc - rdir) <= np.maximum(_ulps(rdir), 2 * 2.0**-24)
            ).all()
    np.testing.assert_allclose(np.linalg.norm(direc, axis=1), 1.0, atol=1e-6)
    # the staged dict: the reference's, value for value, as numpy arrays
    staged, rstaged = tsrc.stage(), jsrc.stage()
    assert sorted(staged) == sorted(rstaged)
    for k, v in staged.items():
        assert isinstance(v, np.ndarray) and v.dtype == np.float32, k
        np.testing.assert_array_equal(v, np.asarray(rstaged[k]), err_msg=k)
    assert TS.staged_structure(tsrc) == JS.staged_structure(jsrc)


@pytest.mark.parametrize("name", NAMES)
def test_launch_draws_follow_the_stream(name):
    """A source reads exactly its N_DRAWS launch uniforms: re-deriving
    them from the launch stream gives the radius / angle inputs, and the
    in-flight stream is the one the pencil beam gets."""
    tsrc = TS.demo_menu(SIZE)[name]
    lo, hi = _ids(64)
    ids = _tids(lo, hi)
    got = tsrc.sample(ids, SEED)
    pencil = TS.Pencil().sample(ids, SEED)
    assert torch.equal(got[3], pencil[3])  # the flight stream
    ls = TS.launch_stream(SEED, ids)
    draws = []
    for _ in range(type(tsrc).N_DRAWS):
        ls, u = trng.next_uniform(ls)
        draws.append(u)
    if name == "disk":
        p = tsrc.stage()
        r = torch.linalg.vector_norm(got[0][:, :2] - torch.tensor(
            p["pos"][:2]), dim=1)
        torch.testing.assert_close(r, float(p["radius"]) * torch.sqrt(
            draws[0]), rtol=1e-5, atol=1e-5)
    if name.startswith("line"):
        p = tsrc.stage()
        t = (got[0][:, 0] - float(p["start"][0])) / float(
            p["end"][0] - p["start"][0])
        torch.testing.assert_close(t, draws[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_batched_sampling_equals_each_scenario_alone(name):
    menus = [TS.demo_menu(s) for s in (20, 24, 30)]
    srcs = [m[name] for m in menus]
    stacked = {k: torch.stack([torch.as_tensor(s.stage()[k]) for s in srcs])
               for k in srcs[0].stage()}
    lo, hi = _ids(96)
    rows = [(lo + 1000 * i).astype(np.uint32) for i in range(3)]
    ids = trng.PhotonId(torch.as_tensor(np.stack(rows).astype(np.int64)),
                        torch.as_tensor(np.stack([hi] * 3).astype(np.int64)))
    seeds = torch.tensor([[SEED], [SEED + 1], [7]])
    batched = type(srcs[0]).sample_staged(stacked, ids, seeds)
    for i, src in enumerate(srcs):
        alone = src.sample(_tids(rows[i], hi), int(seeds[i, 0]))
        for a, b in zip(batched, alone):
            assert torch.equal(a[i], b)
    # StagedSource runs the same operations as the source it came from
    cls, staged = TS.stage_source(srcs[0])
    restaged = TS.StagedSource(cls, staged)
    for a, b in zip(restaged.sample(_tids(lo, hi), SEED),
                    srcs[0].sample(_tids(lo, hi), SEED)):
        assert torch.equal(a, b)
    assert TS.as_source(restaged) is restaged


def test_registry_round_trips_and_demo_menu():
    assert TS.available_sources() == JS.available_sources()
    assert sorted(TS.demo_menu(SIZE)) == NAMES
    for name in NAMES:
        src = TS.demo_menu(SIZE)[name]
        d = TS.to_dict(src)
        assert TS.from_dict(d) == src
        assert TS.as_source(d) == src
        assert TS.get_source_cls(d["type"]) is type(src)
        # the reference rebuilds the same configuration from the dict
        assert JS.to_dict(JS.from_dict(d)) == d
    # list-typed fields are normalized to tuples (hashable, frozen)
    disk = TS.as_source(TS.Disk(pos=[1.0, 2.0, 0.0], radius=2.0))
    assert disk == TS.Disk(pos=(1.0, 2.0, 0.0), radius=2.0)
    hash(disk)
    with pytest.raises(KeyError):
        TS.get_source_cls("laser")


def test_stage_rejects_a_source_without_staged_parameters():
    class Custom:
        def sample(self, photon_ids, seed):
            raise AssertionError("not called")

    with pytest.raises(TypeError, match="staged"):
        TS.stage_source(Custom())
    # the geometry helpers derive in float64 and round once
    e1, e2 = tbase.orthonormal_frame((0.0, 1.0, 1.0))
    je1, je2 = JS.base.orthonormal_frame((0.0, 1.0, 1.0))
    np.testing.assert_array_equal(e1, np.asarray(je1))
    np.testing.assert_array_equal(e2, np.asarray(je2))
    np.testing.assert_array_equal(tbase.unit((1.0, 2.0, 2.0)),
                                  np.asarray(JS.base.unit((1.0, 2.0, 2.0))))
