"""The port's volumes, configs and pencil source against the reference.

Label grids, media tables and the RNG words are exact; the pencil's
launch state is bit-equal (it is pure data movement plus the RNG).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import sources as JS  # noqa: E402
from repro.core import photon as jph  # noqa: E402
from repro.core import rng as jrng  # noqa: E402
from repro.core import volume as JV  # noqa: E402
from repro_torch import sources as TS  # noqa: E402
from repro_torch.core import photon as tph  # noqa: E402
from repro_torch.core import rng as trng  # noqa: E402
from repro_torch.core import volume as TV  # noqa: E402


@pytest.mark.parametrize("shape", [(60, 60, 60), (24, 20, 16), (9, 9, 9)])
@pytest.mark.parametrize("bench", ["b1", "b2"])
def test_benchmark_volumes_equal(bench, shape):
    jv = getattr(JV, f"benchmark_{bench}")(shape)
    tv = getattr(TV, f"benchmark_{bench}")(shape)
    assert tv.shape == jv.shape and tv.unitinmm == jv.unitinmm
    assert tv.labels.dtype == torch.uint8
    assert tv.media.dtype == torch.float32
    np.testing.assert_array_equal(tv.labels.numpy(), np.asarray(jv.labels))
    np.testing.assert_array_equal(tv.media.numpy(), np.asarray(jv.media))


def test_volume_from_arrays_carries_a_reference_volume():
    jv = JV.benchmark_b2((12, 10, 8))
    tv = TV.volume_from_arrays(np.asarray(jv.labels), np.asarray(jv.media),
                               jv.unitinmm)
    np.testing.assert_array_equal(tv.labels.numpy(), np.asarray(jv.labels))
    np.testing.assert_array_equal(tv.media.numpy(), np.asarray(jv.media))
    with pytest.raises(ValueError):
        TV.volume_from_arrays(np.zeros((4, 4), np.uint8), np.asarray(jv.media))


def test_simconfig_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(JV.SimConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TV.SimConfig)}
    assert tf == jf
    assert TV.b1_config() == TV.SimConfig(**dataclasses.asdict(
        JV.b1_config()))
    assert TV.b2_config() == TV.SimConfig(**dataclasses.asdict(
        JV.b2_config()))
    assert TV.C_MM_PER_NS == JV.C_MM_PER_NS
    assert TV.b2_config().gate_width_ns == JV.b2_config().gate_width_ns


@pytest.mark.parametrize("src", [
    {}, {"pos": (10.0, 7.5, 0.0)}, {"pos": (3.0, 4.0, 2.0),
                                     "dir": (1.0, 2.0, 2.0)}])
def test_pencil_sample_bit_equal(src):
    n, seed = 300, 0xC0FFEE
    full = np.arange(n, dtype=np.uint64) + np.uint64(2**32 - 150)
    lo = (full & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (full >> np.uint64(32)).astype(np.uint32)
    ref = JS.Pencil(**src).sample(
        jrng.PhotonId(jnp.asarray(lo), jnp.asarray(hi)), jnp.uint32(seed))
    got = TS.Pencil(**src).sample(
        trng.PhotonId(torch.as_tensor(lo.astype(np.int64)),
                      torch.as_tensor(hi.astype(np.int64))), seed)
    for r, g in zip(ref[:3], got[:3]):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(got[3].numpy().astype(np.uint32),
                                  np.asarray(ref[3]))
    # launch turns the samples into the same photon state
    shape = (20, 16, 12)
    active = np.arange(n) % 3 != 0
    jst = jph.launch(*ref, jnp.asarray(active), shape)
    tst = tph.launch(*got, torch.as_tensor(active), shape)
    for name, r in jst._asdict().items():
        np.testing.assert_array_equal(tph.state_to_numpy(tst)[name],
                                      np.asarray(r), err_msg=name)


def test_source_registry_and_dict_round_trip():
    assert TS.available_sources() == ("pencil",)
    assert TS.LAUNCH_STREAM_SALT == JS.LAUNCH_STREAM_SALT
    p = TS.Pencil(pos=(1.0, 2.0, 0.0), dir=(0.0, 1.0, 1.0))
    d = TS.to_dict(p)
    assert d == JS.to_dict(JS.Pencil(pos=(1.0, 2.0, 0.0),
                                     dir=(0.0, 1.0, 1.0)))
    assert TS.from_dict(d) == p
    assert TS.as_source(None) == TS.Pencil()
    assert TS.as_source(d) == p
    assert TS.as_source(TV.Source(pos=(1.0, 2.0, 0.0),
                                  dir=(0.0, 1.0, 1.0))) == p
    with pytest.raises(KeyError):
        TS.from_dict({"type": "disk"})
    with pytest.raises(TypeError):
        TS.as_source(42)


def test_launch_stream_bit_equal():
    ids = np.arange(64, dtype=np.uint32)
    ref = np.asarray(JS.launch_stream(jnp.uint32(99), jnp.asarray(ids)))
    got = TS.launch_stream(99, torch.as_tensor(ids.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)
