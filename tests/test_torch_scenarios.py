"""The port's batched scenarios (``repro_torch.scenarios``) against its
own sequential runs and against ``repro.scenarios``.

Bit-identity is the port's own contract: every scenario of
``simulate_many`` gives exactly the bits of its own ``simulate_one``
(every field of ``SimResult``), with mixed groups, shared and stacked
labels, detectors, time gates, both workload modes, scenarios that
finish at different rounds, and 1, 3 and 8 scenarios.  The round
loop's totals are int64 fixed-point sums, which do not depend on order
or shape; the plain version's fixed-point grids are bit-equal under a
random permutation of the lanes, and within the rounding of each
deposit (half a unit of ``2**-shift`` each) of a float64 sum of the
same float32 deposits.

Against JAX, as in test_torch_simulator.py and test_torch_detection.py
(trajectories that diverge under XLA's FMA contraction are independent
draws): ``n_launched`` and ``launched_w`` exact; absorbed, escaped and
timed-out weight within 2e-3 of the launched weight; per-detector
detected weight within 3e-3 of it; the fluence's depth profile (summed
over x and y, and gates) within 1e-3 of it in every slab.  Measured on
these two scenarios over seeds 1-4: totals up to 9.7e-4, detected
weight up to 1.1e-3, depth profile up to 2.3e-4 of the launched weight.
The compile cache sees the reference's hit / miss / eviction sequence
for the same calls.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import scenarios as JSC  # noqa: E402
from repro.core import analysis as JA  # noqa: E402
from repro_torch import scenarios as SC  # noqa: E402
from repro_torch import telemetry as T  # noqa: E402
from repro_torch.core import analysis as TA  # noqa: E402
from repro_torch.core import photon as ph  # noqa: E402
from repro_torch.core import volume as V  # noqa: E402
from repro_torch.kernels.photon_step import ops, spec  # noqa: E402
from repro_torch.core.fixed import from_fixed  # noqa: E402
from repro_torch.kernels.photon_step.ref import photon_steps_ref  # noqa: E402

SIZE = 20
LANES = 64
TOTALS_TOL = 2e-3
DET_W_TOL = 3e-3
PROFILE_TOL = 1e-3
DETS = [{"x": 13.0, "y": 10.0, "radius": 2.5},
        {"x": 6.0, "y": 6.0, "radius": 2.0}]


def _cfg(**kw):
    base = dict(do_reflect=True, steps_per_round=4, n_time_gates=3,
                tmax_ns=0.6)
    base.update(kw)
    return V.SimConfig(**base)


def _shifted_b2(shift):
    """B2 with its sphere moved ``shift`` voxels along x: other labels,
    the same shape and media table."""
    vol = V.benchmark_b2((SIZE,) * 3)
    return V.volume_from_arrays(np.roll(vol.labels.numpy(), shift, axis=0),
                                vol.media.numpy())


def assert_same_bits(got, want):
    for name, x, y in zip(got._fields, got, want):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), name
        else:
            assert x == y, name


def _fleet(n):
    """``n`` scenarios in three groups: disk sources on two B2 volumes
    (stacked labels) with detectors, pencils on one shared B1 volume,
    and a line source; budgets differ, so they finish apart."""
    b2, b2s = V.benchmark_b2((SIZE,) * 3), _shifted_b2(3)
    b1 = V.benchmark_b1((SIZE,) * 3)
    cfg1 = _cfg(do_reflect=False, n_time_gates=1)
    out = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            out.append(SC.Scenario(
                b2 if i % 2 else b2s, _cfg(), 150 + 40 * i, seed=11 + i,
                source={"type": "disk", "pos": [8.0 + i, 10.0, 0.0],
                        "radius": 2.0}, detectors=DETS,
                id_offset=2**32 - 60 + 1000 * i))
        elif kind == 1:
            out.append(SC.Scenario(b1, cfg1, 90 + 30 * i, seed=5,
                                   source={"type": "pencil",
                                           "pos": [10.0, 10.0, 0.0]},
                                   id_offset=500 * i))
        else:
            out.append(SC.Scenario(
                b2, _cfg(), 120, seed=2 + i,
                source={"type": "line", "start": [6.0, 10.0, 0.0],
                        "end": [14.0, 10.0, 0.0], "dir": None}))
    return out


@pytest.mark.parametrize("n", [1, 3, 8])
def test_simulate_many_bit_identical_to_simulate_one(n):
    fleet = _fleet(n)
    cache = SC.CompileCache()
    many = SC.simulate_many(fleet, n_lanes=LANES, device="cpu", cache=cache)
    steps = set()
    for sc, got in zip(fleet, many):
        want = SC.simulate_one(sc, n_lanes=LANES, device="cpu")
        assert_same_bits(got, want)
        assert int(got.n_launched) == sc.n_photons
        steps.add(got.steps)
    assert cache.misses == len({SC.group_key(sc, LANES, device="cpu")
                                for sc in fleet})
    if n > 1:
        assert len(steps) > 1  # scenarios finished at different rounds


def test_static_mode_and_stats_bit_identical_batched():
    cfg = _cfg(collect_stats=True)
    vol = V.benchmark_b2((SIZE,) * 3)
    fleet = [SC.Scenario(vol, cfg, 100 + 37 * i, seed=i,
                         source={"type": "gaussian", "pos": [10.0, 10.0, 0.0],
                                 "waist": 1.5 + i}, detectors=DETS)
             for i in range(3)]
    many = SC.simulate_many(fleet, n_lanes=LANES, mode="static",
                            device="cpu", cache=SC.CompileCache())
    for sc, got in zip(fleet, many):
        want = SC.simulate_one(sc, n_lanes=LANES, mode="static",
                               device="cpu")
        assert_same_bits(got, want)
        assert int(got.stats.relaunched) == sc.n_photons
        assert got.stats.lane_segments == got.steps * LANES


def test_zero_photon_padding_changes_no_result():
    fleet = _fleet(3)[:1] * 2
    preps = [SC._prepare(i, sc) for i, sc in enumerate(fleet)]
    fn = SC._raw_batched_fn(preps[0], LANES, "dynamic", torch.device("cpu"))
    plain = fn(*SC._stack_group(preps, 0, True, torch.device("cpu")))
    padded = fn(*SC._stack_group(preps, 2, True, torch.device("cpu")))
    assert len(padded) == 4
    for a, b in zip(plain, padded[:2]):
        assert_same_bits(a, b)
    for extra in padded[2:]:
        assert int(extra.n_launched) == 0 and float(extra.energy.sum()) == 0


def test_make_batched_group_key_and_mesh():
    fleet = _fleet(3)
    b2 = [fleet[0], SC.Scenario(_shifted_b2(-2), fleet[0].cfg, 80, seed=3,
                                source=fleet[0].source, detectors=DETS)]
    assert SC.group_key(b2[0], LANES, device="cpu") == SC.group_key(
        b2[1], LANES, device="cpu")
    assert SC.group_key(fleet[0], LANES, device="cpu") != SC.group_key(
        fleet[2], LANES, device="cpu")  # disk and line sources
    fn, args = SC.make_batched(b2, n_lanes=LANES, device="cpu")
    assert args[0].shape == (2, SIZE**3)  # stacked labels
    for got, sc in zip(fn(*args), b2):
        assert_same_bits(got, SC.simulate_one(sc, n_lanes=LANES,
                                              device="cpu"))
    with pytest.raises(ValueError, match="single scenario group"):
        SC.make_batched(fleet, n_lanes=LANES, device="cpu")
    # a mesh takes the place of the device; an empty one has no device
    with pytest.raises(ValueError, match="device or mesh"):
        SC.simulate_many(fleet, n_lanes=LANES, device="cpu", mesh=["cpu"])
    with pytest.raises(ValueError, match="at least one device"):
        SC.simulate_many(fleet, n_lanes=LANES, mesh=[])
    assert SC.simulate_many([], device="cpu") == []


def test_scenario_from_dict_matches_reference():
    d = {"bench": "B2", "size": 12, "photons": 70, "seed": 4,
         "source": {"type": "cone", "pos": [6, 6, 0], "half_angle_deg": 30},
         "detectors": [{"x": 8, "y": 6, "radius": 2}], "time_gates": 2,
         "steps_per_round": 4, "tmax_ns": 1.5, "id_offset": 2**33}
    got, ref = SC.Scenario.from_dict(d), JSC.Scenario.from_dict(d)
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(ref.cfg)
    np.testing.assert_array_equal(got.volume.labels.numpy(),
                                  np.asarray(ref.volume.labels))
    np.testing.assert_array_equal(got.volume.media.numpy(),
                                  np.asarray(ref.volume.media))
    for f in ("n_photons", "seed", "source", "detectors", "id_offset"):
        assert getattr(got, f) == getattr(ref, f), f
    with pytest.raises(ValueError, match="unknown scenario keys"):
        SC.Scenario.from_dict({"photons": 1, "colour": "red"})
    with pytest.raises(ValueError, match="unknown bench"):
        SC.Scenario.from_dict({"photons": 1, "bench": "B9"})


def _jax_scenario(sc_dict):
    return JSC.Scenario.from_dict(sc_dict)


@pytest.mark.parametrize("entry", [
    {"bench": "B2", "size": SIZE, "photons": 1500, "seed": 3,
     "source": {"type": "disk", "pos": [10, 10, 0], "radius": 3},
     "detectors": DETS, "time_gates": 4, "steps_per_round": 4,
     "tmax_ns": 2.0, "id_offset": 2**32 - 700},
    {"bench": "B1", "size": SIZE, "photons": 1500, "seed": 8,
     "source": {"type": "planar", "pos": [5, 5, 0], "v1": [10, 0, 0],
                "v2": [0, 10, 0], "pattern": [[1.0, 0.25], [0.5, 1.0]]},
     "steps_per_round": 4}])
def test_port_matches_jax_simulate_one(entry):
    ref = JSC.simulate_one(_jax_scenario(entry), n_lanes=256)
    jax.block_until_ready(ref)
    got = SC.simulate_one(SC.Scenario.from_dict(entry), n_lanes=256,
                          device="cpu")
    assert int(got.n_launched) == int(ref.n_launched) == entry["photons"]
    assert float(got.launched_w) == float(ref.launched_w)
    L = float(ref.launched_w)
    jb, tb = JA.energy_balance(ref), TA.energy_balance(got)
    for key in ("absorbed", "escaped", "timed_out"):
        assert abs(tb[key] - jb[key]) <= TOTALS_TOL * L, key
    assert abs(tb["residue_frac"]) < 1e-5
    assert got.energy.shape == tuple(np.asarray(ref.energy).shape)
    axes = (0, 1) if got.energy.ndim == 3 else (0, 1, 3)
    tprof = got.energy.double().sum(dim=axes).numpy()
    jprof = np.asarray(ref.energy, np.float64).sum(axis=axes)
    assert np.abs(tprof - jprof).max() <= PROFILE_TOL * L
    if "detectors" in entry:
        tw = got.det_w.double().sum(dim=1).numpy()
        jw = np.asarray(ref.det_w, np.float64).sum(axis=1)
        assert (jw > 1).all()
        assert np.abs(tw - jw).max() <= DET_W_TOL * L


def test_fixed_point_sums_ignore_lane_order():
    vol = V.benchmark_b2((16, 14, 12))
    cfg = _cfg(n_time_gates=4, tmax_ns=0.3)
    n, K = 512, 12
    state = ops.fresh_state(vol, n, seed=21, source={
        "type": "disk", "pos": [8.0, 7.0, 0.0], "radius": 3.0})
    geom = torch.tensor([[9.0, 7.0, 9.0], [5.0, 7.0, 4.0]])
    kw = dict(ppath=torch.zeros(n, vol.media.shape[0]), det_geom=geom)
    args = (vol.labels.reshape(-1), vol.media)
    got = photon_steps_ref(*args, state, vol.shape, 1.0, cfg, K, **kw)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(4))
    shuffled = photon_steps_ref(
        *args, ph.PhotonState(*(x[perm] for x in state)), vol.shape, 1.0,
        cfg, K, **dict(kw, ppath=kw["ppath"][perm]))
    for i in (1, 2, 6, 7):  # fluence, exitance, TPSF, path sums
        assert got[i].dtype == torch.int64
        assert torch.equal(got[i], shuffled[i])
    assert int(got[6].sum()) > 0
    # against a float64 sum of the same float32 deposits: each deposit
    # was rounded once, by at most half a unit
    ntg = cfg.n_time_gates
    flu = torch.zeros(got[1].numel(), dtype=torch.float64)
    st = state
    for _ in range(K):
        res = ph.step(st, vol.labels.reshape(-1), vol.media, vol.shape, 1.0,
                      cfg)
        gate = ph.time_gate_bins(res.dep_t, cfg.tmax_ns, ntg)
        flu.index_add_(0, res.dep_idx * ntg + gate, res.dep_w.double())
        st = res.state
    shift = spec.FIXED_SHIFT["fluence"]
    err = (got[1].double() * 2.0**-shift - flu).abs().max()
    assert float(err) <= n * K * 0.5 * 2.0**-shift
    assert float(flu.sum()) > 1.0
    np.testing.assert_allclose(from_fixed(got[1], shift).double().numpy(),
                               flu.numpy(), rtol=1e-6, atol=1e-9)


def test_cache_sequence_matches_reference():
    """Four calls through caches of one entry: miss, hit (new values of
    the same shape), miss and eviction (another shape), miss and
    eviction (the first shape again), in both packages; the tracer sees
    the same cache counters and spans as the reference's."""
    def entries(photons, src_type):
        src = ({"type": "pencil", "pos": [4, 4, 0]} if src_type == "pencil"
               else {"type": "disk", "pos": [4, 4, 0], "radius": 1})
        return [{"bench": "B1", "size": 8, "photons": p, "seed": i,
                 "steps_per_round": 8, "source": src}
                for i, p in enumerate(photons)]

    calls = [entries([12, 9], "pencil"), entries([7, 11], "pencil"),
             entries([10], "disk"), entries([5, 6], "pencil")]
    caches = {"port": SC.CompileCache(max_entries=1),
              "reference": JSC.CompileCache(max_entries=1)}
    tracers = {"port": T.Tracer(), "reference": None}
    from repro import telemetry as JT
    tracers["reference"] = JT.Tracer()
    seen = {"port": [], "reference": []}
    for call in calls:
        SC.simulate_many([SC.Scenario.from_dict(e) for e in call],
                         n_lanes=16, device="cpu", cache=caches["port"],
                         tracer=tracers["port"])
        res = JSC.simulate_many([JSC.Scenario.from_dict(e) for e in call],
                                n_lanes=16, cache=caches["reference"],
                                tracer=tracers["reference"])
        jax.block_until_ready(res)
        for who, cache in caches.items():
            st = cache.stats()
            seen[who].append((st["hits"], st["misses"], st["evictions"],
                              st["entries"]))
    assert seen["port"] == seen["reference"] == [
        (0, 1, 0, 1), (1, 1, 0, 1), (1, 2, 1, 1), (1, 3, 2, 1)]
    names = {who: [(e.name, e.args.get("scenarios"), e.args.get("cache_hit"))
                   for e in tr.events] for who, tr in tracers.items()}
    assert names["port"] == names["reference"]


def test_tracer_counters_of_a_batch():
    sink = T.InMemorySink()
    tracer = T.Tracer(sinks=[sink])
    fleet = _fleet(2)
    SC.simulate_many(fleet, n_lanes=LANES, device="cpu",
                     cache=SC.CompileCache(), tracer=tracer)
    counters = [e["name"] for e in sink.events if e["type"] == "counter"]
    assert counters.count("scenarios.cache.miss") == 2
    assert counters[-2:] == ["scenarios.cache.hit_rate",
                             "scenarios.cache.evictions"]
    batches = [e for e in tracer.events if e.name == "scenarios.batch"]
    assert [e.args["photons"] for e in batches] == [
        sc.n_photons for sc in fleet]
    assert all(e.device == "cpu:0" and e.engine == "plain" for e in batches)
