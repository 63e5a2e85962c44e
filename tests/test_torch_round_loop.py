"""The round loop's host reads, once every ``ROUNDS_PER_READ`` rounds,
on the CPU.

The loop reads a flag each round leaves on the device (whether any
scenario has work left) once every ``simulator.ROUNDS_PER_READ`` rounds,
so a run issues up to R - 1 rounds after its last photon ends.  Those
rounds are no-ops: every field of the ``FixedResult`` is the same bits
whatever R is, and equal to the frozen plain reference
(``perfbench/reference``), which runs each photon to its end; rounds and
steps are counted on the device, one a round in which a scenario had
work; the ``max_steps`` cap cuts the last batch of rounds; a cancel is
seen at the first read.  On the CPU every round is issued eagerly: no
graph is captured or replayed.  R is a constant of the code; the tests
set other values of it to hold the semantics against R = 1 (a read
before every round).  No JAX is imported here.
"""

import dataclasses
import pathlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import scenarios as SC  # noqa: E402
from repro_torch import telemetry as T  # noqa: E402
from repro_torch.core import simulator as S  # noqa: E402
from repro_torch.core import volume as V  # noqa: E402
from repro_torch.detectors import as_detectors, det_geometry  # noqa: E402
from repro_torch.kernels.photon_step import photon_step as K  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPE = (16, 16, 16)
DISK = {"type": "disk", "pos": [8.0, 8.0, 0.0], "radius": 3.0}
DETECTORS = [{"x": 11, "y": 8, "radius": 3}, {"x": 5, "y": 8, "radius": 2}]


@pytest.fixture
def reference(monkeypatch):
    """``perfbench.reference``'s ``step`` and ``transport``."""
    monkeypatch.syspath_prepend(str(ROOT))
    from perfbench.reference import step, transport

    return step, transport


def _cfg(k=3, **kw):
    return dataclasses.replace(V.b2_config(), steps_per_round=k,
                               n_time_gates=3, tmax_ns=0.5,
                               collect_stats=True, **kw)


def _run(monkeypatch, every, photons=700, lanes=128, mode="dynamic",
         cfg=None, **kw):
    monkeypatch.setattr(S, "ROUNDS_PER_READ", every)
    return S.simulate_fixed(V.benchmark_b2(SHAPE), cfg or _cfg(), photons,
                            lanes, 2**31 + 9, source=DISK, mode=mode,
                            device="cpu", detectors=DETECTORS,
                            record_detected=512, id_offset=2**32 - 300,
                            **kw)


def _assert_same(a, b):
    for name, x, y in zip(S.FixedResult._fields, a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), name
        else:
            assert x == y, name


def _by_id(rows):
    ids = rows[:, 1].astype(np.uint64) << np.uint64(32) | rows[:, 0].astype(
        np.uint64)
    return rows[np.argsort(ids, kind="stable")]


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_trailing_no_op_rounds_change_nothing(reference, monkeypatch, mode):
    """Runs that read before every round, every 6 rounds and every 64
    give every field's bits, and those of the frozen reference: grids,
    totals, counters, records."""
    step, transport = reference
    runs = {every: _run(monkeypatch, every, mode=mode) for every in (1, 6, 64)}
    for every in (6, 64):
        _assert_same(runs[1], runs[every])
    got = runs[64]
    rounds = got.steps // 3
    # the work ends inside the last batch of 6 and of 64
    assert rounds > 64 and rounds % 6 and rounds % 64
    cfg = _cfg()
    vol = V.benchmark_b2(SHAPE)
    phys = step.Physics(do_reflect=cfg.do_reflect, tmax_ns=cfg.tmax_ns,
                        w_threshold=cfg.w_threshold,
                        roulette_m=cfg.roulette_m,
                        n_time_gates=cfg.n_time_gates)
    geom = det_geometry(as_detectors(DETECTORS), "cpu")
    ref = transport.forward(vol.labels.reshape(-1), vol.media, vol.shape,
                            vol.unitinmm, phys, DISK, 2**31 + 9,
                            2**32 - 300, 700, det_geom=geom, record=True)
    assert torch.equal(got.fluence.reshape(-1), ref.fluence)
    assert torch.equal(got.exitance.reshape(-1), ref.exitance)
    assert torch.equal(got.det_w.reshape(-1), ref.det_w)
    assert torch.equal(got.det_ppath, ref.det_ppath)
    assert [int(got.escaped), int(got.timed_out), int(got.launched_w),
            int(got.n_launched), int(got.counters[3])] == [
        ref.escaped, ref.timed_out, ref.launched_w, ref.n_launched,
        ref.live_segments]
    n = int(got.det_rec_n)
    assert 0 < n == ref.records.shape[0] and int(got.det_rec_overflow) == 0
    np.testing.assert_array_equal(_by_id(got.det_rec[:n].numpy()),
                                  _by_id(ref.records.numpy()))


def test_rounds_and_steps_are_counted_on_the_device(monkeypatch):
    """In a batch of scenarios that end rounds apart, each scenario's
    steps and round counters stop at its own last round with work, read
    every 64 rounds or before every round alike."""
    vol = V.benchmark_b2(SHAPE)
    fleet = [SC.Scenario(vol, _cfg(k=4), n, seed=5,
                         source=dict(DISK, pos=[6.0 + 2 * i, 8.0, 0.0]),
                         id_offset=1000 * i)
             for i, n in enumerate((20, 150, 400))]
    runs = {}
    for every in (1, 64):
        monkeypatch.setattr(S, "ROUNDS_PER_READ", every)
        runs[every] = SC.simulate_many(fleet, n_lanes=64, device="cpu",
                                       cache=SC.CompileCache())
    steps = [r.steps for r in runs[64]]
    assert steps == [r.steps for r in runs[1]]
    assert steps[0] < steps[1] < steps[2]
    for a, b in zip(runs[1], runs[64]):
        assert torch.equal(a.energy, b.energy)
        assert a.stats == b.stats
        assert int(b.stats.rounds) == b.steps // 4
        assert float(b.stats.lane_segments) == b.steps * 64


def test_max_steps_cuts_the_last_batch(monkeypatch):
    """A cap of 50 segments at K = 3 is 17 rounds, 3 batches of 5 and one
    of 2: the loop issues 17 photon steps, retires what is still in
    flight, and gives the bits of a read before every round."""
    calls = []
    step = S.photon_steps

    def counted(*a, **k):
        calls.append(1)
        return step(*a, **k)

    monkeypatch.setattr(S, "photon_steps", counted)
    cfg = _cfg(max_steps=50)
    capped = _run(monkeypatch, 5, cfg=cfg)
    assert len(calls) == 17 and capped.steps == 51
    assert int(capped.timed_out) > 0
    _assert_same(_run(monkeypatch, 1, cfg=cfg), capped)
    assert len(calls) == 34


def test_cpu_runs_replay_no_graph(monkeypatch):
    """Under a capture the ``run`` span counts its reads and no replay;
    no round graph is counted in ``launches_by``, and every round issued
    (the rounds with work, then no-op ones up to the next read) is an
    eager round of the host kernel."""
    T.capture_tracer().events.clear()
    K.reset_launches()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got = _run(monkeypatch, 4, cfg=_cfg(k=8))
        events = T.capture_tracer().events
        (run,) = [e for e in events if e.name == "run"]
        rounds = got.steps // 8
        batches = -(-rounds // 4)
        assert run.args["rounds"] == rounds
        assert run.args["host_reads"] == batches + 1
        assert run.args["replays"] == 0
        assert not [e for e in events if e.name == "round.replay"]
        assert len([e for e in events if e.name == "round.step"]) == (
            batches * 4)
        assert K.photon_step_cuda.launches_by["round_graph"] == 0
        host = [k for k in K.photon_step_cuda.launches_by
                if k.startswith("host/")]
        assert len(host) == 1
        assert K.photon_step_cuda.launches_by[host[0]] == batches * 4
    finally:
        T.capture_tracer().events.clear()


def test_a_cancel_set_before_the_run_stops_it_at_the_first_read(
        monkeypatch):
    calls = []
    monkeypatch.setattr(S, "photon_steps",
                        lambda *a, **k: calls.append(1))
    vol = V.benchmark_b2(SHAPE)
    run = S.build_fixed_fn(vol.shape, vol.unitinmm, _cfg(), 128,
                           source=DISK, device="cpu")
    cancel = threading.Event()
    cancel.set()
    with pytest.raises(S.RunCancelled, match="after 0 steps"):
        run(vol.labels.reshape(-1), vol.media, 700, 3, cancel=cancel)
    assert calls == []
