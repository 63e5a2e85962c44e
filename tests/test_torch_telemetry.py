"""The port's telemetry, load balancing, autotune and CLI flags against
the reference.

``Tracer`` spans and counters reach every sink, export to Chrome
``trace_event`` JSON and load back (timestamps to the microsecond
rounding of the format); ``chrome_trace`` of the same events gives the
reference's JSON apart from the process name.  ``fit_device_models``
and the ``loadbalance`` partitioners and fits give the reference's
numbers on the same samples exactly (the port's module is a copy of
the reference's, which has no JAX in it).  ``autotune_rounds`` /
``autotune_lanes`` time every candidate and return the fastest.  The
CLI's ``--source``, ``--scenarios``, ``--autotune``, ``--trace-out``
and ``--metrics-out`` run on ``--device cpu``.
"""

import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import telemetry as JT  # noqa: E402
from repro.core import loadbalance as JLB  # noqa: E402
from repro_torch import telemetry as T  # noqa: E402
from repro_torch.core import loadbalance as TLB  # noqa: E402
from repro_torch.core import simulator as S  # noqa: E402
from repro_torch.core import volume as V  # noqa: E402
from repro_torch.launch import simulate as launch  # noqa: E402

SAMPLES = {"cuda:0": [(1e6, 0.41), (2e6, 0.79), (4e6, 1.62)],
           "cpu:0": [(5e4, 2.0), (5e4, 2.2)],
           "cuda:1": [(3e6, 0.9), (1e6, 0.35)]}


def _events(module):
    """The same span events, built by either package's SpanEvent."""
    out = []
    t = 100.0
    for device, samples in SAMPLES.items():
        for n, dur in samples:
            out.append(module.SpanEvent(name="chunk", device=device, t0=t,
                                        dur=dur, engine="kernel",
                                        args={"photons": n}))
            t += dur
    out.append(module.SpanEvent(name="replay_batch", device="cuda:0", t0=t,
                                dur=0.5, engine="kernel",
                                args={"records": 1000}))
    return out


def test_tracer_sinks_and_chrome_round_trip(tmp_path):
    mem = T.InMemorySink()
    path = tmp_path / "metrics.jsonl"
    with T.JsonlSink(path) as jl:
        tracer = T.Tracer(sinks=[mem, jl])
        with tracer.span("simulate", device=torch.device("cpu"),
                         engine="plain", photons=1000) as sp:
            pass
        span = tracer.span("replay_batch", device="cuda:3", records=7)
        ev = span.end(batch_start=0)
        tracer.counter("photons_per_s", np.float32(2.5), bench="B1")
    assert sp.event.device == "cpu:0" and ev.args == {"records": 7,
                                                      "batch_start": 0}
    assert [e["type"] for e in mem.events] == ["span", "span", "counter"]
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert lines == json.loads(json.dumps(mem.events, default=float))
    assert lines[0]["photons_per_s"] == pytest.approx(
        1000 / lines[0]["dur_s"])
    saved = tracer.save_chrome_trace(tmp_path / "t" / "trace.json")
    back = T.load_chrome_trace(saved)
    assert [(e.name, e.device, e.engine, e.args) for e in back] == [
        (e.name, e.device, e.engine, e.args) for e in tracer.events]
    for a, b in zip(back, tracer.events):
        assert a.t0 == pytest.approx(b.t0, abs=1e-6)
        assert a.dur == pytest.approx(b.dur, abs=1e-6)
    # the same events render as the reference renders them
    ours = T.chrome_trace(_events(T))
    ref = JT.chrome_trace(_events(JT))
    assert ours["traceEvents"][1:] == ref["traceEvents"][1:]
    assert T.device_label(None) == JT.device_label(None) == "host"
    assert T.device_label("mesh") == "mesh"
    assert T.device_label(torch.device("cpu")) == "cpu:0"
    # under a capture a span is a profiler range, which needs no card; an
    # exception inside it propagates and closes the range
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pytest.raises(RuntimeError):
            with T.Tracer().span("x", device="cpu:0"):
                raise RuntimeError("propagates")
        with T.Tracer().span("y") as after:
            pass
    assert after.event.parent is None
    assert [e.name for e in prof.events()
            if e.name in ("x", "y")] == ["x", "y"]


def test_fit_device_models_and_partitioners_match_reference(tmp_path):
    ours = T.fit_device_models(_events(T))
    ref = JT.fit_device_models(_events(JT))
    assert sorted(ours) == sorted(ref)
    for name in ours:
        assert (ours[name].a, ours[name].t0) == (ref[name].a, ref[name].t0)
    # from a saved trace too
    tracer = T.Tracer()
    tracer.events.extend(_events(T))
    saved = tracer.save_chrome_trace(tmp_path / "trace.json")
    again = T.fit_device_models(str(saved))
    for name in ours:
        assert again[name].a == pytest.approx(ours[name].a, rel=1e-9)
    assert T.device_samples(_events(T), name="chunk") == \
        JT.device_samples(_events(JT), name="chunk")
    models = [TLB.DeviceModel(m.name, m.a, m.t0, cores=c)
              for m, c in zip(ours.values(), (4, 1, 2))]
    rmodels = [JLB.DeviceModel(m.name, m.a, m.t0, cores=m.cores)
               for m in models]
    for total in (0, 1, 999, 10**7 + 3):
        for key in ("S1", "S2", "S3"):
            part = TLB.PARTITIONERS[key](total, models)
            assert part == JLB.PARTITIONERS[key](total, rmodels), key
            assert sum(part) == total
            assert TLB.makespan(part, models) == JLB.makespan(part, rmodels)
        assert TLB.ideal_makespan(total, models) == JLB.ideal_makespan(
            total, rmodels)
    fit = TLB.fit_pilot([1e5, 5e5], [0.3, 1.1], name="g")
    assert (fit.a, fit.t0) == (JLB.fit_pilot([1e5, 5e5], [0.3, 1.1]).a,
                               JLB.fit_pilot([1e5, 5e5], [0.3, 1.1]).t0)
    with pytest.raises(ValueError):
        TLB.fit_pilot([1e5, 1e5], [0.3, 0.4])
    with pytest.raises(ValueError):
        TLB.DeviceModel("bad", a=0.0, t0=0.0)
    assert TLB.model_from_samples([(0, 0)]) is None


def test_autotune_times_every_candidate():
    vol = V.benchmark_b1((12, 12, 12))
    cfg = V.b1_config()
    best, timings = S.autotune_rounds(vol, cfg, n_pilot=40,
                                      lane_candidates=(16, 64),
                                      round_candidates=(1, 8), repeats=1,
                                      source={"type": "pencil",
                                              "pos": [6.0, 6.0, 0.0]},
                                      device="cpu")
    assert sorted(timings) == [(16, 1), (16, 8), (64, 1), (64, 8)]
    assert best == min(timings, key=timings.get)
    assert all(t > 0 for t in timings.values())
    lanes, per_lane = S.autotune_lanes(vol, cfg, n_pilot=40,
                                       candidates=(16, 32), repeats=1,
                                       device="cpu")
    assert sorted(per_lane) == [16, 32] and lanes in per_lane


def test_cli_source_trace_and_metrics(tmp_path, capsys):
    trace, metrics = tmp_path / "trace.json", tmp_path / "m.jsonl"
    res = launch.main([
        "--bench", "B2", "--photons", "300", "--size", "16", "--lanes", "64",
        "--steps-per-round", "4", "--device", "cpu",
        "--source", '{"type": "cone", "pos": [8, 8, 0], '
                    '"half_angle_deg": 25}',
        "--trace-out", str(trace), "--metrics-out", str(metrics)])
    assert int(res.n_launched) == 300
    out = capsys.readouterr().out
    assert "trace timeline" in out and "energy balance" in out
    events = T.load_chrome_trace(trace)
    assert [e.name for e in events] == ["volume.shapes", "simulate"]
    assert events[1].args["photons"] == 300
    rows = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert rows[0]["type"] == "span" and rows[-1]["name"] == "photons_per_s"


def test_cli_scenarios_and_autotune(tmp_path, capsys):
    fleet = [{"bench": "B1", "size": 16, "photons": 120, "seed": 1,
              "source": {"type": "disk", "pos": [8, 8, 0], "radius": 2}},
             {"bench": "B1", "size": 16, "photons": 90, "seed": 2,
              "source": {"type": "disk", "pos": [6, 8, 0], "radius": 3}},
             {"bench": "B2", "size": 16, "photons": 60,
              "detectors": [{"x": 10, "y": 8, "radius": 2}]}]
    spec = tmp_path / "fleet.json"
    spec.write_text(json.dumps(fleet))
    trace = tmp_path / "trace.json"
    results = launch.main(["--scenarios", f"@{spec}", "--lanes", "32",
                           "--device", "cpu", "--trace-out", str(trace)])
    assert [int(r.n_launched) for r in results] == [120, 90, 60]
    out = capsys.readouterr().out
    assert "scenarios: 3" in out and "2 config shape(s)" in out
    names = [e.name for e in T.load_chrome_trace(trace)]
    assert names.count("scenarios.batch") == 2
    with pytest.raises(SystemExit):
        launch.main(["--scenarios", "[]", "--device", "cpu"])
    with pytest.raises(SystemExit):
        launch.main(["--scenarios", json.dumps(fleet), "--autotune",
                     "--device", "cpu"])
    res = launch.main(["--bench", "B1", "--photons", "200", "--size", "12",
                       "--steps-per-round", "8", "--autotune",
                       "--device", "cpu"])
    assert int(res.n_launched) == 200
    assert "-> lanes =" in capsys.readouterr().out
