"""The round loop's phase spans under a ``torch.profiler`` capture.

Under a CPU capture a run records its phases in the process-wide tracer
(``telemetry.capture_tracer``): a ``round.host_read`` for each test of
the loop condition (one every ``ROUNDS_PER_READ`` rounds, and the one
that ends the loop), a ``round.regenerate``, ``round.step`` and
``round.totals`` for each round issued (the CPU replays no graph), one
``run`` (with its host reads and replays), ``run.finish`` and
``convert``, each tied to its parent and to
one root, each stamped on the trace's clock.  Outside a capture nothing
is recorded, and the results are the same bits either way.  In a fleet
the round spans hang below ``scenarios.batch`` while a passed tracer
gets the spans it always got.  The benchmark's span-share readers and
``launch/profile_run.py``'s charging of idle time to spans run on
made-up inputs.
"""

import collections
import dataclasses
import json
import pathlib
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch import telemetry as T  # noqa: E402
from repro_torch.telemetry import trace as TR  # noqa: E402
from repro_torch.core import simulator as S  # noqa: E402
from repro_torch.core import volume as V  # noqa: E402
from repro_torch.launch import profile_run as P  # noqa: E402
from repro_torch import scenarios as SC  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
K = 8
SOURCE = {"type": "pencil", "pos": [6.0, 6.0, 0.0]}
ROUND = ("round.host_read", "round.regenerate", "round.step",
         "round.totals")


@pytest.fixture(autouse=True)
def fresh_capture():
    """Each test starts and ends with an empty process-wide tracer."""
    T.capture_tracer().events.clear()
    yield T.capture_tracer().events
    T.capture_tracer().events.clear()


def _capture():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _setup():
    vol = V.benchmark_b1((12, 12, 12))
    cfg = dataclasses.replace(V.b1_config(), steps_per_round=K)
    return vol, cfg


def _by_name(events):
    out = collections.defaultdict(list)
    for e in sorted(events, key=lambda e: e.t0):
        out[e.name].append(e)
    return out


def test_a_run_records_its_phases_on_the_trace_clock(tmp_path):
    vol, cfg = _setup()
    with _capture() as prof:
        with torch.profiler.record_function(P.WINDOW):
            pass  # the capture's first range pays its set-up
        res = S.simulate(vol, cfg, 200, 64, 3, source=SOURCE, device="cpu")
    rounds = res.steps // K
    assert rounds > 2
    # a read before every ROUNDS_PER_READ rounds, and the one that ends
    # the loop; on the CPU each round issued is eager
    batches = -(-rounds // S.ROUNDS_PER_READ)
    issued = batches * S.ROUNDS_PER_READ
    spans = _by_name(T.capture_tracer().events)
    counts = {name: len(v) for name, v in spans.items()}
    assert counts == {"round.host_read": batches + 1,
                      "round.regenerate": issued, "round.step": issued,
                      "round.totals": issued, "run": 1, "run.finish": 1,
                      "convert": 1, "simulate": 1}
    (sim,), (run,), (fin,), (conv,) = (spans[k] for k in (
        "simulate", "run", "run.finish", "convert"))
    assert sim.parent is None and sim.root == sim.span_id
    assert run.parent == sim.span_id and conv.parent == sim.span_id
    assert fin.parent == run.span_id
    assert all(e.parent == run.span_id for k in ROUND for e in spans[k])
    assert {e.root for v in spans.values() for e in v} == {sim.span_id}
    assert run.args == {"photons": 200, "scenarios": 1, "lanes": 64,
                        "K": K, "rounds": rounds, "host_reads": batches + 1,
                        "replays": 0}
    assert all(not e.args for k in ROUND for e in spans[k])
    # each span is a record_function range of the capture, starting
    # where the span's own stamp says
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"]) / 1e9
    ranges = collections.defaultdict(list)
    for name, a, _ in P.span_ranges(trace["traceEvents"]):
        ranges[name].append(base + a / 1e6)
    assert {k: len(v) for k, v in ranges.items()} == counts
    for name, events in spans.items():
        for e, ts in zip(events, ranges[name]):
            assert abs(e.t0 - ts) < 1e-3, name
    assert P.clock_offset_us(T.capture_tracer().events,
                             trace["traceEvents"],
                             int(trace["baseTimeNanoseconds"])) < 1e3


def test_outside_a_capture_a_run_records_nothing_and_keeps_its_bits():
    vol, cfg = _setup()
    args = (vol, cfg, 300, 64, 5)
    kw = dict(source=SOURCE, device="cpu")
    plain = S.simulate_fixed(*args, **kw)
    assert T.capture_tracer().events == [] and T.capture() is None
    with _capture():
        traced = S.simulate_fixed(*args, **kw)
    assert {e.name for e in T.capture_tracer().events} == {
        "run", "run.finish", *ROUND}
    for name, a, b in zip(S.FixedResult._fields, plain, traced):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        else:
            assert a == b, name


def _fleet():
    vol, cfg = _setup()
    return [SC.Scenario(vol, cfg, n_photons=n, seed=s,
                        source={"type": "disk", "pos": [x, 6.0, 0.0],
                                "radius": 2.0})
            for n, s, x in ((150, 1, 5.0), (90, 2, 7.0))]


def _dispatch(tracer):
    return [(e.name, e.device, e.engine, e.args) for e in tracer.events]


def test_fleet_round_spans_reach_their_batch():
    plain = T.Tracer()
    SC.simulate_many(_fleet(), n_lanes=32, device="cpu",
                     cache=SC.CompileCache(), tracer=plain)
    assert T.capture_tracer().events == []
    passed = T.Tracer()
    with _capture():
        SC.simulate_many(_fleet(), n_lanes=32, device="cpu",
                         cache=SC.CompileCache(), tracer=passed)
    assert _dispatch(passed) == _dispatch(plain)
    assert [e.name for e in passed.events] == ["scenarios.compile",
                                               "scenarios.batch"]
    cap = T.capture_tracer().events
    by_id = {e.span_id: e for e in cap}
    batch = next(e for e in cap if e.name == "scenarios.batch")
    assert batch.span_id == passed.events[1].span_id
    fleet = next(e for e in cap if e.name == "simulate_many")
    rounds = [e for e in cap if e.name in ROUND]
    assert len(rounds) > 8
    for e in rounds:
        chain = []
        while e.parent is not None:
            e = by_id[e.parent]
            chain.append(e.name)
        assert chain == ["run", "scenarios.compile", "scenarios.batch",
                         "simulate_many"]
    assert {e.root for e in cap} == {fleet.span_id}


def test_phase_spans_never_synchronise(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    card = torch.device("cuda", 0)
    cap = T.capture_tracer()
    with TR.phase(cap, "round.step", card):
        pass
    with cap.span("run", card, sync=False):
        pass
    assert synced == [] and [e.name for e in cap.events] == [
        "round.step", "run"]
    with T.Tracer().span("simulate", card):
        pass
    assert synced == [card]
    with TR.phase(None, "round.step", card):
        pass
    assert len(cap.events) == 2 and synced == [card]


def test_parents_are_with_blocks_of_one_thread():
    tracer, other = T.Tracer(), T.Tracer()
    with tracer.span("outer") as outer:
        handle = tracer.span("dispatch")  # an async dispatch: no parent
        with other.span("inner", also=tracer) as inner:
            tracer.complete("done", T.clock(), 0.5)
            late = tracer.span("late")
        handle.end()
        late.end()
    ev = {e.name: e for e in tracer.events}
    assert ev["dispatch"].parent == outer.event.span_id
    assert ev["inner"].parent == outer.event.span_id
    assert ev["done"].parent == inner.event.span_id
    assert ev["late"].parent == inner.event.span_id
    assert other.events == [inner.event]
    assert {e.root for e in tracer.events} == {outer.event.span_id}
    with tracer.span("next") as nxt:
        pass
    assert nxt.event.parent is None and nxt.event.root == nxt.event.span_id
    # the links survive a Chrome trace and load back into their fields
    back = T.load_chrome_trace(tracer.chrome_trace())
    assert [(e.span_id, e.parent, e.root, e.args) for e in back] == [
        (e.span_id, e.parent, e.root, e.args)
        for e in sorted(tracer.events, key=lambda e: e.t0)]
    # stamps are Unix-epoch seconds; durations monotonic
    assert abs(T.clock() - time.time()) < 1.0
    assert all(e.dur >= 0 for e in tracer.events)


READERS = [f"{m}.{c}" for c in ("cw", "sweep") for m in (
    "regen_host_share", "totals_host_share", "step_issue_share",
    "host_read_share")]
SPAN_OF = {"regen_host_share": "round.regenerate",
           "totals_host_share": "round.totals",
           "step_issue_share": "round.step",
           "host_read_share": "round.host_read"}


@pytest.mark.parametrize("metric", READERS)
def test_span_share_readers(metric, monkeypatch, fresh_capture):
    monkeypatch.syspath_prepend(str(ROOT))
    from perfbench import harness
    from perfbench.profiling import Trace

    reader = harness.reader(ROOT, metric)
    secs = {"round.regenerate": 0.25, "round.totals": 0.05,
            "round.step": 0.125, "round.host_read": 0.0625}
    for name, dur in secs.items():
        for k in range(4):  # two solutions, two rounds each
            fresh_capture.append(T.SpanEvent(
                name=name, device="cuda:0", t0=100.0 + k, dur=dur / 4))
    fresh_capture.append(T.SpanEvent(name="run", device="cuda:0", t0=100.0,
                                     dur=1.5))
    trace = Trace(window_s=2.0, busy_s=0.2, device_events=10, step_s=0.1,
                  other_s=0.1, device_ops=[], idle_gaps=[])
    run = {"trace": trace, "profiled": [{"rounds": 2}, {"rounds": 2}]}
    want = secs[SPAN_OF[metric.split(".")[0]]] / 2.0
    assert reader.read(run) == pytest.approx(want, rel=1e-12)
    assert reader.read(dict(run, trace=None)) is None
    fresh_capture.clear()
    assert reader.read(run) is None


def test_profile_run_charges_idle_time_to_spans():
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [
        x("user_annotation", P.WINDOW, 0.0, 100.0),
        x("user_annotation", "run", 5.0, 90.0),
        x("user_annotation", "round.regenerate", 10.0, 20.0),
        x("user_annotation", "round.step", 30.0, 10.0),
        x("user_annotation", "round.host_read", 40.0, 30.0),
        x("kernel", "elementwise", 15.0, 5.0),        # in regenerate
        x("kernel", "photon_step_kernel", 35.0, 30.0),  # step to read
        x("cpu_op", "aten::add", 12.0, 3.0),
    ]
    idle = P.idle_by_span(events, 0.0, 100.0)
    # [0, 5) outside, [5, 10) run, [10, 15) and [20, 30) regenerate,
    # [30, 35) step, [65, 70) host read, [70, 95) run, [95, 100) outside
    want = {P.OUTSIDE: 10.0, "run": 30.0, "round.regenerate": 15.0,
            "round.step": 5.0, "round.host_read": 5.0}
    assert idle == pytest.approx({k: v / 1e6 for k, v in want.items()})
    assert list(idle)[0] == "run"
    assert sum(idle.values()) == pytest.approx(
        (100.0 - P.busy_us([(15.0, 20.0), (35.0, 65.0)])) / 1e6)
    spans = [T.SpanEvent("round.step", "cuda:0", t0=1000.0 + 30e-6,
                         dur=2e-3),
             T.SpanEvent("round.step", "cuda:0", t0=1000.5, dur=4e-3),
             T.SpanEvent("round.regenerate", "cuda:0", t0=1000.0, dur=1e-3)]
    assert P.host_ms_per_round(spans, 2) == pytest.approx(
        {"round.step": 3.0, "round.regenerate": 0.5})
    ranges = [x("user_annotation", "round.step", 30.0 + 4.0, 1.0),
              x("user_annotation", "round.step", 0.5e6 + 2.0, 1.0),
              x("user_annotation", "round.regenerate", 0.0, 1.0)]
    # offsets 4, 2 and 0 us: the median is 2
    assert P.clock_offset_us(spans, ranges, 1000 * 10**9) == pytest.approx(
        2.0, abs=1e-3)
