"""Host-side span recording and Chrome trace export.

The paper's heterogeneous-execution result rests on measuring per-device
throughput and feeding it back into work assignment (Sec. 2.4).  A
:class:`Tracer` wraps each dispatch (a simulation, a scenario batch, a
replay batch) in a span tagged with device, engine and photon count; the
timeline exports as Chrome ``trace_event`` JSON (chrome://tracing,
Perfetto) or streams to any :class:`repro_torch.telemetry.MetricsSink`.

Every stamp is on the clock of a ``torch.profiler`` trace, Unix-epoch
seconds (:func:`clock`: the monotonic clock plus one anchor taken at
import), and every duration is a difference of monotonic readings.  A
span records its parent, the innermost span open in its thread (a span
is open inside its ``with`` block), and the root of that chain, so the
spans of one solution or fleet share one id.  While a
``torch.profiler`` capture runs, every span is also a
``record_function`` range, so it shows in the capture beside the
device work, at the same time.

A dispatch span on a CUDA device ends after a ``torch.cuda.synchronize``
of that device, so its duration covers the device work it enqueued; a
span opened with ``sync=False`` (the round loop's phases) never
synchronises.  The span records double as measured throughput samples:
:func:`fit_device_models` turns a recorded (or re-loaded) timeline into
per-device ``loadbalance.DeviceModel`` fits (two or more distinct chunk
sizes give the paper's ``T = a*n + T0`` pilot fit; equal sizes a
throughput-only model).

:func:`capture` gives the process-wide tracer (:func:`capture_tracer`)
while a ``torch.profiler`` capture runs and ``None`` otherwise: the
round loop reads it once a run and records its phase spans there, so a
run outside a capture pays that one flag read and a ``None`` test a
phase.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
from pathlib import Path
from typing import Sequence

import torch

from repro_torch.telemetry.sinks import MetricsSink

# Unix-epoch seconds at monotonic zero: the anchor of clock()
_EPOCH = time.time() - time.monotonic()  # reprolint: disable=REP201 - the trace clock's one anchor, telemetry only
# span ids, unique in the process
_IDS = itertools.count(1)


class _Open(threading.local):
    """The spans open in each thread, innermost last."""

    def __init__(self):
        self.stack: list = []


_OPEN = _Open()


def clock() -> float:
    """Now, in Unix-epoch seconds on the clock of a ``torch.profiler``
    trace (whose events are ``ts`` microseconds past its
    ``baseTimeNanoseconds``): the monotonic clock plus one anchor."""
    return time.monotonic() + _EPOCH  # reprolint: disable=REP201 - span times on the host clock, telemetry only


def _link(event: "SpanEvent") -> "SpanEvent":
    """Give a new event an id, and as its parent the innermost span open
    in this thread (and that span's root)."""
    stack = _OPEN.stack
    outer = stack[-1].event if stack else None
    event.span_id = next(_IDS)
    event.parent = None if outer is None else outer.span_id
    event.root = event.span_id if outer is None else outer.root
    return event


def _cuda_device(device):
    """The ``torch.device`` a span must synchronize at its end, or None."""
    if isinstance(device, torch.device) and device.type == "cuda":
        return device
    return None


def device_label(device) -> str:
    """Stable string id of a ``torch.device`` (``"cuda:0"``, ``"cpu:0"``;
    a CUDA device without an index names the current one), or pass a
    string through; ``None`` is ``"host"``."""
    if device is None:
        return "host"
    if isinstance(device, str):
        return device
    device = torch.device(device)
    index = device.index
    if index is None:
        index = (torch.cuda.current_device() if device.type == "cuda"
                 else 0)
    return f"{device.type}:{index}"


# the fields that tie a span to its parent and root
_LINKS = ("span_id", "parent", "root")


@dataclasses.dataclass
class SpanEvent:
    """One completed span on the host timeline."""

    name: str
    device: str               # device_label() string
    t0: float                 # start, Unix-epoch seconds (clock())
    dur: float                # duration, seconds
    engine: str | None = None
    args: dict = dataclasses.field(default_factory=dict)
    span_id: int | None = None  # unique in the process
    parent: int | None = None   # the span open around it, if any
    root: int | None = None     # the outermost span of its chain

    @property
    def photons_per_s(self) -> float | None:
        n = self.args.get("photons", self.args.get("records"))
        if n is None or self.dur <= 0:
            return None
        return float(n) / self.dur

    def to_dict(self) -> dict:
        out = {"type": "span", "name": self.name, "device": self.device,
               "t0": self.t0, "dur_s": self.dur, "engine": self.engine,
               **self.args, **self.links()}
        pps = self.photons_per_s
        if pps is not None:
            out["photons_per_s"] = pps
        return out

    def links(self) -> dict:
        """The span's id, parent and root, those that are set."""
        return {k: getattr(self, k) for k in _LINKS
                if getattr(self, k) is not None}


class _Span:
    """Open span handle; ``end()`` (or exiting the ``with`` block) seals
    it into its tracers' event lists and sinks, after synchronizing its
    CUDA device unless opened with ``sync=False``."""

    def __init__(self, tracers: tuple, name: str, device,
                 engine: str | None, args: dict, sync: bool = True):
        self._tracers = tracers
        self._sync = _cuda_device(device) if sync else None
        self.event = _link(SpanEvent(name=name, device=device_label(device),
                                     t0=0.0, dur=0.0, engine=engine,
                                     args=args))
        self._stack = None
        self._m0 = time.monotonic()  # reprolint: disable=REP201 - span times on the host clock, telemetry only
        self.event.t0 = self._m0 + _EPOCH
        self._annotation = None
        if torch.autograd._profiler_enabled():
            self._annotation = torch.profiler.record_function(name)
            self._annotation.__enter__()

    def note(self, **args) -> None:
        """Add args to the span before it ends."""
        self.event.args.update(args)

    def _close(self) -> None:
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
            self._annotation = None
        if self._stack is not None:
            self._stack.remove(self)
            self._stack = None

    def end(self, **extra_args) -> SpanEvent:
        if self._sync is not None:
            torch.cuda.synchronize(self._sync)
        self._close()
        self.event.dur = time.monotonic() - self._m0  # reprolint: disable=REP201 - span times on the host clock, telemetry only
        self.event.args.update(extra_args)
        for tracer in self._tracers:
            tracer._record(self.event)
        return self.event

    def __enter__(self):
        # inside its block it is the parent of the spans opened
        self._stack = _OPEN.stack
        self._stack.append(self)
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.end()
        else:
            self._close()


class _NoSpan:
    """The phase span of a run outside a capture: records nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NO_SPAN = _NoSpan()


def phase(tracer, name: str, device=None, **args):
    """A span of a phase of the host's work that never synchronises,
    recorded in ``tracer``, or a span that records nothing when
    ``tracer`` is ``None`` (a run outside a capture)."""
    if tracer is None:
        return _NO_SPAN
    return tracer.span(name, device, sync=False, **args)


class Tracer:
    """Collect host-side spans + counters; fan out to metrics sinks.

    ``span(...)`` returns an open handle for explicit ``begin``/``end``
    bracketing of async dispatches (begin at dispatch, end when the
    result array is ready); it is also a context manager for the
    synchronous case, and only then the parent of the spans opened in
    its block (of which an async dispatch, several open at once, is
    none).  All completed events are kept in ``events`` (for
    in-process consumers like :func:`fit_device_models`) and forwarded
    to every sink as flat dicts.
    """

    def __init__(self, sinks: Sequence[MetricsSink] = ()):
        self.sinks = list(sinks)
        self.events: list[SpanEvent] = []

    # -- spans -------------------------------------------------------------

    def span(self, name: str, device=None, engine: str | None = None, *,
             sync: bool = True, also=None, **args) -> _Span:
        """Open a span.  ``sync=False``: it ends without a device
        synchronisation.  ``also``: a second tracer that records the
        same event."""
        tracers = (self,) if also is None else (self, also)
        return _Span(tracers, name, device, engine, dict(args), sync)

    def complete(self, name: str, t0: float, dur: float, device=None,
                 engine: str | None = None, **args) -> SpanEvent:
        """Record a span that has already ended: started at ``t0``
        (:func:`clock`), lasting ``dur`` seconds (another process's
        wall, say); its parent is the innermost span open now."""
        event = _link(SpanEvent(name=name, device=device_label(device),
                                t0=t0, dur=float(dur), engine=engine,
                                args=dict(args)))
        self._record(event)
        return event

    def _record(self, event: SpanEvent) -> None:
        self.events.append(event)
        self._emit(event.to_dict())

    # -- scalar metrics ----------------------------------------------------

    def counter(self, name: str, value, **labels) -> None:
        """Emit one scalar sample (run summaries, RoundStats fields)."""
        self._emit({"type": "counter", "name": name,
                    "value": value, **labels})

    def _emit(self, record: dict) -> None:
        for sink in self.sinks:
            sink.emit(record)

    # -- chrome trace export ----------------------------------------------

    def chrome_trace(self) -> dict:
        return chrome_trace(self.events)

    def save_chrome_trace(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.chrome_trace(), indent=1) + "\n")
        return path


_CAPTURE = Tracer()


def capture_tracer() -> Tracer:
    """The process-wide tracer of the spans recorded under
    ``torch.profiler`` captures (clear its ``events`` between
    captures)."""
    return _CAPTURE


def capture() -> Tracer | None:
    """:func:`capture_tracer` while a ``torch.profiler`` capture runs,
    else ``None``; read once when a run starts."""
    return _CAPTURE if torch.autograd._profiler_enabled() else None


# ---------------------------------------------------------------------------
# Chrome trace_event JSON (chrome://tracing / Perfetto / speedscope)
# ---------------------------------------------------------------------------

_PID = 0  # one process: the simulation host


def chrome_trace(events: Sequence[SpanEvent]) -> dict:
    """Render span events as a Chrome ``trace_event`` JSON object.

    One trace-viewer *thread* (tid) per device, named via ``M``
    metadata events; each span is a complete ``X`` event with
    microsecond timestamps and the span's args (photon count, engine,
    photons/s, and its id, parent and root where set) attached for
    inspection in the viewer.
    """
    tids: dict[str, int] = {}
    trace: list[dict] = [{
        "ph": "M", "pid": _PID, "tid": 0, "name": "process_name",
        "args": {"name": "repro_torch photon transport"},
    }]
    span_rows: list[dict] = []
    for ev in sorted(events, key=lambda e: e.t0):
        tid = tids.setdefault(ev.device, len(tids))
        args = dict(ev.args)
        if ev.engine is not None:
            args["engine"] = ev.engine
        pps = ev.photons_per_s
        if pps is not None:
            args["photons_per_s"] = pps
        args.update(ev.links())
        span_rows.append({
            "ph": "X", "pid": _PID, "tid": tid, "name": ev.name,
            "cat": "dispatch", "ts": ev.t0 * 1e6, "dur": ev.dur * 1e6,
            "args": args,
        })
    for device, tid in tids.items():
        trace.append({"ph": "M", "pid": _PID, "tid": tid,
                      "name": "thread_name", "args": {"name": device}})
    trace.extend(span_rows)
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def load_chrome_trace(path_or_obj) -> list[SpanEvent]:
    """Parse a Chrome trace JSON back into :class:`SpanEvent` rows.

    Accepts a path or an already-parsed trace dict.  The inverse of
    :func:`chrome_trace` up to float rounding — the round-trip is what
    lets a saved ``--trace-out`` file feed :func:`fit_device_models`
    (and therefore ``loadbalance.fit_pilot``) in a later process.
    """
    if isinstance(path_or_obj, (str, Path)):
        obj = json.loads(Path(path_or_obj).read_text())
    else:
        obj = path_or_obj
    rows = obj.get("traceEvents", obj) if isinstance(obj, dict) else obj
    tid_names: dict[tuple, str] = {}
    for row in rows:
        if row.get("ph") == "M" and row.get("name") == "thread_name":
            tid_names[(row.get("pid"), row.get("tid"))] = \
                row.get("args", {}).get("name", "")
    events = []
    for row in rows:
        if row.get("ph") != "X":
            continue
        args = dict(row.get("args", {}))
        engine = args.pop("engine", None)
        args.pop("photons_per_s", None)  # derived; recomputed on demand
        links = {k: args.pop(k) for k in _LINKS if k in args}
        device = tid_names.get((row.get("pid"), row.get("tid")),
                               str(row.get("tid")))
        events.append(SpanEvent(
            name=row.get("name", ""), device=device,
            t0=float(row.get("ts", 0.0)) / 1e6,
            dur=float(row.get("dur", 0.0)) / 1e6,
            engine=engine, args=args, **links))
    return events


# ---------------------------------------------------------------------------
# measured-throughput samples -> loadbalance device models
# ---------------------------------------------------------------------------

def device_samples(events: Sequence[SpanEvent],
                   name: str | None = None) -> dict[str, list[tuple]]:
    """Group span events into per-device ``(photons, seconds)`` samples.

    ``name`` filters by span name (``None``: every span carrying a
    ``photons`` or ``records`` arg counts).  The samples are exactly the
    pilot measurements ``loadbalance.fit_pilot`` consumes.
    """
    out: dict[str, list[tuple]] = {}
    for ev in events:
        if name is not None and ev.name != name:
            continue
        n = ev.args.get("photons", ev.args.get("records"))
        if n is None or ev.dur <= 0:
            continue
        out.setdefault(ev.device, []).append((float(n), float(ev.dur)))
    return out


def fit_device_models(events_or_trace, name: str | None = None) -> dict:
    """Fit a ``loadbalance.DeviceModel`` per device from span records.

    ``events_or_trace`` is a list of :class:`SpanEvent` (a live
    ``Tracer.events``) or anything :func:`load_chrome_trace` accepts (a
    saved ``--trace-out`` path).  Fitting follows the shared rule in
    ``loadbalance.model_from_samples`` (full ``T = a*n + T0`` fit when
    the samples span >= 2 distinct photon counts, aggregate-throughput
    fallback otherwise).  The result plugs straight into
    ``loadbalance.PARTITIONERS`` / ``heterogeneous_partition``.
    """
    from repro_torch.core.loadbalance import DeviceModel, model_from_samples

    events = events_or_trace
    if not (isinstance(events, (list, tuple)) and
            all(isinstance(e, SpanEvent) for e in events)):
        events = load_chrome_trace(events_or_trace)
    models: dict[str, DeviceModel] = {}
    for device, samples in device_samples(events, name=name).items():
        model = model_from_samples(samples, name=device)
        if model is not None:
            models[device] = model
    return models
