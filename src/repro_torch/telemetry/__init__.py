"""Simulation telemetry: round counters, span timeline, metrics sinks.

  * :class:`RoundStats`: per-round physics counters accumulated by the
    round loop when ``SimConfig.collect_stats`` is set, returned on
    ``SimResult.stats``;
  * :class:`Tracer` / :func:`chrome_trace`: host-side span timeline of
    simulations, scenario batches and replay batches (each dispatch span
    on a CUDA device ends after a device synchronisation), on the clock
    of a ``torch.profiler`` trace (:func:`clock`), exportable as Chrome
    ``trace_event`` JSON;
  * :func:`capture_tracer`: the process-wide tracer that holds the round
    loop's phase spans (``run``, ``round.*``, ``run.finish``,
    ``convert``) recorded while a ``torch.profiler`` capture runs
    (:func:`capture`); they never synchronise the device;
  * :class:`MetricsSink` backends (:class:`InMemorySink`,
    :class:`JsonlSink`): structured event consumers, wired to the CLI's
    ``--metrics-out``.

:func:`fit_device_models` turns a recorded (or re-loaded) trace into
per-device ``loadbalance.DeviceModel`` fits.
"""

from repro_torch.telemetry.sinks import InMemorySink, JsonlSink, MetricsSink
from repro_torch.telemetry.stats import RoundStats
from repro_torch.telemetry.trace import (
    SpanEvent,
    Tracer,
    capture,
    capture_tracer,
    chrome_trace,
    clock,
    device_label,
    device_samples,
    fit_device_models,
    load_chrome_trace,
)

__all__ = [
    "InMemorySink",
    "JsonlSink",
    "MetricsSink",
    "RoundStats",
    "SpanEvent",
    "Tracer",
    "capture",
    "capture_tracer",
    "chrome_trace",
    "clock",
    "device_label",
    "device_samples",
    "fit_device_models",
    "load_chrome_trace",
]
