"""Simulation telemetry: round counters, span timeline, metrics sinks.

  * :class:`RoundStats`: per-round physics counters accumulated by the
    round loop when ``SimConfig.collect_stats`` is set, returned on
    ``SimResult.stats``;
  * :class:`Tracer` / :func:`chrome_trace`: host-side span timeline of
    simulations, scenario batches and replay batches (each span on a
    CUDA device ends after a device synchronisation), exportable as
    Chrome ``trace_event`` JSON;
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
    chrome_trace,
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
    "chrome_trace",
    "device_label",
    "device_samples",
    "fit_device_models",
    "load_chrome_trace",
]
