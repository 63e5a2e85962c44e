"""Host seconds in the port's phase spans, as a share of the traced
window.

While a ``torch.profiler`` capture runs, the port records the phases of
its round loop (``round.host_read``, ``round.regenerate``,
``round.step``, ``round.totals``) in a process-wide tracer,
``repro_torch.telemetry.capture_tracer()``, on the trace's clock.  The
profiled solutions are the only work a run captures, so that tracer
holds their spans and nothing else.  A port without it (an older
checkout) gives no share, and the metric is left out of the line.
"""

from __future__ import annotations


def share(run, name: str) -> float | None:
    """Host seconds inside the spans called ``name``, summed over the
    profiled solutions, over the traced window's seconds; ``None``
    without a trace or without such spans."""
    t = run["trace"]
    if t is None:
        return None
    try:
        from repro_torch.telemetry import trace
    except ImportError:
        return None
    tracer = getattr(trace, "capture_tracer", None)
    if tracer is None:
        return None
    durs = [e.dur for e in tracer().events if e.name == name]
    return sum(durs) / t.window_s if durs else None
