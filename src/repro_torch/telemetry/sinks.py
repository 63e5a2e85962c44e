"""Metrics sinks: structured event consumers.

A sink receives flat JSON-serializable event dicts (span records from
the :class:`repro_torch.telemetry.Tracer`, counter samples, run
summaries) and does something durable with them:

  * :class:`InMemorySink`: a list, for tests and for feeding measured
    throughput samples back into ``loadbalance.fit_pilot`` (see
    ``telemetry.fit_device_models``);
  * :class:`JsonlSink`: one JSON object per line, the CLI's
    ``--metrics-out`` backend.

Sinks flush per event and enforce no schema beyond "dict in, JSON out".
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Protocol, runtime_checkable


@runtime_checkable
class MetricsSink(Protocol):
    """Anything with an ``emit(event: dict) -> None``."""

    def emit(self, event: dict) -> None:  # pragma: no cover - protocol
        ...


class InMemorySink:
    """Collect events in a list (tests, in-process consumers)."""

    def __init__(self):
        self.events: list[dict] = []

    def emit(self, event: dict) -> None:
        self.events.append(event)

    def __len__(self) -> int:
        return len(self.events)


class JsonlSink:
    """Append events as JSON lines to ``path`` (the CLI's --metrics-out).

    The file is opened lazily on the first event and flushed per line,
    so a crashed campaign keeps every event emitted before the crash.
    """

    def __init__(self, path):
        self.path = Path(path)
        self._fh = None

    def emit(self, event: dict) -> None:
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open("a")
        self._fh.write(json.dumps(event, default=_jsonable) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _jsonable(obj):
    """Fallback encoder: numpy scalars and 0-d tensors -> Python
    numbers."""
    if hasattr(obj, "item"):
        return obj.item()
    return str(obj)
