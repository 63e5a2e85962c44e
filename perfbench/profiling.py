"""Device time from a ``torch.profiler`` trace, and the host behind idle.

The arithmetic is that of the port's ``launch/profile_run.py``: the
trace's device events (kernels, copies, sets) by group, and the busy
time as the length of the union of their intervals.  Tracing slows the
host, so the idle share it gives overstates the untraced run's.

Each idle stretch of the device (a gap between two device intervals,
and the ends of the window) is charged to what the host was doing then:
the outermost host operation (``cpu_op``) running in it, or
``host (between operations)`` where none ran.  The trace is written to
a temporary file under ``TMPDIR``, read and deleted.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
from typing import NamedTuple

import numpy as np

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
STEP_KERNEL = "photon_step"
BETWEEN = "host (between operations)"
# a kernel's name in the breakdown, cut to this length
NAME_CHARS = 160
# entries in each list of the breakdown
TOP = 10


class Trace(NamedTuple):
    window_s: float               # the traced window, host clock
    busy_s: float                 # union of device intervals in it
    device_events: int            # kernels, copies and sets
    step_s: float                 # photon-step kernel time
    other_s: float                # every other device event's time
    device_ops: list              # [[name, seconds], ...] most time first
    idle_gaps: list               # [[host activity, seconds], ...]


def _union(starts: np.ndarray, ends: np.ndarray):
    """The union of intervals as sorted disjoint ``(starts, ends)``."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    out_s, out_e = [], []
    cur_s, cur_e = None, None
    for a, b in zip(s.tolist(), e.tolist()):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                out_s.append(cur_s)
                out_e.append(cur_e)
            cur_s, cur_e = a, b
        elif b > cur_e:
            cur_e = b
    if cur_e is not None:
        out_s.append(cur_s)
        out_e.append(cur_e)
    return np.asarray(out_s), np.asarray(out_e)


def _outermost(starts, ends, names):
    """The host operations that no other one contains, in order."""
    order = np.argsort(starts, kind="stable")
    keep_s, keep_e, keep_n = [], [], []
    end = -np.inf
    for i in order.tolist():
        if starts[i] >= end:
            keep_s.append(starts[i])
            keep_e.append(ends[i])
            keep_n.append(names[i])
            end = ends[i]
    return np.asarray(keep_s), np.asarray(keep_e), keep_n


def reduce(events, t0_us: float, t1_us: float) -> Trace:
    """Reduce a trace's events over the window ``[t0_us, t1_us]`` (the
    trace's clock)."""
    dev_s, dev_e, dev_n = [], [], []
    host_s, host_e, host_n = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev_s.append(a)
            dev_e.append(b)
            dev_n.append(e.get("name", cat))
        elif cat == "cpu_op":
            host_s.append(a)
            host_e.append(b)
            host_n.append(e.get("name", "cpu_op"))
    if not dev_s:
        raise RuntimeError("the trace holds no device events")
    dev_s, dev_e = np.asarray(dev_s), np.asarray(dev_e)
    dur = dev_e - dev_s
    by_name: collections.Counter = collections.Counter()
    step_s = 0.0
    for n, d in zip(dev_n, dur.tolist()):
        by_name[n] += d / 1e6
        if STEP_KERNEL in n:
            step_s += d / 1e6
    us, ue = _union(np.clip(dev_s, t0_us, t1_us), np.clip(dev_e, t0_us, t1_us))
    busy = float(np.sum(ue - us)) / 1e6
    # idle stretches of the window: before, between and after the busy ones
    gap_s = np.concatenate([[t0_us], ue])
    gap_e = np.concatenate([us, [t1_us]])
    gaps = gap_e > gap_s
    gap_s, gap_e = gap_s[gaps], gap_e[gaps]
    idle: collections.Counter = collections.Counter()
    if host_s:
        hs, he, hn = _outermost(np.asarray(host_s), np.asarray(host_e),
                                host_n)
        lo = np.searchsorted(he, gap_s, side="right")
        for a, b, i in zip(gap_s.tolist(), gap_e.tolist(), lo.tolist()):
            covered = 0.0
            while i < len(hs) and hs[i] < b:
                c = min(b, he[i]) - max(a, hs[i])
                if c > 0:
                    idle[hn[i]] += c / 1e6
                    covered += c
                i += 1
            idle[BETWEEN] += (b - a - covered) / 1e6
    else:
        idle[BETWEEN] += float(np.sum(gap_e - gap_s)) / 1e6
    return Trace(
        window_s=(t1_us - t0_us) / 1e6, busy_s=busy,
        device_events=len(dev_n), step_s=step_s,
        other_s=float(np.sum(dur)) / 1e6 - step_s,
        device_ops=[[k[:NAME_CHARS], v] for k, v in by_name.most_common(TOP)],
        idle_gaps=[[k, float(v)] for k, v in idle.most_common(TOP)])


def profiled(run_fn):
    """Run ``run_fn()`` under ``torch.profiler`` (host and CUDA
    activity); returns ``(its value, Trace)`` over the window from the
    call's start to its end, which ``run_fn`` ends with a device
    synchronisation."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("perfbench.window"):
            value = run_fn()
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    marks = [e for e in events if e.get("name") == "perfbench.window"
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the trace lost its window mark")
    t0 = float(marks[0]["ts"])
    t1 = t0 + float(marks[0]["dur"])
    return value, reduce(events, t0, t1)
