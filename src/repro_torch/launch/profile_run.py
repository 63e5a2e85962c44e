"""Where a run's time goes on the card, from one ``torch.profiler`` trace.

    python -m repro_torch.launch.profile_run --bench B2 --photons 1000000 \\
        --lanes 262144 --steps-per-round 16

The detection forward takes the CLI's flags for it:

    python -m repro_torch.launch.profile_run --bench B2 --photons 1000000 \\
        --time-gates 50 --tmax-ns 5.0 \\
        --detectors '[{"x": 40, "y": 30, "radius": 2}]' \\
        --save-detected 1048576 --collect-stats

Runs the simulator twice untraced (kernel build and warm-up, then a
timed run) and once under ``torch.profiler`` with CUDA activity, then
prints one JSON line with the rounds, the untraced and the traced wall
time, and for each group of device work (the photon-step kernel, every
other kernel, memory copies and sets) its launches per round and device
milliseconds, and the untraced run's photon-step launches by kernel
variant (``photon_step_variants``).  ``idle_frac`` is the share of the
traced wall time in which no device work ran, from the union of the
trace's device intervals; tracing slows the host, so it overstates the
untraced run's idle share.  ``idle_by_span`` charges each idle stretch
of the device to the innermost of the port's spans open then (their
``record_function`` ranges in the trace: ``round.host_read``,
``round.regenerate``, ``round.step``, ``round.totals``, ``run``,
``run.finish``, ``convert``, ``simulate``), in seconds;
``host_ms_per_round`` gives the spans' host milliseconds a round by name
(``telemetry.capture_tracer``), and ``clock_offset_us`` the median
distance of a round span's start on the port's clock from its start in
the trace.  ``--trace`` also writes the Chrome trace.  It needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import tempfile
import time

import torch

from repro_torch import telemetry
from repro_torch.core import simulator as S
from repro_torch.detectors import as_detectors
from repro_torch.kernels.photon_step import photon_step as K
from repro_torch.launch.simulate import BENCHES, bench_source, get_bench

DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
               "gpu_memset": "memset"}
# the traced call's own range, no span of the port
WINDOW = "profile_run.window"
# idle time no span of the port was open around
OUTSIDE = "outside port spans"
ROUND_SPANS = ("round.host_read", "round.regenerate", "round.step",
               "round.totals")


def device_events_of(trace_events) -> list[tuple[str, str, float, float]]:
    """``(group, name, start_us, end_us)`` of every device event of a
    Chrome trace written by ``torch.profiler``, given its events."""
    out = []
    for e in trace_events:
        cat = DEVICE_CATS.get(e.get("cat"))
        if cat is None or e.get("ph") != "X":
            continue
        name = e.get("name", "")
        if cat == "kernel":
            cat = "photon_step" if "photon_step" in name else "other_kernels"
        out.append((cat, name, float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out


def device_events(trace_path: str) -> list[tuple[str, str, float, float]]:
    """:func:`device_events_of` the Chrome trace at ``trace_path``."""
    with open(trace_path) as f:
        return device_events_of(json.load(f)["traceEvents"])


def _union(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, disjoint and in order."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    return sum(b - a for a, b in _union(intervals))


def span_ranges(trace_events) -> list[tuple[str, float, float]]:
    """``(name, start_us, end_us)`` of the port's spans in a Chrome trace
    written by ``torch.profiler`` (its ``user_annotation`` ranges, but
    the traced call's own), outer before inner where two start at once."""
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in trace_events
           if e.get("cat") == "user_annotation" and e.get("ph") == "X"
           and e.get("name") != WINDOW]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def idle_by_span(trace_events, t0_us: float, t1_us: float) -> dict:
    """Seconds of ``[t0_us, t1_us]`` in which the device ran nothing, by
    the innermost of the port's spans open then (``OUTSIDE`` where none
    was), most first.  The spans of one thread nest, so a sweep over
    their starts and ends cuts the window into stretches of one
    innermost span, which the idle stretches are laid over."""
    gaps, cur = [], t0_us
    for a, b in _union((a, b) for *_, a, b in device_events_of(trace_events)):
        if min(a, t1_us) > cur:
            gaps.append((cur, min(a, t1_us)))
        cur = max(cur, b)
    if cur < t1_us:
        gaps.append((cur, t1_us))
    spans = span_ranges(trace_events)
    bounds = sorted([(a, 1, i) for i, (_, a, _) in enumerate(spans)]
                    + [(b, 0, i) for i, (_, _, b) in enumerate(spans)])
    stretches, open_, cur = [], [], float("-inf")
    for t, starts, i in bounds:
        if t > cur:
            stretches.append((cur, t, spans[open_[-1]][0] if open_
                              else OUTSIDE))
            cur = t
        if starts:
            open_.append(i)
        else:
            open_.remove(i)
    stretches.append((cur, float("inf"), OUTSIDE))
    out: dict[str, float] = {}
    j = 0
    for a, b in gaps:
        while stretches[j][1] <= a:
            j += 1
        k = j
        while k < len(stretches) and stretches[k][0] < b:
            lo, hi, name = stretches[k]
            out[name] = out.get(name, 0.0) + (min(b, hi) - max(a, lo)) / 1e6
            k += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def host_ms_per_round(spans, rounds: int) -> dict:
    """Host milliseconds a round in each named span of ``spans``
    (``telemetry.SpanEvent``\\ s)."""
    out: dict[str, float] = {}
    for e in spans:
        out[e.name] = out.get(e.name, 0.0) + e.dur * 1e3 / rounds
    return out


def clock_offset_us(spans, trace_events, base_ns: int) -> float | None:
    """Median distance, in microseconds, of each round span's start on
    the port's clock (``SpanEvent.t0``) from its range's start in the
    trace (``ts`` past ``baseTimeNanoseconds``), the k-th span of a name
    paired with the k-th range of that name."""
    ours: dict[str, list[float]] = {n: [] for n in ROUND_SPANS}
    theirs: dict[str, list[float]] = {n: [] for n in ROUND_SPANS}
    for e in spans:
        if e.name in ours:
            ours[e.name].append((e.t0 - base_ns / 1e9) * 1e6)
    for name, a, _ in span_ranges(trace_events):
        if name in theirs:
            theirs[name].append(a)
    diffs = [abs(t - ts) for n in ROUND_SPANS
             for t, ts in zip(sorted(ours[n]), theirs[n])]
    return statistics.median(diffs) if diffs else None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", default="B1", choices=BENCHES)
    ap.add_argument("--photons", type=int, default=1_000_000)
    ap.add_argument("--lanes", type=int, default=262_144)
    ap.add_argument("--size", type=int, default=None,
                    help="voxels a side of B1/B2 (default 60)")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--steps-per-round", type=int, default=16)
    ap.add_argument("--time-gates", type=int, default=1)
    ap.add_argument("--tmax-ns", type=float, default=None)
    ap.add_argument("--detectors", default=None,
                    help="JSON detector disks, as the CLI takes them")
    ap.add_argument("--save-detected", type=int, default=0, metavar="CAP")
    ap.add_argument("--collect-stats", action="store_true")
    ap.add_argument("--trace", default=None,
                    help="also write the Chrome trace to this path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_run needs a CUDA device")

    dev = torch.device("cuda")
    vol, cfg = get_bench(args.bench, args.size, dev)
    cfg = dataclasses.replace(cfg, steps_per_round=args.steps_per_round,
                              n_time_gates=args.time_gates,
                              collect_stats=args.collect_stats)
    if args.tmax_ns is not None:
        cfg = dataclasses.replace(cfg, tmax_ns=args.tmax_ns)
    detectors = (as_detectors(json.loads(args.detectors))
                 if args.detectors else None)

    def run():
        res = S.simulate(vol, cfg, args.photons, args.lanes, args.seed,
                         source=bench_source(args.bench), device=dev,
                         detectors=detectors,
                         record_detected=args.save_detected)
        torch.cuda.synchronize(dev)
        return res

    run()
    K.reset_launches()
    t0 = time.perf_counter()
    run()
    untraced_ms = (time.perf_counter() - t0) * 1e3
    variants = dict(K.photon_step_cuda.launches_by)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    spans = telemetry.capture_tracer().events
    spans.clear()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            res = run()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    trace_events = trace["traceEvents"]
    events = device_events_of(trace_events)
    if not events:
        raise RuntimeError("the trace holds no device events; time the "
                           "phases with CUDA events instead")

    rounds = res.steps // cfg.steps_per_round
    groups = {}
    for cat, _, a, b in events:
        g = groups.setdefault(cat, {"launches": 0, "device_ms": 0.0})
        g["launches"] += 1
        g["device_ms"] += (b - a) / 1e3
    for g in groups.values():
        g["per_round"] = g["launches"] / rounds
    busy = busy_us([(a, b) for _, _, a, b in events])
    mark = next(e for e in trace_events if e.get("name") == WINDOW
                and e.get("cat") == "user_annotation")
    out = {"bench": args.bench, "photons": args.photons,
           "lanes": args.lanes, "k": cfg.steps_per_round, "rounds": rounds,
           "ntg": cfg.n_time_gates, "n_det": len(detectors or ()),
           "photon_step_variants": variants,
           "untraced_wall_ms": untraced_ms, "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy / 1e3,
           "idle_frac": 1.0 - busy / wall_us, "groups": groups,
           "idle_by_span": idle_by_span(
               trace_events, float(mark["ts"]),
               float(mark["ts"]) + float(mark["dur"])),
           "host_ms_per_round": host_ms_per_round(spans, rounds),
           "clock_offset_us": clock_offset_us(
               spans, trace_events, int(trace["baseTimeNanoseconds"]))}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
