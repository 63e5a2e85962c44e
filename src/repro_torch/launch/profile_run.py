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
untraced run's idle share.  ``--trace`` also writes the
Chrome trace.  It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch

from repro_torch.core import simulator as S
from repro_torch.detectors import as_detectors
from repro_torch.kernels.photon_step import photon_step as K
from repro_torch.launch.simulate import get_bench

DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
               "gpu_memset": "memset"}


def device_events(trace_path: str) -> list[tuple[str, str, float, float]]:
    """``(group, name, start_us, end_us)`` of every device event of a
    Chrome trace written by ``torch.profiler``."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = []
    for e in events:
        cat = DEVICE_CATS.get(e.get("cat"))
        if cat is None or e.get("ph") != "X":
            continue
        name = e.get("name", "")
        if cat == "kernel":
            cat = "photon_step" if "photon_step" in name else "other_kernels"
        out.append((cat, name, float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", default="B1", choices=["B1", "B2", "B2a"])
    ap.add_argument("--photons", type=int, default=1_000_000)
    ap.add_argument("--lanes", type=int, default=262_144)
    ap.add_argument("--size", type=int, default=60)
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
                         device=dev, detectors=detectors,
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
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = run()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = device_events(path)
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
    out = {"bench": args.bench, "photons": args.photons,
           "lanes": args.lanes, "k": cfg.steps_per_round, "rounds": rounds,
           "ntg": cfg.n_time_gates, "n_det": len(detectors or ()),
           "photon_step_variants": variants,
           "untraced_wall_ms": untraced_ms, "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy / 1e3,
           "idle_frac": 1.0 - busy / wall_us, "groups": groups}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
