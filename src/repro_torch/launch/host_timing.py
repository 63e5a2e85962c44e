"""Time the host (CPU) photon-step kernel on this machine's CPU.

    PYTHONPATH=src python -m repro_torch.launch.host_timing \\
        [--size 60] [--lanes 2048,8192,32768] [--photons 65536] \\
        [--threads 1,N]

Needs no card.  Prints JSON lines:

  env     torch, the CPU (``lscpu``'s model name, the cores this process
          may use), torch's CPU capability, the kernel's math library
          (MKL's VML or at::vec) and the library's build seconds
  launch  one K = 16 launch from a mid-run state (12 rounds of
          regeneration and a launch, as the simulator runs them, and
          regenerated once more) for B1 and B2 base and the detection
          forward (B2, det+record+stats, 50 gates over 5 ns, three
          detectors), at each lane count: ms per launch of the host
          kernel at each thread count and of the plain version (torch's
          threads), each adding into run totals as the simulator
          launches them, the live lane-segments (counted by the stats
          group),
          ns per lane-segment and thread, and whether every output of
          both thread counts is bit-equal to the plain version
  sim     ``simulator.simulate`` of B1 at ``--size``^3 on the CPU at each
          lane and thread count: seconds, photons/ms, and the share of
          the wall inside host-kernel launches (the rest is the round's
          own PyTorch operations on CPU tensors)

``N`` in ``--threads`` is the cores this process may use.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import torch

from repro_torch.core import simulator as S
from repro_torch.detectors import as_detectors, det_geometry
from repro_torch.kernels.photon_step import ops
from repro_torch.kernels.photon_step import photon_step_cpu as H
from repro_torch.kernels.photon_step.ref import photon_steps_ref
from repro_torch.launch.kernel_timing import _relaunch
from repro_torch.launch.simulate import get_bench
from repro_torch.sources import Pencil

K_STEPS, SEED = 16, 1234
# launches timed a case, the least kept
REPS = 3
# the detection path of chip_smoke.py: 50 gates over 5 ns, 2 mm disks
# 10, 15 and 20 mm from the pencil at (30, 30)
DETECTORS = [{"x": 40, "y": 30, "radius": 2}, {"x": 45, "y": 30, "radius": 2},
             {"x": 50, "y": 30, "radius": 2}]
NTG_DETECT, TMAX_DETECT = 50, 5.0


def cpu_name() -> dict:
    """The CPU as ``lscpu`` names it, and the cores this process may
    use."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        out = ""
    model = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                  if ln.startswith("Model name")), "unknown")
    return {"model": model, "cores": len(os.sched_getaffinity(0)),
            "cpu_count": os.cpu_count()}


def cores() -> int:
    return len(os.sched_getaffinity(0))


def case(bench: str, size: int, detect: bool = False):
    """``(volume, cfg)`` of a launch case on the CPU; ``detect`` sets the
    detection path's gates."""
    vol, cfg = get_bench(bench, size, torch.device("cpu"))
    cfg = dataclasses.replace(cfg, steps_per_round=K_STEPS)
    if detect:
        cfg = dataclasses.replace(cfg, n_time_gates=NTG_DETECT,
                                  tmax_ns=TMAX_DETECT)
    return vol, cfg


def group_kwargs(vol, lanes: int, detect: bool, ppath=None) -> dict:
    """The detection forward's keywords (det+record+stats), or none."""
    if not detect:
        return {}
    return dict(ppath=ppath if ppath is not None else torch.zeros(
        (lanes, vol.media.shape[-2])),
        det_geom=det_geometry(as_detectors(DETECTORS)), record=True,
        stats=True)


def mid_flight(vol, cfg, lanes: int, detect: bool, seed: int = 99,
               rounds: int = 12):
    """The lanes after ``rounds`` rounds of regeneration and a K-segment
    launch of the host kernel, as the simulator runs them, and
    regenerated once more (``kernel_timing``'s mid-run state, on the
    CPU): ``(state, ppath)``."""
    st = ops.fresh_state(vol, lanes, seed=seed)._replace(
        alive=torch.zeros(lanes, dtype=torch.bool))
    kw = group_kwargs(vol, lanes, detect)
    pp = kw.get("ppath")
    remaining, next_lo = torch.tensor(1 << 30), torch.tensor(0)
    for i in range(rounds + 1):
        st, remaining, next_lo, pp = _relaunch(st, remaining, next_lo,
                                               Pencil(), seed, vol.shape, pp)
        if i == rounds:
            return st, pp
        if detect:
            kw["ppath"] = pp
        outs = H.photon_step_host(vol.labels.reshape(-1), vol.media, st,
                                  vol.shape, vol.unitinmm, cfg, K_STEPS, **kw)
        st, pp = outs[0], (outs[5] if detect else None)


def bit_equal(a, b) -> bool:
    """Every output of two photon-step calls bit-equal."""
    return len(a) == len(b) and all(
        torch.equal(x, y) for x, y in zip((*a[0], *a[1:]), (*b[0], *b[1:])))


def seconds(fn, reps: int) -> float:
    """Least wall seconds of ``fn`` over ``reps`` calls."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def grids(outs, kw) -> list:
    """The int64 grids of a call's outputs, in the order ``totals``
    takes them: fluence, exitance, [det_w, det_ppath], [jac]."""
    at = [1, 2] + ([6, 7] if "det_geom" in kw else [])
    if kw.get("jac_cols"):
        at.append(len(outs) - 1 - bool(kw.get("stats")))
    return [outs[i] for i in at]


def time_launch(args, kw, threads, reps: int) -> dict:
    """The host kernel at each thread count against the plain version on
    the same inputs, each adding into zeroed run totals as the simulator
    and the replay launch it: bit-equality, ms per launch, live
    lane-segments."""
    saved = torch.get_num_threads()
    shapes = grids(H.photon_step_host(*args, **kw), kw)

    def zeros():
        return [torch.zeros_like(g) for g in shapes]

    want = photon_steps_ref(*args, **kw, totals=zeros())
    into = zeros()
    plain_ms = seconds(lambda: photon_steps_ref(*args, **kw, totals=into),
                       reps) * 1e3
    out = {"plain_ms": plain_ms, "plain_threads": saved, "ms": {},
           "bit_equal": {}}
    try:
        for t in threads:
            torch.set_num_threads(t)
            got = H.photon_step_host(*args, **kw, totals=zeros())
            out["bit_equal"][t] = bit_equal(got, want)
            out["ms"][t] = seconds(lambda: H.photon_step_host(
                *args, **kw, totals=into), reps) * 1e3
    finally:
        torch.set_num_threads(saved)
    stats = H.photon_step_host(*args, **{**kw, "stats": True})[-1]
    live = int(stats[:, 0].sum())
    out["live_segments"] = live
    out["ns_per_segment_thread"] = {
        t: ms * 1e6 * t / max(live, 1) for t, ms in out["ms"].items()}
    out["got"], out["want"] = got, want
    return out


def sim_rate(vol, cfg, photons: int, lanes: int, threads: int) -> dict:
    """``simulate`` on the CPU at ``threads``: seconds, photons/ms and
    the share of the wall inside host-kernel launches."""
    inside = [0.0]
    step = S.photon_steps

    def timed_step(*a, **k):
        t0 = time.perf_counter()
        try:
            return step(*a, **k)
        finally:
            inside[0] += time.perf_counter() - t0

    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    S.photon_steps = timed_step
    try:
        t0 = time.perf_counter()
        res = S.simulate(vol, cfg, photons, lanes, SEED, device="cpu")
        wall = time.perf_counter() - t0
    finally:
        S.photon_steps = step
        torch.set_num_threads(saved)
    return {"photons": photons, "lanes": lanes, "threads": threads,
            "seconds": wall, "photons_per_ms": photons / wall / 1e3,
            "kernel_share": inside[0] / wall, "rounds": int(res.steps)
            // cfg.steps_per_round, "n_launched": int(res.n_launched)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=60)
    ap.add_argument("--lanes", default="2048,8192,32768")
    ap.add_argument("--photons", type=int, default=65536)
    ap.add_argument("--threads", default="1,N")
    args = ap.parse_args(argv)
    lanes = [int(x) for x in args.lanes.split(",")]
    threads = [cores() if x == "N" else int(x)
               for x in args.threads.split(",")]

    build_s = H.load()
    print(json.dumps({"phase": "env", "torch": torch.__version__,
                      "cpu": cpu_name(),
                      "capability": torch.backends.cpu.get_cpu_capability(),
                      "math": H.math_library(), "build_s": build_s,
                      "torch_threads": torch.get_num_threads()}), flush=True)
    for name, bench, detect in (("B1 base", "B1", False),
                                ("B2 base", "B2", False),
                                ("detection forward", "B2", True)):
        vol, cfg = case(bench, args.size, detect)
        for n in lanes:
            st, pp = mid_flight(vol, cfg, n, detect)
            call = (vol.labels.reshape(-1), vol.media, st, vol.shape,
                    vol.unitinmm, cfg, K_STEPS)
            got = time_launch(call, group_kwargs(vol, n, detect, pp),
                              threads, REPS)
            del got["got"], got["want"]
            print(json.dumps({"phase": "launch", "case": name, "lanes": n,
                              "k": K_STEPS, **got}), flush=True)
    vol, cfg = case("B1", args.size)
    for n in lanes:
        for t in threads:
            print(json.dumps({"phase": "sim", "bench": "B1",
                              "size": args.size,
                              **sim_rate(vol, cfg, args.photons, n, t)}),
                  flush=True)


if __name__ == "__main__":
    main()
