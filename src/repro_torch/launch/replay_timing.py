"""Where the replay's time goes on the card, pass by pass and launch by launch.

    python -m repro_torch.launch.replay_timing [--reps 3] \\
        [--steps-per-launch 16,1024,4095] [--ablate jac_atomics]

Runs the detection forward of ``chip_smoke.py`` (B2 at 60^3, 10^7
photons, 262144 lanes, K = 16, 50 gates over 5 ns, three 2 mm detectors,
2^20 record slots) and replays its records as the CLI's
``--replay-gate-resolved`` does, in one batch.  Prints JSON lines:

- ``replay``: the wall of ``replay.replay_jacobian`` (host clock, ended by
  a device synchronisation) over ``--reps`` runs, records per ms and the
  kernel launches by variant; once for each ``--steps-per-launch`` where
  the replay's builder (``replay._build_replay_fn``) takes that argument;
- ``breakdown``: one default replay traced (``telemetry.Tracer``): the
  seconds of its ``replay_batch`` spans (the two passes of a batch, to a
  device synchronisation) and of the rest of the wall (set-up, checks,
  the Jacobian's conversion and copy to the host);
- ``pass``: for each replay pass, its launches, the device ms a launch
  and all of the pass's device ms, the ms a launch as the host issues
  the pass's launches (``kernel_timing.device_ms`` and ``host_loop_ms``
  over the pass's launches), the pass's live lane-segments and the
  segments of its longest lane (from the stats group on the same
  launches);
- ``ablation``: for each ``--ablate`` name, the pass's launches through a
  library built from the kernel source with the named statements
  replaced (``ABLATIONS``), against the unchanged source through the
  same host path, in turns (unchanged, ablated, ablated, unchanged).

Uses only entry points that earlier checkouts of the port have too, so
one file times both: to compare two checkouts on one card, run it by
its path under each one's ``PYTHONPATH`` in turns.  It needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses
import functools
import inspect
import json
import re
import subprocess
import time

import numpy as np
import torch

from repro_torch import replay as R
from repro_torch.core import simulator as S
from repro_torch.kernels.photon_step import ops
from repro_torch.kernels.photon_step import photon_step as K
from repro_torch.launch.kernel_timing import device_ms, host_loop_ms
from repro_torch.launch.simulate import get_bench

SIZE, LANES, K_STEPS, PHOTONS, SEED = 60, 262_144, 16, 10_000_000, 1234
NTG, TMAX = 50, 5.0
DETECTORS = [{"x": 40, "y": 30, "radius": 2}, {"x": 45, "y": 30, "radius": 2},
             {"x": 50, "y": 30, "radius": 2}]
SAVE_DETECTED = 1 << 20

# Statements of csrc/photon_step.cu that an ablation replaces, by name:
# (pattern, replacement) pairs, each pattern matching exactly once.
ABLATIONS = {
    # the Jacobian's deposit into device memory (float32 atomics before
    # the fixed-point Jacobian, int64 ones after)
    "jac_atomics": ((r"atomicAdd\(jac \+[^;]*;", ";"),),
    # fluence and exitance deposits into the block's cache
    "base_deposits": ((r"cache_add\(s_key, s_val, cell,[^;]*;", ";"),
                      (r"cache_add\(s_key, s_val, n_flu \+ bin,[^;]*;", ";")),
}


def ablated_library(name: str, groups: int) -> ctypes.CDLL:
    """The kernel of one group mask built from its source with the
    statements of ``ABLATIONS[name]`` replaced."""
    src = K._SRC.read_text()
    for pattern, replacement in ABLATIONS[name]:
        src, n = re.subn(pattern, lambda _: replacement, src)
        if n != 1:
            raise RuntimeError(f"ablation {name}: {pattern!r} matched {n} "
                               f"times, not once")
    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = K.BUILD_DIR / f"ablate_{name}_g{groups}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    out = subprocess.run([K._nvcc(), *K._flags(groups), "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for ablation {name}:\n{out.stdout}"
                           f"{out.stderr}")
    lib = ctypes.CDLL(str(so))
    # the entry point takes a records array since RoundRecords came
    lib.photon_step_launch.argtypes = [ctypes.c_void_p] * (
        7 if hasattr(K, "RoundRecords") else 6)
    lib.photon_step_launch.restype = ctypes.c_int
    return lib


def launch_with(lib, args, kw) -> None:
    """One launch of ``lib``'s entry point on the wrapper's arguments,
    with no round tail and no records (null pointers)."""
    _, ins, outs, ints, floats = K.prepare(*args, **kw)
    arrays = K.pack(ins, outs, ints, floats)
    nulls = [None] * (len(lib.photon_step_launch.argtypes) - 5)
    err = lib.photon_step_launch(*[a.buffer_info()[0] for a in arrays],
                                 *nulls,
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed ({err})")


def _fresh(kw):
    """A launch's keywords with any run totals replaced by zeroed
    scratch copies, so that timing it again changes nothing kept."""
    if kw.get("totals") is None:
        return kw
    return dict(kw, totals=[torch.zeros_like(t) for t in kw["totals"]])


def detect_records(dev):
    vol, cfg = get_bench("B2", SIZE, dev)
    cfg = dataclasses.replace(cfg, steps_per_round=K_STEPS,
                              n_time_gates=NTG, tmax_ns=TMAX)
    res = S.simulate(vol, cfg, PHOTONS, LANES, SEED, device=dev,
                     detectors=DETECTORS, record_detected=SAVE_DETECTED)
    return vol, cfg, R.detected_records(res)


def replay(vol, cfg, rec, extra, steps_per_launch=None):
    """One replay of ``rec`` and its wall; ``steps_per_launch`` goes to
    the replay's builder."""
    build = R._build_replay_fn
    if steps_per_launch is not None:
        R._build_replay_fn = functools.partial(
            build, steps_per_launch=steps_per_launch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        rep = R.replay_jacobian(vol, cfg, rec, DETECTORS, seed=SEED,
                                n_lanes=LANES, gate_resolved=True, **extra)
        torch.cuda.synchronize()
    finally:
        R._build_replay_fn = build
    wall = time.perf_counter() - t0
    if not (rep.replayed_det == rep.det).all():
        raise AssertionError("a record did not replay at its detector")
    return rep, wall


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--steps-per-launch", default="",
                    help="comma-separated launch lengths to replay with, "
                         "where the replay's builder takes steps_per_launch")
    ap.add_argument("--ablate", nargs="*", default=[],
                    choices=sorted(ABLATIONS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("replay_timing needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    vol, cfg, rec = detect_records(dev)
    takes = "steps_per_launch" in inspect.signature(
        R._build_replay_fn).parameters
    lengths = [None] + ([int(x) for x in args.steps_per_launch.split(",")
                         if x] if takes else [])
    results = []

    def emit(kind, **fields):
        out = {"kind": kind, **fields, "card": card}
        print(json.dumps(out), flush=True)
        results.append(out)

    replay(vol, cfg, rec, {})  # warm-up: builds and loads the libraries
    walls_by_run = {}
    for n in lengths:
        walls, by = [], None
        for _ in range(args.reps):
            K.reset_launches()
            _, wall = replay(vol, cfg, rec, {}, n)
            walls.append(wall)
            by = dict(K.photon_step_cuda.launches_by)
        walls_by_run[n] = (walls, by)
        emit("replay", records=int(rec.shape[0]),
             **({} if n is None else {"steps_per_launch": n}), walls_s=walls,
             records_per_ms=[rec.shape[0] / w / 1e3 for w in walls],
             launches_by_variant=by)

    from repro_torch.telemetry import Tracer
    tracer = Tracer()
    _, wall = replay(vol, cfg, rec, {"tracer": tracer})
    spans = [e.dur for e in tracer.events if e.name == "replay_batch"]
    emit("breakdown", wall_s=wall, batch_spans_s=spans,
         outside_batches_s=wall - sum(spans))

    # every launch of one default replay, its inputs kept by variant
    kept = collections.defaultdict(list)
    cuda_step = ops.photon_step_cuda

    def keep(*a, **kw):
        groups = K.group_mask(int(kw.get("det_geom") is not None),
                              bool(kw.get("record")),
                              int(kw.get("jac_cols") or 0),
                              bool(kw.get("stats")))
        kept[groups].append((a, _fresh(kw)))
        return cuda_step(*a, **kw)

    ops.photon_step_cuda = keep
    try:
        replay(vol, cfg, rec, {})
    finally:
        ops.photon_step_cuda = cuda_step
    # the default replay's wall (not this instrumented one) a launch
    walls, by = walls_by_run[None]
    n_launches = sum(by.values())
    wall_ms_per_launch = (float(np.median(walls)) * 1e3 / n_launches
                          if n_launches else None)
    for groups, launches in sorted(kept.items()):
        def run_pass(launches=launches):
            for a, kw in launches:
                cuda_step(*a, **kw)
        dev_ms = device_ms(run_pass, 1)
        host_ms = host_loop_ms(run_pass, 1)
        # live lane-segments of each lane, summed over the pass
        live = None
        for a, kw in launches:
            st = cuda_step(*a, **dict(kw, stats=True, totals=None))[-1][:, 0]
            live = st.double() if live is None else live + st.double()  # reprolint: disable=REP301 - host-side timing statistics
        emit("pass", groups=groups, variant=K.group_names(groups),
             launches=len(launches), lanes=int(launches[0][0][2].w.numel()),
             n_steps=[int(a[6]) for a, _ in launches][:4],
             device_ms_per_launch=dev_ms / len(launches),
             device_ms_pass=dev_ms,
             host_loop_ms_per_launch=host_ms / len(launches),
             replay_wall_ms_per_launch=wall_ms_per_launch,
             live_segments=float(live.sum()),
             longest_lane_segments=float(live.max()),
             lanes_over_1024_segments=int((live > 1024).sum()))
        for name in args.ablate:
            if name == "jac_atomics" and not groups & K.GROUP_BITS[
                    "jac_cols"]:
                continue
            lib = ablated_library(name, groups)
            base = K._library(groups)
            turns = {}
            for which, use in (("unchanged", base), ("ablated", lib),
                               ("ablated", lib), ("unchanged", base)):
                ms = device_ms(lambda use=use: [launch_with(use, a, kw)
                                                for a, kw in launches], 1)
                turns.setdefault(which, []).append(ms / len(launches))
            emit("ablation", ablation=name, groups=groups,
                 variant=K.group_names(groups), launches=len(launches),
                 device_ms_per_launch=turns,
                 ratio=float(np.mean(turns["ablated"])
                             / np.mean(turns["unchanged"])))
    return results


if __name__ == "__main__":
    main()
