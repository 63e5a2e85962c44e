"""Photon-simulation launcher (the paper's workload) on the PyTorch port.

  PYTHONPATH=src python -m repro_torch.launch.simulate --bench B1 \
      --photons 100000 --lanes 4096 [--device cpu]

Time-gated detectors, detected-photon records and their replay into
absorption Jacobians, with round counters:

  PYTHONPATH=src python -m repro_torch.launch.simulate --bench B2 \
      --photons 10000000 --lanes 262144 --steps-per-round 16 \
      --time-gates 50 --tmax-ns 5.0 \
      --detectors '[{"x": 40, "y": 30, "radius": 2}]' \
      --save-detected 1048576 --replay --replay-gate-resolved \
      --collect-stats

Runs on the CUDA device by default, where each fused round (forward,
and both replay passes) is one launch of the CUDA photon-step kernel;
``--device cpu`` runs the plain PyTorch version instead.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import analysis as A
from repro_torch.core import simulator as S
from repro_torch.core import volume as V
from repro_torch.detectors import as_detectors
from repro_torch.kernels.photon_step.ops import resolve_device
from repro_torch.replay import (ReplayResult, detected_records,
                                replay_jacobian)


def get_bench(name: str, size: int, device="cpu"):
    shape = (size, size, size)
    if name == "B1":
        return V.benchmark_b1(shape, device), V.b1_config()
    if name in ("B2", "B2a"):
        return V.benchmark_b2(shape, device), V.b2_config()
    raise ValueError(name)


class Run(NamedTuple):
    """What one CLI run computed, with its host-clock seconds (each
    ended by a device synchronisation)."""

    result: S.SimResult
    replay: ReplayResult | None
    seconds: float
    replay_seconds: float | None


def run(argv=None) -> Run:
    """Parse the CLI arguments, run, print the report; returns the
    forward result and, with ``--replay``, the replay result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", default="B1", choices=["B1", "B2", "B2a"])
    ap.add_argument("--photons", type=int, default=100_000)
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--size", type=int, default=60)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--steps-per-round", type=int, default=1,
                    help="K: fused transport segments per regeneration/"
                         "flush round")
    ap.add_argument("--time-gates", type=int, default=1,
                    help="bin deposited energy over this many time-of-"
                         "flight gates spanning [0, tmax_ns]; 1 = CW "
                         "(default)")
    ap.add_argument("--detectors", default=None,
                    help="JSON detector disks on the z=0 face (voxel "
                         "units), e.g. '[{\"x\": 40, \"y\": 30, "
                         "\"radius\": 2}]'; records per-detector TPSF "
                         "and mean partial pathlengths")
    ap.add_argument("--save-detected", type=int, default=0, metavar="CAP",
                    help="record detected-photon ids (global photon id, "
                         "detector, exit gate) for replay, up to CAP "
                         "records; requires --detectors")
    ap.add_argument("--replay", action="store_true",
                    help="after the forward run, replay the recorded "
                         "detected photons into per-detector absorption "
                         "Jacobian volumes (requires --save-detected)")
    ap.add_argument("--replay-gate-resolved", action="store_true",
                    help="widen the replay scatter to a time-gate-"
                         "resolved (nvox, n_det, n_time_gates) Jacobian "
                         "keyed by each record's exit gate (requires "
                         "--replay)")
    ap.add_argument("--tmax-ns", type=float, default=None,
                    help="time-of-flight cutoff in ns (default: the "
                         "benchmark config's 5.0); weight still in "
                         "flight at the cutoff is retired as timed-out")
    ap.add_argument("--collect-stats", action="store_true",
                    help="accumulate round counters (lane occupancy, "
                         "relaunches, retired weight) onto "
                         "SimResult.stats; physics outputs stay "
                         "bit-identical")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the CUDA kernel (default); cpu: the plain "
                         "PyTorch version")
    args = ap.parse_args(argv)
    if args.save_detected and not args.detectors:
        ap.error("--save-detected requires --detectors")
    if args.replay and not args.save_detected:
        ap.error("--replay requires --save-detected")
    if args.replay_gate_resolved and not args.replay:
        ap.error("--replay-gate-resolved requires --replay")

    dev = resolve_device(args.device)
    detectors = as_detectors(
        json.loads(args.detectors)) if args.detectors else None
    vol, cfg = get_bench(args.bench, args.size, dev)
    cfg = dataclasses.replace(cfg, steps_per_round=args.steps_per_round,
                              n_time_gates=args.time_gates,
                              collect_stats=args.collect_stats)
    if args.tmax_ns is not None:
        cfg = dataclasses.replace(cfg, tmax_ns=args.tmax_ns)

    t0 = time.perf_counter()
    res = S.simulate(vol, cfg, args.photons, args.lanes, args.seed,
                     device=dev, detectors=detectors,
                     record_detected=args.save_detected)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = fwd_seconds = time.perf_counter() - t0

    bal = A.energy_balance(res)
    print(f"{args.bench}: {args.photons} photons in {dt:.2f}s "
          f"({args.photons/dt/1e3:.2f} photons/ms)")
    print(f"energy balance: absorbed={bal['absorbed']:.1f} "
          f"escaped={bal['escaped']:.1f} timed_out={bal['timed_out']:.2e} "
          f"residue={bal['residue_frac']:.2e}")
    timed_frac = bal["timed_out"] / max(bal["launched"], 1e-30)
    if timed_frac > 0.01:
        print(f"WARNING: {timed_frac:.1%} of launched weight "
              f"({bal['timed_out']:.3f}) was retired by the "
              f"tmax_ns={cfg.tmax_ns} time gate / max_steps cap; fluence "
              f"and detector readings are truncated; raise --tmax-ns if "
              f"unintended")
    if res.stats is not None:
        sd = res.stats.to_dict()
        print(f"round stats: {sd['rounds']} rounds "
              f"({sd['regen_rounds']} regenerating, "
              f"{sd['relaunched']} relaunches), lane occupancy "
              f"{sd['lane_occupancy']:.1%} "
              f"({sd['live_segments']:.3g}/{sd['lane_segments']:.3g} "
              f"lane-segments live)")
    phi = A.fluence_cw(res, vol)
    print(f"fluence: max={float(phi.max()):.3e} "
          f"nonzero voxels={int((phi > 0).sum())}")
    if cfg.n_time_gates > 1:
        per_gate = A.fluence_td(res, vol).sum(axis=(0, 1, 2))
        print(f"time gates: {cfg.n_time_gates} x {cfg.gate_width_ns:.3f} ns, "
              f"peak gate {int(per_gate.argmax())}")
    if detectors:
        times, curves = A.tpsf(res, cfg)
        tot = res.det_w.double().sum(dim=1).cpu().numpy()
        for i, d in enumerate(detectors):
            peak = float(times[int(curves[i].argmax())]) if tot[i] else 0.0
            print(f"detector {i} ({d.x:.0f},{d.y:.0f},r={d.radius:.0f}): "
                  f"weight={tot[i]:.3f} tpsf-peak@{peak:.3f} ns")
        print("mean partial pathlengths (mm/medium):")
        print(np.array_str(A.detector_mean_ppath(res), precision=2))
    if args.save_detected:
        recs = detected_records(res)
        overflow = int(res.det_rec_overflow)
        print(f"detected-photon records: {recs.shape[0]} "
              f"(overflow: {overflow})")
        if overflow > 0:
            print(f"WARNING: {overflow} detector captures were dropped "
                  f"from the id buffer (capacity {args.save_detected}); "
                  f"det_w still counts them, but replay will miss them; "
                  f"raise --save-detected")
        if args.replay and recs.shape[0]:
            t0 = time.perf_counter()
            rep = replay_jacobian(vol, cfg, recs, detectors, seed=args.seed,
                                  n_lanes=args.lanes,
                                  gate_resolved=args.replay_gate_resolved,
                                  device=dev)
            dt = time.perf_counter() - t0
            ok = int((rep.replayed_det == rep.det).sum())
            print(f"replay[{dev.type}]: {rep.n_records} photons "
                  f"in {dt:.2f}s ({rep.n_records/dt/1e3:.2f} photons/ms), "
                  f"{ok}/{rep.n_records} detector-exact")
            jac = rep.jacobian
            med = A.jacobian_medium_sums(jac, vol)
            gated = jac if jac.ndim == 4 else jac.sum(axis=-1)
            for i in range(len(detectors)):
                nz = int(np.sum(gated[..., i] > 0))
                print(f"  J[det {i}]: sum={gated[..., i].sum():.3e} "
                      f"(weight*mm), nonzero voxels={nz}, per-medium "
                      f"{np.array_str(med[i], precision=3)}")
            if jac.ndim == 5:
                per_gate = jac.sum(axis=(0, 1, 2, 3))
                print(f"  gate-resolved: {jac.shape[-1]} gates, "
                      f"peak gate {int(per_gate.argmax())}")
            return Run(res, rep, fwd_seconds, dt)
    return Run(res, None, fwd_seconds, None)


def main(argv=None) -> S.SimResult:
    """Run the CLI; returns the forward ``SimResult``."""
    return run(argv).result


if __name__ == "__main__":
    main()
