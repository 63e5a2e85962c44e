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

Any registered source (``--source``), a lane-count pilot sweep
(``--autotune``), and a fleet of scenarios batched into one round loop
(``--scenarios``, one kernel launch a round for each group of
scenarios of one shape), with the span timeline and metrics written
out:

  PYTHONPATH=src python -m repro_torch.launch.simulate --scenarios \
      '[{"bench": "B2", "size": 60, "photons": 1000000, "source":
         {"type": "disk", "pos": [20, 30, 0], "radius": 3}}, ...]' \
      --lanes 32768 --trace-out trace.json --metrics-out metrics.jsonl

Several devices: ``--devices all`` shards the photons (and the replay's
records, and the scenario axis) over every device of ``--device``'s
type, each in a process of its own (``core.procs``), when more than
one is found;
``--chunk N`` pulls chunks of N photons from a shared queue through the
resilience pool, with a seeded chaos drill, retry caps, deadlines and
checkpoints (a rerun with the same ``--checkpoint-dir`` resumes):

  PYTHONPATH=src python -m repro_torch.launch.simulate --bench B1 \
      --photons 4000 --size 20 --lanes 256 --device cpu --chunk 500 \
      --chaos '{"seed": 1, "p_fail": 0.2, "p_nan": 0.1}' \
      --checkpoint-every 2 --checkpoint-dir /tmp/ckpt

Sharded and chunked runs add int64 fixed-point totals, so they give the
bits of one run on one device of the same type.

Runs on the CUDA device by default, where each fused round (forward,
and both replay passes) is one launch of the CUDA photon-step kernel;
``--device cpu`` runs each round as one launch of the host kernel
instead (C++ built with ``g++`` at first use, on torch's intra-op
threads).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import scenarios as SC
from repro_torch import telemetry as T
from repro_torch.core import analysis as A
from repro_torch.core import multidevice as M
from repro_torch.core import simulator as S
from repro_torch.core import volume as V
from repro_torch.detectors import as_detectors
from repro_torch.kernels.photon_step.ops import resolve_device, visible_devices
from repro_torch.replay import (ReplayResult, detected_records,
                                replay_jacobian)
from repro_torch.telemetry.trace import phase


BENCHES = ("B1", "B2", "B2a", "skinvessel")
# MCX's skin-vessel volume is offered at its published size only
SKINVESSEL_SIZE = 200


def get_bench(name: str, size: int | None = None, device="cpu"):
    """``(volume, config)`` of a benchmark; ``size`` (voxels a side)
    scales B1 and B2 (default 60), and must be 200 or ``None`` for the
    skin-vessel volume, whose shapes are MCX's own."""
    if name == "skinvessel":
        if size not in (None, SKINVESSEL_SIZE):
            raise ValueError(f"skinvessel is MCX's {SKINVESSEL_SIZE}^3 "
                             f"grid only; got --size {size}")
        return V.benchmark_skinvessel(device), V.skinvessel_config()
    shape = (size or 60,) * 3
    if name == "B1":
        return V.benchmark_b1(shape, device), V.b1_config()
    if name in ("B2", "B2a"):
        return V.benchmark_b2(shape, device), V.b2_config()
    raise ValueError(name)


def bench_source(name: str):
    """A benchmark's own source: the skin-vessel disk beam, else None
    (the paper's pencil beam)."""
    return dict(V.SKINVESSEL_SOURCE) if name == "skinvessel" else None


def build_bench(name: str, size: int | None, device, n_time_gates: int,
                tracer=None):
    """:func:`get_bench` inside a ``volume.shapes`` span (recorded in
    ``tracer`` and, while a ``torch.profiler`` capture runs, in the
    capture's tracer; never synchronising), then the counters
    ``volume.voxels``, ``volume.media`` and ``volume.grid_bytes`` (the
    int64 fluence and exitance grids a run of ``n_time_gates`` gates
    holds) in ``tracer``."""
    cap = T.capture()
    with phase(tracer or cap, "volume.shapes", device,
               also=cap if tracer is not None else None, bench=name):
        vol, cfg = get_bench(name, size, device)
    if tracer is not None:
        nx, ny, nz = vol.shape
        nvox = nx * ny * nz
        tracer.counter("volume.voxels", nvox, bench=name)
        tracer.counter("volume.media", int(vol.media.shape[0]), bench=name)
        tracer.counter("volume.grid_bytes", 8 * (nvox * n_time_gates
                                                 + nx * ny), bench=name)
    return vol, cfg


class Run(NamedTuple):
    """What one CLI run computed, with its host-clock seconds (each
    ended by a device synchronisation); with ``--scenarios``, the
    scenarios' results in ``scenarios`` and no ``result``.  ``totals``
    is the forward run's int64 fixed-point result, which ``result``
    converts."""

    result: S.SimResult | None
    replay: ReplayResult | None
    seconds: float
    replay_seconds: float | None
    scenarios: list | None = None
    totals: S.FixedResult | None = None


def _synchronize(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _close(tracer, sinks, trace_out) -> None:
    if tracer is None:
        return
    if trace_out:
        path = tracer.save_chrome_trace(trace_out)
        print(f"trace timeline: {path} "
              f"({len(tracer.events)} spans; open in chrome://tracing)")
    for sink in sinks:
        sink.close()


def _mesh(args, dev):
    """``--devices all``: every device of ``dev``'s type, or None where
    that is one device (the one-device path)."""
    if args.devices != "all":
        return None
    devices = visible_devices(dev.type)
    return devices if len(devices) > 1 else None


def _run_chunked(args, vol, cfg, lanes, source, detectors, tracer):
    """--chunk: the resilience pool over every device of ``--device``'s
    type; returns the merged int64 totals."""
    from repro_torch.resilience import FaultInjector, RetryPolicy

    injector = (FaultInjector(**json.loads(args.chaos))
                if args.chaos else None)
    policy = (RetryPolicy(max_attempts=args.max_retries)
              if args.max_retries is not None else None)
    checkpointer = None
    resume = False
    if args.checkpoint_every:
        from repro_torch.checkpoint import Checkpointer

        checkpointer = Checkpointer(args.checkpoint_dir)
        resume = checkpointer.latest_step() is not None
        if resume:
            print(f"resuming from checkpoint step "
                  f"{checkpointer.latest_step()} in {args.checkpoint_dir}")
    sched = M.ChunkScheduler(vol, cfg, n_lanes=lanes,
                             devices=visible_devices(args.device),
                             source=source, detectors=detectors,
                             record_detected=args.save_detected,
                             tracer=tracer, fault_injector=injector,
                             retry_policy=policy,
                             chunk_timeout_s=args.chunk_timeout_s,
                             checkpointer=checkpointer,
                             checkpoint_every=args.checkpoint_every)
    totals, stats = sched.run_fixed(args.photons, args.chunk,
                                    seed=args.seed,
                                    deadline_s=args.deadline_s,
                                    resume=resume)
    print("per-device photons:", stats)
    rep = sched.last_report
    if injector is not None or rep.retries or rep.quarantine_events:
        c = rep.counters()
        print(f"resilience: {c['merged']}/{c['chunks']} chunks merged, "
              f"{c['retries']} retries, {c['speculative']} speculative, "
              f"{c['validation_failures']} rejected by merge guard, "
              f"{c['quarantine_events']} quarantine events, "
              f"{c['checkpoints']} checkpoints")
    return totals


def _run_scenarios(args, ap, dev, tracer, sinks) -> Run:
    """--scenarios: the fleet through ``scenarios.simulate_many``."""
    spec = args.scenarios
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            spec = f.read()
    entries = json.loads(spec)
    if not isinstance(entries, list) or not entries:
        ap.error("--scenarios expects a non-empty JSON list of scenario "
                 "dicts (or @file.json holding one)")
    scenarios = [SC.Scenario.from_dict(e) for e in entries]
    mesh = _mesh(args, dev)
    cache = SC.default_cache()
    t0 = time.perf_counter()
    results = SC.simulate_many(scenarios, n_lanes=args.lanes,
                               device=None if mesh else dev, mesh=mesh,
                               cache=cache, tracer=tracer)
    _synchronize(dev)
    dt = time.perf_counter() - t0

    total_photons = sum(sc.n_photons for sc in scenarios)
    keys = {SC.group_key(sc, args.lanes, device=dev) for sc in scenarios}
    sharded = f" over {len(mesh)} devices" if mesh else ""
    print(f"scenarios: {len(scenarios)} in {dt:.2f}s "
          f"({len(scenarios)/dt:.2f} scenarios/s, "
          f"{total_photons/dt/1e3:.2f} photons/ms total), "
          f"{len(keys)} config shape(s){sharded}")
    st = cache.stats()
    print(f"compile cache: {st['hits']} hits / {st['misses']} misses "
          f"(hit rate {st['hit_rate']:.2f}), {st['entries']} entries, "
          f"{st['evictions']} evictions")
    for i, (sc, res) in enumerate(zip(scenarios, results)):
        bal = A.energy_balance(res)
        line = (f"  scenario {i}: {sc.n_photons} photons seed={sc.seed} "
                f"absorbed={bal['absorbed']:.1f} "
                f"escaped={bal['escaped']:.1f} "
                f"residue={bal['residue_frac']:.2e}")
        if sc.detectors:
            line += f" det_w={float(res.det_w.double().sum()):.3f}"  # reprolint: disable=REP301 - host-side report sums
        print(line)
    if tracer is not None:
        engine = "kernel" if dev.type == "cuda" else "plain"
        tracer.counter("scenarios_per_s", len(scenarios) / dt, engine=engine)
        tracer.counter("photons_per_s", total_photons / dt, engine=engine)
    _close(tracer, sinks, args.trace_out)
    return Run(None, None, dt, None, results)


def run(argv=None) -> Run:
    """Parse the CLI arguments, run, print the report; returns the
    forward result and, with ``--replay``, the replay result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", default="B1", choices=BENCHES)
    ap.add_argument("--photons", type=int, default=100_000)
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--size", type=int, default=None,
                    help="voxels a side of B1/B2 (default 60); skinvessel "
                         "is MCX's 200^3 grid only")
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
                         "benchmark config's 5.0, skinvessel's 50.0); "
                         "weight still in "
                         "flight at the cutoff is retired as timed-out")
    ap.add_argument("--collect-stats", action="store_true",
                    help="accumulate round counters (lane occupancy, "
                         "relaunches, retired weight) onto "
                         "SimResult.stats; physics outputs stay "
                         "bit-identical")
    ap.add_argument("--source", default=None,
                    help="JSON source spec (repro_torch.sources), e.g. "
                         '\'{"type": "disk", "pos": [30, 30, 0], '
                         '"radius": 5}\'; default: the pencil beam, or '
                         "skinvessel's own disk beam")
    ap.add_argument("--autotune", action="store_true",
                    help="Opt2: pilot-sweep the lane count (at the chosen "
                         "steps-per-round) and run with the fastest")
    ap.add_argument("--scenarios", default=None, metavar="JSON",
                    help="batched multi-scenario run (repro_torch."
                         "scenarios): a JSON list of scenario dicts (or "
                         "@file.json), each with keys bench/size/photons/"
                         "seed/source/detectors/time_gates/"
                         "steps_per_round/tmax_ns/do_reflect/id_offset.  "
                         "Scenarios of one config shape run as one batch, "
                         "one kernel launch a round; results are bit-"
                         "identical to sequential runs")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="stream structured telemetry events (spans, "
                         "counters) as JSON lines to PATH")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the host-side span timeline as Chrome "
                         "trace_event JSON to PATH (chrome://tracing or "
                         "Perfetto; per-device photons/s feeds "
                         "telemetry.fit_device_models)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the CUDA kernel (default); cpu: the host "
                         "kernel (C++ built with g++ at first use, on "
                         "torch's intra-op threads)")
    ap.add_argument("--devices", default="one", choices=["one", "all"],
                    help="all: shard the photons, the replay's records and "
                         "the scenario axis over every device of --device's "
                         "type (every CUDA device, or the one CPU), each in "
                         "a process of its own, when more than one is "
                         "found.  On one H100 two shards run at about one "
                         "run's rate, but the scenario and replay meshes "
                         "are slower than one device (PERF.md): use them "
                         "for bits and faults, not speed")
    ap.add_argument("--chunk", type=int, default=0,
                    help=">0: dynamic chunk scheduling over every device "
                         "of --device's type through the resilience pool "
                         "(straggler-safe; retries, checkpoints); each "
                         "worker runs its chunks in a process of its own.  "
                         "A pool run costs throughput against one run "
                         "(PERF.md)")
    ap.add_argument("--chaos", default=None, metavar="JSON",
                    help="seeded fault-injection drill for the --chunk "
                         "scheduler: JSON FaultInjector config, e.g. "
                         "'{\"seed\": 1, \"p_fail\": 0.2, \"p_nan\": 0.1, "
                         "\"p_delay\": 0.2, \"delay_s\": 0.1, "
                         "\"poison_chunks\": [0], \"dropout\": "
                         "{\"w0:cpu:0\": 2}}'; results stay bit-identical "
                         "to the fault-free run")
    ap.add_argument("--max-retries", type=int, default=None, metavar="N",
                    help="attempt cap per chunk before it is quarantined "
                         "(default: RetryPolicy's 5); requires --chunk")
    ap.add_argument("--chunk-timeout-s", type=float, default=None,
                    metavar="S",
                    help="hard per-chunk deadline: a chunk inflight "
                         "longer re-dispatches speculatively (on top of "
                         "the fitted DeviceModel deadlines); requires "
                         "--chunk")
    ap.add_argument("--deadline-s", type=float, default=None, metavar="S",
                    help="overall wall-clock bound for the chunked run "
                         "(TimeoutError past it instead of waiting "
                         "forever); requires --chunk")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                    help="auto-checkpoint the chunked campaign every N "
                         "merged chunks (atomic Checkpointer, int64 "
                         "totals); requires --chunk and --checkpoint-dir")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="checkpoint directory for --checkpoint-every; "
                         "if it already holds a matching campaign "
                         "checkpoint the run resumes from it")
    args = ap.parse_args(argv)
    if args.save_detected and not args.detectors:
        ap.error("--save-detected requires --detectors")
    if args.replay and not args.save_detected:
        ap.error("--replay requires --save-detected")
    if args.replay_gate_resolved and not args.replay:
        ap.error("--replay-gate-resolved requires --replay")
    for flag in ("chaos", "max_retries", "chunk_timeout_s", "deadline_s"):
        if getattr(args, flag) is not None and not args.chunk:
            ap.error(f"--{flag.replace('_', '-')} requires --chunk")
    if args.checkpoint_every and not (args.chunk and args.checkpoint_dir):
        ap.error("--checkpoint-every requires --chunk and --checkpoint-dir")
    if args.scenarios:
        for flag in ("chunk", "autotune", "save_detected", "replay",
                     "source", "detectors", "collect_stats"):
            if getattr(args, flag):
                ap.error(f"--scenarios is incompatible with "
                         f"--{flag.replace('_', '-')} (scenario dicts "
                         f"carry their own per-scenario config)")

    dev = resolve_device(args.device)
    sinks = [T.JsonlSink(args.metrics_out)] if args.metrics_out else []
    tracer = T.Tracer(sinks=sinks) if (args.trace_out or sinks) else None
    if args.scenarios:
        return _run_scenarios(args, ap, dev, tracer, sinks)
    source = (json.loads(args.source) if args.source
              else bench_source(args.bench))
    detectors = as_detectors(
        json.loads(args.detectors)) if args.detectors else None
    try:
        vol, cfg = build_bench(args.bench, args.size, dev, args.time_gates,
                               tracer)
    except ValueError as e:  # a --size the benchmark does not offer
        ap.error(str(e))
    cfg = dataclasses.replace(cfg, steps_per_round=args.steps_per_round,
                              n_time_gates=args.time_gates,
                              collect_stats=args.collect_stats)
    if args.tmax_ns is not None:
        cfg = dataclasses.replace(cfg, tmax_ns=args.tmax_ns)

    lanes = args.lanes
    if args.autotune:
        lanes, timings = S.autotune_lanes(vol, cfg,
                                          n_pilot=args.photons // 10,
                                          source=source, device=dev)
        print("autotune:", {k: round(v, 3) for k, v in timings.items()},
              "-> lanes =", lanes)

    engine = "kernel" if dev.type == "cuda" else "plain"
    mesh = None
    t0 = time.perf_counter()
    if args.chunk:
        totals = _run_chunked(args, vol, cfg, lanes, source, detectors,
                              tracer)
    else:
        mesh = _mesh(args, dev)
        span = tracer.span("simulate", device="mesh" if mesh else dev,
                           engine=engine,
                           photons=args.photons) if tracer else None
        if mesh:
            counts = M.shard_counts(args.photons, len(mesh))
            totals = S.merge_fixed(M.sharded_sim_fn(
                vol, cfg, lanes, mesh, source=source, detectors=detectors,
                record_detected=args.save_detected)(
                    counts, M.shard_offsets(counts), args.seed))
        else:
            totals = S.simulate_fixed(vol, cfg, args.photons, lanes,
                                      args.seed, source=source, device=dev,
                                      detectors=detectors,
                                      record_detected=args.save_detected)
        if span is not None:
            span.end()
    res = S.to_sim_result(totals)
    _synchronize(dev)
    dt = fwd_seconds = time.perf_counter() - t0

    bal = A.energy_balance(res)
    sharded = f" over {len(mesh)} devices" if mesh else ""
    print(f"{args.bench}: {args.photons} photons in {dt:.2f}s "
          f"({args.photons/dt/1e3:.2f} photons/ms){sharded}")
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
        if tracer is not None:
            for k, v in sd.items():
                tracer.counter(f"round_stats.{k}", v, bench=args.bench,
                               engine=engine)
    phi = A.fluence_cw(res, vol)
    print(f"fluence: max={float(phi.max()):.3e} "
          f"nonzero voxels={int((phi > 0).sum())}")
    if cfg.n_time_gates > 1:
        per_gate = A.fluence_td(res, vol).sum(axis=(0, 1, 2))
        print(f"time gates: {cfg.n_time_gates} x {cfg.gate_width_ns:.3f} ns, "
              f"peak gate {int(per_gate.argmax())}")
    if detectors:
        times, curves = A.tpsf(res, cfg)
        tot = res.det_w.double().sum(dim=1).cpu().numpy()  # reprolint: disable=REP301 - host-side report sums
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
                  f"from the id buffer (capacity {args.save_detected} per "
                  f"simulation unit: the run, a shard or a chunk); det_w "
                  f"still counts them, but replay will miss them; raise "
                  f"--save-detected")
        if args.replay and recs.shape[0]:
            t0 = time.perf_counter()
            rep = replay_jacobian(vol, cfg, recs, detectors, source=source,
                                  seed=args.seed, n_lanes=lanes,
                                  gate_resolved=args.replay_gate_resolved,
                                  device=None if mesh else dev, mesh=mesh,
                                  tracer=tracer)
            dt = time.perf_counter() - t0
            ok = int((rep.replayed_det == rep.det).sum())
            print(f"replay[{dev.type}]: {rep.n_records} photons "
                  f"in {dt:.2f}s ({rep.n_records/dt/1e3:.2f} photons/ms)"
                  f"{sharded}, {ok}/{rep.n_records} detector-exact")
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
            _finish(tracer, sinks, args, fwd_seconds, engine)
            return Run(res, rep, fwd_seconds, dt, totals=totals)
    _finish(tracer, sinks, args, fwd_seconds, engine)
    return Run(res, None, fwd_seconds, None, totals=totals)


def _finish(tracer, sinks, args, fwd_seconds, engine) -> None:
    if tracer is not None:
        tracer.counter("photons_per_s", args.photons / fwd_seconds,
                       bench=args.bench, engine=engine)
    _close(tracer, sinks, args.trace_out)


def main(argv=None):
    """Run the CLI; returns the forward ``SimResult``, or with
    ``--scenarios`` the list of the scenarios' results."""
    out = run(argv)
    return out.scenarios if out.scenarios is not None else out.result


if __name__ == "__main__":
    main()
