"""Heterogeneous multi-device simulation with pilot-fitted load balancing.

Reproduces the paper's device-level workflow end to end: pilot runs fit
T = a*n + T0 per device class, the S3 minimax partitioner splits the
budget, and the chunk scheduler absorbs stragglers dynamically.  The run
and the chunk scheduler use every device of ``--device``'s type, each
in a process of its own.

  PYTHONPATH=src python -m repro_torch.examples.heterogeneous_lb \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.core import analysis as A
from repro_torch.core import loadbalance as LB
from repro_torch.core import multidevice as M
from repro_torch.core import simulator as S
from repro_torch.core import volume as V
from repro_torch.examples import STEPS_PER_ROUND
from repro_torch.kernels.photon_step.ops import (resolve_device,
                                                 visible_devices)
from repro_torch.telemetry.trace import device_label

SEED = 7


def synthetic_mix(model: LB.DeviceModel) -> list[LB.DeviceModel]:
    """The reference's heterogeneous mix, scaled from one fitted model:
    a fast and a slow card and a CPU."""
    return [
        LB.DeviceModel("gpu-fast", a=model.a / 4, t0=model.t0, cores=4096),
        LB.DeviceModel("gpu-slow", a=model.a / 2, t0=model.t0 * 2,
                       cores=2048),
        LB.DeviceModel("cpu", a=model.a, t0=model.t0 / 2, cores=16),
    ]


def partitions(n_photons: int, mix) -> dict:
    """S1/S2/S3 partitions of ``n_photons`` over ``mix``, each with its
    predicted makespan (s), and the ideal makespan."""
    out = {}
    for strat, fn in LB.PARTITIONERS.items():
        part = fn(n_photons, mix)
        out[strat] = {"partition": part,
                      "makespan": LB.makespan(part, mix)}
    out["ideal"] = LB.ideal_makespan(n_photons, mix)
    return out


def run(size: int = 40, photons: int = 40_000,
        pilot: tuple[int, int] = (4000, 20_000), lanes: int = 2048,
        chunk_lanes: int = 1024, device="cuda",
        model: LB.DeviceModel | None = None) -> dict:
    """The workflow on B1; returns what :func:`main` prints.

    ``model`` takes the place of the timed pilot.  ``lanes`` are the
    pilot's and the one-device run's, ``chunk_lanes`` a shard's and a
    chunk's (the reference's 2048 and 1024).  The run over the
    local devices is kept as its int64 totals (``local``), as is the
    chunk scheduler's (``chunked``): both hold one run's bits on one
    device type.  Seconds are host-clock, ended by a device
    synchronisation."""
    dev = resolve_device(device)
    vol = V.benchmark_b1((size,) * 3, dev)
    cfg = dataclasses.replace(V.b1_config(), steps_per_round=STEPS_PER_ROUND)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # --- pilot fit on the real simulator (the paper's two-run protocol) ---
    if model is None:
        fn = S.make_simulator(vol, cfg, lanes, device=dev)

        def run_n(k):
            args = (vol.labels.reshape(-1), vol.media, k, SEED)
            fn(*args)       # warm: the first call builds the kernel
            sync()
            t0 = time.perf_counter()
            fn(*args)
            sync()
            return time.perf_counter() - t0

        model = LB.run_pilot(run_n, *pilot, name="local")

    # --- run for real on every local device of the type (with several,
    # simulate_sharded's run, kept as its int64 totals) ---
    devices = visible_devices(dev.type)
    sync()
    t0 = time.perf_counter()
    if len(devices) > 1:
        counts = M.shard_counts(photons, len(devices))
        local = S.merge_fixed(M.sharded_sim_fn(vol, cfg, chunk_lanes,
                                               devices)(
            counts, M.shard_offsets(counts), SEED))
    else:
        counts = [photons]
        local = S.simulate_fixed(vol, cfg, photons, lanes, SEED, device=dev)
    sync()
    local_s = time.perf_counter() - t0

    # --- dynamic chunk scheduling (straggler mitigation) ---
    sched = M.ChunkScheduler(vol, cfg, n_lanes=chunk_lanes, devices=devices)
    t0 = time.perf_counter()
    chunked, chunk_photons = sched.run_fixed(photons, photons // 8,
                                             seed=SEED)
    chunk_s = time.perf_counter() - t0

    return {
        "model": model,
        "pilot_photons_per_ms": model.throughput / 1e3,
        # S1/S2/S3 on a synthetic heterogeneous mix from the measured slope
        "partitions": partitions(photons, synthetic_mix(model)),
        "devices": [device_label(d) for d in devices],
        "local": local,
        "local_photons": {device_label(d): n
                          for d, n in zip(devices, counts)},
        "local_balance": A.energy_balance(S.to_sim_result(local)),
        "local_seconds": local_s,
        "local_photons_per_ms": photons / local_s / 1e3,
        "chunked": chunked,
        "chunk_photons": chunk_photons,
        "chunk_seconds": chunk_s,
        "chunk_photons_per_ms": photons / chunk_s / 1e3,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=40)
    ap.add_argument("--photons", type=int, default=40_000)
    ap.add_argument("--pilot", type=int, nargs=2, default=(4000, 20_000),
                    metavar=("N1", "N2"))
    ap.add_argument("--lanes", type=int, default=2048)
    ap.add_argument("--chunk-lanes", type=int, default=1024)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    out = run(args.size, args.photons, tuple(args.pilot), args.lanes,
              args.chunk_lanes, args.device)
    model = out["model"]
    print(f"pilot fit: a={model.a:.3e} s/photon, T0={model.t0*1e3:.1f} ms, "
          f"throughput={out['pilot_photons_per_ms']:.2f} photons/ms")
    parts = out["partitions"]
    for strat in LB.PARTITIONERS:
        print(f"{strat}: partition={parts[strat]['partition']} "
              f"makespan={parts[strat]['makespan']:.3f}s")
    print(f"ideal: {parts['ideal']:.3f}s")
    print(f"distributed run on {len(out['devices'])} device(s) "
          f"{out['local_photons']} in {out['local_seconds']:.2f}s "
          f"({out['local_photons_per_ms']:.2f} photons/ms):",
          out["local_balance"])
    print(f"chunk scheduler per-device photons: {out['chunk_photons']} in "
          f"{out['chunk_seconds']:.2f}s "
          f"({out['chunk_photons_per_ms']:.2f} photons/ms)")
    return out


if __name__ == "__main__":
    main()
