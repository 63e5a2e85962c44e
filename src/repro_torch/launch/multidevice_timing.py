"""Where the time of a multi-device run goes on one host.

    PYTHONPATH=src python -m repro_torch.launch.multidevice_timing [--no-cpu]

Every shard and pool worker runs its round loop in a process of its own
(``core.procs``), each with its own interpreter, CUDA context and kernel
libraries.  This script times that, on B2 (two shards of one card) and
B1 (the card beside a CPU shard), at 60^3 with 262144 lanes and K = 16,
each measurement twice with every process already warm, and prints one
JSON line each, with the card's name and power limit:

  single        one run of all the photons in the calling process
  sequential    the two shards (0.7 / 0.3) one after the other in the
                calling process
  processes     the two shards at once, each in its own process
                (``core.multidevice.sharded_sim_fn`` over ``[cuda:0,
                cuda:0]``), with each shard's wall and device seconds
                from its process's reply
  cpu beside    the card's process running a B1 shard with the CPU's
                process idle (zero photons), then beside a CPU shard
                running at once on the cores the card's process leaves
                (``procs.cpu_threads``): the card shard's wall, device
                seconds and slowdown, and the CPU shard's wall and the
                threads its process ran on
  cpu threads   the CPU's process alone running the B1 shard at
                THREAD_LANES lanes, on one thread and on the cores a
                card's process leaves: wall and photons/ms of each
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch

from repro_torch.core import multidevice as M
from repro_torch.core import procs
from repro_torch.core import simulator as S
from repro_torch.launch.simulate import get_bench

SIZE, LANES, K, SEED = 60, 262_144, 16, 1234
# the CPU process's lanes timed on one thread and on the cores left
THREAD_LANES = (2048, 8192, 32768)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bench(name: str, device):
    vol, cfg = get_bench(name, SIZE, device)
    return vol, dataclasses.replace(cfg, steps_per_round=K)


def shards(mesh, works, counts, offsets):
    """One request a device at once; returns the replies."""
    return procs.run_all([
        procs.Job(d, s, "sim", w, (int(c), SEED, int(o)))
        for d, s, w, c, o in zip(mesh, procs.slots(mesh), works, counts,
                                 offsets)])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--photons", type=int, default=10_000_000)
    ap.add_argument("--card-photons", type=int, default=20_000_000,
                    help="photons of the card shard beside a CPU shard")
    ap.add_argument("--cpu-photons", type=int, default=131072)
    ap.add_argument("--cpu-lanes", type=int, default=8192)
    ap.add_argument("--no-cpu", action="store_true",
                    help="time only the two shards of one card, not the "
                         "card beside a CPU shard")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("multidevice_timing needs a CUDA device")
    gpu, cpu = torch.device("cuda", 0), torch.device("cpu")
    name = card()
    n = args.photons
    first = round(0.7 * n)
    counts = [first, n - first]
    offsets = M.shard_offsets(counts)
    vol2, cfg2 = bench("B2", gpu)
    fn = S.build_fixed_fn(vol2.shape, vol2.unitinmm, cfg2, LANES, device=gpu)

    def run_b2(count, offset=0):
        return fn(vol2.labels.reshape(-1), vol2.media, int(count), SEED,
                  offset)

    work2 = procs.sim_work(vol2, cfg2, LANES)
    mesh2 = [gpu, gpu]
    run_b2(LANES)  # first launches of each kernel variant
    shards(mesh2, [work2] * 2, [LANES] * 2, [0, LANES])  # warm processes
    for turn in range(2):
        _, single = timed(lambda: run_b2(n))
        _, sequential = timed(lambda: [run_b2(counts[0]),
                                       run_b2(counts[1], counts[0])])
        replies, both = timed(lambda: shards(mesh2, [work2] * 2, counts,
                                             offsets))
        emit(turn=turn, card=name, bench="B2", photons=n, lanes=LANES, k=K,
             partition=counts, single_s=single, sequential_s=sequential,
             processes_s=both, shard_wall_s=[r.wall_s for r in replies],
             shard_device_s=[r.device_s for r in replies],
             pids=[r.pid for r in replies],
             processes_over_single=both / single,
             single_over_processes=single / both,
             sequential_over_single=sequential / single)

    if args.no_cpu:
        return
    vol1, cfg1 = bench("B1", gpu)
    mesh1 = [gpu, cpu]
    works1 = [procs.sim_work(vol1, cfg1, LANES),
              procs.sim_work(vol1, cfg1, args.cpu_lanes)]
    cpu_offset = args.card_photons
    shards(mesh1, works1, [LANES, args.cpu_lanes], [0, cpu_offset])
    for turn in range(2):
        alone, _ = timed(lambda: shards(mesh1, works1,
                                        [args.card_photons, 0],
                                        [0, cpu_offset]))
        beside, wall = timed(lambda: shards(
            mesh1, works1, [args.card_photons, args.cpu_photons],
            [0, cpu_offset]))
        emit(turn=turn, card=name, bench="B1",
             card_photons=args.card_photons, cpu_photons=args.cpu_photons,
             cpu_lanes=args.cpu_lanes, cpu_threads=beside[1].threads,
             card_alone_s=alone[0].wall_s,
             card_alone_device_s=alone[0].device_s,
             card_beside_cpu_s=beside[0].wall_s,
             card_beside_cpu_device_s=beside[0].device_s,
             cpu_shard_s=beside[1].wall_s, both_s=wall,
             slowdown=beside[0].wall_s / alone[0].wall_s)

    # the CPU process's threads: one, and what a card's process leaves;
    # set here, not by a run's device types
    proc = procs.child(cpu, 0)
    proc.run = ()
    share = procs.cpu_threads(("cuda", "cpu"))
    for lanes in THREAD_LANES:
        work = procs.sim_work(vol1, cfg1, lanes)
        for threads in (1, share):
            proc.call(torch.set_num_threads, threads)
            procs.result(proc.submit("sim", work, (lanes, SEED,
                                                   cpu_offset)))  # warm
            for turn in range(2):
                got = procs.reply(proc.submit(
                    "sim", work, (args.cpu_photons, SEED, cpu_offset)))
                if not got.ok:
                    raise got.value
                emit(turn=turn, card=name, bench="B1", item="cpu threads",
                     cpu_photons=args.cpu_photons, cpu_lanes=lanes,
                     threads=got.threads, cpu_s=got.wall_s,
                     photons_per_ms=args.cpu_photons / got.wall_s / 1e3)
    proc.call(torch.set_num_threads, 1)


if __name__ == "__main__":
    main()
