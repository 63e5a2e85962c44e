"""Where the time of a multi-device run goes on one host.

    PYTHONPATH=src python -m repro_torch.launch.multidevice_timing [--no-cpu]

Every shard and pool worker runs its round loop in a host thread of its
own, and each round issues ~180 device operations from Python, each of
which lets go of the interpreter lock and takes it back.  This script
separates what two host threads cost from what sharing the card costs,
on B2 (two shards of one card) and B1 (the card beside a CPU shard), at
60^3 with 262144 lanes and K = 16, each measurement twice, and prints
one JSON line each, with the card's name and power limit:

  single        one run of all the photons in the calling thread
  sequential    the two shards (0.7 / 0.3) one after the other in the
                calling thread
  threaded      the two shards at once, each in its own host thread
                (``core.multidevice.sharded_sim_fn``)
  lock probe    one run while another thread only issues tiny CPU
                tensor operations (no device work): the cost of handing
                the interpreter lock back and forth alone
  cpu beside    a card run alone, then beside a CPU shard in another
                thread, with PyTorch's CPU threads at the default, all
                cores but one, and one

Uses only entry points that earlier checkouts of the port have too: to
compare two checkouts on one card, run this file by its path under each
one's ``PYTHONPATH`` in turns.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import threading
import time

import torch

from repro_torch.core import multidevice as M
from repro_torch.core import simulator as S
from repro_torch.launch.simulate import get_bench

SIZE, LANES, K, SEED = 60, 262_144, 16, 1234


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


def runner(bench: str, device, lanes: int):
    vol, cfg = get_bench(bench, SIZE, device)
    cfg = dataclasses.replace(cfg, steps_per_round=K)
    fn = S.build_fixed_fn(vol.shape, vol.unitinmm, cfg, lanes, device=device)
    labels, media = vol.labels.reshape(-1), vol.media
    return (lambda n, offset=0: fn(labels, media, int(n), SEED, offset)), \
        vol, cfg


def beside(main, other):
    """Run ``main()`` in this thread while ``other(stop)`` runs in
    another; returns (main's seconds, other's result)."""
    stop = threading.Event()
    box = {}
    thread = threading.Thread(target=lambda: box.update(out=other(stop)))
    thread.start()
    try:
        _, seconds = timed(main)
    finally:
        stop.set()
        thread.join(timeout=600)
    return seconds, box.get("out")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--photons", type=int, default=10_000_000)
    ap.add_argument("--card-photons", type=int, default=20_000_000,
                    help="photons of the card run beside a CPU shard")
    ap.add_argument("--cpu-lanes", type=int, default=2048)
    ap.add_argument("--no-cpu", action="store_true",
                    help="time only the two shards of one card (and the "
                         "lock probe), not the card beside a CPU shard")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("multidevice_timing needs a CUDA device")
    gpu = torch.device("cuda", 0)
    name = card()
    n = args.photons
    first = round(0.7 * n)
    counts = [first, n - first]
    run_b2, vol2, cfg2 = runner("B2", gpu, LANES)
    run_b2(LANES)  # first launches of each kernel variant
    shards = M.sharded_sim_fn(vol2, cfg2, LANES, [gpu, gpu])
    for turn in range(2):
        _, single = timed(lambda: run_b2(n))
        _, sequential = timed(lambda: [run_b2(counts[0]),
                                       run_b2(counts[1], counts[0])])
        _, threaded = timed(lambda: shards(counts, M.shard_offsets(counts),
                                           SEED))

        def probe(stop):
            x, ops = torch.zeros(16), 0
            while not stop.is_set():
                x = x + 1
                ops += 1
            return ops

        probed, ops = beside(lambda: run_b2(n), probe)
        emit(turn=turn, card=name, bench="B2", photons=n, lanes=LANES, k=K,
             partition=counts, single_s=single, sequential_s=sequential,
             threaded_s=threaded, lock_probe_s=probed, lock_probe_ops=ops,
             threaded_over_single=threaded / single,
             sequential_over_single=sequential / single,
             lock_probe_over_single=probed / single)

    if args.no_cpu:
        return
    run_b1, _, _ = runner("B1", gpu, LANES)
    run_cpu, _, _ = runner("B1", torch.device("cpu"), args.cpu_lanes)
    default_threads = torch.get_num_threads()
    cores = os.cpu_count() or 1
    for turn in range(2):
        _, alone = timed(lambda: run_b1(args.card_photons))
        for threads in (default_threads, max(1, cores - 1), 1):
            torch.set_num_threads(threads)
            try:
                def cpu_shard(stop):
                    t0 = time.perf_counter()
                    run_cpu(args.cpu_lanes, args.card_photons)
                    return time.perf_counter() - t0

                with_cpu, cpu_s = beside(lambda: run_b1(args.card_photons),
                                         cpu_shard)
            finally:
                torch.set_num_threads(default_threads)
            emit(turn=turn, card=name, bench="B1",
                 card_photons=args.card_photons, cpu_photons=args.cpu_lanes,
                 cpu_lanes=args.cpu_lanes, cpu_threads=threads, cores=cores,
                 card_alone_s=alone, card_beside_cpu_s=with_cpu,
                 cpu_shard_s=cpu_s, slowdown=with_cpu / alone)


if __name__ == "__main__":
    main()
