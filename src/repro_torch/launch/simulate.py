"""Photon-simulation launcher (the paper's workload) on the PyTorch port.

  PYTHONPATH=src python -m repro_torch.launch.simulate --bench B1 \
      --photons 100000 --lanes 4096 [--device cpu]

Runs on the CUDA device by default, where each fused round is one
launch of the CUDA photon-step kernel; ``--device cpu`` runs the plain
PyTorch version instead.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.core import analysis as A
from repro_torch.core import simulator as S
from repro_torch.core import volume as V
from repro_torch.kernels.photon_step.ops import resolve_device


def get_bench(name: str, size: int, device="cpu"):
    shape = (size, size, size)
    if name == "B1":
        return V.benchmark_b1(shape, device), V.b1_config()
    if name in ("B2", "B2a"):
        return V.benchmark_b2(shape, device), V.b2_config()
    raise ValueError(name)


def main(argv=None) -> S.SimResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", default="B1", choices=["B1", "B2", "B2a"])
    ap.add_argument("--photons", type=int, default=100_000)
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--size", type=int, default=60)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--steps-per-round", type=int, default=1,
                    help="K: fused transport segments per regeneration/"
                         "flush round")
    ap.add_argument("--tmax-ns", type=float, default=None,
                    help="time-of-flight cutoff in ns (default: the "
                         "benchmark config's 5.0); weight still in "
                         "flight at the cutoff is retired as timed-out")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the CUDA kernel (default); cpu: the plain "
                         "PyTorch version")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    vol, cfg = get_bench(args.bench, args.size, dev)
    cfg = dataclasses.replace(cfg, steps_per_round=args.steps_per_round)
    if args.tmax_ns is not None:
        cfg = dataclasses.replace(cfg, tmax_ns=args.tmax_ns)

    t0 = time.perf_counter()
    res = S.simulate(vol, cfg, args.photons, args.lanes, args.seed,
                     device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

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
              f"tmax_ns={cfg.tmax_ns} time gate / max_steps cap; raise "
              f"--tmax-ns if unintended")
    phi = A.fluence_cw(res, vol)
    print(f"fluence: max={float(phi.max()):.3e} "
          f"nonzero voxels={int((phi > 0).sum())}")
    return res


if __name__ == "__main__":
    main()
