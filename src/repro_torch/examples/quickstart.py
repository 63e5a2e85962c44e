"""Quickstart: run the paper's B1 benchmark and validate the physics.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The pencil beam enters at the centre of the z=0 face ((30, 30, 0) on
the 60 mm cube); ``--size`` scales the cube, the beam and the fitted
depth range (10-35 mm at 60) together.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import sources as SRC
from repro_torch.core import analysis as A
from repro_torch.core import simulator as S
from repro_torch.core import volume as V
from repro_torch.examples import STEPS_PER_ROUND
from repro_torch.kernels.photon_step.ops import resolve_device

PROFILE_MM = 15   # depths of the printed on-axis profile


def run(size: int = 60, photons: int = 50_000, lanes: int = 4096,
        seed: int = 42, device="cuda") -> dict:
    """Simulate B1 and return what :func:`main` prints: the result, its
    energy balance, the fitted and theoretical mu_eff (1/mm), the
    on-axis fluence profile, and the run's host-clock seconds (ended by
    a device synchronisation) and photons/ms."""
    dev = resolve_device(device)
    vol = V.benchmark_b1((size,) * 3, dev)
    cfg = dataclasses.replace(V.b1_config(), steps_per_round=STEPS_PER_ROUND)
    c = size // 2
    t0 = time.perf_counter()
    res = S.simulate(vol, cfg, photons, lanes, seed,
                     source=SRC.Pencil(pos=(size / 2, size / 2, 0.0)),
                     device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    m = V.B1_MEDIUM
    return {
        "result": res,
        "balance": A.energy_balance(res),
        "mu_fit": A.fit_axial_decay(res, vol, (size // 6, size * 7 // 12),
                                    axis_xy=(c, c)),
        "mu_theory": A.mu_eff_theory(m.mua, m.mus, m.g),
        "profile": A.fluence_cw(res, vol)[c, c, :PROFILE_MM],
        "seconds": seconds,
        "photons_per_ms": photons / seconds / 1e3,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=60)
    ap.add_argument("--photons", type=int, default=50_000)
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    c = args.size // 2
    print(f"simulating {args.photons} photons (B1, pencil beam at "
          f"({c},{c},0)) on {args.device}...")
    out = run(args.size, args.photons, args.lanes, args.seed, args.device)
    bal = out["balance"]
    print(f"{out['seconds']:.2f}s ({out['photons_per_ms']:.2f} photons/ms)")
    print(f"energy balance: launched={bal['launched']:.0f} "
          f"absorbed={bal['absorbed']:.1f} escaped={bal['escaped']:.1f} "
          f"residue={bal['residue_frac']:.2e}")
    mu_fit, mu_th = out["mu_fit"], out["mu_theory"]
    print(f"axial decay: fitted mu_eff={mu_fit:.4f}/mm, "
          f"diffusion theory={mu_th:.4f}/mm ({mu_fit/mu_th*100:.0f}%)")
    print(f"on-axis fluence profile (z=0..{len(out['profile']) - 1} mm):")
    for z, v in enumerate(out["profile"]):
        bar = "#" * int(max(0, 50 + 5 * np.log10(max(v, 1e-12))))
        print(f"  z={z:2d}mm {v:9.3e} {bar}")
    return out


if __name__ == "__main__":
    main()
