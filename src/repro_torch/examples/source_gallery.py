"""Source gallery: every registered illumination type on the B1 cube.

Runs each source through the same simulation, prints the energy balance
and an ASCII map of the diffuse-reflectance (exitance) image — the
spatial signature that distinguishes a pencil from a disk from a slit.

  PYTHONPATH=src python -m repro_torch.examples.source_gallery \
      [--photons N] [--size S] [--lanes L] [--device cpu]
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


def ascii_map(img: np.ndarray, width: int = 32) -> str:
    """Log-scale ASCII rendering of a 2-D exitance image."""
    shades = " .:-=+*#%@"
    ds = max(1, img.shape[0] // width)
    img = img[: img.shape[0] // ds * ds, : img.shape[1] // ds * ds]
    img = img.reshape(img.shape[0] // ds, ds, img.shape[1] // ds, ds).sum((1, 3))
    lo = np.log10(np.maximum(img, 1e-12))
    lo = (lo - lo.min()) / max(lo.max() - lo.min(), 1e-9)
    idx = np.minimum((lo * len(shades)).astype(int), len(shades) - 1)
    idx[img <= 0] = 0
    return "\n".join("".join(shades[i] for i in row) for row in idx.T)


def run(size: int = 40, photons: int = 20_000, lanes: int = 2048,
        seed: int = 42, device="cuda") -> list[dict]:
    """Simulate every source of ``sources.demo_menu(size)`` on B1; for
    each, its name, config, result, energy balance, ``steps``, exitance
    image (numpy) and host-clock seconds (ended by a device
    synchronisation) and photons/ms."""
    dev = resolve_device(device)
    vol = V.benchmark_b1((size,) * 3, dev)
    cfg = dataclasses.replace(V.b1_config(), steps_per_round=STEPS_PER_ROUND)
    out = []
    for name, src in SRC.demo_menu(size).items():
        t0 = time.perf_counter()
        res = S.simulate(vol, cfg, photons, lanes, seed, source=src,
                         device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        out.append({"name": name, "source": SRC.to_dict(src),
                    "result": res, "balance": A.energy_balance(res),
                    "steps": int(res.steps),
                    "exitance": res.exitance.cpu().numpy(),
                    "seconds": seconds,
                    "photons_per_ms": photons / seconds / 1e3})
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--photons", type=int, default=20_000)
    ap.add_argument("--size", type=int, default=40)
    ap.add_argument("--lanes", type=int, default=2048)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    out = run(args.size, args.photons, args.lanes, device=args.device)
    for row in out:
        bal = row["balance"]
        print(f"\n=== {row['name']}  ({row['source']})")
        print(f"    launched_w={bal['launched']:.1f} "
              f"absorbed={bal['absorbed']:.1f} escaped={bal['escaped']:.1f} "
              f"residue={-bal['residue_frac']:+.2e} steps={row['steps']} "
              f"({row['photons_per_ms']:.2f} photons/ms)")
        print("    exitance through z=0 (log scale):")
        for line in ascii_map(row["exitance"]).splitlines():
            print("    " + line)
    return out


if __name__ == "__main__":
    main()
