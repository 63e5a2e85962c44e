"""The comparison's two readings at a cell's own size, seed by seed.

    python3 perfbench/control.py --workload b1.cw --seeds 11,12,13

For each seed, one solution of the cell through the port (as a run's
window makes it), then the plain reference twice: as the benchmark runs
it (each number's lower reading: what sound runs give) and as the
control, with every value handed to a fixed-point sum computed in
bfloat16 (each number's upper reading: what the comparison has to
reject).  Prints one JSON line a seed with both readings, the
reference's seconds and, for the roofline, the live segments a photon
of the reference.  Needs a CUDA device; the benchmark's own runs do not
run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def readings(workload: str, seeds, device=None, root=ROOT):
    """Yield a dict of both readings for each seed."""
    import torch

    from perfbench import harness
    from perfbench.reference import transport

    bench = harness.benchmark(root)
    device = torch.device(device or "cuda")
    for seed in seeds:
        cell = harness.find_cell(bench, workload, root, seed, device)
        drv = harness.driver(cell)
        drv.set_up()
        sol = drv.solve(0)
        out = {"workload": workload, "seed": seed, "stats": drv.stats(sol)}
        for name, control in (("sound", False), ("control", True)):
            t0 = time.perf_counter()
            ref = drv.reference(sol, control=control)
            out[f"{name}_reference_s"] = time.perf_counter() - t0
            out[name] = drv.compare(sol, ref)
            fwd = ref if isinstance(ref, transport.Forward) else ref[0]
            if name == "sound":
                out["live_segments_per_photon"] = (fwd.live_segments
                                                   / fwd.n_launched)
            del ref
        yield out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    for out in readings(args.workload, seeds):
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
