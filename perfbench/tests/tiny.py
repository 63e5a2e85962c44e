"""A checkout with tiny cells added as new files, for the CPU tests.

``checkout(tmp)`` copies ``BENCHMARK.json`` and ``perfbench/`` into
``tmp``, links the port's ``src/``, and adds, as new files only, tiny
B1 and B2 configurations (16^3 voxels, 0.3 ns) and a tiny cell of each
traffic kind, entered in the copy's ``BENCHMARK.json`` beside the real
ones.  ``run(root, workload, ...)`` runs one cell there on the CPU, as
``perfbench/run.py`` runs it on the card, and returns its result line.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
DETECTORS = [{"x": 10, "y": 8, "radius": 2}, {"x": 12, "y": 8, "radius": 2}]
CELLS = {
    "tiny.cw": ("tinyB1", "b1.cw", dict(
        photons=3000, lanes=1024, steps_per_round=8, warmup_photons=512)),
    "tiny.detect": ("tinyB2", "b2.detect", dict(
        photons=3000, lanes=1024, steps_per_round=8, warmup_photons=512,
        tmax_ns=0.3, time_gates=3, record_slots=4096, detectors=DETECTORS)),
    "tiny.sweep": ("tinyB2", "b2.sweep", dict(
        photons=500, lanes=256, scenarios=3, steps_per_round=8,
        warmup_photons=256, tmax_ns=0.3, time_gates=3,
        source={"type": "disk", "pos": [5.0, 8.0, 0.0],
                "dir": [0.0, 0.0, 1.0], "radius": 2.0},
        detectors=DETECTORS[:1])),
}
# cells whose files stay while BENCHMARK.json leaves them out: their
# end-to-end metric, entered in the copy for the tiny cell like them
DEFERRED = {"b2.detect": {"name": "jacobian_s", "unit": "s",
                          "better": "lower", "bound": 0.25,
                          "source": "host_clock"}}


def checkout(tmp: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp / "src").symlink_to(ROOT / "src")
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    pb = tmp / "perfbench"
    for name in ("B1", "B2"):
        cfg = json.loads((pb / "configs" / f"{name}.json").read_text())
        cfg["volume"]["shape"] = [16, 16, 16]
        cfg["source"]["pos"] = [8.0, 8.0, 0.0]
        cfg["physics"].update(tmax_ns=0.3, max_steps=2000)
        for inc in cfg["volume"]["inclusions"]:
            inc.update(center_mm=[8.0, 8.0, 8.0], radius_mm=4.0)
        (pb / "configs" / f"tiny{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({
            "name": f"tiny{name}", "source": "tiny copy of " + name,
            "file": f"perfbench/configs/tiny{name}.json", "reduced": [],
            "why": "CPU tests"})
    names = {m["name"] for m in bench["end_to_end"]}
    bench["end_to_end"] += [dict(m, workloads=[like])
                            for like, m in DEFERRED.items()
                            if m["name"] not in names]
    for cell, (config, like, changes) in CELLS.items():
        w = json.loads((pb / "workloads" / f"{like}.json").read_text())
        w.update(changes)
        (pb / "workloads" / f"{cell}.json").write_text(json.dumps(w))
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": w["kind"], "chips": 1,
                                   "why": "CPU tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp


def run(root: Path, workload: str, seed: int = 4294967311,
        seconds: float = 1.0, trace: int = 0) -> dict:
    mod = harness.load_module(root / "perfbench" / "run.py",
                              "perfbench_run_under_test")
    return mod.run(["--workload", workload, "--seed", str(seed),
                    "--seconds", str(seconds), "--trace", str(trace)],
                   device="cpu")


def driver(root: Path, workload: str, seed: int = 5):
    """A set-up driver of a tiny cell on the CPU."""
    import torch

    cell = harness.find_cell(harness.benchmark(root), workload, root, seed,
                             torch.device("cpu"))
    drv = harness.driver(cell)
    drv.set_up()
    return drv
