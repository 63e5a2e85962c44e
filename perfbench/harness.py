"""The benchmark's machinery: a cell's files by name, seeds, the window.

Everything that belongs to one configuration, one cell or one metric is
a file of its own, found by the name that ``BENCHMARK.json`` gives it:

  * ``configs/<config>.json``: the deployment's volume, physics and
    source (the file named by the configuration's ``file``);
  * ``workloads/<cell>.json``: the cell's traffic, whose ``kind`` names
    its driver, ``drivers/<kind>.py``;
  * ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``.

A driver module defines ``Driver(cell)`` with ``groups`` (the kernel
variants it launches), ``set_up()``, ``warm_up()``, ``solve(i)`` (one
whole solution, ended by a device synchronisation), ``stats(sol)`` (what
the metric readers read of it: its photons, rounds, host-clock seconds),
``quick_check(sol)`` (cheap checks of every solution: a list of
faults), ``release()`` (drops the port's state), ``reference(sol,
control=False)`` (the plain reference's run of the same photons) and
``compare(sol, ref)`` (``{name: entries that differ}``, each limit 0).
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import random
from typing import NamedTuple

ROOT = pathlib.Path(__file__).resolve().parents[1]
MASK64 = (1 << 64) - 1


def load_module(path: pathlib.Path, name: str):
    """A module from a file, by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell(NamedTuple):
    name: str
    config: dict      # configs/<config>.json
    workload: dict    # workloads/<cell>.json
    seed: int
    device: object    # a torch.device
    root: pathlib.Path


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str, root: pathlib.Path, seed: int,
              device) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads(
        (root / configs[cells[name]["config"]]["file"]).read_text())
    workload = json.loads((root / "perfbench" / "workloads"
                           / f"{name}.json").read_text())
    return Cell(name, config, workload, int(seed), device, root)


def driver(cell: Cell):
    kind = cell.workload["kind"]
    mod = load_module(cell.root / "perfbench" / "drivers" / f"{kind}.py",
                      f"perfbench_driver_{kind}")
    return mod.Driver(cell)


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved
                             else [])]


def reader(root: pathlib.Path, name: str):
    return load_module(root / "perfbench" / "metrics" / f"{name}.py",
                       f"perfbench_metric_{name.replace('.', '_')}")


def mix64(*words: int) -> int:
    """splitmix64 over the words: a 64-bit value for seeds and ids."""
    z = 0x243F6A8885A308D3
    for w in words:
        z = (z ^ (int(w) & MASK64)) & MASK64
        z = (z + 0x9E3779B97F4A7C15) & MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
        z ^= z >> 31
    return z


# salts that keep the solution seeds, id offsets and the sample apart
SEED_SALT, ID_SALT, SAMPLE_SALT = 1, 2, 3


def solution_seed(seed: int, index: int) -> int:
    """The 32-bit seed of solution ``index`` (``-1``: the warm-up)."""
    return mix64(seed, SEED_SALT, index) & 0xFFFFFFFF


def solution_ids(seed: int, index: int) -> int:
    """The first 64-bit photon id of solution ``index``: below 2**62,
    so its photons stay inside the 64-bit range."""
    return mix64(seed, ID_SALT, index) >> 2


class Sample:
    """The one solution of a window whose outputs are compared, drawn
    from the seed as the window runs (a reservoir of one: the ``k``-th
    solution offered replaces the kept one with probability ``1/k``), so
    that no other solution's outputs are held."""

    def __init__(self, seed: int):
        self.draw = random.Random(mix64(seed, SAMPLE_SALT))
        self.offered = 0
        self.kept = None

    def offer(self, sol) -> None:
        self.offered += 1
        if self.draw.random() * self.offered < 1.0:
            self.kept = sol
