"""CW solutions: ``simulate`` of the workload's photons, back to back.

A solution is the port's one-shot run, ``core.simulator.simulate``, as
its two halves: ``simulate_fixed`` (the round loop, the run's int64
fixed-point totals) and ``to_sim_result`` (the one conversion to the
float32 ``SimResult``), so that the int64 totals the timed path made
are what the reference is held to.  Its seed and 64-bit id offset come
from ``--seed`` and its index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from perfbench import harness
from perfbench.port import Inputs, differing, synchronize
from perfbench.reference import transport


class Solution(NamedTuple):
    index: int
    seed: int
    first_id: int
    photons: int
    fixed: object    # the port's FixedResult, on the device
    result: object   # its SimResult


class Driver:
    groups = (0,)     # the base kernel variant

    def __init__(self, cell):
        self.cell = cell
        self.inputs = Inputs(cell)
        self.photons = int(cell.workload["photons"])
        self.lanes = int(cell.workload["lanes"])

    def set_up(self) -> None:
        from repro_torch.core import simulator
        from repro_torch.kernels.photon_step import photon_step

        self.sim = simulator
        if self.cell.device.type == "cuda":
            photon_step.load(self.groups)
        self.volume = self.inputs.port_volume()
        self.cfg = self.inputs.port_config()

    def run(self, index: int, photons: int) -> Solution:
        seed = harness.solution_seed(self.cell.seed, index)
        first = harness.solution_ids(self.cell.seed, index)
        fixed = self.sim.simulate_fixed(
            self.volume, self.cfg, photons, self.lanes, seed,
            source=self.inputs.source, device=self.cell.device,
            id_offset=first)
        result = self.sim.to_sim_result(fixed)
        synchronize(self.cell.device)
        return Solution(index, seed, first, photons, fixed, result)

    def warm_up(self) -> None:
        self.run(-1, int(self.cell.workload["warmup_photons"]))

    def solve(self, index: int) -> Solution:
        return self.run(index, self.photons)

    def stats(self, sol: Solution) -> dict:
        return {"photons": sol.photons,
                "rounds": int(sol.fixed.steps) // int(self.cfg.steps_per_round)}

    def quick_check(self, sol: Solution) -> list[str]:
        """Every photon launched, each at weight 1."""
        faults = []
        if int(sol.fixed.n_launched) != sol.photons:
            faults.append(f"solution {sol.index}: n_launched "
                          f"{int(sol.fixed.n_launched)} != {sol.photons}")
        if int(sol.fixed.launched_w) != sol.photons << transport.TOTAL_SHIFT:
            faults.append(f"solution {sol.index}: launched weight off")
        return faults

    def reference(self, sol: Solution, control: bool = False):
        i = self.inputs
        return transport.forward(
            i.labels_dev, i.media_dev, i.shape, i.unit, i.physics, i.source,
            sol.seed, sol.first_id, sol.photons, control=control)

    def compare(self, sol: Solution, ref) -> dict:
        """Entries of the solution's int64 outputs that differ from the
        reference's (each limit 0: the sums are exact)."""
        f = sol.fixed
        totals = torch.tensor([int(f.escaped), int(f.timed_out),
                               int(f.launched_w), int(f.n_launched)])
        want = torch.tensor([ref.escaped, ref.timed_out, ref.launched_w,
                             ref.n_launched])
        return {"fluence_cells_off": differing(f.fluence.reshape(-1),
                                               ref.fluence),
                "exitance_cells_off": differing(f.exitance.reshape(-1),
                                                ref.exitance),
                "totals_off": differing(totals, want)}

    def release(self) -> None:
        """Drop the port's volume before the reference runs."""
        self.volume = None
