"""Fleet solutions: an optode sweep through ``scenarios.simulate_many``.

A fleet is the workload's scenarios, one per source position (the
source stepped by ``source_step`` voxels from the workload's ``source``),
each with the workload's photons and detectors, one seed, and disjoint
64-bit id ranges; ``simulate_many`` batches them (one group, one launch
a round).  The fleet's wall is timed on the host clock to a device
synchronisation, and its ``scenarios.batch`` span read from the port's
``Tracer``.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from perfbench import harness
from perfbench.port import Inputs, differing, synchronize
from perfbench.reference import transport


class Solution(NamedTuple):
    index: int
    seed: int
    first_id: int
    photons: int            # a scenario's
    sources: list
    results: list           # the SimResults, in scenario order
    fleet_s: float
    batch_s: float          # inside the scenarios.batch spans


class Driver:
    groups = (1,)     # the detector group, S scenarios a launch

    def __init__(self, cell):
        self.cell = cell
        self.inputs = Inputs(cell)
        w = cell.workload
        self.photons = int(w["photons"])
        self.lanes = int(w["lanes"])
        self.n = int(w["scenarios"])
        step = w["source_step"]
        base = dict(w["source"])
        self.sources = [dict(base, pos=[p + k * d for p, d in
                                        zip(base["pos"], step)])
                        for k in range(self.n)]

    def set_up(self) -> None:
        from repro_torch import scenarios
        from repro_torch.kernels.photon_step import photon_step
        from repro_torch.telemetry import Tracer

        self.scenarios, self.tracer_cls = scenarios, Tracer
        if self.cell.device.type == "cuda":
            photon_step.load(self.groups)
        self.volume = self.inputs.port_volume()
        self.cfg = self.inputs.port_config()

    def run(self, index: int, photons: int) -> Solution:
        dev = self.cell.device
        seed = harness.solution_seed(self.cell.seed, index)
        first = harness.solution_ids(self.cell.seed, index)
        tracer = self.tracer_cls()
        t0 = time.perf_counter()
        fleet = [self.scenarios.Scenario(
            self.volume, self.cfg, photons, seed=seed, source=src,
            detectors=self.inputs.detectors, id_offset=first + k * photons)
            for k, src in enumerate(self.sources)]
        results = self.scenarios.simulate_many(
            fleet, n_lanes=self.lanes, device=dev, tracer=tracer)
        synchronize(dev)
        fleet_s = time.perf_counter() - t0
        batch_s = sum(e.dur for e in tracer.events
                      if e.name == "scenarios.batch")
        return Solution(index, seed, first, photons, self.sources, results,
                        fleet_s, batch_s)

    def warm_up(self) -> None:
        self.run(-1, int(self.cell.workload["warmup_photons"]))

    def solve(self, index: int) -> Solution:
        return self.run(index, self.photons)

    def stats(self, sol: Solution) -> dict:
        return {"photons": sol.photons * self.n, "fleet_s": sol.fleet_s,
                "batch_s": sol.batch_s,
                "rounds": max(int(r.steps) for r in sol.results)
                // int(self.cfg.steps_per_round)}

    def quick_check(self, sol: Solution) -> list[str]:
        """Every scenario's photons launched, each at weight 1."""
        faults = []
        for k, r in enumerate(sol.results):
            if int(r.n_launched) != sol.photons or float(
                    r.launched_w) != float(sol.photons):
                faults.append(f"fleet {sol.index} scenario {k}: launched "
                              f"photons off")
        return faults

    def reference(self, sol: Solution, control: bool = False) -> list:
        i = self.inputs
        return transport.forward_many(
            i.labels_dev, i.media_dev, i.shape, i.unit, i.physics,
            sol.sources, sol.seed,
            [sol.first_id + k * sol.photons for k in range(self.n)],
            sol.photons, det_geom=i.det_geom(), control=control)

    def compare(self, sol: Solution, ref: list) -> dict:
        """Entries of each scenario's ``SimResult`` that differ from the
        reference's int64 sums converted as the port converts them
        (each limit 0: exact)."""
        sh = transport.SHIFT

        def conv(x, shift):
            return x.to(torch.float32) * float(2.0 ** -shift)

        out = dict.fromkeys(("fluence_cells_off", "exitance_cells_off",
                             "totals_off", "tpsf_cells_off",
                             "ppath_sums_off"), 0)
        for r, f in zip(sol.results, ref):
            dev = f.fluence.device
            scalars = torch.tensor([f.escaped, f.timed_out, f.launched_w],
                                   dtype=torch.int64, device=dev)
            got = torch.stack([torch.as_tensor(x, device=dev).reshape(())
                               for x in (r.escaped_w, r.timed_out_w,
                                         r.launched_w)])
            out["fluence_cells_off"] += differing(
                r.energy.reshape(-1), conv(f.fluence, sh["fluence"]))
            out["exitance_cells_off"] += differing(
                r.exitance.reshape(-1), conv(f.exitance, sh["exitance"]))
            out["totals_off"] += differing(
                got, conv(scalars, transport.TOTAL_SHIFT)) + int(
                int(r.n_launched) != f.n_launched)
            out["tpsf_cells_off"] += differing(
                r.det_w.reshape(-1), conv(f.det_w, sh["det_w"]))
            out["ppath_sums_off"] += differing(
                r.det_ppath, conv(f.det_ppath, sh["det_ppath"]))
        return out

    def release(self) -> None:
        self.volume = None
