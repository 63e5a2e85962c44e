"""Time-resolved detection forwards on a volume built from MCX's shapes.

A solution is the forward half of ``drivers/detect.py`` (no replay):
``core.simulator.simulate`` with the probe's detectors and a record
buffer, as ``simulate_fixed`` and ``to_sim_result`` so that the int64
totals are at hand, then ``replay.detected_records`` of its result, the
records a DOT or fNIRS user replays into a Jacobian.  The volume is
``drivers/cw_shapes.py``'s: the port's preset (``volume.port_preset``)
against the reference's labels from ``perfbench/shapes.py``.  The probe
is the configuration's (``source``, ``detectors``), which the workload
may replace.  The comparison adds ``labels_off``, ``tpsf_cells_off``,
``ppath_sums_off`` and ``records_off`` (records in the order of their
64-bit ids) to the CW numbers, each limit 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from perfbench import harness
from perfbench.drivers.cw_shapes import ShapeInputs
from perfbench.drivers.detect import _by_id
from perfbench.port import differing, synchronize
from perfbench.reference import transport


class Solution(NamedTuple):
    index: int
    seed: int
    first_id: int
    photons: int
    fixed: object     # the forward's FixedResult, on the device
    records: object   # (n, 4) uint32 [id_lo, id_hi, det, gate]


class Driver:
    groups = (1 | 2,)     # detectors and records, no stats

    def __init__(self, cell):
        self.cell = cell
        w = cell.workload
        self.inputs = ShapeInputs(cell)
        self.inputs.detectors = [dict(d) for d in w.get(
            "detectors", cell.config["detectors"])]
        self.photons = int(w["photons"])
        self.lanes = int(w["lanes"])
        self.slots = int(w["record_slots"])

    def set_up(self) -> None:
        """The port's volume first: a port without the configuration's
        preset fails here, in a second, before any kernel is built."""
        self.volume = self.inputs.port_volume()
        # the labels the port ran, kept for the comparison after release()
        self.port_labels = self.volume.labels
        from repro_torch import replay
        from repro_torch.core import simulator
        from repro_torch.kernels.photon_step import photon_step

        self.sim, self.replay = simulator, replay
        if self.cell.device.type == "cuda":
            photon_step.load(self.groups)
        self.cfg = self.inputs.port_config()

    def run(self, index: int, photons: int) -> Solution:
        dev = self.cell.device
        seed = harness.solution_seed(self.cell.seed, index)
        first = harness.solution_ids(self.cell.seed, index)
        i = self.inputs
        fixed = self.sim.simulate_fixed(
            self.volume, self.cfg, photons, self.lanes, seed,
            source=i.source, device=dev, detectors=i.detectors,
            record_detected=self.slots, id_offset=first)
        result = self.sim.to_sim_result(fixed)
        records = self.replay.detected_records(result)
        synchronize(dev)
        return Solution(index, seed, first, photons, fixed, records)

    def warm_up(self) -> None:
        self.run(-1, int(self.cell.workload["warmup_photons"]))

    def solve(self, index: int) -> Solution:
        return self.run(index, self.photons)

    def stats(self, sol: Solution) -> dict:
        return {"photons": sol.photons, "records": int(sol.records.shape[0]),
                "rounds": int(sol.fixed.steps)
                // int(self.cfg.steps_per_round)}

    def quick_check(self, sol: Solution) -> list[str]:
        """Every photon launched at weight 1, no record dropped, and
        every record at one of the probe's detectors (the port's own
        claims)."""
        f, faults = sol.fixed, []
        if int(f.n_launched) != sol.photons or int(
                f.launched_w) != sol.photons << transport.TOTAL_SHIFT:
            faults.append(f"solution {sol.index}: launched photons off")
        if int(f.det_rec_overflow):
            faults.append(f"solution {sol.index}: {int(f.det_rec_overflow)} "
                          f"records dropped")
        det = sol.records[:, 2].astype(np.int64)
        if det.size and (det.min() < 0
                         or det.max() >= len(self.inputs.detectors)):
            faults.append(f"solution {sol.index}: a record off the probe's "
                          f"detectors")
        return faults

    def reference(self, sol: Solution, control: bool = False):
        i = self.inputs
        fwd = transport.forward(
            i.labels_dev, i.media_dev, i.shape, i.unit, i.physics, i.source,
            sol.seed, sol.first_id, sol.photons, det_geom=i.det_geom(),
            record=True, control=control)
        order = torch.as_tensor(_by_id(fwd.records.cpu().numpy()),
                                device=fwd.records.device)
        return fwd, fwd.records[order]

    def compare(self, sol: Solution, ref) -> dict:
        """Entries that differ from the reference's: the int64 grids,
        totals, TPSF, path sums and records, and the labels (each limit
        0: exact)."""
        fwd, records = ref
        f = sol.fixed
        got = torch.tensor([int(f.escaped), int(f.timed_out),
                            int(f.launched_w), int(f.n_launched)])
        want = torch.tensor([fwd.escaped, fwd.timed_out, fwd.launched_w,
                             fwd.n_launched])
        mine = np.asarray(sol.records, np.int64)
        return {"fluence_cells_off": differing(f.fluence.reshape(-1),
                                               fwd.fluence),
                "exitance_cells_off": differing(f.exitance.reshape(-1),
                                                fwd.exitance),
                "totals_off": differing(got, want),
                "tpsf_cells_off": differing(f.det_w.reshape(-1), fwd.det_w),
                "ppath_sums_off": differing(f.det_ppath, fwd.det_ppath),
                "records_off": differing(torch.as_tensor(mine[_by_id(mine)]),
                                         records.cpu()),
                "labels_off": differing(self.port_labels.reshape(-1),
                                        self.inputs.labels_dev)}

    def release(self) -> None:
        """Drop the port's volume before the reference runs."""
        self.volume = None
