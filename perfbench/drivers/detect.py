"""Jacobian solutions: a time-resolved detection forward, then its replay.

A solution is what a DOT or fNIRS user waits for before an inversion:
``core.simulator.simulate`` with detectors, a record buffer and the
round counters (as ``simulate_fixed`` and ``to_sim_result``, so the
int64 totals are at hand), ``replay.detected_records`` of its result,
and ``replay.replay_jacobian`` of those records, gate-resolved.  Both
halves are timed on the host clock, each ended by a device
synchronisation.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from perfbench import harness
from perfbench.port import Inputs, differing, synchronize
from perfbench.reference import transport


class Solution(NamedTuple):
    index: int
    seed: int
    first_id: int
    photons: int
    fixed: object     # the forward's FixedResult, on the device
    records: object   # (n, 4) uint32 [id_lo, id_hi, det, gate]
    replay: object    # the ReplayResult
    forward_s: float
    replay_s: float


def _by_id(rows: np.ndarray) -> np.ndarray:
    """The order of record rows by their 64-bit photon id."""
    ids = rows[:, 1].astype(np.uint64) << np.uint64(32) | rows[:, 0].astype(
        np.uint64)
    return np.argsort(ids, kind="stable")


class Driver:
    # the detection forward, then replay passes A and B
    groups = (1 | 2 | 8, 1 | 2, 4)

    def __init__(self, cell):
        self.cell = cell
        self.inputs = Inputs(cell)
        w = cell.workload
        self.photons = int(w["photons"])
        self.lanes = int(w["lanes"])
        self.slots = int(w["record_slots"])
        self.gate_resolved = bool(w["gate_resolved"])

    def set_up(self) -> None:
        from repro_torch import replay
        from repro_torch.core import simulator
        from repro_torch.kernels.photon_step import photon_step

        self.sim, self.replay = simulator, replay
        if self.cell.device.type == "cuda":
            photon_step.load(self.groups)
        self.volume = self.inputs.port_volume()
        self.cfg = self.inputs.port_config(
            collect_stats=bool(self.cell.workload["collect_stats"]))

    def run(self, index: int, photons: int) -> Solution:
        dev = self.cell.device
        seed = harness.solution_seed(self.cell.seed, index)
        first = harness.solution_ids(self.cell.seed, index)
        i = self.inputs
        t0 = time.perf_counter()
        fixed = self.sim.simulate_fixed(
            self.volume, self.cfg, photons, self.lanes, seed,
            source=i.source, device=dev, detectors=i.detectors,
            record_detected=self.slots, id_offset=first)
        result = self.sim.to_sim_result(fixed)
        records = self.replay.detected_records(result)
        synchronize(dev)
        t1 = time.perf_counter()
        rep = self.replay.replay_jacobian(
            self.volume, self.cfg, records, i.detectors, source=i.source,
            seed=seed, n_lanes=self.lanes, gate_resolved=self.gate_resolved,
            device=dev)
        synchronize(dev)
        t2 = time.perf_counter()
        return Solution(index, seed, first, photons, fixed, records, rep,
                        t1 - t0, t2 - t1)

    def warm_up(self) -> None:
        self.run(-1, int(self.cell.workload["warmup_photons"]))

    def solve(self, index: int) -> Solution:
        return self.run(index, self.photons)

    def stats(self, sol: Solution) -> dict:
        return {"photons": sol.photons, "forward_s": sol.forward_s,
                "replay_s": sol.replay_s, "records": int(sol.replay.n_records),
                "rounds": int(sol.fixed.steps)
                // int(self.cfg.steps_per_round)}

    def quick_check(self, sol: Solution) -> list[str]:
        """Every photon launched at weight 1, no record dropped, every
        record replayed at its own detector (the port's own claims)."""
        f, faults = sol.fixed, []
        if int(f.n_launched) != sol.photons or int(
                f.launched_w) != sol.photons << transport.TOTAL_SHIFT:
            faults.append(f"solution {sol.index}: launched photons off")
        if int(f.det_rec_overflow):
            faults.append(f"solution {sol.index}: {int(f.det_rec_overflow)} "
                          f"records dropped")
        if not np.array_equal(sol.replay.replayed_det, sol.replay.det):
            faults.append(f"solution {sol.index}: a record replayed off "
                          f"its detector")
        return faults

    def reference(self, sol: Solution, control: bool = False):
        i = self.inputs
        geom = i.det_geom()
        fwd = transport.forward(
            i.labels_dev, i.media_dev, i.shape, i.unit, i.physics, i.source,
            sol.seed, sol.first_id, sol.photons, det_geom=geom, record=True,
            control=control)
        order = torch.as_tensor(_by_id(fwd.records.cpu().numpy()),
                                device=fwd.records.device)
        records, w_exit = fwd.records[order], fwd.w_exit[order]
        n_det = geom.shape[0]
        ntg = i.physics.n_time_gates
        jac = transport.replay_jacobian(
            i.labels_dev, i.media_dev, i.shape, i.unit, i.physics, i.source,
            sol.seed, records, w_exit,
            n_det * ntg if self.gate_resolved else n_det,
            self.gate_resolved, control=control)
        return fwd, records, w_exit, jac

    def compare(self, sol: Solution, ref) -> dict:
        """Entries that differ from the reference's: the forward's int64
        grids, totals, counters and records, and the replay's per-record
        outputs and Jacobian (each limit 0: exact)."""
        fwd, records, w_exit, jac = ref
        f = sol.fixed
        got = torch.tensor([int(f.escaped), int(f.timed_out),
                            int(f.launched_w), int(f.n_launched),
                            int(f.counters[3]), int(f.counters[2])])
        want = torch.tensor([fwd.escaped, fwd.timed_out, fwd.launched_w,
                             fwd.n_launched, fwd.live_segments,
                             fwd.n_launched])
        out = {"fluence_cells_off": differing(f.fluence.reshape(-1),
                                              fwd.fluence),
               "exitance_cells_off": differing(f.exitance.reshape(-1),
                                               fwd.exitance),
               "totals_off": differing(got, want),
               "tpsf_cells_off": differing(f.det_w.reshape(-1), fwd.det_w),
               "ppath_sums_off": differing(f.det_ppath, fwd.det_ppath)}
        mine = np.asarray(sol.records, np.int64)
        order = _by_id(mine)
        want_rec = records.cpu().numpy()
        out["records_off"] = differing(torch.as_tensor(mine[order]),
                                       torch.as_tensor(want_rec))
        rep = sol.replay
        if mine.shape[0] == want_rec.shape[0]:
            w_got = torch.as_tensor(rep.w_exit[order])
            replayed = np.stack([rep.replayed_det[order], rep.gate[order]], 1)
            out["replay_records_off"] = differing(
                w_got, w_exit.cpu()) + differing(
                torch.as_tensor(replayed.astype(np.int64)),
                torch.as_tensor(want_rec[:, 2:4]))
        else:
            out["replay_records_off"] = max(mine.shape[0], want_rec.shape[0])
        jac_ref = (jac.to(torch.float64) * float(2.0 ** -transport.SHIFT["jac"])
                   ).cpu()
        out["jacobian_cells_off"] = differing(
            torch.from_numpy(rep.jacobian.reshape(-1)), jac_ref)
        return out

    def release(self) -> None:
        self.volume = None
