"""What the drivers hand the port and the reference, from a cell's files.

The port (``repro_torch``) is imported by the drivers while the run is
set up; this module imports nothing of it itself.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import volumes
from perfbench.reference.step import Physics


class Inputs:
    """A cell's volume arrays (host and device), physics and source."""

    def __init__(self, cell):
        self.cell = cell
        self.labels, self.media, self.unit = volumes.build(
            cell.config["volume"])
        self.shape = tuple(int(s) for s in self.labels.shape)
        dev = cell.device
        self.labels_dev = torch.as_tensor(self.labels.reshape(-1),
                                          device=dev)
        self.media_dev = torch.as_tensor(self.media, device=dev)
        w = cell.workload
        phys = cell.config["physics"]
        self.physics = Physics(
            do_reflect=bool(phys["do_reflect"]),
            tmax_ns=float(w.get("tmax_ns", phys["tmax_ns"])),
            w_threshold=float(phys["w_threshold"]),
            roulette_m=float(phys["roulette_m"]),
            n_time_gates=int(w.get("time_gates", 1)))
        self.source = dict(w.get("source", cell.config["source"]))
        self.detectors = [dict(d) for d in w.get("detectors", ())]

    def det_geom(self):
        """``(n_det, 3)`` float32 rows of ``(x, y, r**2)``, ``r**2``
        formed in double and rounded once, as the port forms them."""
        if not self.detectors:
            return None
        rows = [[d["x"], d["y"], float(d["radius"]) * float(d["radius"])]
                for d in self.detectors]
        return torch.as_tensor(np.asarray(rows, np.float32),
                               device=self.cell.device)

    def port_volume(self):
        from repro_torch.core.volume import volume_from_arrays

        return volume_from_arrays(self.labels, self.media, self.unit,
                                  device=self.cell.device)

    def port_config(self, **extra):
        from repro_torch.core.volume import SimConfig

        p = self.physics
        phys = self.cell.config["physics"]
        kw = dict(do_reflect=p.do_reflect, tmax_ns=p.tmax_ns,
                  w_threshold=p.w_threshold, roulette_m=p.roulette_m,
                  n_time_gates=p.n_time_gates,
                  steps_per_round=int(self.cell.workload["steps_per_round"]))
        if "max_steps" in phys:
            kw["max_steps"] = int(phys["max_steps"])
        kw.update(extra)
        return SimConfig(**kw)


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def differing(a, b) -> int:
    """Entries that differ between two arrays of one shape (all of them
    when the shapes differ)."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b).to(a.device)
    if a.shape != b.shape:
        return max(a.numel(), b.numel(), 1)
    return int((a.reshape(-1) != b.reshape(-1)).sum())
