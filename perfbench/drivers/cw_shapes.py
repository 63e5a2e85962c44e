"""CW solutions on a volume built from MCX's shape list.

B1's CW driver (``drivers/cw.py``) with two differences.  The port's
volume comes from the port's own code: the preset the configuration
names (``volume.port_preset``, e.g. ``benchmark_skinvessel``, the path
the CLI runs), or else its rasteriser of the shape list
(``core.volume.volume_from_shapes``).  The reference's labels come from
``perfbench/shapes.py``, which shares no code with the port's.  So the
comparison adds ``labels_off``: voxels whose labels differ between the
two, limit 0.
"""

from __future__ import annotations

import torch

from perfbench import shapes
from perfbench.drivers import cw
from perfbench.port import Inputs, differing
from perfbench.reference.step import Physics


class ShapeInputs(Inputs):
    """:class:`perfbench.port.Inputs` of a volume given as MCX shapes."""

    def __init__(self, cell):
        self.cell = cell
        self.labels, self.media, self.unit = shapes.build(
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
        self.detectors = []

    def port_volume(self):
        from repro_torch.core import volume as V

        vol, dev = self.cell.config["volume"], self.cell.device
        preset = vol.get("port_preset")
        if preset:
            return getattr(V, preset)(device=dev)
        media = [V.AIR] + [V.Medium(m["mua"], m["mus"], m["g"], m["n"])
                           for m in vol["media"]]
        return V.volume_from_shapes(vol["shapes"], media,
                                    float(vol["unitinmm"]), device=dev)


class Driver(cw.Driver):

    def __init__(self, cell):
        self.cell = cell
        self.inputs = ShapeInputs(cell)
        self.photons = int(cell.workload["photons"])
        self.lanes = int(cell.workload["lanes"])

    def set_up(self) -> None:
        """The port's volume first: a port without the configuration's
        function fails here, in a second, before any kernel is built."""
        self.volume = self.inputs.port_volume()
        # the labels the port ran, kept for the comparison after release()
        self.port_labels = self.volume.labels
        from repro_torch.core import simulator
        from repro_torch.kernels.photon_step import photon_step

        self.sim = simulator
        if self.cell.device.type == "cuda":
            photon_step.load(self.groups)
        self.cfg = self.inputs.port_config()

    def compare(self, sol, ref) -> dict:
        out = super().compare(sol, ref)
        out["labels_off"] = differing(self.port_labels.reshape(-1),
                                      self.inputs.labels_dev)
        return out
