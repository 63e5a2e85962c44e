"""Registered source types.

Positions are in voxel units; directions need not be normalized.  Each
type documents its launch-stream draw count (``N_DRAWS``).  This part of
the port has the pencil beam, the paper's configuration; the other
source types of the reference follow in a later part.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import rng as xrng
from repro_torch.sources import base

Vec3 = tuple[float, float, float]


@base.register("pencil")
@dataclasses.dataclass(frozen=True)
class Pencil:
    """Zero-width collimated beam (consumes no launch-stream draws)."""

    pos: Vec3 = (30.0, 30.0, 0.0)
    dir: Vec3 = (0.0, 0.0, 1.0)

    N_DRAWS = 0

    def sample(self, photon_ids, seed):
        ids = xrng.as_photon_id(photon_ids)
        n, dev = ids.lo.shape[0], ids.lo.device
        pos = torch.tensor(self.pos, dtype=torch.float32, device=dev)
        direc = base.unit(self.dir).to(dev)
        return (pos.expand(n, 3), direc.expand(n, 3),
                torch.ones((n,), dtype=torch.float32, device=dev),
                base.flight_stream(seed, ids))
