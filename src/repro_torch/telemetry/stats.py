"""Round-level simulation counters, host data.

A copy of the reference's ``RoundStats`` (the port keeps its own copy of
what it needs from the JAX package).  With ``SimConfig.collect_stats``
the simulator adds per-round counters on the device, next to the
physics totals, and returns them as a ``RoundStats`` of numpy scalars on
``SimResult.stats``.  The counters only read values the round already
computes: collecting them changes no physics output.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class RoundStats(NamedTuple):
    """Per-run totals of the round-level counters.

    All fields are numpy scalars.  ``lane_occupancy()`` is the headline
    derived metric: the fraction of executed lane-segments that carried
    a live photon (1.0 means no masked-lane waste); its falloff with
    ``steps_per_round`` measures what fused rounds cost in idle lanes.
    """

    rounds: np.ndarray          # () int32 outer while-loop rounds executed
    regen_rounds: np.ndarray    # () int32 rounds whose regeneration
    #                             relaunched >= 1 photon
    relaunched: np.ndarray      # () int32 photons launched via regeneration
    #                             (== SimResult.n_launched; reconciled in
    #                             tests)
    live_segments: np.ndarray   # () float32 lane-segments entered with a
    #                             live photon (summed over every segment of
    #                             every round)
    lane_segments: np.ndarray   # () float32 lane-segments executed in
    #                             total: rounds * K * n_lanes — the
    #                             occupancy denominator
    deposited_w: np.ndarray     # () float32 weight deposited (Beer-Lambert
    #                             absorption); reconciles with
    #                             sum(SimResult.energy) to fp order
    escaped_w: np.ndarray       # () float32 weight escaping the domain —
    #                             bit-equal to SimResult.escaped_w (same
    #                             accumulation)
    timed_out_w: np.ndarray     # () float32 weight retired by tmax_ns /
    #                             max_steps — bit-equal to
    #                             SimResult.timed_out_w
    detected_w: np.ndarray      # () float32 weight captured by detector
    #                             disks; reconciles with sum(det_w)

    def lane_occupancy(self) -> float:
        """Live-lane fraction of all executed lane-segments, in [0, 1]."""
        denom = float(self.lane_segments)
        return float(self.live_segments) / denom if denom > 0 else 0.0

    def to_dict(self) -> dict:
        """JSON-friendly counters + derived occupancy (metrics sinks)."""
        out = {k: (int(v) if k in _INT_FIELDS else float(v))
               for k, v in zip(self._fields, self)}
        out["lane_occupancy"] = self.lane_occupancy()
        return out

    @classmethod
    def from_vector(cls, values) -> "RoundStats":
        """Rebuild from a numeric vector in field order (checkpoints)."""
        return cls(*(np.int32(v) if f in _INT_FIELDS else np.float32(v)
                     for f, v in zip(cls._fields, values)))

    @classmethod
    def zeros(cls) -> "RoundStats":
        """Host-side numpy zeros (an accumulator for scheduler merges)."""
        return cls(*(np.int32(0) if f in _INT_FIELDS else np.float32(0.0)
                     for f in cls._fields))

    def add(self, other: "RoundStats") -> "RoundStats":
        """Field-wise sum (host-side merge across shards / chunks).

        Totals are additive across disjoint photon subsets by
        construction; ``lane_occupancy`` of the merged struct is the
        work-weighted mean of the parts.
        """
        return RoundStats(*(np.asarray(a) + np.asarray(b)
                            for a, b in zip(self, other)))


_INT_FIELDS = ("rounds", "regen_rounds", "relaunched")
