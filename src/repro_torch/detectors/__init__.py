"""Detectors on the z=0 (illuminated) face: TPSF and partial pathlengths.

Besides the fluence volume, MCX's main diffuse-optics output is the set
of detected photons: packets that leave the domain through a detector
aperture, with their time of flight and per-medium partial pathlengths.
The lock-step engine keeps fixed-shape accumulators instead of growing
lists:

  * A :class:`Detector` is a disk on the z=0 face: ``(x, y)`` centre
    and ``radius`` in voxel units.
  * Capture uses the exitance image's z=0-face predicate
    (``photon.Z_EXIT_FACE_VOX``), so every detected packet is part of
    the exitance.
  * Per detector the engine keeps a ``(n_det, n_time_gates)``
    detected-weight histogram (the TPSF) and a ``(n_det, n_media)``
    weight-weighted partial-pathlength sum; their ratio is the mean
    partial pathlength per medium.
  * Overlapping disks: a photon is credited to the first (lowest
    index) detector whose disk holds the exit point, as in MCX.

The capture arithmetic here is what the CUDA kernel
(``kernels/photon_step/csrc/photon_step.cu``) repeats lane by lane:
``dx*dx + dy*dy <= r^2`` in float32, in that order.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.fixed import to_fixed
from repro_torch.core.photon import Z_EXIT_FACE_VOX
from repro_torch.kernels.photon_step.spec import FIXED_SHIFT


@dataclasses.dataclass(frozen=True)
class Detector:
    """One detector disk on the z=0 face (voxel units)."""

    x: float
    y: float
    radius: float

    def __post_init__(self):
        if self.radius <= 0:
            raise ValueError(f"detector radius must be > 0, got {self.radius}")


def as_detectors(spec) -> tuple[Detector, ...]:
    """Coerce a detector spec into a tuple of :class:`Detector`.

    Accepts ``None`` (no detectors), an iterable of :class:`Detector`,
    ``(x, y, radius)`` triples, or ``{"x": .., "y": .., "radius": ..}``
    dicts (the CLI's ``--detectors`` JSON form).
    """
    if spec is None:
        return ()
    out = []
    for d in spec:
        if isinstance(d, Detector):
            out.append(d)
        elif isinstance(d, dict):
            out.append(Detector(float(d["x"]), float(d["y"]),
                                float(d["radius"])))
        else:
            x, y, r = d
            out.append(Detector(float(x), float(y), float(r)))
    return tuple(out)


def to_dicts(detectors: Sequence[Detector]) -> list[dict]:
    """JSON-friendly form (inverse of :func:`as_detectors`)."""
    return [{"x": d.x, "y": d.y, "radius": d.radius} for d in detectors]


def validate_detectors(detectors: Sequence[Detector],
                       shape: tuple[int, int, int]) -> None:
    """Reject a disk that does not meet the ``[0, nx] x [0, ny]``
    footprint of the z=0 face: it could never capture a photon (most
    often a mm-for-voxel mistake)."""
    nx, ny = float(shape[0]), float(shape[1])
    for i, d in enumerate(detectors):
        # distance from the disk centre to the nearest point of the
        # footprint (0 when the centre lies inside it)
        dx = max(0.0 - d.x, 0.0, d.x - nx)
        dy = max(0.0 - d.y, 0.0, d.y - ny)
        if dx * dx + dy * dy >= d.radius * d.radius:
            raise ValueError(
                f"detector {i} (x={d.x}, y={d.y}, radius={d.radius}) lies "
                f"entirely outside the z=0 face of the volume (footprint "
                f"[0, {nx}] x [0, {ny}] voxels) and can never capture a "
                f"photon; detector coordinates are in voxel units on the "
                f"z=0 face")


def det_geometry(detectors: Sequence[Detector], device="cpu") -> torch.Tensor:
    """``(n_det, 3)`` float32 rows of ``(x, y, radius^2)`` on ``device``;
    ``radius^2`` is formed in double and rounded once."""
    rows = [[d.x, d.y, d.radius * d.radius] for d in detectors]
    return torch.tensor(np.asarray(rows, np.float32).reshape(-1, 3),
                        device=device)


def detector_bins(esc_pos, esc_w, det_geom):
    """Match z=0-face escapes against the detector disks.

    Returns ``(det_idx, w)``: per lane the int64 index of the first
    detector whose disk holds the exit point, and the weight to credit
    it (0 for lanes that did not leave through the z=0 face or missed
    every disk; their index is 0, so a masked scatter stays in range).
    ``det_geom`` is ``(n_det, 3)``, or ``(N, n_det, 3)``: each lane's
    own disks (lanes of several scenarios).
    """
    z_exit = esc_pos[:, 2] < Z_EXIT_FACE_VOX
    geom = det_geom if det_geom.ndim == 3 else det_geom[None]
    dx = esc_pos[:, None, 0] - geom[:, :, 0]   # (N, n_det)
    dy = esc_pos[:, None, 1] - geom[:, :, 1]
    inside = (dx * dx + dy * dy) <= geom[:, :, 2]
    hit_any = inside.any(dim=1) & z_exit & (esc_w > 0)
    det_idx = torch.argmax(inside.to(torch.uint8), dim=1)  # first match
    return det_idx, torch.where(hit_any, esc_w, torch.zeros_like(esc_w))


def accumulate_capture(pp, dw, dp, res, gate, det_geom, ntg,
                       lane_scenario=None):
    """One segment of detector bookkeeping.

    Adds the segment's path to the lane's per-medium ``pp``
    ``(N, n_media)`` *before* the capture test (a photon escaping in
    this segment is recorded with it), then adds detected weight into
    the flat gate-major TPSF ``dw`` ``(n_det * ntg,)`` and the weighted
    path sums ``dp`` ``(n_det, n_media)``.  A float grid sums the
    float32 values in its dtype; an int64 grid sums them in fixed point
    (``core.fixed``, the photon-step kernel's grids), in place.  ``res``
    is the segment's ``photon.StepResult`` and ``gate`` its per-lane
    time gate.  With ``lane_scenario`` (each lane's scenario) the grids
    are S scenarios' stacked, ``(S * n_det * ntg,)`` and
    ``(S * n_det, n_media)``, and ``det_geom`` is per lane.  Returns the
    new ``(pp, dw, dp)``.
    """
    n_media = pp.shape[1]
    med_cols = torch.arange(n_media, device=pp.device)[None, :]
    pp = pp + torch.where(res.seg_med[:, None] == med_cols,
                          res.seg_len[:, None], torch.zeros_like(pp))
    didx, dwgt = detector_bins(res.esc_pos, res.esc_w, det_geom)
    n_det = det_geom.shape[-2]
    tpsf_at, sums_at = didx * ntg + gate, didx
    if lane_scenario is not None:
        tpsf_at = tpsf_at + lane_scenario * (n_det * ntg)
        sums_at = sums_at + lane_scenario * n_det
    weighted = dwgt[:, None] * pp
    if dw.dtype == torch.int64:
        dw.index_add_(0, tpsf_at, to_fixed(dwgt, FIXED_SHIFT["det_w"]))
        dp.index_add_(0, sums_at, to_fixed(weighted, FIXED_SHIFT["det_ppath"]))
        return pp, dw, dp
    dw = dw.index_add(0, tpsf_at, dwgt.to(dw.dtype))
    dp = dp.index_add(0, sums_at, weighted.to(dp.dtype))
    return pp, dw, dp


def update_capture(cap_det, cap_gate, res, gate, det_geom):
    """One segment of detected-photon bookkeeping.

    ``cap_det`` / ``cap_gate`` are per-lane int32: the detector (-1:
    none) and exit gate of the lane's capture in this round.  A lane
    captures at most once a round (escape ends it, and regeneration
    runs between rounds), so a masked select is enough.
    """
    didx, dwgt = detector_bins(res.esc_pos, res.esc_w, det_geom)
    newly = dwgt > 0
    cap_det = torch.where(newly, didx.to(torch.int32), cap_det)
    cap_gate = torch.where(newly, gate.to(torch.int32), cap_gate)
    return cap_det, cap_gate
