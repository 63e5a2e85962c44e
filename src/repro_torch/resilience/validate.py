"""Merge-guard validation of per-chunk results.

A corrupted chunk that reaches the host-side accumulator poisons the
whole campaign, and a silently short-launched chunk skews the
normalization.  The schedulers therefore harvest every chunk to the host
first and run it through :func:`validate_chunk` *before* merging; a
rejected chunk is requeued (its replay is bit-identical) instead of
corrupting the accumulator.

The harvest is a chunk's ``core.simulator.FixedResult`` on the CPU:
int64 fixed-point grids and totals, which add exactly in any order, so
a campaign merged from harvests has the bits of one run over the same
photons.  An int64 total cannot hold a NaN; what corruption or an
overflowed sum leaves in it is a negative value.  Checks, in order of
cost:

  * a chunk launched exactly the photons it was assigned
    (``n_launched == chunk.count``);
  * no total is negative (a wrapped fixed-point sum, or a corrupted
    cell);
  * the per-chunk energy balance closes: ``launched_w = absorbed +
    escaped + timed_out + roulette residue`` with ``|residue| /
    launched_w <= max_residue_frac``.  The residue of a healthy chunk
    is the unbiased Russian-roulette leftover (|residue_frac| < 1e-4
    for the benchmark volumes); the default tolerance of 5e-3 leaves
    headroom for very small chunks while still rejecting any
    corruption large enough to matter.
"""

from __future__ import annotations

import torch

from repro_torch.core import simulator as S
from repro_torch.kernels.photon_step import spec

# the fields a harvest's checks read, and their fixed-point shifts
_SHIFTS = {"fluence": spec.FIXED_SHIFT["fluence"],
           "exitance": spec.FIXED_SHIFT["exitance"],
           "det_w": spec.FIXED_SHIFT["det_w"],
           "det_ppath": spec.FIXED_SHIFT["det_ppath"],
           "escaped": spec.TOTAL_SHIFT, "timed_out": spec.TOTAL_SHIFT,
           "launched_w": spec.TOTAL_SHIFT}


def harvest_result(fixed: S.FixedResult) -> S.FixedResult:
    """Copy one chunk's ``FixedResult`` to the CPU (waits for its
    device), detached from device memory, for the schedulers to buffer,
    validate and merge: ``det_rec`` trimmed to its valid rows (a sharded
    result's buffers reassembled) with ``det_rec_n`` their count, so
    buffered copies don't pin the full capacity buffer, and ``steps``
    the longest shard's."""
    cpu = S.FixedResult(*(x.cpu() if isinstance(x, torch.Tensor) else x
                          for x in fixed))
    n = cpu.det_rec_n.reshape(-1).tolist()
    cap = cpu.det_rec.shape[0] // len(n)
    rec = torch.cat([cpu.det_rec[i * cap: i * cap + k]
                     for i, k in enumerate(n)]).reshape(-1, 4)
    return cpu._replace(det_rec=rec, det_rec_n=torch.tensor(rec.shape[0]),
                        steps=int(torch.as_tensor(cpu.steps).max()))


def weight(harvest: S.FixedResult, field: str) -> float:
    """A harvest field's weight as a float64: the sum of a grid, or a
    scalar total, converted from its fixed point."""
    return float(getattr(harvest, field).sum()) * 2.0**-_SHIFTS[field]


def validate_chunk(harvest: S.FixedResult, expected_photons: int | None = None,
                   max_residue_frac: float = 5e-3) -> list[str]:
    """Validate one harvested chunk; returns a list of defects (empty =
    the chunk is safe to merge)."""
    errs: list[str] = []
    if expected_photons is not None and \
            int(harvest.n_launched) != int(expected_photons):
        errs.append(f"launched {int(harvest.n_launched)} photons, chunk "
                    f"assigned {int(expected_photons)}")
    for k in _SHIFTS:
        t = getattr(harvest, k)
        if t.numel() and int(t.min()) < 0:
            errs.append(f"{k} contains a negative total (min {int(t.min())} "
                        f"fixed-point units: corrupted, or a sum past "
                        f"2**63 - 1)")
    if errs:
        # the residue check below would just re-report the defect
        return errs
    launched = weight(harvest, "launched_w")
    absorbed = weight(harvest, "fluence")
    escaped = weight(harvest, "escaped")
    timed_out = weight(harvest, "timed_out")
    frac = (launched - absorbed - escaped - timed_out) / max(launched, 1.0)
    if abs(frac) > max_residue_frac:
        errs.append(f"energy-balance residue {frac:.3e} of launched "
                    f"weight exceeds {max_residue_frac:.1e} "
                    f"(launched={launched:.4f}, absorbed={absorbed:.4f}, "
                    f"escaped={escaped:.4f}, timed_out={timed_out:.4f})")
    return errs


def corrupt_harvest(harvest: S.FixedResult) -> S.FixedResult:
    """Corrupt one harvested chunk (the FaultInjector's ``p_nan``
    fault), on a copy so device results and other chunks are untouched:
    the first fluence cell becomes the int64 minimum, the bits a
    fixed-point sum leaves when it wraps, which ``validate_chunk``
    rejects as a negative total."""
    fluence = harvest.fluence.clone()
    fluence.view(-1)[0] = torch.iinfo(torch.int64).min
    return harvest._replace(fluence=fluence)
