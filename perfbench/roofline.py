"""The photon-step kernel's least time on one H100, frozen.

The constants and their derivations are copied from ``chip_smoke.py``'s
``group_bound`` as of the benchmark's first version; a later change to
the kernel does not move them.

Peaks of the H100 SXM (NVIDIA data sheet): HBM3 3.35 TB/s; float32
outside the tensor cores 67 TFLOP/s.  That rate counts an FMA as two
operations; the kernel is built with ``--fmad=false`` and issues none,
so its float32 operations go at one per lane and clock, half of it.
Special functions (MUFU: rcp, sqrt, lg2, ex2, sin, cos) issue at 16 per
clock per SM on compute capability 9.0 (CUDA C++ Programming Guide,
arithmetic instruction throughput), at the 1.98 GHz boost clock.  The
peaks assume the card's full 700 W; the run prints its power limit
beside the share.

Work of one live lane-segment of ``csrc/photon_step.cu``, counted from
the source (scatter path, the common one): 5 uniforms (2 float ops
each), hop and wall distances (~30), deposit (~6), HG spin and
renormalize (~60), position, time and roulette updates (~20), gate
index (2): 130 float32 operations; log, exp, sin, cos, 4 square roots
and ~10 reciprocals for the IEEE divisions: 18 special-function
operations.

The least time of a solution is the larger of its operations over the
peak rates and its bytes over the HBM rate.  The operations come from
its live lane-segments, counted from its photons (live segments a
photon, measured by the plain reference and frozen in the cell's
file), so the count does not depend on what implements the kernel.
The bytes are what the solution must move: the labels and media read
once and each int64 grid written once.  A kernel that keeps photons in
registers for their whole path moves no lane state, so lane state is
not counted.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2
MUFU_OPS_PER_S = 16 * 132 * 1.98e9
F32_OPS_PER_SEGMENT = 130
MUFU_OPS_PER_SEGMENT = 18
FIXED_BYTES = 8


def least_seconds(live_segments: float, nvox: int, nxy: int,
                  n_media: int) -> dict:
    """Least time of the photon-step work of one CW solution: its
    ``live_segments``, on a volume of ``nvox`` voxels and ``nxy``
    exitance bins."""
    f32 = F32_OPS_PER_SEGMENT * live_segments / F32_OPS_PER_S
    mufu = MUFU_OPS_PER_SEGMENT * live_segments / MUFU_OPS_PER_S
    hbm = (nvox + 16 * n_media + FIXED_BYTES * (nvox + nxy)
           ) / HBM_BYTES_PER_S
    bound = {"float32": f32, "special functions": mufu, "bytes": hbm}
    by = max(bound, key=bound.get)
    return {"seconds": bound[by], "bound_by": by, **bound}
