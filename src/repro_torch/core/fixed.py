"""Fixed-point sums that do not depend on the order of the adds.

Fluence, exitance, TPSFs, detector path sums and the replay Jacobian
are int64 counts of ``2**-shift`` units (``kernels/photon_step/spec.py``:
``FIXED_SHIFT`` by output, with their range and resolution): each
float32 deposit is rounded once, to nearest with ties to even as the
CUDA kernel's ``__float2ll_rn(v * 2**shift)`` rounds it, and integer
addition is associative, so a sum has the same bits in any order, on
any device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.photon_step import spec


def to_fixed(v: torch.Tensor, shift: int) -> torch.Tensor:
    """float32 ``v`` as int64 units of ``2**-shift``; raises
    ``OverflowError`` for a deposit of ``spec.DEPOSIT_LIMIT`` units or
    more, or not finite, which the kernel flags."""
    x = v * float(2**shift)  # exact: a power-of-two scale in float32
    if not bool((x < spec.DEPOSIT_LIMIT).all()):
        raise OverflowError(f"a deposit of 2**44 units of 2**-{shift} or "
                            f"more, or not finite")
    return torch.round(x).to(torch.int64)


def from_fixed(x: torch.Tensor, shift: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int64 units of ``2**-shift`` as ``dtype`` (float32 or float64),
    rounded once (the power-of-two scale is exact)."""
    return x.to(dtype) * float(2.0**-shift)
