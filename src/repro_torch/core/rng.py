"""Counter-seeded xorshift128 RNG used by the photon transport engine.

Marsaglia xorshift128 with four 32-bit words of state per photon lane,
seeded by splitmix32 rounds of ``seed ^ photon_id`` so that every photon
has its own reproducible stream whichever lane or device runs it.  The
same bit-level algorithm runs here and in the CUDA kernel
(``kernels/photon_step/csrc/photon_step.cu``), so the two agree bit for
bit.

PyTorch on the CPU has no shift, add or compare for ``torch.uint32``,
so this module carries every 32-bit word as ``torch.int64`` holding a
value in ``[0, 2**32)``: each operation that can leave that range is
masked with ``0xFFFFFFFF``.  Products with the 32-bit mixing constants
are split into 16-bit halves so no intermediate exceeds 2**48 and int64
never overflows.  The kernel uses native ``uint32_t``.

Photon ids are 64-bit, carried as a :class:`PhotonId` ``(lo, hi)`` pair
of such words.  A zero high word contributes nothing, so ids below
2**32 seed exactly as a single-word id would.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MASK32 = 0xFFFFFFFF
# splitmix32 constants (Steele et al., "Fast splittable PRNGs")
_GOLDEN = 0x9E3779B9
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35
# odd multiplier folding the high id word into the chain (a bijection
# on 32-bit words; 0 maps to 0)
_HI_MULT = 0x85EBCA77
_ID_MULT = 0x9E3779B1
_ZERO_FIX = 0xDEADBEEF
_U24_SCALE = 2.0**-24


class PhotonId(NamedTuple):
    """A 64-bit global photon id as two 32-bit words in int64 tensors."""

    lo: torch.Tensor
    hi: torch.Tensor

    @property
    def shape(self):
        return self.lo.shape


def as_photon_id(ids) -> PhotonId:
    """Coerce a plain id tensor (hi=0) or PhotonId to PhotonId."""
    if isinstance(ids, PhotonId):
        return ids
    lo = torch.as_tensor(ids).to(torch.int64) & MASK32
    return PhotonId(lo=lo, hi=torch.zeros_like(lo))


def split_id64(start_id: int) -> tuple[int, int]:
    """Split a host-side Python int id into its (lo, hi) 32-bit words."""
    start_id = int(start_id)
    if start_id < 0 or start_id >= 1 << 64:
        raise ValueError(f"photon id out of uint64 range: {start_id}")
    return start_id & MASK32, start_id >> 32


def add_id(lo, hi, delta) -> PhotonId:
    """The 64-bit id ``(lo, hi) + delta`` for a ``delta`` in ``[0, 2**32)``:
    the low word wraps and its carry goes into the high word."""
    new_lo = (lo + delta) & MASK32
    new_hi = (hi + (new_lo < lo).to(torch.int64)) & MASK32
    return PhotonId(lo=new_lo, hi=new_hi)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for a word ``x`` and a constant ``c``,
    through 16-bit halves of ``c`` so int64 never overflows."""
    c_lo, c_hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (x * c_lo + (((x * c_hi) & 0xFFFF) << 16)) & MASK32


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """One splitmix32 output step; ``x`` is the 32-bit counter word."""
    z = (x + _GOLDEN) & MASK32
    z = mul32(z ^ (z >> 16), _MIX1)
    z = mul32(z ^ (z >> 13), _MIX2)
    return z ^ (z >> 16)


def seed_state(seed, photon_id) -> torch.Tensor:
    """Derive a (..., 4) int64 xorshift128 state from (seed, photon_id).

    ``seed`` is a Python int or a word tensor; ``photon_id`` a plain id
    tensor or a :class:`PhotonId`.  All-zero states are replaced by
    0xDEADBEEF in every word (xorshift must never be seeded all-zero).
    """
    pid = as_photon_id(photon_id)
    if isinstance(seed, torch.Tensor):
        seed = seed.to(torch.int64) & MASK32
    else:
        seed = int(seed) & MASK32
    hmix = mul32(pid.hi, _HI_MULT)
    x = seed ^ mul32(pid.lo, _ID_MULT)
    words = []
    for k in range(4):
        x = splitmix32((x + ((k * _GOLDEN) & MASK32) + hmix) & MASK32)
        words.append(x)
    state = torch.stack(words, dim=-1)
    allzero = (state == 0).all(dim=-1, keepdim=True)
    return torch.where(allzero, torch.full_like(state, _ZERO_FIX), state)


def next_u32(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Marsaglia xorshift128 step. state: (..., 4) -> (new_state, word)."""
    x, y, z, w = state.unbind(-1)
    t = x ^ ((x << 11) & MASK32)
    t = t ^ (t >> 8)
    neww = (w ^ (w >> 19)) ^ t
    return torch.stack([y, z, w, neww], dim=-1), neww


def next_uniform(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform float32 in the open interval (0, 1) from the top 24 bits:
    ``(r + 0.5) * 2**-24``, never exactly 0 or 1."""
    state, bits = next_u32(state)
    r = (bits >> 8).to(torch.float32)
    return state, (r + 0.5) * _U24_SCALE
