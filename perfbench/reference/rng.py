"""Counter-seeded xorshift128, frozen.

A copy of ``repro_torch/core/rng.py`` as of the benchmark's first
version (seeding, the 64-bit id words, the draw and the uniform), in
plain PyTorch.  Every 32-bit word is carried in ``torch.int64`` holding
a value in ``[0, 2**32)``, masked after each operation that can leave
that range; products with the mixing constants go through 16-bit
halves, so int64 never overflows.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35
_HI_MULT = 0x85EBCA77
_ID_MULT = 0x9E3779B1
_ZERO_FIX = 0xDEADBEEF
_U24_SCALE = 2.0**-24
# the salt that separates a source's launch stream from the flight one
LAUNCH_STREAM_SALT = 0xA511CE50


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` through the 16-bit halves of ``c``."""
    c_lo, c_hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (x * c_lo + (((x * c_hi) & 0xFFFF) << 16)) & MASK32


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    z = (x + _GOLDEN) & MASK32
    z = mul32(z ^ (z >> 16), _MIX1)
    z = mul32(z ^ (z >> 13), _MIX2)
    return z ^ (z >> 16)


def seed_state(seed: int, id_lo: torch.Tensor,
               id_hi: torch.Tensor) -> torch.Tensor:
    """The ``(..., 4)`` xorshift128 state of photon ``(id_lo, id_hi)``
    under ``seed`` (an all-zero state becomes 0xDEADBEEF words)."""
    seed = int(seed) & MASK32
    hmix = mul32(id_hi, _HI_MULT)
    x = seed ^ mul32(id_lo, _ID_MULT)
    words = []
    for k in range(4):
        x = splitmix32((x + ((k * _GOLDEN) & MASK32) + hmix) & MASK32)
        words.append(x)
    state = torch.stack(words, dim=-1)
    allzero = (state == 0).all(dim=-1, keepdim=True)
    return torch.where(allzero, torch.full_like(state, _ZERO_FIX), state)


def next_u32(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    x, y, z, w = state.unbind(-1)
    t = x ^ ((x << 11) & MASK32)
    t = t ^ (t >> 8)
    neww = (w ^ (w >> 19)) ^ t
    return torch.stack([y, z, w, neww], dim=-1), neww


def next_uniform(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform float32 in (0, 1) from the top 24 bits."""
    state, bits = next_u32(state)
    r = (bits >> 8).to(torch.float32)
    return state, (r + 0.5) * _U24_SCALE


def id_words(first: int, n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``(lo, hi)`` words of the 64-bit ids ``first .. first + n - 1``
    (``first + n <= 2**64``)."""
    first = int(first)
    if first < 0 or first + n > 1 << 64:
        raise ValueError(f"ids {first} + {n} leave the 64-bit range")
    lo0, hi0 = first & MASK32, first >> 32
    k = torch.arange(n, dtype=torch.int64, device=device)
    lo = (lo0 + k) & MASK32
    hi = (hi0 + ((lo0 + k) >> 32)) & MASK32
    return lo, hi
