"""The pencil and disk sources, frozen.

Copies of ``repro_torch/sources`` (``Pencil``, ``Disk`` and the helpers
they call) as of the benchmark's first version, in plain PyTorch: the
static parameters derived in float64 on the host and rounded once to
float32, the per-photon draws from the salted launch stream, the flight
stream seeded by ``(seed, id)``.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import rng as xrng

TWO_PI = float(np.float32(2.0 * np.pi))


def _unit(v) -> np.ndarray:
    d = np.asarray(v, np.float64)
    return (d / np.linalg.norm(d)).astype(np.float32)


def _frame(axis) -> tuple[np.ndarray, np.ndarray]:
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    h = np.array([0.0, 0.0, 1.0]) if abs(a[2]) < 0.9 else np.array(
        [1.0, 0.0, 0.0])
    e1 = np.cross(h, a)
    e1 = e1 / np.linalg.norm(e1)
    e2 = np.cross(a, e1)
    return e1.astype(np.float32), e2.astype(np.float32)


def sample(source: dict, seed: int, id_lo, id_hi):
    """``(pos, dir, w0, rng)`` of the photons ``(id_lo, id_hi)`` of a
    source given as the configuration's dict: ``{"type": "pencil",
    "pos", "dir"}`` or ``{"type": "disk", "pos", "dir", "radius"}``
    (voxel units)."""
    dev = id_lo.device
    n = id_lo.shape[0]
    kind = source["type"]
    pos = torch.as_tensor(np.asarray(source["pos"], np.float32), device=dev)
    direc = torch.as_tensor(_unit(source.get("dir", (0.0, 0.0, 1.0))),
                            device=dev)
    pos = pos[None, :].expand(n, 3)
    direc = direc[None, :].expand(n, 3)
    w0 = torch.ones((n,), dtype=torch.float32, device=dev)
    if kind == "disk":
        e1, e2 = (torch.as_tensor(e, device=dev)
                  for e in _frame(source.get("dir", (0.0, 0.0, 1.0))))
        radius = torch.as_tensor(np.float32(source["radius"]), device=dev)
        ls = xrng.seed_state((int(seed) ^ xrng.LAUNCH_STREAM_SALT)
                             & xrng.MASK32, id_lo, id_hi)
        ls, u_r = xrng.next_uniform(ls)
        ls, u_phi = xrng.next_uniform(ls)
        r = radius * torch.sqrt(u_r)
        phi = TWO_PI * u_phi
        pos = (pos + (r * torch.cos(phi))[:, None] * e1[None, :]
               + (r * torch.sin(phi))[:, None] * e2[None, :])
    elif kind != "pencil":
        raise ValueError(f"the reference has no {kind!r} source")
    return pos, direc, w0, xrng.seed_state(seed, id_lo, id_hi)
