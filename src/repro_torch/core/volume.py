"""Voxelized heterogeneous media for photon transport.

A :class:`Volume` is a uint8 label grid plus a small table of optical
properties per label, as in MCX.  Label 0 is exterior (air outside the
domain): photons that transmit into label-0 voxels escape.

The paper's benchmarks, with the published optical properties:

  * B1  - 60x60x60 mm homogeneous cube, mua=0.005/mm, mus=1.0/mm,
          g=0.01, n=1.37; photons terminate on the cube surface.
  * B2  - the same cube with a radius-15 mm spherical inclusion at the
          center (mua=0.002, mus=5.0, g=0.9, n=1.0); Snell/Fresnel
          reflection at the sphere and cube boundaries.
  * B2a - the physics of B2; the paper uses it to time atomic fluence
          accumulation, which is what the CUDA kernel does for every
          benchmark.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

C_MM_PER_NS = 299.792458  # speed of light in vacuum, mm/ns


@dataclasses.dataclass(frozen=True)
class Medium:
    """Optical properties of one tissue type."""

    mua: float  # absorption coefficient, 1/mm
    mus: float  # scattering coefficient, 1/mm
    g: float    # Henyey-Greenstein anisotropy
    n: float    # refractive index


AIR = Medium(mua=0.0, mus=0.0, g=1.0, n=1.0)


@dataclasses.dataclass(frozen=True)
class Volume:
    """Label grid + per-label optical property table.

    labels: (nx, ny, nz) uint8; media: (n_media, 4) float32 rows of
    (mua, mus, g, n), both on one device.  ``unitinmm`` is the voxel
    edge length.
    """

    labels: torch.Tensor
    media: torch.Tensor
    unitinmm: float = 1.0

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(self.labels.shape)

    @property
    def device(self) -> torch.device:
        return self.labels.device

    def to(self, device) -> "Volume":
        return dataclasses.replace(self, labels=self.labels.to(device),
                                   media=self.media.to(device))


def pack_media(media_list: list[Medium], device="cpu") -> torch.Tensor:
    rows = [[m.mua, m.mus, m.g, m.n] for m in media_list]
    return torch.tensor(rows, dtype=torch.float32, device=device)


def volume_from_arrays(labels, media, unitinmm: float = 1.0,
                       device="cpu") -> Volume:
    """Build a Volume from host arrays (e.g. another package's volume
    turned into numpy): labels become uint8, media float32."""
    labels = torch.tensor(np.asarray(labels, np.uint8), device=device)
    media = torch.tensor(np.asarray(media, np.float32), device=device)
    if labels.ndim != 3:
        raise ValueError(f"labels must be 3-D, got shape {tuple(labels.shape)}")
    if media.ndim != 2 or media.shape[1] != 4:
        raise ValueError(f"media must be (n_media, 4), got {tuple(media.shape)}")
    return Volume(labels=labels.contiguous(), media=media.contiguous(),
                  unitinmm=float(unitinmm))


def homogeneous_cube(shape: tuple[int, int, int], medium: Medium,
                     unitinmm: float = 1.0, device="cpu") -> Volume:
    labels = torch.ones(shape, dtype=torch.uint8, device=device)
    return Volume(labels=labels, media=pack_media([AIR, medium], device),
                  unitinmm=unitinmm)


def cube_with_sphere(shape: tuple[int, int, int], background: Medium,
                     inclusion: Medium,
                     center_mm: tuple[float, float, float],
                     radius_mm: float, unitinmm: float = 1.0,
                     device="cpu") -> Volume:
    nx, ny, nz = shape
    # voxel centers in mm, in float64 on the host as in the reference
    xs = (np.arange(nx) + 0.5) * unitinmm
    ys = (np.arange(ny) + 0.5) * unitinmm
    zs = (np.arange(nz) + 0.5) * unitinmm
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    r2 = ((gx - center_mm[0]) ** 2 + (gy - center_mm[1]) ** 2
          + (gz - center_mm[2]) ** 2)
    labels = np.where(r2 <= radius_mm**2, 2, 1).astype(np.uint8)
    return Volume(labels=torch.as_tensor(labels, device=device),
                  media=pack_media([AIR, background, inclusion], device),
                  unitinmm=unitinmm)


# ---------------------------------------------------------------------------
# Paper benchmark domains (Fig. 2 of Yu et al. 2017)
# ---------------------------------------------------------------------------

B1_MEDIUM = Medium(mua=0.005, mus=1.0, g=0.01, n=1.37)
B2_INCLUSION = Medium(mua=0.002, mus=5.0, g=0.9, n=1.0)


def benchmark_b1(shape: tuple[int, int, int] = (60, 60, 60),
                 device="cpu") -> Volume:
    """B1: homogeneous cube, photon terminates at the boundary."""
    return homogeneous_cube(shape, B1_MEDIUM, device=device)


def benchmark_b2(shape: tuple[int, int, int] = (60, 60, 60),
                 device="cpu") -> Volume:
    """B2/B2a: cube with centered spherical inclusion, boundary reflection."""
    center = tuple(s / 2.0 for s in shape)
    radius = shape[0] / 4.0  # 15 mm for the 60 mm cube of the paper
    return cube_with_sphere(shape, B1_MEDIUM, B2_INCLUSION, center, radius,
                            device=device)


@dataclasses.dataclass(frozen=True)
class Source:
    """Legacy pencil-beam source (the paper's configuration).

    Anywhere a source is accepted this is coerced to
    ``repro_torch.sources.Pencil`` (bit-identical results).
    """

    pos: tuple[float, float, float] = (30.0, 30.0, 0.0)
    dir: tuple[float, float, float] = (0.0, 0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Physics / termination configuration for a simulation run.

    ``do_reflect`` toggles Snell/Fresnel handling at refractive-index
    mismatches (False for B1, True for B2/B2a).  ``deposit_mode``
    selects exact Beer-Lambert deposition (``"exact"``) or the
    first-order variant (``"taylor"``, the paper's Opt1 analogue).
    ``specialize`` selects the specialized or general step (see
    ``photon.step``).

    ``steps_per_round`` (K) fuses K transport segments into one round:
    regeneration runs once per round and the accumulators are flushed
    once per round.  ``n_time_gates`` bins deposited energy over
    time-of-flight into equal gates over ``[0, tmax_ns]``; 1 is the
    continuous-wave case.  ``collect_stats`` returns the round counters
    (``telemetry.RoundStats``) on ``SimResult.stats``.
    """

    do_reflect: bool = False
    tmax_ns: float = 5.0
    w_threshold: float = 1e-4
    roulette_m: float = 10.0
    deposit_mode: str = "exact"  # "exact" | "taylor" (Opt1 analogue)
    specialize: bool = True      # Opt3 analogue
    max_steps: int = 500_000     # hard cap on lock-step iterations
    steps_per_round: int = 1     # K: fused segments per outer iteration
    n_time_gates: int = 1        # time-resolved fluence gates over [0, tmax_ns]
    collect_stats: bool = False  # round counters on SimResult.stats

    @property
    def gate_width_ns(self) -> float:
        """Width of one time gate: the CW case is a single all-covering gate."""
        return self.tmax_ns / self.n_time_gates


def b1_config() -> SimConfig:
    return SimConfig(do_reflect=False)


def b2_config() -> SimConfig:
    return SimConfig(do_reflect=True)
