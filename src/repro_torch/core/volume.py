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

And MCX's skin-vessel example (``example/skinvessel``; mcxlab's
``demo_mcxyz_skinvessel.m``), S. Jacques' mcxyz skin-vessel at 532 nm:
200^3 voxels of 5 um built from MCX shapes (``core/shapes.py``), a
water layer over epidermis over dermis, crossed by a blood vessel along
x; a disk beam, no reflection, one gate to 50 ns.

And the five-layer adult head of the fNIRS literature (Okada & Delpy,
Appl. Opt. 42(16):2906, 2003): scalp, skull, CSF, gray and white matter
as z slabs of 1 mm voxels, with the 830 nm media MCX runs on its colin27
atlas (Fang & Boas, Opt. Express 17(22):20178, 2009), probed in the time
domain by a pencil beam and four detectors 10-40 mm away, with Fresnel
reflection, 50 gates to 5 ns and detected-photon records.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# MCX's shape primitives, re-exported beside cube_with_sphere
from repro_torch.core.shapes import (cylinder, grid, rasterize,  # noqa: F401
                                     zlayers)

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


def volume_from_shapes(shape_list, media_list: list[Medium],
                       unitinmm: float = 1.0, device="cpu") -> Volume:
    """A Volume from an MCX ``Shapes`` list (``core/shapes.py``); row
    ``t`` of ``media_list`` is tag ``t``, row 0 the exterior."""
    labels = rasterize(shape_list)
    if int(labels.max()) >= len(media_list):
        raise ValueError(f"tag {int(labels.max())} has no medium among "
                         f"{len(media_list)} rows")
    return Volume(labels=torch.as_tensor(labels, device=device),
                  media=pack_media(media_list, device), unitinmm=unitinmm)


# MCX example/skinvessel: tags 1 water, 2 blood, 3 dermis, 4 epidermis
SKINVESSEL_MEDIA = (
    AIR,
    Medium(mua=3.564e-05, mus=1.0, g=1.0, n=1.37),
    Medium(mua=23.05426549, mus=9.398496241, g=0.90, n=1.37),
    Medium(mua=0.04584957865, mus=35.65405549, g=0.90, n=1.37),
    Medium(mua=1.657237447, mus=37.59398496, g=0.90, n=1.37),
)
SKINVESSEL_SHAPES = (
    {"Grid": {"Tag": 1, "Size": [200, 200, 200]}},
    {"ZLayers": [[1, 20, 1], [21, 32, 4], [33, 200, 3]]},
    {"Cylinder": {"Tag": 2, "C0": [0, 100.5, 100.5],
                  "C1": [200, 100.5, 100.5], "R": 20}},
)
SKINVESSEL_UNITINMM = 0.005
# the source's disk beam, in voxel units (MCX's issrcfrom0 = 1)
SKINVESSEL_SOURCE = {"type": "disk", "pos": [100.0, 100.0, 20.0],
                     "dir": [0.0, 0.0, 1.0], "radius": 60.0}


def benchmark_skinvessel(device="cpu") -> Volume:
    """MCX's skin-vessel volume at its published 200^3 voxels of 5 um."""
    return volume_from_shapes(SKINVESSEL_SHAPES, list(SKINVESSEL_MEDIA),
                              SKINVESSEL_UNITINMM, device)


# Okada & Delpy's five-layer head at 830 nm (MCX's colin27 media): tags 1
# scalp, 2 skull, 3 CSF, 4 gray matter, 5 white matter
HEAD5_MEDIA = (
    AIR,
    Medium(mua=0.019, mus=7.8, g=0.89, n=1.37),
    Medium(mua=0.019, mus=7.8, g=0.89, n=1.37),
    Medium(mua=0.004, mus=0.009, g=0.89, n=1.37),
    Medium(mua=0.02, mus=9.0, g=0.89, n=1.37),
    Medium(mua=0.08, mus=40.9, g=0.84, n=1.37),
)
# white matter to the floor, then scalp 3 mm, skull 7, CSF 2, gray matter 4
HEAD5_SHAPES = (
    {"Grid": {"Tag": 5, "Size": [120, 120, 60]}},
    {"ZLayers": [[1, 3, 1], [4, 10, 2], [11, 12, 3], [13, 16, 4]]},
)
HEAD5_UNITINMM = 1.0
# the probe on the scalp (voxel units): a pencil beam at (60, 60, 0) and
# four detector disks of radius 2 mm at 10, 20, 30 and 40 mm from it
HEAD5_SOURCE = {"type": "pencil", "pos": [60.0, 60.0, 0.0],
                "dir": [0.0, 0.0, 1.0]}
HEAD5_DETECTORS = tuple({"x": 60 + d, "y": 60, "radius": 2}
                        for d in (10, 20, 30, 40))
# detected-photon record slots: MCX's maxdetphoton default of 10^6
HEAD5_RECORD_SLOTS = 1 << 20


def benchmark_head5(device="cpu") -> Volume:
    """The five-layer adult head: 120 x 120 x 60 voxels of 1 mm."""
    return volume_from_shapes(HEAD5_SHAPES, list(HEAD5_MEDIA),
                              HEAD5_UNITINMM, device)


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


def skinvessel_config() -> SimConfig:
    """No reflection (the demo is compared against mcxyz, which models no
    index mismatch), one gate to 50 ns."""
    return SimConfig(do_reflect=False, tmax_ns=50.0)


def head5_config() -> SimConfig:
    """Fresnel reflection at the scalp (tissue n 1.37 against air), and
    a time-domain instrument's TPSF: 50 gates of 0.1 ns to 5 ns."""
    return SimConfig(do_reflect=True, tmax_ns=5.0, n_time_gates=50)
