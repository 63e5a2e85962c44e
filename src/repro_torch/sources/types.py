"""The source menu: MCX-style illumination patterns as frozen dataclasses.

Positions and lengths are in voxel units, directions need not be
normalized.  A sampled launch position outside the domain is clamped
onto its boundary (``photon.launch``).  Each type documents its
launch-stream draw count (``N_DRAWS``).

Registered types (``repro_torch.sources.available_sources()``):

  pencil     zero-width collimated beam (the paper's configuration)
  isotropic  point source radiating uniformly over 4 pi
  cone       uniform solid-angle cone around an axis
  gaussian   collimated beam with a Gaussian intensity profile
  disk       uniform-intensity flat circular beam
  planar     uniform parallelogram patch, optional intensity pattern
  line       line segment, collimated (slit) or isotropic emission

Every type splits into ``stage()``, the host derivations over its
fields in float64 rounded once to float32 numpy arrays (the reference's
staged dict, value for value), and ``sample_staged(staged, ids, seed)``
on a leading scenario axis (``sources/base.py``); ``sample`` is their
composition for one scenario.  Scalar fields are staged as float32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import rng as xrng
from repro_torch.sources import base

Vec3 = tuple[float, float, float]


def _f32(v) -> np.ndarray:
    return np.asarray(v, np.float32)


class _Staged:
    """``sample`` as the composition of ``stage`` and ``sample_staged``."""

    def sample(self, photon_ids, seed):
        return base.sample_one(type(self), self.stage(), photon_ids, seed)


def _draws(seed, ids, n: int):
    """The first ``n`` launch-stream uniforms of each photon."""
    ls = base.launch_stream(seed, ids)
    out = []
    for _ in range(n):
        ls, u = xrng.next_uniform(ls)
        out.append(u)
    return out


@base.register("pencil")
@dataclasses.dataclass(frozen=True)
class Pencil(_Staged):
    """Zero-width collimated beam (consumes no launch-stream draws)."""

    pos: Vec3 = (30.0, 30.0, 0.0)
    dir: Vec3 = (0.0, 0.0, 1.0)

    N_DRAWS = 0

    def stage(self):
        return {"pos": _f32(self.pos), "dir": base.unit(self.dir)}

    @staticmethod
    def sample_staged(p, photon_ids, seed):
        return (base.lanes(p["pos"], photon_ids),
                base.lanes(p["dir"], photon_ids), base.ones(photon_ids),
                base.flight_stream(seed, photon_ids))


@base.register("isotropic")
@dataclasses.dataclass(frozen=True)
class IsotropicPoint(_Staged):
    """Point source radiating uniformly over the full sphere."""

    pos: Vec3 = (30.0, 30.0, 30.0)

    N_DRAWS = 2  # u_cos, u_phi

    def stage(self):
        return {"pos": _f32(self.pos)}

    @staticmethod
    def sample_staged(p, photon_ids, seed):
        u_cos, u_phi = _draws(seed, photon_ids, 2)
        return (base.lanes(p["pos"], photon_ids),
                base.isotropic_direction(u_cos, u_phi),
                base.ones(photon_ids), base.flight_stream(seed, photon_ids))


@base.register("cone")
@dataclasses.dataclass(frozen=True)
class Cone(_Staged):
    """Point source emitting uniformly into a cone of ``half_angle_deg``
    around ``dir`` (an optical-fiber numerical-aperture model)."""

    pos: Vec3 = (30.0, 30.0, 0.0)
    dir: Vec3 = (0.0, 0.0, 1.0)
    half_angle_deg: float = 15.0

    N_DRAWS = 2  # u_cos, u_phi

    def stage(self):
        e1, e2 = base.orthonormal_frame(self.dir)
        cos_half = math.cos(math.radians(self.half_angle_deg))
        # staged as the 1 - cos form the cap formula uses, rounded once
        return {"pos": _f32(self.pos), "axis": base.unit(self.dir),
                "e1": e1, "e2": e2,
                "one_minus_cos_half": _f32(1.0 - cos_half)}

    @staticmethod
    def sample_staged(p, photon_ids, seed):
        u_cos, u_phi = _draws(seed, photon_ids, 2)
        # uniform over the spherical cap [cos_half, 1]
        cost = 1.0 - u_cos * base.col(p["one_minus_cos_half"])
        direc = base.direction_from_axis(cost, base.TWO_PI * u_phi,
                                         p["axis"], p["e1"], p["e2"])
        return (base.lanes(p["pos"], photon_ids), direc,
                base.ones(photon_ids), base.flight_stream(seed, photon_ids))


@base.register("gaussian")
@dataclasses.dataclass(frozen=True)
class GaussianBeam(_Staged):
    """Collimated beam with a Gaussian intensity profile of 1/e^2 radius
    ``waist`` (voxel units) around ``pos``, along ``dir``:
    r = waist sqrt(-ln u / 2)."""

    pos: Vec3 = (30.0, 30.0, 0.0)
    dir: Vec3 = (0.0, 0.0, 1.0)
    waist: float = 3.0

    N_DRAWS = 2  # u_r, u_phi

    def stage(self):
        e1, e2 = base.orthonormal_frame(self.dir)
        return {"pos": _f32(self.pos), "dir": base.unit(self.dir),
                "e1": e1, "e2": e2, "waist": _f32(self.waist)}

    @staticmethod
    def sample_staged(p, photon_ids, seed):
        u_r, u_phi = _draws(seed, photon_ids, 2)
        r = base.col(p["waist"]) * torch.sqrt(-torch.log(u_r) * 0.5)
        pos = base.radial_offset(base.lanes(p["pos"], photon_ids), r, u_phi,
                                 p["e1"], p["e2"])
        return (pos, base.lanes(p["dir"], photon_ids), base.ones(photon_ids),
                base.flight_stream(seed, photon_ids))


@base.register("disk")
@dataclasses.dataclass(frozen=True)
class Disk(_Staged):
    """Uniform-intensity collimated circular beam of ``radius`` voxels."""

    pos: Vec3 = (30.0, 30.0, 0.0)
    dir: Vec3 = (0.0, 0.0, 1.0)
    radius: float = 5.0

    N_DRAWS = 2  # u_r, u_phi

    def stage(self):
        e1, e2 = base.orthonormal_frame(self.dir)
        return {"pos": _f32(self.pos), "dir": base.unit(self.dir),
                "e1": e1, "e2": e2, "radius": _f32(self.radius)}

    @staticmethod
    def sample_staged(p, photon_ids, seed):
        u_r, u_phi = _draws(seed, photon_ids, 2)
        r = base.col(p["radius"]) * torch.sqrt(u_r)  # uniform over the area
        pos = base.radial_offset(base.lanes(p["pos"], photon_ids), r, u_phi,
                                 p["e1"], p["e2"])
        return (pos, base.lanes(p["dir"], photon_ids), base.ones(photon_ids),
                base.flight_stream(seed, photon_ids))


@base.register("planar")
@dataclasses.dataclass(frozen=True)
class Planar(_Staged):
    """Collimated area source over the parallelogram ``pos + a v1 + b v2``
    (a, b uniform in [0, 1)).

    ``pattern`` (optional, row-major tuple of tuples) sets the initial
    packet weight like MCX's pattern source: the patch is split into
    len(pattern) x len(pattern[0]) cells along (v1, v2) and a photon
    launched in cell (i, j) starts with w0 = pattern[i][j].  Positions
    stay uniform; only weights vary.
    """

    pos: Vec3 = (20.0, 20.0, 0.0)
    v1: Vec3 = (20.0, 0.0, 0.0)
    v2: Vec3 = (0.0, 20.0, 0.0)
    dir: Vec3 = (0.0, 0.0, 1.0)
    pattern: tuple = ()

    N_DRAWS = 2  # u_a, u_b

    def stage(self):
        p = {"pos": _f32(self.pos), "v1": _f32(self.v1), "v2": _f32(self.v2),
             "dir": base.unit(self.dir)}
        # the pattern's presence and grid shape are structural, its
        # weights staged values
        if self.pattern:
            p["pattern"] = _f32(self.pattern)
        return p

    @staticmethod
    def sample_staged(p, photon_ids, seed):
        u_a, u_b = _draws(seed, photon_ids, 2)
        pos = (base.lanes(p["pos"], photon_ids)
               + u_a[..., None] * base.vec(p["v1"])
               + u_b[..., None] * base.vec(p["v2"]))
        if "pattern" in p:
            pat = p["pattern"]
            rows, cols = pat.shape[-2:]
            ia = torch.clamp((u_a * rows).to(torch.int32), 0, rows - 1)
            ib = torch.clamp((u_b * cols).to(torch.int32), 0, cols - 1)
            w0 = torch.gather(pat.reshape(pat.shape[0], -1), 1,
                              (ia * cols + ib).to(torch.int64))
        else:
            w0 = base.ones(photon_ids)
        return (pos, base.lanes(p["dir"], photon_ids), w0,
                base.flight_stream(seed, photon_ids))


@base.register("line")
@dataclasses.dataclass(frozen=True)
class Line(_Staged):
    """Line-segment source from ``start`` to ``end``.

    With ``dir`` set this is a slit (collimated along ``dir``); with
    ``dir=None`` each photon emits isotropically from its launch point.
    Always draws 3 launch uniforms, so the stream layout is the same for
    both variants.
    """

    start: Vec3 = (20.0, 30.0, 0.0)
    end: Vec3 = (40.0, 30.0, 0.0)
    dir: Vec3 | None = (0.0, 0.0, 1.0)

    N_DRAWS = 3  # u_t, u_cos, u_phi

    def stage(self):
        p = {"start": _f32(self.start), "end": _f32(self.end)}
        # collimated or isotropic is structural: the staged dict has a
        # "dir" key exactly for the slit
        if self.dir is not None:
            p["dir"] = base.unit(self.dir)
        return p

    @staticmethod
    def sample_staged(p, photon_ids, seed):
        u_t, u_cos, u_phi = _draws(seed, photon_ids, 3)
        start, end = p["start"], p["end"]
        pos = base.vec(start) + u_t[..., None] * base.vec(end - start)
        if "dir" in p:
            direc = base.lanes(p["dir"], photon_ids)
        else:
            direc = base.isotropic_direction(u_cos, u_phi)
        return pos, direc, base.ones(photon_ids), base.flight_stream(
            seed, photon_ids)


def demo_menu(size: int) -> dict:
    """One representative instance of every source type, scaled to a
    cubic domain of edge ``size`` voxels (the reference's menu)."""
    c = size / 2.0
    q = size / 4.0
    return {
        "pencil": Pencil(pos=(c, c, 0.0)),
        "isotropic": IsotropicPoint(pos=(c, c, c)),
        "cone": Cone(pos=(c, c, 0.0), half_angle_deg=20.0),
        "gaussian": GaussianBeam(pos=(c, c, 0.0), waist=size / 12.0),
        "disk": Disk(pos=(c, c, 0.0), radius=size / 6.0),
        # checkerboard: structured illumination through launch weights
        "planar+pattern": Planar(
            pos=(q, q, 0.0), v1=(2 * q, 0.0, 0.0), v2=(0.0, 2 * q, 0.0),
            pattern=((1.0, 0.1, 1.0), (0.1, 1.0, 0.1), (1.0, 0.1, 1.0)),
        ),
        "line (slit)": Line(start=(q, c, 0.0), end=(3 * q, c, 0.0)),
        "line (isotropic)": Line(start=(q, c, c), end=(3 * q, c, c),
                                 dir=None),
    }
