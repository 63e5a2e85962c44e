"""Source subsystem core: registry, RNG streams, geometry helpers.

A source turns global photon ids into launch states.  Every source is a
frozen dataclass with static (Python scalar / tuple) parameters and one
method::

    sample(photon_ids, seed) -> (pos, dir, w0, rng)

with ``pos``/``dir`` of shape (N, 3) float32 (voxel units / unit
vectors), ``w0`` the (N,) float32 initial packet weight and ``rng`` the
(N, 4) in-flight xorshift128 state (int64 words, see ``core/rng.py``),
all on the device of ``photon_ids``.  ``photon_ids`` is a plain id
tensor or a :class:`repro_torch.core.rng.PhotonId` pair.

Launch-time randomness comes from a launch stream seeded from
``(seed ^ LAUNCH_STREAM_SALT, photon_id)``; the in-flight stream is
seeded from ``(seed, photon_id)``, so the choice of source never changes
a trajectory given its launch state.  Each source type consumes a fixed
number of launch-stream uniforms per photon (``N_DRAWS``).

Every registered source splits ``sample`` into ``stage()``, the host
derivations over its fields in float64 (unit vectors, frames, trig)
rounded once to float32 numpy arrays, and ``sample_staged(staged, ids,
seed)``, which reads only the staged dict and works on a leading
scenario axis: staged values ``(S, ...)``, ids ``(S, n)``, seed an int
or an ``(S, 1)`` word tensor, results ``(S, n, ...)``.  ``sample`` is
``sample_staged`` of the staged dict with S = 1, so a batch of
scenarios (``repro_torch.scenarios``) runs the same operations as one.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import rng as xrng

# Domain-separation salt for the launch stream, XORed into the seed.
LAUNCH_STREAM_SALT = 0xA511CE50


@runtime_checkable
class PhotonSource(Protocol):
    """Structural type every registered source satisfies."""

    def sample(self, photon_ids, seed):
        """(photon_ids, seed) -> (pos, dir, w0, rng) per-lane launch state."""
        ...


def launch_stream(seed, photon_ids) -> torch.Tensor:
    """Per-photon launch-time RNG state (salted counter seed)."""
    return xrng.seed_state(seed ^ LAUNCH_STREAM_SALT, photon_ids)


def flight_stream(seed, photon_ids) -> torch.Tensor:
    """Per-photon in-flight RNG state."""
    return xrng.seed_state(seed, photon_ids)


def unit(v) -> np.ndarray:
    """Normalize a static 3-vector in float64, return float32."""
    d = np.asarray(v, np.float64)  # reprolint: disable=REP301 - static parameters derived in float64, rounded once to float32
    return (d / np.linalg.norm(d)).astype(np.float32)


def orthonormal_frame(axis) -> tuple[np.ndarray, np.ndarray]:
    """Two unit float32 vectors spanning the plane perpendicular to a
    static axis (derived in float64)."""
    a = np.asarray(axis, np.float64)  # reprolint: disable=REP301 - static parameters derived in float64, rounded once to float32
    a = a / np.linalg.norm(a)
    h = np.array([0.0, 0.0, 1.0]) if abs(a[2]) < 0.9 else np.array(
        [1.0, 0.0, 0.0])
    e1 = np.cross(h, a)
    e1 = e1 / np.linalg.norm(e1)
    e2 = np.cross(a, e1)
    return e1.astype(np.float32), e2.astype(np.float32)


# float32(2 pi), the constant every launch-angle formula multiplies by
TWO_PI = float(np.float32(2.0 * np.pi))


def vec(p: torch.Tensor) -> torch.Tensor:
    """A staged ``(S, 3)`` vector as ``(S, 1, 3)``, to broadcast over a
    scenario's lanes."""
    return p[:, None, :]


def col(p: torch.Tensor) -> torch.Tensor:
    """A staged ``(S,)`` scalar as ``(S, 1)``."""
    return p[:, None]


def isotropic_direction(u_cos, u_phi) -> torch.Tensor:
    """Unit directions uniform over the sphere from two launch uniforms
    (``(..., 3)``); shared by every isotropically emitting source."""
    cost = 2.0 * u_cos - 1.0
    sint = torch.sqrt(torch.clamp(1.0 - cost * cost, min=0.0))
    phi = TWO_PI * u_phi
    return torch.stack([sint * torch.cos(phi), sint * torch.sin(phi), cost],
                       dim=-1)


def radial_offset(pos, r, u_phi, e1, e2) -> torch.Tensor:
    """Offset ``(S, n, 3)`` positions by radius ``r`` ``(S, n)`` at
    azimuth ``2 pi u_phi`` in the plane of the staged ``(S, 3)`` frame
    ``(e1, e2)``; shared by every radial beam profile (disk, Gaussian)."""
    phi = TWO_PI * u_phi
    return (pos + (r * torch.cos(phi))[..., None] * vec(e1)
            + (r * torch.sin(phi))[..., None] * vec(e2))


def direction_from_axis(cost, phi, axis, e1, e2) -> torch.Tensor:
    """Unit directions at polar cosine ``cost`` / azimuth ``phi``
    (``(S, n)``) around a staged ``(S, 3)`` axis with perpendicular
    frame ``(e1, e2)``."""
    cost = torch.clamp(cost, -1.0, 1.0)
    sint = torch.sqrt(torch.clamp(1.0 - cost * cost, min=0.0))
    d = ((sint * torch.cos(phi))[..., None] * vec(e1)
         + (sint * torch.sin(phi))[..., None] * vec(e2)
         + cost[..., None] * vec(axis))
    dx, dy, dz = d.unbind(-1)
    norm = torch.sqrt(dx * dx + dy * dy + dz * dz)[..., None]
    return d / torch.clamp(norm, min=1e-12)


def ones(ids) -> torch.Tensor:
    """Unit launch weights, one per id of an ``(S, n)`` id array."""
    return torch.ones(ids.lo.shape, dtype=torch.float32, device=ids.lo.device)


def lanes(p: torch.Tensor, ids) -> torch.Tensor:
    """A staged ``(S, 3)`` vector broadcast to every lane: ``(S, n, 3)``."""
    return vec(p).expand(ids.lo.shape + (3,))


# ---------------------------------------------------------------------------
# staged launch parameters (scenario batching)
# ---------------------------------------------------------------------------

def staged_tensors(staged: dict, device, batch: bool = True) -> dict:
    """A staged dict's numpy values as float32 tensors on ``device``,
    with a leading scenario axis of 1 unless they have one (``batch``
    False)."""
    out = {}
    for k, v in staged.items():
        t = torch.as_tensor(np.asarray(v, np.float32), device=device)
        out[k] = t[None] if batch else t
    return out


def sample_one(source_cls, staged: dict, photon_ids, seed):
    """``sample`` of one scenario through ``sample_staged``: ids
    ``(n,)``, results ``(n, ...)``."""
    ids = xrng.as_photon_id(photon_ids)
    ids = xrng.PhotonId(ids.lo[None], ids.hi[None])
    out = source_cls.sample_staged(staged_tensors(staged, ids.lo.device),
                                   ids, seed)
    return tuple(x[0] for x in out)


class StagedSource:
    """A source class bound to staged launch parameters.

    ``sample(ids, seed)`` runs the class's ``sample_staged`` on the
    staged dict (numpy values, as ``stage()`` gives them), the same
    operations as the source it was staged from.  Hashable by identity,
    so ``as_source`` passes it through.
    """

    __slots__ = ("source_cls", "staged")

    def __init__(self, source_cls: type, staged: dict):
        self.source_cls = source_cls
        self.staged = dict(staged)

    def sample(self, photon_ids, seed):
        return sample_one(self.source_cls, self.staged, photon_ids, seed)


class StagedSampler:
    """The round loop's ``sample(ids, seeds)``: ``source_cls``'s
    ``sample_staged`` on ``staged``, a dict of ``(S, ...)`` tensors on
    the run's device.  The loop reads both attributes to hand them to the
    regeneration kernel (``kernels/photon_step/regenerate.py``)."""

    __slots__ = ("source_cls", "staged")

    def __init__(self, source_cls: type, staged: dict):
        self.source_cls = source_cls
        self.staged = staged

    def __call__(self, photon_ids, seeds):
        return self.source_cls.sample_staged(self.staged, photon_ids, seeds)


def stage_source(source) -> tuple[type, dict]:
    """Coerce and stage: returns ``(source class, staged dict)``, the
    dict's values float32 numpy arrays."""
    src = as_source(source)
    if isinstance(src, StagedSource):
        return src.source_cls, dict(src.staged)
    if not hasattr(src, "stage"):
        raise TypeError(
            f"source {type(src).__qualname__} does not support staged "
            f"launch parameters (needs stage()/sample_staged(); required "
            f"for simulate_many batching)")
    return type(src), src.stage()


def staged_structure(source) -> tuple:
    """Hashable structural signature of a source's staged params:
    ``(type_name, ((param, shape), ...))``.  Two sources batch into one
    launch exactly when it matches."""
    cls, staged = stage_source(source)
    return (cls.type_name,
            tuple((k, tuple(np.shape(staged[k]))) for k in sorted(staged)))


# ---------------------------------------------------------------------------
# registry + config serialization
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type] = {}


def register(name: str):
    """Class decorator: add a source type to the registry under ``name``."""

    def deco(cls):
        cls.type_name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def available_sources() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_source_cls(name: str) -> type:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown source type {name!r}; registered: {available_sources()}"
        ) from None


def _jsonify(v):
    if isinstance(v, tuple):
        return [_jsonify(x) for x in v]
    return v


def _unjsonify(v):
    if isinstance(v, (list, tuple)):
        return tuple(_unjsonify(x) for x in v)
    return v


def to_dict(source) -> dict:
    """Serialize a registered source to a JSON-friendly campaign config."""
    d = dataclasses.asdict(source)
    return {"type": source.type_name, **{k: _jsonify(v) for k, v in d.items()}}


def from_dict(d: dict):
    """Rebuild a source from :func:`to_dict` output (lists become tuples
    so the instance stays frozen and hashable)."""
    d = dict(d)
    cls = get_source_cls(d.pop("type"))
    return cls(**{k: _unjsonify(v) for k, v in d.items()})


def as_source(source=None) -> PhotonSource:
    """Coerce user input to a source instance.

    Accepts ``None`` (the paper's pencil beam), a registered source
    instance, the legacy :class:`repro_torch.core.volume.Source`, or a
    :func:`to_dict`-style config dict.
    """
    from repro_torch.core.volume import Source as LegacySource
    from repro_torch.sources.types import Pencil

    if source is None:
        return Pencil()
    if isinstance(source, LegacySource):
        return Pencil(pos=tuple(source.pos), dir=tuple(source.dir))
    if isinstance(source, dict):
        return from_dict(source)
    if isinstance(source, PhotonSource):
        try:
            hash(source)
        except TypeError:
            if hasattr(source, "type_name"):
                # a registered dataclass built with list-typed fields
                return from_dict(to_dict(source))
            raise
        return source
    raise TypeError(f"cannot interpret {source!r} as a photon source")
