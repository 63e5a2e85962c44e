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


def unit(v) -> torch.Tensor:
    """Normalize a static 3-vector in float64, return float32 (CPU)."""
    d = np.asarray(v, np.float64)
    return torch.as_tensor((d / np.linalg.norm(d)).astype(np.float32))


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
