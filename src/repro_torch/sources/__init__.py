"""Pluggable photon sources.

Every source is a frozen dataclass with a pure, counter-seeded
``sample(photon_ids, seed) -> (pos, dir, w0, rng)``.  The pencil beam is
the default.

    from repro_torch import sources
    cfgd = sources.to_dict(sources.Pencil(pos=(20, 20, 0)))
    src = sources.from_dict(cfgd)
"""

from repro_torch.sources.base import (
    LAUNCH_STREAM_SALT,
    PhotonSource,
    as_source,
    available_sources,
    flight_stream,
    from_dict,
    get_source_cls,
    launch_stream,
    register,
    to_dict,
)
from repro_torch.sources.types import Pencil

__all__ = [
    "LAUNCH_STREAM_SALT",
    "PhotonSource",
    "as_source",
    "available_sources",
    "flight_stream",
    "from_dict",
    "get_source_cls",
    "launch_stream",
    "register",
    "to_dict",
    "Pencil",
]
