"""Pluggable photon sources.

Every source is a frozen dataclass with a pure, counter-seeded
``sample(photon_ids, seed) -> (pos, dir, w0, rng)``, split into a host
``stage()`` and a ``sample_staged`` that runs on a leading scenario axis
(``base.py``).  The pencil beam is the default.

    from repro_torch import sources
    cfgd = sources.to_dict(sources.Disk(pos=(30, 30, 0), radius=5))
    src = sources.from_dict(cfgd)
"""

from repro_torch.sources.base import (
    LAUNCH_STREAM_SALT,
    PhotonSource,
    StagedSource,
    as_source,
    available_sources,
    flight_stream,
    from_dict,
    get_source_cls,
    launch_stream,
    register,
    stage_source,
    staged_structure,
    to_dict,
)
from repro_torch.sources.types import (
    Cone,
    Disk,
    GaussianBeam,
    IsotropicPoint,
    Line,
    Pencil,
    Planar,
    demo_menu,
)

__all__ = [
    "LAUNCH_STREAM_SALT",
    "PhotonSource",
    "StagedSource",
    "as_source",
    "available_sources",
    "flight_stream",
    "from_dict",
    "get_source_cls",
    "launch_stream",
    "register",
    "stage_source",
    "staged_structure",
    "to_dict",
    "Cone",
    "Disk",
    "GaussianBeam",
    "IsotropicPoint",
    "Line",
    "Pencil",
    "Planar",
    "demo_menu",
]
