"""The AST-tier rules of the port's lint.

Adding a rule: implement it in a module here, append the class to
``ALL_RULES`` and add fixture tests (one that fires, one that stays
quiet) to ``tests/test_torch_lint.py``.  Rule ids and names are the
reference's (``repro.lint``) where a rule has a counterpart there:
pragmas and baselines name them.
"""

from __future__ import annotations

from repro_torch.lint.rules.bench import BenchSchemaRule
from repro_torch.lint.rules.determinism import DeterminismRule
from repro_torch.lint.rules.dtype import DtypeRule
from repro_torch.lint.rules.hostsync import HostSyncRule
from repro_torch.lint.rules.mirror import MirrorRule
from repro_torch.lint.rules.reach import ReachabilityRule
from repro_torch.lint.rules.smem import SharedMemoryRule

ALL_RULES = (
    MirrorRule,         # REP101 mirror-drift
    DeterminismRule,    # REP201 determinism
    DtypeRule,          # REP301 dtype
    HostSyncRule,       # REP401 jit-hygiene: host reads in the round
    SharedMemoryRule,   # REP501 vmem-budget: static shared memory
    ReachabilityRule,   # REP601 reachability
    BenchSchemaRule,    # REP701 bench-schema
)

__all__ = ["ALL_RULES", "MirrorRule", "DeterminismRule", "DtypeRule",
           "HostSyncRule", "SharedMemoryRule", "ReachabilityRule",
           "BenchSchemaRule"]
