"""Fault-tolerant heterogeneous execution.

Public surface of the robustness layer: the device pool and its specs,
the retry/health policy, the merge-guard validators, and the seeded
chaos injector used by tests, the chip smoke run and the CLI
``--chaos`` drill.  The pool's harvests, accumulators and checkpoints
hold int64 fixed-point totals, and a worker's bit-class is its device
type.
"""

from repro_torch.core.fixed import harvest_result
from repro_torch.resilience.faults import (FaultInjector, InjectedCrash,
                                           InjectedFault)
from repro_torch.resilience.policy import (HEALTHY, QUARANTINED, SUSPECT,
                                           RetryPolicy)
from repro_torch.resilience.pool import (ChunkQuarantinedError, DevicePool,
                                         DeviceSpec, PoolExhaustedError,
                                         PoolReport, Worker)
from repro_torch.resilience.validate import corrupt_harvest, validate_chunk

__all__ = [
    "DevicePool", "DeviceSpec", "Worker", "PoolReport",
    "PoolExhaustedError", "ChunkQuarantinedError",
    "RetryPolicy", "HEALTHY", "SUSPECT", "QUARANTINED",
    "FaultInjector", "InjectedFault", "InjectedCrash",
    "validate_chunk", "harvest_result", "corrupt_harvest",
]
