"""Retry and health policies for resilient chunk execution.

Retries are *safe* here in a way they are not in most distributed
systems: photons are keyed by 64-bit global id, so re-dispatching a
chunk reproduces the exact same photon set bit for bit.  The policy
layer only has to decide *when to stop*: a chunk that keeps failing is
a poison pill (bad input, a broken device pairing, an injector's
``poison_chunks``) and must be quarantined instead of starving the
campaign, and a worker that keeps failing must stop receiving work
before it burns the retry budget of every chunk it touches.

The port keeps its own copy of the reference's module, which has no
JAX in it (``repro/resilience/policy.py``): every decision is the same
in both (``tests/test_torch_resilience.py``).
"""

from __future__ import annotations

import dataclasses

# Worker health ladder: healthy -> suspect -> quarantined.  Suspect
# workers still receive work (they are deprioritized behind healthy
# ones); quarantined workers are out of the fleet for the rest of the
# run.  One success climbs a worker back to healthy.
HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Attempt caps, backoff, and worker health thresholds.

    ``max_attempts`` bounds the total number of dispatches of one chunk
    (counting the first); a chunk that fails ``max_attempts`` times is
    quarantined — recorded, never merged, never retried again.  Backoff
    is exponential (``backoff_s * backoff_factor**(attempt-1)``, capped
    at ``max_backoff_s``) and is honored by the pool as a "not eligible
    before t" gate, never a blocking sleep, so other chunks keep
    flowing while a flaky one cools down.

    ``suspect_after`` / ``quarantine_after`` count *consecutive*
    failures of one worker (any success resets the streak).
    """

    max_attempts: int = 5
    backoff_s: float = 0.0
    backoff_factor: float = 2.0
    max_backoff_s: float = 2.0
    suspect_after: int = 2
    quarantine_after: int = 5

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.quarantine_after < self.suspect_after:
            raise ValueError("quarantine_after must be >= suspect_after")
        if self.backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff durations must be >= 0")

    def backoff(self, attempt: int) -> float:
        """Cool-down seconds before retry number ``attempt`` (1-based:
        the first retry is attempt 1)."""
        if self.backoff_s <= 0.0:
            return 0.0
        return min(self.backoff_s * self.backoff_factor ** max(attempt - 1, 0),
                   self.max_backoff_s)

    def exhausted(self, failures: int) -> bool:
        """True once a chunk has failed away its whole attempt budget."""
        return failures >= self.max_attempts

    def health_for(self, consecutive_failures: int) -> str:
        """Health state implied by a worker's current failure streak."""
        if consecutive_failures >= self.quarantine_after:
            return QUARANTINED
        if consecutive_failures >= self.suspect_after:
            return SUSPECT
        return HEALTHY
