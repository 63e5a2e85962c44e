"""Deterministic, seeded fault injection.

Chaos testing a Monte Carlo scheduler only proves something if the
fault schedule is *reproducible*: the anchor property, "under any
injected fault schedule the final result is bit-identical to the
fault-free run", needs the same faults to fire on every replay of a
failing seed.  :class:`FaultInjector` therefore derives every decision
from a counter-based hash of ``(seed, kind, chunk_id, attempt)``
(splitmix64), never from wall-clock time, scheduling order, or Python's
randomized ``hash``.  A chunk's fate on its k-th attempt is a pure
function of the injector config, independent of which worker picks it
up or when.

Fault kinds (all off by default):

  * ``p_fail``: the dispatch raises :class:`InjectedFault` (a device
    that died mid-chunk);
  * ``poison_chunks``: chunk start-ids whose dispatch *always* fails
    (a deterministic poison pill; exercises retry caps and quarantine);
  * ``p_delay`` / ``delay_s``: the result is withheld for ``delay_s``
    seconds after dispatch (a straggler; exercises deadlines and
    speculative re-dispatch).  The pool honors this as a non-blocking
    "not ready before t" gate;
  * ``p_nan``: the completed chunk's harvest is corrupted before the
    merge (a bad result; exercises ``validate_chunk``);
  * ``dropout``: ``{worker_label: n}``: the labelled worker is
    permanently dropped once it has dispatched ``n`` chunks (a device
    leaving the fleet);
  * ``kill_after_merges``: raise :class:`InjectedCrash` once this many
    chunks have merged (a host crash; exercises checkpoint/restart).

The port keeps its own copy of the reference's module, which has no
JAX in it (``repro/resilience/faults.py``): every decision is the same
in both (``tests/test_torch_resilience.py``).  Used by the pool, the
elastic simulator and the CLI's ``--chaos`` drill.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Mapping

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


class InjectedFault(RuntimeError):
    """A deterministic, injector-scheduled device failure."""


class InjectedCrash(RuntimeError):
    """A deterministic, injector-scheduled host crash (checkpoint
    tests catch this, restore, and finish the campaign)."""


@dataclasses.dataclass(frozen=True)
class FaultInjector:
    """Seeded chaos layer; every decision is replay-stable.

    All probabilities are per ``(chunk, attempt)`` pair, so a failed
    chunk's retry rolls a fresh — but deterministic — die: transient
    faults clear on retry, and only ``poison_chunks`` fail forever.
    """

    seed: int = 0
    p_fail: float = 0.0
    p_nan: float = 0.0
    p_delay: float = 0.0
    delay_s: float = 0.05
    poison_chunks: tuple[int, ...] = ()
    dropout: Mapping[str, int] = dataclasses.field(default_factory=dict)
    kill_after_merges: int | None = None

    def __post_init__(self):
        # JSON configs (--chaos) hand lists/dicts; normalize so the
        # injector stays hashable where it can be
        object.__setattr__(self, "poison_chunks",
                           tuple(int(c) for c in self.poison_chunks))
        object.__setattr__(self, "dropout",
                           {str(k): int(v)
                            for k, v in dict(self.dropout).items()})

    # -- the counter-based coin ---------------------------------------------

    def _uniform(self, kind: str, chunk_id: int, attempt: int) -> float:
        """Deterministic uniform in [0, 1) for one (kind, chunk, attempt)."""
        h = _splitmix64((int(self.seed) & _M64) ^ zlib.crc32(kind.encode()))
        h = _splitmix64(h ^ (int(chunk_id) & _M64))
        h = _splitmix64(h ^ (int(attempt) & _M64))
        return h / float(1 << 64)

    # -- dispatch-time faults -----------------------------------------------

    def check_dispatch(self, chunk_id: int, attempt: int,
                       worker: str = "") -> None:
        """Raise :class:`InjectedFault` if this (chunk, attempt) is
        scheduled to fail; called by the workers at dispatch time."""
        if chunk_id in self.poison_chunks:
            raise InjectedFault(
                f"poison chunk {chunk_id} (attempt {attempt}, "
                f"worker {worker or '?'})")
        if self.p_fail > 0.0 and \
                self._uniform("fail", chunk_id, attempt) < self.p_fail:
            raise InjectedFault(
                f"injected dispatch failure on chunk {chunk_id} "
                f"(attempt {attempt}, worker {worker or '?'})")

    def delay_for(self, chunk_id: int, attempt: int) -> float:
        """Seconds this (chunk, attempt) result is withheld (0 = none)."""
        if self.p_delay > 0.0 and \
                self._uniform("delay", chunk_id, attempt) < self.p_delay:
            return float(self.delay_s)
        return 0.0

    # -- result corruption ---------------------------------------------------

    def corrupts(self, chunk_id: int, attempt: int) -> bool:
        """True when this (chunk, attempt) result is scheduled for
        corruption (``validate.corrupt_harvest``, applied by the caller
        to its host-side copy)."""
        return self.p_nan > 0.0 and \
            self._uniform("nan", chunk_id, attempt) < self.p_nan

    # -- fleet-level schedules ----------------------------------------------

    def dropped(self, worker_label: str, n_dispatched: int) -> bool:
        """True once ``worker_label`` has dispatched its scheduled
        number of chunks and must leave the fleet."""
        limit = self.dropout.get(worker_label)
        return limit is not None and n_dispatched >= limit

    def maybe_kill(self, n_merged: int) -> None:
        """Raise :class:`InjectedCrash` at the scheduled merge count."""
        if self.kill_after_merges is not None and \
                n_merged >= self.kill_after_merges:
            raise InjectedCrash(
                f"injected host crash after {n_merged} merged chunks")

    @property
    def active(self) -> bool:
        """Whether any fault kind is actually configured."""
        return bool(self.p_fail or self.p_nan or self.p_delay or
                    self.poison_chunks or self.dropout or
                    self.kill_after_merges is not None)
