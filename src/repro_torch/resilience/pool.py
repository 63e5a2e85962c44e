"""Fault-tolerant heterogeneous device pool.

The paper's headline result runs *unequal* CPU+GPU devices together
under device-level load balancing; any such fleet serving long
campaigns will see stragglers, hangs, dropped devices, and corrupted
results.  :class:`DevicePool` is the robustness layer that lets the
chunked schedulers survive all of them:

  * **Heterogeneous workers**: each :class:`Worker` wraps one
    :class:`DeviceSpec` ``(device, n_lanes, mode)`` and runs its chunks
    in a process of its own (``core.procs``: a spawned child that builds
    the round loop and holds the volume on its device), so CUDA and CPU
    workers, or several workers on one card, run at once, each with its
    own interpreter.  A dispatch sends the chunk to the worker's
    process, and a chunk is ready when its reply has come: its int64
    totals on the CPU, or the error it raised there.
  * **Retries with caps**: a failed dispatch or rejected result is
    requeued through :class:`RetryPolicy` (exponential backoff, honored
    as a non-blocking eligibility gate); a chunk that exhausts its
    attempt budget is quarantined and recorded, never merged.
  * **Deadlines and speculation**: per-chunk deadlines derive from the
    worker's fitted ``loadbalance.DeviceModel`` (measured samples feed
    back as chunks complete); an overdue chunk is speculatively
    re-dispatched to another worker, the first valid result wins, and
    duplicates are discarded by chunk id.  Throttles and injected delays
    are a "not ready before t" gate, not a sleep.
  * **Abandoned work**: a chunk left on a quarantined worker, and every
    chunk still running when the run ends, is cancelled through its
    process's cancel slot; its round loop raises at its next round's
    host read and its reply is dropped unread, so the run never waits
    for an abandoned chunk.  A process that dies is a failed dispatch
    on its worker (requeued), never a silent loss; the worker's next
    dispatch starts a new one.
  * **Validated merges**: every result comes to the host as int64 totals
    and runs through :func:`validate_chunk` (negative totals, launch
    count, per-chunk energy balance) before it may touch the
    accumulator.
  * **Errors that are not retried**: the kernel's build, load and
    launch errors, what its launches flag and refused arguments
    (``NOT_RETRIED``), raised in a worker's process and pickled back
    with its message, end the run: retrying them on another worker
    would carry the work on off the card because its kernel failed.
    Injected faults and other errors (a lost device) are retried.
  * **Worker health**: healthy -> suspect -> quarantined, with graceful
    degradation down to one device; an empty pool raises
    :class:`PoolExhaustedError` with the full failure history.
  * **Exact merges**: the harvests are int64 fixed-point totals
    (``core.fixed.FixedResult``), so the merged result has the bits
    of one run over the same photons whatever the chunk size, lanes,
    mode, merge order or fault schedule.  Merges still go in chunk-id
    order (a bounded reordering frontier), which keeps the checkpoint a
    contiguous merged prefix.
  * **Bit-classes**: a chunk's bits depend only on the arithmetic of
    the device that ran it.  A worker's class is its device type
    (``"cuda"``, ``"cpu"``); each chunk is bound round-robin to one of
    the pool's classes, so retries and speculation move a chunk only
    between workers of its class; a chunk that really failed on a worker
    (not by an injected fault) is bound to that worker's class even
    when the pool binds none.  If a class loses its last live worker to
    scheduled dropouts, its chunks are re-bound to survive (counted in
    ``PoolReport.rebound``: bit-identity then holds only to the
    tolerance between the two devices' arithmetic, for exactly those
    chunks); if it lost one to real failures, the run raises
    :class:`PoolExhaustedError` instead of moving the chunks to another
    device type (a card's work to the CPU's host kernel).
  * **Checkpoints**: every ``checkpoint_every`` merged chunks the
    contiguous merged prefix is saved through the atomic
    ``checkpoint.Checkpointer``, its totals in int64; ``run(resume=True)``
    restores it and only simulates the remainder.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED
from concurrent.futures import wait as wait_futures
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import procs
from repro_torch.core import simulator as S
from repro_torch.core.fixed import (FixedResult, add_fixed, fixed_from_state,
                                    fixed_state, harvest_result, zero_fixed)
from repro_torch.core.loadbalance import DeviceModel, model_from_samples
from repro_torch.core.volume import SimConfig, Volume
from repro_torch.detectors import as_detectors
from repro_torch.kernels.photon_step.ops import (engine_of, resolve_device,
                                                 visible_devices)
from repro_torch.kernels.photon_step.photon_step import KernelError
from repro_torch.resilience.faults import FaultInjector, InjectedFault
from repro_torch.resilience.policy import (HEALTHY, QUARANTINED, SUSPECT,
                                           RetryPolicy)
from repro_torch.resilience.validate import corrupt_harvest, validate_chunk
from repro_torch.sources import as_source
from repro_torch.telemetry.trace import device_label


# the longest the run loop waits before it looks at the fleet again
_IDLE_S = 0.05


class PoolExhaustedError(RuntimeError):
    """Every worker has been quarantined/dropped with work remaining."""


class ChunkQuarantinedError(RuntimeError):
    """A chunk exhausted its retry budget (raise_on_quarantine=True)."""


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One worker's execution recipe: device, lane count and mode.

    ``device=None`` is the CUDA device (a machine without one raises).
    ``label`` names the worker in reports, fault schedules
    (``FaultInjector.dropout``) and telemetry; it defaults to
    ``w<i>:<type>:<index>``.  ``throttle_s`` imposes a per-chunk latency
    floor: a *simulated* slow device, used by tests and the chip smoke
    run to build unequal fleets on identical hardware (the paper's
    unequal-device setup).
    """

    device: Any = None
    n_lanes: int = 1024
    mode: str = "dynamic"
    label: str | None = None
    throttle_s: float = 0.0

    @property
    def bit_class(self) -> str:
        """Workers sharing this key produce bit-identical chunk results:
        the device type.  Lanes and mode change no bit of a chunk's
        int64 totals."""
        return torch.device("cuda" if self.device is None
                            else self.device).type


class Worker:
    """One pool member: a spec, its health, and its measured samples."""

    def __init__(self, spec: DeviceSpec, index: int, slot: int):
        self.spec = spec
        self.device = resolve_device(spec.device)
        self.slot = slot  # which of its device's processes it runs in
        self.label = spec.label or f"w{index}:{device_label(self.device)}"
        self.health = HEALTHY
        self.consecutive_failures = 0
        self.n_dispatched = 0
        self.n_merged = 0
        self.photons_merged = 0
        self.failures = 0
        self.samples: list[tuple[float, float]] = []  # (photons, seconds)
        self.busy = False
        self.dropped = False  # quarantined by a scheduled dropout
        self.last_error: BaseException | None = None
        self._model: DeviceModel | None = None

    @property
    def bit_class(self) -> str:
        return self.spec.bit_class

    def record_sample(self, photons: int, seconds: float) -> None:
        if seconds > 0:
            self.samples.append((float(photons), float(seconds)))
            self._model = None  # refit lazily

    @property
    def model(self) -> DeviceModel | None:
        """Runtime model fitted from this worker's completed chunks
        (the measured-throughput feedback loop)."""
        if self._model is None and self.samples:
            self._model = model_from_samples(self.samples, name=self.label)
        return self._model

    def predict_s(self, photons: int) -> float | None:
        m = self.model
        return m.predict(photons) if m is not None else None

    def summary(self) -> dict:
        m = self.model
        return {
            "label": self.label,
            "device": device_label(self.device),
            "n_lanes": int(self.spec.n_lanes),
            "health": self.health,
            "chunks_merged": self.n_merged,
            "photons_merged": self.photons_merged,
            "dispatched": self.n_dispatched,
            "failures": self.failures,
            "photons_per_s": (m.throughput if m is not None else None),
        }


@dataclasses.dataclass
class PoolReport:
    """Resilience accounting of one :meth:`DevicePool.run`."""

    n_chunks: int = 0
    merged: int = 0
    retries: int = 0               # chunk re-entries into the queue
    speculative: int = 0           # deadline-triggered re-dispatches
    duplicates_discarded: int = 0  # late results for already-merged chunks
    validation_failures: int = 0   # results rejected by validate_chunk
    dispatch_failures: int = 0     # dispatches that raised
    injected_faults: int = 0       # ... of which were FaultInjector's
    rebound: int = 0               # chunks re-bound after class extinction
    workers_quarantined: int = 0   # workers dropped/quarantined mid-run
    checkpoints: int = 0
    wall_s: float = 0.0
    quarantined_chunks: list = dataclasses.field(default_factory=list)
    chunk_failures: dict = dataclasses.field(default_factory=dict)
    workers: list = dataclasses.field(default_factory=list)
    per_device_photons: dict = dataclasses.field(default_factory=dict)

    @property
    def quarantine_events(self) -> int:
        """Total quarantine events (poison chunks + lost workers)."""
        return len(self.quarantined_chunks) + self.workers_quarantined

    def counters(self) -> dict:
        """Flat numeric counters (telemetry sinks, benchmark JSON)."""
        return {
            "chunks": self.n_chunks,
            "merged": self.merged,
            "retries": self.retries,
            "speculative": self.speculative,
            "duplicates_discarded": self.duplicates_discarded,
            "validation_failures": self.validation_failures,
            "dispatch_failures": self.dispatch_failures,
            "injected_faults": self.injected_faults,
            "rebound": self.rebound,
            "quarantined_chunks": len(self.quarantined_chunks),
            "workers_quarantined": self.workers_quarantined,
            "quarantine_events": self.quarantine_events,
            "checkpoints": self.checkpoints,
            "wall_s": self.wall_s,
        }

    def to_dict(self) -> dict:
        return {**self.counters(),
                "quarantined": [(c.start_id, c.count)
                                for c in self.quarantined_chunks],
                "chunk_failures": dict(self.chunk_failures),
                "workers": list(self.workers)}


@dataclasses.dataclass
class _Chunk:
    start_id: int
    count: int


class _Task:
    """Per-chunk scheduler state."""

    __slots__ = ("chunk", "idx", "bound", "failures", "retry_at", "merged",
                 "quarantined", "inflight", "reasons", "last_error",
                 "harvest", "merged_by")

    def __init__(self, chunk, idx, bound):
        self.chunk = chunk
        self.idx = idx
        self.bound = bound          # bit-class this chunk is bound to
        self.failures = 0
        self.retry_at = 0.0
        self.merged = False
        self.quarantined = False
        self.inflight = 0
        self.reasons: list[str] = []
        self.last_error: BaseException | None = None
        self.harvest: FixedResult | None = None  # valid, awaiting frontier
        self.merged_by: Worker | None = None


class _Inflight:
    __slots__ = ("task", "worker", "attempt", "future", "span", "t0",
                 "ready_at", "deadline", "speculated")

    def __init__(self, task, worker, attempt, future, span, t0, ready_at,
                 deadline):
        self.task = task
        self.worker = worker
        self.attempt = attempt
        self.future = future  # the request in the worker's process
        self.span = span
        self.t0 = t0
        self.ready_at = ready_at
        self.deadline = deadline
        self.speculated = False

    def abandon(self, outcome: str) -> None:
        """Stop waiting for this chunk: its round loop stops at its next
        round, and its result, if any, is never read."""
        procs.abandon(self.future)
        if self.span is not None:
            self.span.end(outcome=outcome)


# Errors a retry cannot cure, raised out of the run rather than retried:
# the kernel's build, load and launch errors (KernelError), what its
# launches flag (OverflowError for a fixed-point total past its range,
# ValueError for a Jacobian column out of range) and arguments that it
# or the round loop refuse (ValueError, TypeError).  Each would fail
# again, and a retry on a worker of another type would carry the work
# on off the card because its kernel failed.
NOT_RETRIED = (KernelError, OverflowError, ValueError, TypeError)


class DevicePool:
    """Resilient chunk executor over heterogeneous device workers.

    ``specs`` defaults to one worker per CUDA device (a machine without
    one raises; a CPU worker must be asked for in a spec).  See the
    module docstring for the full semantics; ``run()`` returns
    ``(SimResult, PoolReport)`` and ``run_fixed()`` the merged int64
    totals in place of the ``SimResult``.
    """

    def __init__(self, volume: Volume, cfg: SimConfig,
                 specs: Sequence[DeviceSpec] | None = None, *,
                 source=None, detectors=None, record_detected: int = 0,
                 retry_policy: RetryPolicy | None = None,
                 fault_injector: FaultInjector | None = None,
                 validate: bool = True, max_residue_frac: float = 5e-3,
                 chunk_timeout_s: float | None = None,
                 deadline_factor: float = 4.0, deadline_slack_s: float = 1.0,
                 bind_classes: bool = True,
                 raise_on_quarantine: bool = True,
                 checkpointer=None, checkpoint_every: int = 0,
                 tracer=None):
        self.volume = volume
        self.cfg = cfg
        if specs is None:
            specs = [DeviceSpec(device=d) for d in visible_devices("cuda")]
        if not specs:
            raise ValueError("DevicePool needs at least one DeviceSpec")
        devices = [resolve_device(spec.device) for spec in specs]
        self.workers = [Worker(spec, i, slot) for i, (spec, slot) in
                        enumerate(zip(specs, procs.slots(devices)))]
        labels = [w.label for w in self.workers]
        if len(set(labels)) != len(labels):
            raise ValueError(f"worker labels must be unique, got {labels}")
        self.policy = retry_policy or RetryPolicy()
        self.injector = fault_injector
        self.validate = bool(validate)
        self.max_residue_frac = float(max_residue_frac)
        self.chunk_timeout_s = chunk_timeout_s
        self.deadline_factor = float(deadline_factor)
        self.deadline_slack_s = float(deadline_slack_s)
        self.bind_classes = bool(bind_classes)
        self.raise_on_quarantine = bool(raise_on_quarantine)
        self.checkpointer = checkpointer
        self.checkpoint_every = int(checkpoint_every)
        self.tracer = tracer
        self._default_source = as_source(source)
        self.detectors = as_detectors(detectors)
        self.record_detected = int(record_detected)
        # what the workers' processes build their round loops from, by
        # (source, lanes, mode)
        self._works: dict[tuple, procs.Work] = {}
        # deterministic class order for binding: list order of first
        # appearance in `specs`, so the binding depends only on the spec
        # list, never on which workers survive
        self._classes: list[str] = []
        for w in self.workers:
            if w.bit_class not in self._classes:
                self._classes.append(w.bit_class)
        self._rebound_count = 0

    # -- executors -----------------------------------------------------------

    def _work_for(self, source, w: Worker) -> procs.Work:
        key = (source, int(w.spec.n_lanes), w.spec.mode)
        if key not in self._works:
            self._works[key] = procs.sim_work(
                self.volume, self.cfg, w.spec.n_lanes, w.spec.mode, source,
                self.detectors, self.record_detected)
        return self._works[key]

    # -- fleet bookkeeping ---------------------------------------------------

    def live_workers(self) -> list[Worker]:
        return [w for w in self.workers if w.health != QUARANTINED]

    def _quarantine_worker(self, w: Worker, report: PoolReport,
                           reason: str) -> None:
        if w.health == QUARANTINED:
            return
        w.health = QUARANTINED
        report.workers_quarantined += 1
        if self.tracer is not None:
            self.tracer.counter("resilience.worker_quarantined", 1,
                                worker=w.label, reason=reason)

    def _mark_failure(self, w: Worker, report: PoolReport,
                      reason: str) -> None:
        w.failures += 1
        w.consecutive_failures += 1
        health = self.policy.health_for(w.consecutive_failures)
        if health == QUARANTINED:
            self._quarantine_worker(w, report, reason)
        else:
            w.health = health

    def _mark_success(self, w: Worker) -> None:
        w.consecutive_failures = 0
        if w.health == SUSPECT:
            w.health = HEALTHY

    # -- chunk failure routing ----------------------------------------------

    def _chunk_failed(self, task: _Task, report: PoolReport, reason: str,
                      now: float, pending: deque,
                      error: BaseException | None = None) -> None:
        task.failures += 1
        task.reasons.append(reason)
        if error is not None:
            task.last_error = error
        report.chunk_failures.setdefault(task.chunk.start_id,
                                         []).append(reason)
        if self.policy.exhausted(task.failures):
            task.quarantined = True
            report.quarantined_chunks.append(task.chunk)
            if self.tracer is not None:
                self.tracer.counter("resilience.chunk_quarantined", 1,
                                    chunk_start=task.chunk.start_id,
                                    reason=reason)
        else:
            task.retry_at = now + self.policy.backoff(task.failures)
            report.retries += 1
            if task.inflight == 0 and task not in pending:
                pending.append(task)  # back of the queue: no starvation

    # -- the run loop --------------------------------------------------------

    def run(self, n_photons: int, chunk_size: int, seed: int = 1234,
            source=None, deadline_s: float | None = None, id_offset: int = 0,
            resume: bool = False) -> tuple[S.SimResult, PoolReport]:
        """Simulate ``n_photons`` in ``chunk_size`` chunks across the
        pool; returns ``(SimResult, PoolReport)``, the result on the CPU.
        The arguments are :meth:`run_fixed`'s."""
        fixed, report = self.run_fixed(n_photons, chunk_size, seed, source,
                                       deadline_s, id_offset, resume)
        return S.to_sim_result(fixed), report

    def run_fixed(self, n_photons: int, chunk_size: int, seed: int = 1234,
                  source=None, deadline_s: float | None = None,
                  id_offset: int = 0, resume: bool = False
                  ) -> tuple[FixedResult, PoolReport]:
        """Simulate ``n_photons`` in ``chunk_size`` chunks across the
        pool; returns the merged int64 totals (a ``FixedResult`` on the
        CPU) and the ``PoolReport``.

        ``deadline_s`` bounds the whole run (TimeoutError past it, never
        an unbounded wait).  ``resume=True`` restores the newest
        auto-checkpoint (requires ``checkpointer``) and only simulates
        the chunks past its merged frontier.
        """
        t_start = time.monotonic()
        src = (as_source(source) if source is not None
               else self._default_source)
        chunks = [_Chunk(id_offset + s, min(chunk_size, n_photons - s))
                  for s in range(0, n_photons, chunk_size)]
        n_classes = len(self._classes) if self.bind_classes else 1
        tasks = [
            _Task(ch, i,
                  self._classes[i % n_classes] if self.bind_classes else None)
            for i, ch in enumerate(chunks)
        ]
        report = PoolReport(n_chunks=len(tasks))
        acc = zero_fixed(self.volume.shape, self.volume.media.shape[0],
                         len(self.detectors), self.cfg)
        frontier = 0
        if resume:
            frontier, acc = self._restore(acc, tasks, n_photons, chunk_size,
                                          seed, src)
            for t in tasks[:frontier]:
                if not t.quarantined:
                    t.merged = True
                    report.merged += 1
        pending: deque[_Task] = deque(t for t in tasks if not t.merged
                                      and not t.quarantined)
        inflight: list[_Inflight] = []
        try:
            acc = self._loop(tasks, pending, inflight, acc, report,
                             frontier, t_start, deadline_s, n_photons,
                             chunk_size, seed, src)
        finally:
            # the run waits for no chunk still in a worker's process:
            # each stops at its next round, its reply dropped unread
            for inf in inflight:
                inf.abandon("abandoned")
            for w in self.workers:
                w.busy = False

        report.wall_s = time.monotonic() - t_start
        report.workers = [w.summary() for w in self.workers]
        for w in self.workers:
            did = device_label(w.device)
            report.per_device_photons[did] = (
                report.per_device_photons.get(did, 0) + w.photons_merged)
        self._emit_counters(report)
        if report.quarantined_chunks and self.raise_on_quarantine:
            qc = report.quarantined_chunks[0]
            raise ChunkQuarantinedError(
                f"{len(report.quarantined_chunks)} chunk(s) exhausted "
                f"their {self.policy.max_attempts}-attempt budget; first: "
                f"chunk {qc.start_id} (+{qc.count}) after failures "
                f"{report.chunk_failures.get(qc.start_id)}"
            ) from tasks[[t.chunk for t in tasks].index(qc)].last_error
        return acc, report

    def _loop(self, tasks, pending, inflight, acc, report, frontier,
              t_start, deadline_s, n_photons, chunk_size, seed,
              src) -> FixedResult:
        """Run the chunks to their end; returns the accumulator with
        every merged chunk added."""
        last_ckpt_merged = report.merged

        def all_done() -> bool:
            return all(t.merged or t.quarantined for t in tasks)

        while not all_done():
            now = time.monotonic()
            if deadline_s is not None and now - t_start > deadline_s:
                stuck = [(i.task.chunk.start_id, i.worker.label)
                         for i in inflight]
                raise TimeoutError(
                    f"pool run exceeded deadline_s={deadline_s}: "
                    f"{report.merged}/{len(tasks)} chunks merged, "
                    f"inflight {stuck}")
            progressed = False

            # scheduled device dropout (the chaos layer's fleet faults)
            if self.injector is not None:
                for w in self.live_workers():
                    if self.injector.dropped(w.label, w.n_dispatched):
                        w.dropped = True
                        self._quarantine_worker(w, report,
                                                "injected dropout")
                        progressed = True

            # harvest ready results
            for inf in list(inflight):
                if now < inf.ready_at or not inf.future.done():
                    continue
                inflight.remove(inf)
                inf.worker.busy = False
                inf.task.inflight -= 1
                progressed = True
                self._complete(inf, report, time.monotonic(), pending)

            # lost workers keep "computing" forever as far as the pool
            # is concerned; their inflight entries are abandoned and the
            # chunks requeued (unless already merged elsewhere)
            for inf in list(inflight):
                if inf.worker.health == QUARANTINED:
                    inflight.remove(inf)
                    inf.task.inflight -= 1
                    inf.abandon("abandoned")
                    if not (inf.task.merged or inf.task.quarantined
                            or inf.task.inflight > 0
                            or inf.task in pending):
                        inf.task.retry_at = 0.0
                        report.retries += 1
                        pending.appendleft(inf.task)
                    progressed = True

            # deadline scan: overdue chunks speculate on another worker
            # (not a chunk whose valid result waits for the frontier)
            for inf in inflight:
                if (inf.deadline is not None and not inf.speculated
                        and now - inf.t0 > inf.deadline
                        and not inf.task.merged
                        and inf.task.harvest is None):
                    inf.speculated = True
                    if inf.worker.health == HEALTHY:
                        inf.worker.health = SUSPECT
                    if inf.task.inflight == 1 and inf.task not in pending:
                        inf.task.retry_at = 0.0
                        report.speculative += 1
                        pending.appendleft(inf.task)
                        progressed = True
                        if self.tracer is not None:
                            self.tracer.counter(
                                "resilience.speculative_dispatch", 1,
                                chunk_start=inf.task.chunk.start_id,
                                worker=inf.worker.label)

            # merge the contiguous frontier (chunk-id order: the
            # checkpoint is always a merged prefix)
            while frontier < len(tasks):
                t = tasks[frontier]
                if t.quarantined and t.harvest is None:
                    frontier += 1
                    continue
                if t.harvest is None:
                    break
                acc = self._merge(acc, t, report)
                frontier += 1
                progressed = True
                if (self.checkpointer is not None and self.checkpoint_every
                        and report.merged - last_ckpt_merged
                        >= self.checkpoint_every):
                    self._save_checkpoint(acc, frontier, tasks, n_photons,
                                          chunk_size, seed, src, report)
                    last_ckpt_merged = report.merged
                if self.injector is not None:
                    # the injected host crash fires after the checkpoint
                    # (a host dying between saves; the atomic writer
                    # already covers torn files)
                    self.injector.maybe_kill(report.merged)

            live = self.live_workers()
            if not live and not all_done():
                raise PoolExhaustedError(
                    f"every worker is quarantined with "
                    f"{len(tasks) - report.merged} chunks unfinished; "
                    f"worker history: {[w.summary() for w in self.workers]}")

            # dispatch: healthy workers first, suspects as last resort
            for w in sorted((w for w in live if not w.busy),
                            key=lambda w: w.health != HEALTHY):
                task = self._next_task(pending, w, now)
                if task is None:
                    continue
                pending.remove(task)
                self._dispatch(w, task, seed, src, report, inflight,
                               pending)
                progressed = True

            if not progressed:
                self._idle(inflight, pending, now, t_start, deadline_s)
        return acc

    def _idle(self, inflight, pending, now, t_start, deadline_s) -> None:
        """Wait until a running chunk's reply comes (or its process
        dies) or the next timed event is due (a result's ready gate, a
        chunk deadline, a retry's backoff, the run's deadline; at most
        ``_IDLE_S``)."""
        events = [inf.ready_at for inf in inflight]
        events += [inf.t0 + inf.deadline for inf in inflight
                   if inf.deadline is not None and not inf.speculated]
        events += [t.retry_at for t in pending]
        if deadline_s is not None:
            events.append(t_start + deadline_s)
        timeout = min([e - now for e in events if e > now] + [_IDLE_S])
        if inflight:
            wait_futures([inf.future for inf in inflight], timeout,
                         FIRST_COMPLETED)
        else:
            time.sleep(timeout)

    # -- dispatch / completion ----------------------------------------------

    def _next_task(self, pending: deque, w: Worker,
                   now: float) -> _Task | None:
        """First eligible pending task for this worker (binding-aware)."""
        for task in pending:
            if (task.merged or task.quarantined or task.harvest is not None
                    or task.retry_at > now):
                continue
            if task.bound is not None and task.bound != w.bit_class:
                # the bound class may have lost its last worker; only
                # then, and only to scheduled dropouts, may a foreign
                # worker steal the chunk (bit-identity degrades to the
                # devices' tolerance for this chunk)
                bound = [lw for lw in self.workers
                         if lw.bit_class == task.bound]
                if any(lw.health != QUARANTINED for lw in bound):
                    continue
                if not all(lw.dropped for lw in bound):
                    raise PoolExhaustedError(
                        f"every {task.bound} worker is quarantined, not "
                        f"all by a scheduled dropout, and chunk "
                        f"{task.chunk.start_id} (+{task.chunk.count}) is "
                        f"bound to {task.bound}: it does not move to "
                        f"another device type; worker history: "
                        f"{[lw.summary() for lw in bound]}"
                    ) from task.last_error or next(
                        (lw.last_error for lw in bound if lw.last_error),
                        None)
                task.bound = w.bit_class
                self._report_rebound(task)
            return task
        return None

    def _report_rebound(self, task: _Task) -> None:
        self._rebound_count += 1
        if self.tracer is not None:
            self.tracer.counter("resilience.chunk_rebound", 1,
                                chunk_start=task.chunk.start_id)

    def _dispatch(self, w: Worker, task: _Task, seed: int, src,
                  report: PoolReport, inflight: list[_Inflight],
                  pending: deque) -> None:
        ch = task.chunk
        attempt = task.failures
        w.n_dispatched += 1
        span = None
        if self.tracer is not None:
            # labelled by name: ending the span must not synchronise the
            # device other workers are running on
            span = self.tracer.span("chunk", device=device_label(w.device),
                                    engine=engine_of(w.device),
                                    photons=ch.count, chunk_start=ch.start_id,
                                    attempt=attempt, worker=w.label)
        now = time.monotonic()
        delay = w.spec.throttle_s
        try:
            if self.injector is not None:
                self.injector.check_dispatch(ch.start_id, attempt, w.label)
                delay = max(delay, self.injector.delay_for(ch.start_id,
                                                           attempt))
            work = self._work_for(src, w)
            proc = procs.child(w.device, w.slot)
            proc.run = procs.run_types(v.device for v in self.workers)
            request = proc.submit("sim", work, (ch.count, seed, ch.start_id))
        except InjectedFault as e:
            if span is not None:
                span.end(outcome="injected-fault")
            report.dispatch_failures += 1
            report.injected_faults += 1
            self._mark_failure(w, report, str(e))
            self._chunk_failed(task, report, f"dispatch: {e}", now, pending,
                               e)
            return
        except NOT_RETRIED:
            if span is not None:
                span.end(outcome="error")
            raise
        except Exception as e:  # a real dispatch error: requeue + surface
            self._dispatch_error(w, task, report, span, e, now, pending)
            return
        deadline = self.chunk_timeout_s
        predicted = w.predict_s(ch.count)
        if predicted is not None:
            model_deadline = (self.deadline_factor * predicted
                              + self.deadline_slack_s)
            deadline = (model_deadline if deadline is None
                        else min(deadline, model_deadline))
        task.inflight += 1
        w.busy = True
        inflight.append(_Inflight(task, w, attempt, request, span, now,
                                  now + delay, deadline))

    def _dispatch_error(self, w, task, report, span, error, now,
                        pending) -> None:
        if span is not None:
            span.end(outcome="error")
        if task.bound is None:
            task.bound = w.bit_class  # a real failure: not off its type
        w.last_error = error
        report.dispatch_failures += 1
        self._mark_failure(w, report, repr(error))
        self._chunk_failed(task, report, f"dispatch: {error!r}", now,
                           pending, error)

    def _complete(self, inf: _Inflight, report: PoolReport,
                  now: float, pending: deque) -> None:
        task, w = inf.task, inf.worker
        elapsed = now - inf.t0
        reply = procs.reply(inf.future)
        error = None if reply.ok else reply.value
        settled = task.merged or task.harvest is not None or task.quarantined
        if isinstance(error, NOT_RETRIED):
            if inf.span is not None:
                inf.span.end(outcome="error")
            raise error
        if error is not None:
            # the chunk raised in its process, or the process died: a
            # failed dispatch, which requeues the chunk unless a twin
            # already settled it
            if not settled:
                self._dispatch_error(w, task, report, inf.span, error, now,
                                     pending)
                return
            if inf.span is not None:
                inf.span.end(outcome="error")
            report.dispatch_failures += 1
            self._mark_failure(w, report, repr(error))
            return
        if settled:
            # a speculative twin (or a late result for a quarantined
            # chunk) already settled this chunk id: discard, but keep
            # the timing sample: the worker did real work
            report.duplicates_discarded += 1
            if inf.span is not None:
                inf.span.end(outcome="duplicate")
            w.record_sample(task.chunk.count, elapsed)
            return
        harvest = harvest_result(reply.value)
        injected = self.injector is not None and \
            self.injector.corrupts(task.chunk.start_id, inf.attempt)
        if injected:
            harvest = corrupt_harvest(harvest)
            report.injected_faults += 1
        errs = (validate_chunk(harvest, task.chunk.count,
                               self.max_residue_frac)
                if self.validate else [])
        if errs:
            if inf.span is not None:
                inf.span.end(outcome="invalid")
            report.validation_failures += 1
            if task.bound is None and not injected:
                task.bound = w.bit_class
            self._mark_failure(w, report, errs[0])
            self._chunk_failed(task, report, f"validation: {errs}", now,
                               pending)
            return
        if inf.span is not None:
            inf.span.end(outcome="merged")
        w.record_sample(task.chunk.count, elapsed)
        self._mark_success(w)
        task.harvest = harvest
        task.merged_by = w

    # -- accumulation --------------------------------------------------------

    def _merge(self, acc: FixedResult, task: _Task,
               report: PoolReport) -> FixedResult:
        acc = add_fixed(acc, task.harvest)
        task.harvest = None
        task.merged = True
        report.merged += 1
        w = task.merged_by
        if w is not None:
            w.n_merged += 1
            w.photons_merged += task.chunk.count
        return acc

    # -- checkpoint / resume -------------------------------------------------

    def _run_key(self, n_photons: int, chunk_size: int, seed: int,
                 src) -> np.ndarray:
        """Campaign identity: mixing checkpoints across different
        configs would merge incompatible accumulators."""
        from repro_torch.detectors import to_dicts
        from repro_torch.sources import to_dict as source_to_dict

        src_key = (json.dumps(source_to_dict(src), sort_keys=True)
                   if hasattr(src, "type_name")
                   else f"<custom:{type(src).__qualname__}>")
        key = json.dumps({
            "n_photons": int(n_photons), "chunk_size": int(chunk_size),
            "seed": int(seed), "source": src_key,
            "detectors": to_dicts(self.detectors),
            "record_detected": self.record_detected,
        }, sort_keys=True)
        return np.frombuffer(key.encode(), np.uint8)

    def _state_dict(self, acc: FixedResult, frontier: int, tasks: list,
                    n_photons: int, chunk_size: int, seed: int,
                    src) -> dict:
        return {
            **fixed_state(acc),
            "steps": np.int64(acc.steps),
            "frontier": np.int64(frontier),
            "quarantined": np.asarray(
                [(t.chunk.start_id, t.chunk.count)
                 for t in tasks if t.quarantined], np.int64).reshape(-1, 2),
            "run_key": self._run_key(n_photons, chunk_size, seed, src),
        }

    def _save_checkpoint(self, acc, frontier, tasks, n_photons, chunk_size,
                         seed, src, report: PoolReport) -> None:
        state = self._state_dict(acc, frontier, tasks, n_photons,
                                 chunk_size, seed, src)
        self.checkpointer.save(frontier, state,
                               extra={"kind": "device_pool",
                                      "merged": report.merged,
                                      **{k: v for k, v in
                                         report.counters().items()
                                         if isinstance(v, int)}})
        report.checkpoints += 1
        if self.tracer is not None:
            self.tracer.counter("resilience.checkpoint", frontier)

    def _restore(self, acc: FixedResult, tasks: list, n_photons: int,
                 chunk_size: int, seed: int, src
                 ) -> tuple[int, FixedResult]:
        """Load the newest checkpoint; returns the merged frontier and
        the accumulator it holds (``(0, acc)`` when no checkpoint exists
        yet)."""
        if self.checkpointer is None:
            raise ValueError("resume=True needs a checkpointer")
        if self.checkpointer.latest_step() is None:
            return 0, acc
        template = self._state_dict(acc, 0, [], n_photons, chunk_size, seed,
                                    src)
        _, state = self.checkpointer.restore(template)
        want = self._run_key(n_photons, chunk_size, seed, src)
        got = np.asarray(state["run_key"], np.uint8)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise ValueError(
                f"checkpoint belongs to a different campaign: "
                f"{bytes(got).decode()} vs {bytes(want).decode()}")
        acc = fixed_from_state(state, acc, int(state["steps"]))
        quarantined = {int(s) for s, _ in
                       np.asarray(state["quarantined"],
                                  np.int64).reshape(-1, 2)}
        frontier = int(state["frontier"])
        for t in tasks[:frontier]:
            if t.chunk.start_id in quarantined:
                t.quarantined = True
        return frontier, acc

    # -- telemetry -----------------------------------------------------------

    def _emit_counters(self, report: PoolReport) -> None:
        report.rebound = self._rebound_count
        self._rebound_count = 0
        if self.tracer is None:
            return
        for k, v in report.counters().items():
            self.tracer.counter(f"resilience.{k}", v)
