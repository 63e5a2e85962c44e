"""Multi-device photon simulation on one host.

Maps the paper's heterogeneous multi-device execution (Fig. 1, Fig. 3b/c)
onto a list of torch devices, each device in a process of its own
(``core.procs``: spawned children, reused across calls):

  * :func:`simulate_sharded`: each device of a mesh (a sequence of torch
    devices, e.g. ``[cuda:0, cpu]`` or ``["cpu"] * 4``; a device may
    appear more than once, and then has a process for each place)
    simulates a (possibly unequal) slice of the photon budget, the
    device-level load-balancing partition.  The shards' int64
    fixed-point totals come back to the calling process and are added
    there (``core.fixed.merge_fixed``), which takes the place of the
    reference's one ``psum``, and converted to float32 once.  Because a
    photon's path depends only on ``(seed, global id)`` and each deposit
    is rounded once, the result has the bits of one run over the same
    photons on one device of the same type, whatever the partition,
    lane counts or mode.
  * :func:`sharded_replay_fn`: a replay's record batches split over the
    mesh, each device's process adding into its own int64 Jacobian,
    which cross once and are added at the end.
  * :class:`ChunkScheduler`: dynamic work-stealing over photon chunks;
    the runtime analogue of the paper's "host waits for all devices"
    barrier, without the straggler penalty: fast devices pull more
    chunks.  A front end over ``repro_torch.resilience.DevicePool``.
  * :class:`ElasticSimulator`: fault-tolerant chunk accounting.  The
    counter-based RNG keys photons by *global id*, so a chunk lost to a
    device failure is re-simulated bit-identically elsewhere, and a
    checkpoint is just (accumulated int64 totals + chunk cursor).

A mesh of one device runs in the calling process, as a single run does.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import procs
from repro_torch.core import simulator as S
from repro_torch.core.fixed import (FixedResult, add_fixed, fixed_from_state,
                                    fixed_state, harvest_result, merge_fixed,
                                    zero_fixed)
from repro_torch.core.loadbalance import DeviceModel
from repro_torch.core.volume import SimConfig, Volume
from repro_torch.detectors import as_detectors, validate_detectors
from repro_torch.kernels.photon_step.ops import (engine_of, resolve_device,
                                                 visible_devices)
from repro_torch.resilience import (DevicePool, DeviceSpec, FaultInjector,
                                    InjectedFault, RetryPolicy,
                                    corrupt_harvest, validate_chunk)
from repro_torch.sources import as_source
from repro_torch.telemetry.trace import clock, device_label


# ---------------------------------------------------------------------------
# a mesh of devices, one process a device
# ---------------------------------------------------------------------------

def mesh_devices(mesh) -> list[torch.device]:
    """The devices of a mesh (a sequence of torch devices or their
    names), each checked as ``resolve_device`` checks it."""
    devices = [resolve_device(d) for d in mesh]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return devices


# ---------------------------------------------------------------------------
# sharded runs
# ---------------------------------------------------------------------------

def _per_shard(n_lanes, n_shards: int) -> list[int]:
    lanes = ([int(n_lanes)] * n_shards if np.ndim(n_lanes) == 0
             else [int(x) for x in n_lanes])
    if len(lanes) != n_shards:
        raise ValueError(f"n_lanes must be one count or one a shard "
                         f"({n_shards}), got {len(lanes)}")
    return lanes


def sharded_sim_fn(volume: Volume, cfg: SimConfig, n_lanes, mesh,
                   mode: str = "dynamic", source=None, detectors=None,
                   record_detected: int = 0, tracer=None):
    """Build the shards of a simulation over the devices of ``mesh``.

    Returns ``fn(counts, offsets, seed) -> list[FixedResult]``: shard
    ``i`` runs ``counts[i]`` photons with the global ids from
    ``offsets[i]`` (64-bit Python ints) on ``mesh[i]``, each shard's
    round loop in its device's process, and returns its fixed-point
    result (on the CPU; on its device for a mesh of one);
    ``core.fixed.merge_fixed`` adds them.  Each process builds its round
    loop and copies the volume's labels and media to its device once.
    ``n_lanes`` is one lane count for every shard or one a shard (the
    bits do not depend on it).  ``record_detected`` gives every shard
    its own record buffer of that many rows.  ``tracer`` (a
    ``repro_torch.telemetry.Tracer``) records one ``shard`` span a
    shard, tagged with its device, photons, index and the threads its
    process ran on, and lasting the
    shard's wall in its process (the round loop's last host read ends
    the shard's work).
    """
    devices = mesh_devices(mesh)
    lanes = _per_shard(n_lanes, len(devices))
    if mode not in S.MODES:
        raise ValueError(f"unknown workload mode: {mode}")
    works = [procs.sim_work(volume, cfg, n, mode, source, detectors,
                            record_detected) for n in lanes]
    slots = procs.slots(devices)

    def fn(counts, offsets, seed) -> list[FixedResult]:
        if len(counts) != len(devices) or len(offsets) != len(devices):
            raise ValueError(f"need one count and one offset for each of "
                             f"the {len(devices)} shards")
        t0 = clock()
        replies = procs.run_all([
            procs.Job(d, s, "sim", w, (int(c), seed, int(o)))
            for d, s, w, c, o in zip(devices, slots, works, counts,
                                     offsets)])
        if tracer is not None:
            for i, (d, c, r) in enumerate(zip(devices, counts, replies)):
                tracer.complete("shard", t0, r.wall_s,
                                device=device_label(d), engine=engine_of(d),
                                photons=int(c), shard=i, threads=r.threads)
        return [r.value for r in replies]

    return fn


def shard_counts(n_photons: int, n_shards: int,
                 partition: Sequence[int] | None = None) -> list[int]:
    """Photons a shard: an equal split (the remainder to the first
    shards), or ``partition`` checked to have one entry a shard summing
    to ``n_photons``."""
    if partition is None:
        base = n_photons // n_shards
        return [base + (i < n_photons - base * n_shards)
                for i in range(n_shards)]
    counts = [int(c) for c in partition]
    if len(counts) != n_shards or sum(counts) != n_photons or min(counts) < 0:
        raise ValueError("partition must have one entry per shard and "
                         "sum to n_photons")
    return counts


def shard_offsets(counts: Sequence[int], id_offset: int = 0) -> list[int]:
    """The first global id of each shard: disjoint ranges from
    ``id_offset``, 64-bit."""
    return [int(id_offset) + int(x)
            for x in np.concatenate([[0], np.cumsum(counts)[:-1]])]


def simulate_sharded(volume: Volume, cfg: SimConfig, n_photons: int, mesh,
                     partition: Sequence[int] | None = None,
                     n_lanes=1024, seed: int = 1234, source=None,
                     mode: str = "dynamic", detectors=None,
                     record_detected: int = 0, id_offset: int = 0,
                     tracer=None) -> S.SimResult:
    """Run one simulation over the devices of ``mesh``; returns the
    merged ``SimResult`` on the CPU.

    ``partition`` gives each shard its photons (the device-level load
    balance, e.g. :func:`heterogeneous_partition`); by default they
    split equally.  ``id_offset`` shifts the whole campaign's global
    photon-id range (64-bit); the shards get disjoint ranges from it.
    ``steps`` and ``det_rec_n`` are rank 1, one entry a shard, and
    ``det_rec`` the shards' buffers concatenated, as the reference's
    sharded result; ``replay.detected_records`` reassembles the records.
    ``tracer`` records a span a shard (:func:`sharded_sim_fn`).
    """
    devices = mesh_devices(mesh)
    counts = shard_counts(n_photons, len(devices), partition)
    fn = sharded_sim_fn(volume, cfg, n_lanes, devices, mode, source,
                        detectors, record_detected, tracer)
    return S.to_sim_result(merge_fixed(
        fn(counts, shard_offsets(counts, id_offset), seed)))


def sharded_replay_fn(volume: Volume, cfg: SimConfig, detectors, mesh,
                      n_lanes: int = 1024, source=None,
                      gate_resolved: bool = False):
    """Build a two-pass replay over the devices of ``mesh``.

    The device-parallel half of ``repro_torch.replay.replay_jacobian``:
    every device's process replays its own ``n_lanes``-lane slice of a
    record batch and adds into its own int64 Jacobian total, which stays
    on its device for the whole replay.  Returns ``(run_batch,
    jacobian)``: ``run_batch(id_lo, id_hi, jac_col, active, seed) ->
    (w_exit, gate, replayed_det)`` takes ``len(mesh) * n_lanes`` lanes
    as numpy arrays (``replay``'s batch arrays) and returns the
    per-record outputs in lane order as numpy; ``jacobian()`` ends the
    replay and returns the sum of the totals (int64; on the device
    itself for a mesh of one, else on the CPU, the cells each total
    reached crossing once), whose bits do not depend on the split.  Each shard checks its
    launches' error flags after its slice of a batch.
    """
    dets = as_detectors(detectors)
    n_det = len(dets)
    if n_det == 0:
        raise ValueError("sharded_replay_fn needs the forward run's "
                         "detectors")
    validate_detectors(dets, volume.shape)
    devices = mesh_devices(mesh)
    slots = procs.slots(devices)
    jac_cols = n_det * int(cfg.n_time_gates) if gate_resolved else n_det
    n_lanes = int(n_lanes)
    work = procs.replay_work(volume, cfg, n_lanes, source, dets, jac_cols)

    def each(op, args=lambda i: ()):
        return [r.value for r in procs.run_all([
            procs.Job(d, s, op, work, args(i))
            for i, (d, s) in enumerate(zip(devices, slots))])]

    each("replay_open")

    def run_batch(id_lo, id_hi, col, active, seed):
        def part(i):
            lanes = slice(i * n_lanes, (i + 1) * n_lanes)
            return (id_lo[lanes], id_hi[lanes], col[lanes], active[lanes],
                    seed)
        outs = each("replay_batch", part)
        return tuple(np.concatenate(x) for x in zip(*outs))

    def jacobian() -> torch.Tensor:
        if len(devices) == 1:
            return each("replay_total")[0]
        # each process sends the cells its shard reached; int64 adds
        total = torch.zeros((volume.labels.numel() * jac_cols,),
                            dtype=torch.int64)
        for at, cells in each("replay_total", lambda i: ("cells",)):
            total.index_add_(0, at, cells)
        return total

    return run_batch, jacobian


def heterogeneous_partition(n_photons: int, models: Sequence[DeviceModel],
                            strategy: str = "S2") -> list[int]:
    """Convenience: partition a photon budget with a paper strategy."""
    from repro_torch.core.loadbalance import PARTITIONERS

    return PARTITIONERS[strategy](n_photons, models)


# ---------------------------------------------------------------------------
# chunked work queue: straggler mitigation + heterogeneous devices
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Chunk:
    start_id: int
    count: int


class ChunkScheduler:
    """Greedy dynamic chunk dispatch across devices.

    The device-level generalization of the paper's *workgroup* dynamic
    load balancing: instead of fixing each device's share up front
    (S1-S3), devices pull fixed-size chunks from a shared queue as they
    finish.  Each device runs its chunks in a process of its own, so
    while one device crunches chunk k the host hands k+1 to another.

    A front end over ``repro_torch.resilience.DevicePool``: a dispatch
    that raises requeues the chunk through ``RetryPolicy`` instead of
    losing it, results pass the ``validate_chunk`` merge guard,
    stragglers past their ``DeviceModel`` deadline re-dispatch
    speculatively, ``deadline_s`` bounds the whole run, and the int64
    totals merge to the bits of one run over the same photons.
    ``devices`` defaults to every CUDA device (a machine without one
    raises); heterogeneous fleets pass ``specs`` (a list of
    ``resilience.DeviceSpec``) instead; ``fault_injector`` enables the
    chaos drill.

    ``tracer`` (a ``repro_torch.telemetry.Tracer``) records one span per
    chunk dispatch, opened when the chunk is handed to its worker and
    closed when its result is taken, tagged with device, engine and
    photon count, so the run's timeline exports to Chrome tracing and
    its per-device photons/s feed ``telemetry.fit_device_models``.
    """

    def __init__(self, volume: Volume, cfg: SimConfig, n_lanes: int = 1024,
                 devices=None, mode: str = "dynamic", source=None,
                 detectors=None, record_detected: int = 0, tracer=None,
                 specs: Sequence[DeviceSpec] | None = None,
                 retry_policy: RetryPolicy | None = None,
                 fault_injector: FaultInjector | None = None,
                 validate: bool = True, max_residue_frac: float = 5e-3,
                 chunk_timeout_s: float | None = None,
                 checkpointer=None, checkpoint_every: int = 0,
                 bind_classes: bool = True,
                 raise_on_quarantine: bool = True):
        self.volume = volume
        self.cfg = cfg
        if specs is None:
            self.devices = (mesh_devices(devices) if devices is not None
                            else visible_devices("cuda"))
            specs = [DeviceSpec(device=d, n_lanes=n_lanes, mode=mode)
                     for d in self.devices]
        else:
            if devices is not None:
                raise ValueError("pass either devices or specs, not both")
            self.devices = [resolve_device(s.device) for s in specs]
        self.tracer = tracer
        self.pool = DevicePool(
            volume, cfg, specs, source=source, detectors=detectors,
            record_detected=record_detected, retry_policy=retry_policy,
            fault_injector=fault_injector, validate=validate,
            max_residue_frac=max_residue_frac,
            chunk_timeout_s=chunk_timeout_s, bind_classes=bind_classes,
            raise_on_quarantine=raise_on_quarantine,
            checkpointer=checkpointer, checkpoint_every=checkpoint_every,
            tracer=tracer)
        self.last_report = None

    def run(self, n_photons: int, chunk_size: int, seed: int = 1234,
            source=None, deadline_s: float | None = None,
            resume: bool = False) -> tuple[S.SimResult, dict]:
        """Returns ``(SimResult, {device label: photons merged})``, the
        result on the CPU; the full resilience accounting lands on
        ``self.last_report``."""
        fixed, stats = self.run_fixed(n_photons, chunk_size, seed, source,
                                      deadline_s, resume)
        return S.to_sim_result(fixed), stats

    def run_fixed(self, n_photons: int, chunk_size: int, seed: int = 1234,
                  source=None, deadline_s: float | None = None,
                  resume: bool = False) -> tuple[FixedResult, dict]:
        """:meth:`run` with the merged int64 totals in place of the
        ``SimResult``."""
        fixed, report = self.pool.run_fixed(
            n_photons, chunk_size, seed=seed, source=source,
            deadline_s=deadline_s, resume=resume)
        self.last_report = report
        stats = {device_label(d): 0 for d in self.devices}
        for did, n in report.per_device_photons.items():
            stats[did] = stats.get(did, 0) + n
        return fixed, stats


# ---------------------------------------------------------------------------
# elastic, fault-tolerant execution
# ---------------------------------------------------------------------------

class ElasticSimulator:
    """Chunk-level fault tolerance + elastic scaling for long campaigns.

    Photons are keyed by global id, so work is an immutable set of
    chunks.  Devices may join/leave between rounds; a failed round's
    chunks are simply re-queued and *re-simulated bit-identically*.
    ``state_dict``/``load_state_dict`` give checkpoint/restart: the
    checkpoint stores only the accumulated int64 totals and the
    completed-chunk cursor, O(volume), independent of photon count; the
    result has the bits of one uninterrupted run.

    A failed chunk requeues at the *back* of ``pending`` (a
    deterministic poison chunk cannot starve the campaign) and is
    quarantined onto ``self.skipped`` once it exhausts
    ``retry_policy.max_attempts``; ``fault_injector`` drives seeded
    chaos drills (dispatch faults, delays, corrupted harvests, which the
    ``validate_chunk`` merge guard rejects, and ``kill_after_merges``
    host crashes); ``checkpointer``/``checkpoint_every`` auto-save the
    campaign state every N merged chunks through the atomic
    ``checkpoint.Checkpointer``.  Synchronous: a round returns once each
    of its chunks has ended.

    ``tracer`` (a ``repro_torch.telemetry.Tracer``) records one span per
    chunk, lasting its wall in its process, tagged with device, engine
    and photon count.
    """

    def __init__(self, volume: Volume, cfg: SimConfig, n_photons: int,
                 chunk_size: int, n_lanes: int = 1024, seed: int = 1234,
                 source=None, detectors=None, record_detected: int = 0,
                 tracer=None, retry_policy: RetryPolicy | None = None,
                 fault_injector: FaultInjector | None = None,
                 validate: bool = True, max_residue_frac: float = 5e-3,
                 checkpointer=None, checkpoint_every: int = 0):
        self.volume = volume
        self.cfg = cfg
        self.seed = seed
        self.n_lanes = int(n_lanes)
        self.tracer = tracer
        self.source = as_source(source)
        self.detectors = as_detectors(detectors)
        self.chunk_size = chunk_size
        self.n_photons = n_photons
        self.record_detected = int(record_detected)
        self.policy = retry_policy or RetryPolicy()
        self.injector = fault_injector
        self.validate = bool(validate)
        self.max_residue_frac = float(max_residue_frac)
        self.checkpointer = checkpointer
        self.checkpoint_every = int(checkpoint_every)
        self.pending: list[Chunk] = [
            Chunk(s, min(chunk_size, n_photons - s))
            for s in range(0, n_photons, chunk_size)
        ]
        self.completed: list[Chunk] = []
        self.skipped: list[Chunk] = []   # chunks quarantined by the cap
        self.failures: dict[int, int] = {}   # chunk start_id -> attempts
        self.n_retries = 0
        self.acc = zero_fixed(volume.shape, volume.media.shape[0],
                              len(self.detectors), cfg)
        # what each device's process builds its round loop from
        self._work = procs.sim_work(volume, cfg, self.n_lanes, "dynamic",
                                    self.source, self.detectors,
                                    self.record_detected)

    # -- execution ---------------------------------------------------------

    def run_round(self, devices=None,
                  fail: Callable[[Chunk, torch.device], bool] | None = None,
                  max_chunks: int | None = None) -> int:
        """Assign up to one chunk per device; returns #chunks completed.

        ``devices`` defaults to every CUDA device (a machine without one
        raises).  The round's chunks run at once, each in its device's
        process (one chunk runs in the calling process); ``max_chunks``
        past the device count queues several on a device.  ``fail(chunk,
        device)`` simulates a device failure: the chunk is re-queued
        instead of merged (used by tests and chaos drills).  Failed and
        rejected chunks requeue at the *back* of ``pending``
        (RetryPolicy-capped, then quarantined to ``self.skipped``) so a
        poison chunk cannot starve the rest of the campaign.
        """
        devices = (mesh_devices(devices) if devices is not None
                   else visible_devices("cuda"))
        slots = procs.slots(devices)
        batch = []
        while self.pending and len(batch) < (max_chunks or len(devices)):
            batch.append(self.pending.pop(0))
        # each chunk's injected fault, or its job
        fates, jobs = [], []
        for i, ch in enumerate(batch):
            dev = devices[i % len(devices)]
            attempt = self.failures.get(ch.start_id, 0)
            try:
                if fail is not None and fail(ch, dev):
                    raise InjectedFault(
                        f"fail callback killed chunk {ch.start_id} on "
                        f"{device_label(dev)}")
                if self.injector is not None:
                    self.injector.check_dispatch(ch.start_id, attempt,
                                                 device_label(dev))
                    delay = self.injector.delay_for(ch.start_id, attempt)
                    if delay > 0:
                        # the synchronous simulator has no speculation to
                        # overlap with: a straggler simply takes longer
                        time.sleep(delay)
            except InjectedFault as e:
                fates.append(e)
                continue
            fates.append(len(jobs))
            jobs.append(procs.Job(dev, slots[i % len(devices)], "sim",
                                  self._work,
                                  (ch.count, self.seed, ch.start_id)))
        t0 = clock()
        replies = procs.run_all(jobs) if jobs else []
        n_done = 0
        requeue = []
        for ch, fate in zip(batch, fates):
            try:
                if isinstance(fate, InjectedFault):
                    raise fate
                job, reply = jobs[fate], replies[fate]
                if self.tracer is not None:
                    self.tracer.complete(
                        "chunk", t0, reply.wall_s, device=job.device,
                        engine=engine_of(job.device), photons=ch.count,
                        chunk_start=ch.start_id)
                attempt = self.failures.get(ch.start_id, 0)
                harvest = harvest_result(reply.value)
                if self.injector is not None and \
                        self.injector.corrupts(ch.start_id, attempt):
                    harvest = corrupt_harvest(harvest)
                if self.validate:
                    errs = validate_chunk(harvest, ch.count,
                                          self.max_residue_frac)
                    if errs:
                        raise InjectedFault(
                            f"chunk {ch.start_id} rejected by merge "
                            f"guard: {errs}")
            except InjectedFault as e:
                self._record_failure(ch, requeue, e)
                continue
            self._merge(ch, harvest)
            n_done += 1
        self.pending = self.pending + requeue
        return n_done

    def _record_failure(self, ch: Chunk, requeue: list,
                        err: BaseException) -> None:
        n = self.failures.get(ch.start_id, 0) + 1
        self.failures[ch.start_id] = n
        if self.policy.exhausted(n):
            self.skipped.append(ch)
            if self.tracer is not None:
                self.tracer.counter("resilience.chunk_quarantined", 1,
                                    chunk_start=ch.start_id,
                                    reason=str(err))
        else:
            self.n_retries += 1
            requeue.append(ch)
            if self.tracer is not None:
                self.tracer.counter("resilience.retries", 1,
                                    chunk_start=ch.start_id)

    def run_to_completion(self, devices=None) -> S.SimResult:
        while self.pending:
            self.run_round(devices)
        return self.result()

    def _merge(self, ch: Chunk, harvest: FixedResult):
        """Merge one validated host-side harvest, then auto-checkpoint
        and honor any injected host crash (the crash fires *after* the
        checkpoint, mimicking a host that dies between campaigns rather
        than mid-write; the atomic Checkpointer already covers torn
        writes)."""
        self.acc = add_fixed(self.acc, harvest)
        self.completed.append(ch)
        n_merged = len(self.completed)
        if (self.checkpointer is not None and self.checkpoint_every
                and n_merged % self.checkpoint_every == 0):
            self.checkpointer.save(n_merged, self.state_dict(),
                                   extra={"kind": "elastic",
                                          "merged": n_merged})
            if self.tracer is not None:
                self.tracer.counter("resilience.checkpoint", n_merged)
        if self.injector is not None:
            self.injector.maybe_kill(n_merged)

    @property
    def det_rec(self) -> np.ndarray:
        """Accumulated (n, 4) uint32 detected-photon id records."""
        return self.acc.det_rec.numpy().astype(np.uint32)

    def totals(self) -> FixedResult:
        """The merged int64 totals (CPU tensors); ``steps`` is 0, as in
        the reference."""
        return self.acc._replace(steps=0)

    def result(self) -> S.SimResult:
        """The merged totals converted once, on the CPU."""
        return S.to_sim_result(self.totals())

    # -- checkpoint / restart ----------------------------------------------

    def _source_key(self) -> str:
        """Canonical string for the source config.  Registered sources
        serialize via to_dict; custom protocol sources get a class-name
        sentinel (stable across process restarts, unlike repr/id): it
        catches switching source *types* but not reparameterizing the
        same custom class."""
        from repro_torch.sources import to_dict as _source_to_dict

        if hasattr(self.source, "type_name"):
            return json.dumps(_source_to_dict(self.source), sort_keys=True)
        return f"<custom:{type(self.source).__qualname__}>"

    def _detector_key(self) -> str:
        """Canonical string for the detector config: the TPSF
        histograms are only mergeable with chunks captured by the same
        detector set."""
        from repro_torch.detectors import to_dicts

        return json.dumps(to_dicts(self.detectors), sort_keys=True)

    def state_dict(self) -> dict:
        """The campaign's checkpoint: the reference's keys, with the
        totals as int64 fixed point (``stats`` the int64 round counters
        in ``core.fixed.COUNTER_FIELDS`` order)."""
        return {
            **fixed_state(self.acc),
            "pending": np.asarray(
                [(c.start_id, c.count) for c in self.pending], np.int64
            ).reshape(-1, 2),
            "completed": np.asarray(
                [(c.start_id, c.count) for c in self.completed], np.int64
            ).reshape(-1, 2),
            "skipped": np.asarray(
                [(c.start_id, c.count) for c in self.skipped], np.int64
            ).reshape(-1, 2),
            "seed": np.int64(self.seed),
            "n_photons": np.int64(self.n_photons),
            # the totals are only mergeable with chunks from the same
            # source / detector set; stored as uint8-encoded strings so
            # every leaf stays a numeric array the Checkpointer can write
            "source": np.frombuffer(self._source_key().encode(), np.uint8),
            "detectors": np.frombuffer(self._detector_key().encode(),
                                       np.uint8),
        }

    @staticmethod
    def _decode_key(raw) -> str:
        return (bytes(np.asarray(raw, np.uint8)).decode()
                if not isinstance(raw, str) else raw)

    def load_state_dict(self, state: dict):
        """Restore a :meth:`state_dict`; a campaign of another budget,
        seed, source, detector set or grid shape raises ``ValueError``."""
        checks = [("photon budget", int(state["n_photons"]), self.n_photons),
                  ("seed", int(state["seed"]), self.seed),
                  ("source", self._decode_key(state["source"]),
                   self._source_key()),
                  ("detector", self._decode_key(state["detectors"]),
                   self._detector_key()),
                  ("energy grid (time gates?)",
                   tuple(np.shape(state["energy"])),
                   tuple(self.acc.fluence.shape))]
        for what, got, want in checks:
            if got != want:
                raise ValueError(f"{what} mismatch: checkpoint {got} vs "
                                 f"simulator {want}")
        self.acc = fixed_from_state(state, self.acc)
        self.pending = [Chunk(int(s), int(c)) for s, c in state["pending"]]
        self.completed = [Chunk(int(s), int(c))
                          for s, c in state["completed"]]
        # attempt counters deliberately reset on restart (a restarted
        # host gets a fresh retry budget for transient faults)
        self.skipped = [Chunk(int(s), int(c)) for s, c in state["skipped"]]
        self.failures = {}
