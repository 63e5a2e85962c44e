"""One long-lived process a device for the multi-device paths.

Every device of a multi-device run (shards, the sharded replay, the
chunk schedulers, the resilience pool, the scenario mesh) runs in an
interpreter of its own: a round loop issues about 180 device operations
from Python a round, and two round loops in one interpreter hand its
lock to each other between every two of them.  A child process:

  * is the one process of a ``ProcessPoolExecutor`` started with the
    ``spawn`` method (CUDA and OpenMP state do not survive a fork), and
    owns its CUDA context, its kernel libraries and the device copies
    of the volumes it is given;
  * builds what it runs from a picklable :class:`Work` description (the
    volume's arrays as numpy, ``SimConfig``, source, detectors, lanes,
    mode), once per ``Work.key``, and keeps it for later requests;
  * answers each request with a :class:`Reply`: its value (tensors
    moved to the CPU, a ``FixedResult`` as its int64 fields) or the
    exception it raised, pickled with the child's traceback as a note,
    the kernel launches it made, its wall and device seconds and the
    threads it ran on;
  * tests its cancel slot, a shared int64 that the parent sets to the
    token of the request to stop, at its round loop's one host read;
  * ends after a CUDA runtime error, which it reports as a
    ``KernelError``: its context may be broken, and the work must not
    go on there or off the card.

Children live in a registry keyed by ``(device label, slot)`` (the
slot tells apart two workers of one device), are reused across calls
and closed at exit, so a test module or a smoke phase pays the spawn
(about 2 s on the CPU) once.  A CPU child runs the host kernel on the
cores the run's card processes leave (:func:`cpu_threads`: this
process's cores less one for each card process of the run, shared among
the run's CPU processes): each request carries its run's device types,
and the child sets torch's intra-op threads from them before it runs.
The bits do not depend on the thread count.

:func:`run_all` runs one request a device and returns when every one
has ended: a single request runs in the calling process, as the
one-device paths always have; when one of several raises, the others
are cancelled and the first error is raised.  A child that dies gives
:class:`ChildDied`; nothing carries on in the calling process in its
place.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
import os
import pickle
import re
import threading
import time
import traceback
from concurrent.futures import FIRST_COMPLETED, CancelledError, Future
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from concurrent.futures import wait as wait_futures
from concurrent.futures.process import BrokenProcessPool
from multiprocessing.connection import wait as wait_any
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

# built round loops a process keeps, least recently used dropped first
_MAX_BUILT = 8


class ChildDied(RuntimeError):
    """A device's process ended, or its pipe broke, before it answered."""


@dataclasses.dataclass(frozen=True, eq=False)
class Work:
    """A picklable description of what a device's process builds once
    and runs many times: ``kind`` (``"sim"``, ``"replay"`` or
    ``"batched"``), its parameters and its numpy arrays; ``key`` names
    it (a hash of all three)."""

    kind: str
    params: dict
    arrays: dict
    key: str


def describe(kind: str, params: dict, arrays: dict | None = None) -> Work:
    """A :class:`Work` with its key."""
    arrays = {k: np.ascontiguousarray(v) for k, v in (arrays or {}).items()}
    h = hashlib.sha256(pickle.dumps((kind, params)))
    for name in sorted(arrays):
        h.update(name.encode())
        h.update(arrays[name].tobytes())
    return Work(kind, params, arrays, h.hexdigest()[:24])


def _volume_arrays(volume) -> dict:
    return {"labels": volume.labels.reshape(-1).cpu().numpy(),
            "media": volume.media.cpu().numpy()}


def sim_work(volume, cfg, n_lanes: int, mode: str = "dynamic", source=None,
             detectors=None, record_detected: int = 0) -> Work:
    """The round loop of ``simulator.build_fixed_fn`` on a volume."""
    from repro_torch.detectors import as_detectors
    from repro_torch.sources import as_source

    return describe("sim", dict(
        shape=tuple(int(x) for x in volume.shape),
        unitinmm=float(volume.unitinmm), cfg=cfg, n_lanes=int(n_lanes),
        mode=mode, source=as_source(source),
        detectors=as_detectors(detectors),
        record_detected=int(record_detected)), _volume_arrays(volume))


def replay_work(volume, cfg, n_lanes: int, source, detectors,
                jac_cols: int) -> Work:
    """A shard of ``replay._build_replay_fn``, with its Jacobian total."""
    from repro_torch.detectors import as_detectors
    from repro_torch.sources import as_source

    return describe("replay", dict(
        shape=tuple(int(x) for x in volume.shape),
        unitinmm=float(volume.unitinmm), cfg=cfg, n_lanes=int(n_lanes),
        source=as_source(source), detectors=as_detectors(detectors),
        jac_cols=int(jac_cols)), _volume_arrays(volume))


def batched_work(shape, unitinmm: float, cfg, n_lanes: int, mode: str,
                 src_cls: type, n_det: int) -> Work:
    """The batched round loop of one scenario group
    (``simulator.build_round_loop`` sampling from stacked staged source
    parameters); each request carries the stacked values."""
    return describe("batched", dict(
        shape=tuple(int(x) for x in shape), unitinmm=float(unitinmm),
        cfg=cfg, n_lanes=int(n_lanes), mode=mode, src_cls=src_cls,
        n_det=int(n_det)))


# ---------------------------------------------------------------------------
# what a process does with a request (a child, or the calling process)
# ---------------------------------------------------------------------------

def _on(x, dev):
    return torch.as_tensor(x).to(dev)


def _build(work: Work, dev: torch.device) -> dict:
    from repro_torch.core import simulator as S

    p = work.params
    built = {}
    if "labels" in work.arrays:
        built["labels"] = _on(work.arrays["labels"], dev)
        built["media"] = _on(work.arrays["media"], dev)
    if work.kind == "sim":
        built["fn"] = S.build_fixed_fn(
            p["shape"], p["unitinmm"], p["cfg"], p["n_lanes"], p["mode"],
            p["source"], dev, p["detectors"], p["record_detected"])
    elif work.kind == "replay":
        from repro_torch.detectors import det_geometry
        from repro_torch.replay import _build_replay_fn

        built["fn"] = _build_replay_fn(
            p["shape"], p["unitinmm"], p["cfg"], p["n_lanes"], p["source"],
            det_geometry(p["detectors"], dev), p["jac_cols"])
    elif work.kind == "batched":
        # the sampler closes over each request's staged parameters, so
        # the loop is built per request (a closure; nothing compiles)
        built["fn"] = None
    else:
        raise ValueError(f"unknown work kind {work.kind!r}")
    return built


def _op_sim(state, built, work, args, cancel):
    """One run of a ``sim`` work: ``args`` (photons, seed, 64-bit first
    id); returns its ``FixedResult``."""
    from repro_torch.core.rng import split_id64

    count, seed, offset = args
    return built["fn"](built["labels"], built["media"], int(count), seed,
                       *split_id64(int(offset)), cancel=cancel)


def _op_batched(state, built, work, args, cancel):
    """One batched call of a scenario group: ``args`` the stacked
    ``(labels, media, staged, det_geom, n_photons, seeds, id_lo,
    id_hi)``; returns a ``FixedResult`` a scenario."""
    from repro_torch.core import simulator as S
    from repro_torch.sources.base import StagedSampler

    p, dev = work.params, state.device
    labels, media, staged, det_geom, n_photons, seeds, id_lo, id_hi = args
    sample = StagedSampler(p["src_cls"],
                           {k: _on(v, dev) for k, v in staged.items()})
    run = S.build_round_loop(p["shape"], p["unitinmm"], p["cfg"],
                             p["n_lanes"], p["mode"], sample, dev, p["n_det"])
    return run(_on(labels, dev), _on(media, dev),
               None if det_geom is None else _on(det_geom, dev), n_photons,
               seeds, id_lo, id_hi, cancel)


def _op_replay_open(state, built, work, args, cancel):
    """Zeroed int64 Jacobian and scratch totals for a replay."""
    p, dev = work.params, state.device
    nx, ny, nz = p["shape"]
    nvox, ntg = nx * ny * nz, int(p["cfg"].n_time_gates)
    n_det, n_media = len(p["detectors"]), built["media"].shape[0]

    def zeros(*size):
        return torch.zeros(size, dtype=torch.int64, device=dev)

    state.sessions[work.key] = (
        zeros(nvox * p["jac_cols"]),
        [zeros(nvox * ntg), zeros(nx * ny), zeros(n_det * ntg),
         zeros(n_det, n_media)])


def _op_replay_batch(state, built, work, args, cancel):
    """This shard's lanes of a replay batch (numpy ``id_lo``, ``id_hi``,
    ``jac_col``, ``active`` and the seed), added into its Jacobian;
    returns the per-lane ``(w_exit, gate, replayed_det)`` as numpy."""
    from repro_torch.kernels.photon_step.photon_step import check_errors

    dev = state.device
    id_lo, id_hi, col, active, seed = args
    jac, scratch = state.sessions[work.key]
    w, g, r = built["fn"](
        built["labels"], built["media"].to(torch.float32),
        torch.tensor(id_lo.astype(np.int64), device=dev),
        torch.tensor(id_hi.astype(np.int64), device=dev),
        torch.tensor(col, device=dev), torch.tensor(active, device=dev),
        seed, jac, scratch)
    if dev.type == "cuda":
        check_errors(dev)
    return w.cpu().numpy(), g.cpu().numpy(), r.cpu().numpy()


def _op_replay_total(state, built, work, args, cancel):
    """The replay's int64 Jacobian total, or with ``args`` ``("cells",)``
    only the cells it reached, as ``(flat indices, values)`` (a few
    percent of the grid, to cross between processes); ends the
    replay."""
    jac = state.sessions.pop(work.key)[0]
    if args == ("cells",):
        at = torch.nonzero(jac).squeeze(1)
        return at, jac[at]
    return jac


def _op_call(state, built, work, args, cancel):
    """``fn(*args)`` for a picklable ``fn``, in the process."""
    fn, fargs = args
    return fn(*fargs)


_OPS = {"sim": _op_sim, "batched": _op_batched,
        "replay_open": _op_replay_open, "replay_batch": _op_replay_batch,
        "replay_total": _op_replay_total, "call": _op_call}


class _State:
    """What one process holds for one device: the works it was given,
    what it built from them, and open replays."""

    def __init__(self, device: torch.device):
        self.device = device
        self.works: dict[str, Work] = {}
        self.built: collections.OrderedDict = collections.OrderedDict()
        self.sessions: dict[str, tuple] = {}

    def run(self, op: str, key: str | None, work: Work | None, args,
            cancel=None):
        if work is not None:
            self.works[key] = work
        built = None
        if key is not None:
            if key not in self.built:
                self.built[key] = _build(self.works[key], self.device)
                while len(self.built) > _MAX_BUILT:
                    self.built.popitem(last=False)
            self.built.move_to_end(key)
            built, work = self.built[key], self.works[key]
        return _OPS[op](self, built, work, args, cancel)


# the calling process's own state a device, for single requests
_LOCAL: dict[torch.device, _State] = {}


def _local(device: torch.device) -> _State:
    if device not in _LOCAL:
        _LOCAL[device] = _State(device)
    return _LOCAL[device]


class _Cancel:
    """A request's cancel event: set once the parent writes a token at
    least this request's into the shared slot."""

    __slots__ = ("slot", "token")

    def __init__(self, slot, token: int):
        self.slot, self.token = slot, token

    def is_set(self) -> bool:
        return self.slot.value >= self.token


def _launch_counts():
    from repro_torch.kernels.photon_step.photon_step import photon_step_cuda

    return collections.Counter(photon_step_cuda.launches_by)


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(_to_cpu, x))
    if isinstance(x, (list, tuple)):
        return type(x)(map(_to_cpu, x))
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def _picklable(error: BaseException, where: str) -> BaseException:
    """The error with the child's traceback as a note, or, if it does
    not pickle, a ``RuntimeError`` carrying its text."""
    note = f"raised in {where}:\n" + "".join(traceback.format_exception(
        error))
    try:
        error.add_note(note)
        pickle.loads(pickle.dumps(error))
        return error
    except Exception:
        return RuntimeError(f"{type(error).__name__}: {error}\n{note}")


def _cuda_failure(error: BaseException) -> bool:
    """Whether ``error`` is the CUDA runtime's: after one, the process's
    context may be unusable."""
    accelerator = getattr(torch, "AcceleratorError", ())
    return isinstance(error, accelerator) or (
        isinstance(error, RuntimeError)
        and re.search(r"CUDA (driver )?error", str(error)) is not None)


class Reply(NamedTuple):
    """A process's answer to one request."""

    token: int
    ok: bool
    value: Any            # the result, or the exception raised
    launches: collections.Counter
    wall_s: float
    device_s: float       # between CUDA events around it (the wall on a CPU)
    pid: int
    threads: int          # torch's intra-op threads while it ran
    ended: bool = False   # the process ended itself after this request


# in a child: its device's state, its name in messages, its cancel slot
_CHILD: dict = {}


def cpu_threads(run: Sequence[str]) -> int:
    """Intra-op threads of a CPU process of a run whose processes run
    on the device types ``run`` (``"cuda"``, ``"cpu"``, one a process):
    the cores this process may use, less one for each card process (its
    host thread), shared among the run's CPU processes; at least one."""
    cards = sum(t == "cuda" for t in run)
    cpus = max(1, sum(t == "cpu" for t in run))
    return max(1, (len(os.sched_getaffinity(0)) - cards) // cpus)


def run_types(devices) -> tuple[str, ...]:
    """The device type of each process of a run on ``devices``."""
    return tuple(torch.device(d).type for d in devices)


def _init_child(device_name: str, label: str, cancel_slot) -> None:
    """A child's initializer: the state it keeps for its device.  A CPU
    child starts on one intra-op thread; each request of a run sets its
    share (:func:`cpu_threads`)."""
    if torch.device(device_name).type == "cpu":
        torch.set_num_threads(1)
    _CHILD.update(state=_State(torch.device(device_name)),
                  where=f"the process of {label} (pid {os.getpid()})",
                  cancel=cancel_slot)


def _serve(token: int, op: str, key, work, args, run=()) -> Reply:
    """One request in a child; ``run`` is its run's device types, which
    set a CPU child's threads.  Every error becomes the reply's value.
    The CUDA runtime's own errors become a ``KernelError`` and end the
    process, whose context they may have broken: the work must not go
    on there, nor anywhere off the card."""
    from repro_torch.kernels.photon_step.photon_step import KernelError

    state, where = _CHILD["state"], _CHILD["where"]
    dev = state.device
    if dev.type == "cpu" and run:
        torch.set_num_threads(cpu_threads(run))
    before = _launch_counts()
    t0 = time.perf_counter()  # reprolint: disable=REP201 - a request's wall seconds and deadlines, beside the result
    events = None
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        value, ok = _to_cpu(state.run(op, key, work, args,
                                      _Cancel(_CHILD["cancel"], token))), True
        if events is not None:
            events[1].record()
            events[1].synchronize()
    except Exception as e:  # every error crosses to the parent
        value, ok = e, False
    device_s = None
    if ok and events is not None:
        device_s = events[0].elapsed_time(events[1]) / 1e3
    ended = not ok and _cuda_failure(value)
    if ended:
        cause = value
        value = KernelError(f"the CUDA runtime failed in {where}, which "
                            f"ends: {type(cause).__name__}: {cause}")
        value.__cause__ = cause
    wall = time.perf_counter() - t0  # reprolint: disable=REP201 - a request's wall seconds and deadlines, beside the result
    return Reply(token, ok, value if ok else _picklable(value, where),
                 _launch_counts() - before, wall,
                 wall if device_s is None else device_s, os.getpid(),
                 torch.get_num_threads(), ended)


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

class DeviceProcess:
    """The parent's handle of one device's child: a one-process
    ``ProcessPoolExecutor`` started with ``spawn``, whose initializer
    gives the child its device and its cancel slot.  ``submit`` returns
    the executor's future, which yields a :class:`Reply`; read it with
    :func:`reply` or :func:`result`."""

    def __init__(self, device: torch.device, slot: int = 0):
        from repro_torch.telemetry.trace import device_label

        ctx = torch.multiprocessing.get_context("spawn")
        self.device, self.slot = device, int(slot)
        self.label = f"{device_label(device)}/{self.slot}"
        self._cancel = ctx.RawValue("q", 0)
        self._pool = ProcessPoolExecutor(
            1, mp_context=ctx, initializer=_init_child,
            initargs=(str(device), self.label, self._cancel))
        # the first request starts the executor's one process
        self._pool.submit(int)
        (self._proc,) = self._pool._processes.values()
        self._tokens = itertools.count(1)
        self._sent: set[str] = set()
        # the device type of each process of the run this one serves
        # (run_types), set by the caller: a CPU child's threads
        self.run: tuple[str, ...] = ()
        self.dead: str | None = None

    @property
    def pid(self) -> int:
        return self._proc.pid

    def alive(self) -> bool:
        return self.dead is None and self._proc.is_alive()

    def _died(self) -> str:
        self._proc.join(1.0)  # its exit code
        self.dead = self.dead or (
            f"the process of {self.label} (pid {self.pid}) ended with exit "
            f"code {self._proc.exitcode}")
        return self.dead

    def submit(self, op: str, work: Work | None = None, args=()) -> Future:
        """Send one request; returns its future at once.  The work's
        arrays cross only the first time this child is sent that work.
        The request carries ``self.run``, from which a CPU child takes
        its threads."""
        token = next(self._tokens)
        key = None if work is None else work.key
        send = work if work is not None and key not in self._sent else None
        try:
            if self.dead is not None:
                raise BrokenProcessPool(self.dead)
            fut = self._pool.submit(_serve, token, op, key, send, args,
                                    self.run)
        except (BrokenProcessPool, RuntimeError) as e:
            raise ChildDied(self._died()) from e
        if key is not None:
            self._sent.add(key)
        fut.proc, fut.token = self, token
        fut.add_done_callback(_count)
        return fut

    def cancel(self, token: int) -> None:
        """Stop request ``token`` (and any earlier one) at its next
        round's host read."""
        if self._cancel.value < token:
            self._cancel.value = token

    def call(self, fn, *args, timeout: float | None = None):
        """``fn(*args)`` in the child (``fn`` picklable); its value."""
        return result(self.submit("call", None, (fn, args)), timeout)

    def close(self, timeout: float = 5.0) -> None:
        """End the process: its running request cancelled, the queued
        ones dropped, then asked to exit, then killed."""
        self.dead = self.dead or f"the process of {self.label} was closed"
        self._cancel.value = 2**62
        self._pool.shutdown(wait=False, cancel_futures=True)
        if not wait_any([self._proc.sentinel], timeout):
            self._proc.kill()
            self._proc.join(timeout)


_COUNTED_LOCK = threading.Lock()


def _count(fut: Future) -> None:
    """Add a reply's launches to this process's counts, once (a done
    callback, and again when the reply is read, as the callback may run
    after a waiter wakes)."""
    with _COUNTED_LOCK:
        if getattr(fut, "counted", False):
            return
        fut.counted = True
    if not fut.cancelled() and fut.exception() is None:
        launches = fut.result().launches
        if launches:
            from repro_torch.kernels.photon_step.photon_step import (
                add_launches)

            add_launches(launches)


def reply(fut: Future, timeout: float | None = None) -> Reply:
    """The :class:`Reply` of a request, waiting for it (``TimeoutError``
    past ``timeout``).  A child that died gives a reply holding
    :class:`ChildDied`; one whose request broke its CUDA context has
    been closed."""
    from repro_torch.core.simulator import RunCancelled

    proc = fut.proc
    try:
        got = fut.result(timeout)
    except BrokenProcessPool:
        return Reply(fut.token, False, ChildDied(proc._died()),
                     collections.Counter(), 0.0, 0.0, proc.pid, 0)
    except CancelledError:
        return Reply(fut.token, False, RunCancelled(
            f"request {fut.token} to {proc.label} was abandoned before it "
            f"ran"), collections.Counter(), 0.0, 0.0, proc.pid, 0)
    except FuturesTimeout:
        raise TimeoutError(f"{proc.label} did not answer request "
                           f"{fut.token} within {timeout} s") from None
    except Exception as e:  # the reply did not pickle
        return Reply(fut.token, False, RuntimeError(
            f"the process of {proc.label} (pid {proc.pid}) could not send "
            f"its reply: {e!r}"), collections.Counter(), 0.0, 0.0,
            proc.pid, 0)
    _count(fut)
    if got.ended and proc.dead is None:
        proc.close()
    return got


def result(fut: Future, timeout: float | None = None):
    """A request's value, or the child's error raised."""
    got = reply(fut, timeout)
    if not got.ok:
        raise got.value
    return got.value


def abandon(fut: Future) -> None:
    """Stop a request at its next round and never read its reply."""
    fut.proc.cancel(fut.token)
    fut.cancel()


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

_CHILDREN: dict[tuple[str, int], DeviceProcess] = {}


def child(device, slot: int = 0) -> DeviceProcess:
    """The live process of ``(device, slot)``, started at first use (or
    again after it died)."""
    from repro_torch.kernels.photon_step.ops import resolve_device
    from repro_torch.telemetry.trace import device_label

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (device_label(dev), int(slot))
    proc = _CHILDREN.get(key)
    if proc is None or not proc.alive():
        if proc is not None:
            proc.close(0.5)
        proc = _CHILDREN[key] = DeviceProcess(dev, slot)
    return proc


def children() -> dict[tuple[str, int], DeviceProcess]:
    """The registry's live processes by ``(device label, slot)``."""
    return {k: p for k, p in _CHILDREN.items() if p.alive()}


def close_all() -> None:
    """End every child process (also run at exit, before the executors'
    own exit hook waits for their running requests)."""
    while _CHILDREN:
        _, proc = _CHILDREN.popitem()
        proc.close()


threading._register_atexit(close_all)


def slots(devices: Sequence[torch.device]) -> list[int]:
    """Each device's slot in a mesh: how often it appeared before."""
    from repro_torch.telemetry.trace import device_label

    seen: collections.Counter = collections.Counter()
    out = []
    for d in devices:
        label = device_label(torch.device(d))
        out.append(seen[label])
        seen[label] += 1
    return out


class Job(NamedTuple):
    """One request of :func:`run_all`: ``op`` on ``device``'s process
    of ``slot``, built from ``work``."""

    device: torch.device
    slot: int
    op: str
    work: Work | None
    args: tuple = ()


def run_all(jobs: Sequence[Job], timeout: float | None = None) -> list[Reply]:
    """Run each job and return their replies in order, once all have
    ended.  One job runs in the calling process; several each in its
    device's process, at once.  When one raises, the others are
    cancelled (they stop at their next round) and the first error is
    raised once all have ended, a cancelled run's only if nothing else
    failed."""
    from repro_torch.core.simulator import RunCancelled

    if len(jobs) == 1:
        (dev, _, op, work, args), = jobs
        before = _launch_counts()
        t0 = time.perf_counter()  # reprolint: disable=REP201 - a request's wall seconds and deadlines, beside the result
        value = _local(dev).run(op, None if work is None else work.key,
                                work, args)
        wall = time.perf_counter() - t0  # reprolint: disable=REP201 - a request's wall seconds and deadlines, beside the result
        return [Reply(0, True, value, _launch_counts() - before, wall, wall,
                      os.getpid(), torch.get_num_threads())]
    futures = []
    run = run_types(j.device for j in jobs)
    try:
        for j in jobs:
            proc = child(j.device, j.slot)
            proc.run = run
            futures.append(proc.submit(j.op, j.work, j.args))
    except BaseException:
        for f in futures:
            abandon(f)
        raise
    end = None if timeout is None else time.monotonic() + timeout  # reprolint: disable=REP201 - a request's wall seconds and deadlines, beside the result
    waiting, failed = set(futures), False
    while waiting:
        left = None if end is None else end - time.monotonic()  # reprolint: disable=REP201 - a request's wall seconds and deadlines, beside the result
        if left is not None and left <= 0:
            for f in futures:
                abandon(f)
            raise TimeoutError(f"the devices did not answer within "
                               f"{timeout} s")
        done, waiting = wait_futures(waiting, left, FIRST_COMPLETED)
        if not failed and any(not reply(f).ok for f in done):
            failed = True
            for f in futures:
                f.proc.cancel(f.token)
    replies = [reply(f) for f in futures]
    errors = [r.value for r in replies if not r.ok]
    if errors:
        raise next((e for e in errors if not isinstance(e, RunCancelled)),
                   errors[0])
    return replies
