"""Batched multi-scenario execution: ``simulate_many`` and its cache.

A fleet of (volume, source, detector) scenarios (an optode sweep, a
source sweep, replicates) runs through one round loop with a leading
scenario axis (``core.simulator.build_batched_fn``): each round
regenerates every scenario's lanes with one set of operations and
advances all of them with one launch of the photon-step kernel, where a
loop of ``simulate_one`` issues one of each per scenario.

  * per-scenario **media tables**, **source parameters** (staged launch
    parameters, ``repro_torch.sources.stage_source``), **seeds**,
    **photon budgets**, **64-bit id offsets** and **detector
    geometries** are values of the batch;
  * volume **labels** are shared (one copy) when every scenario of a
    group carries the same grid, stacked otherwise;
  * everything structural (volume dims, ``SimConfig``, lane count,
    mode, device, source type and staged-parameter shapes, detector
    count) forms the **group key**: scenarios group by it, and each
    group runs as one batched call.

Built batched executors live in a :class:`CompileCache` keyed by the
group key, batch size, labels sharing and mesh, with the reference's
hit / miss / eviction counters, which ``simulate_many`` reports through
a ``repro_torch.telemetry.Tracer`` (``scenarios.cache.*`` counters,
``scenarios.compile`` / ``scenarios.batch`` spans).

Bit-identity: every total of the round loop is an integer fixed-point
sum and every other operation acts lane by lane, and a finished
scenario freezes while the others run on, so each scenario's
``SimResult`` from ``simulate_many`` is bit-identical to its own
:func:`simulate_one` (the same code with one scenario).

    from repro_torch.scenarios import Scenario, simulate_many
    results = simulate_many([Scenario(vol, cfg, n_photons=10_000, seed=s)
                             for s in range(8)])

A device mesh (``mesh=``, a sequence of torch devices) splits each
group's scenario axis across its devices, padded with zero-photon
scenarios to a multiple of their count: each device's process
(``core.procs``) runs its slice as one batched call, with no
collective, and returns its scenarios' int64 totals, converted in the
calling process; each scenario still gets the bits of its own
``simulate_one`` on a device of the same type.

CLI: ``python -m repro_torch.launch.simulate --scenarios '[{...}, ...]'``
(with ``--devices all``, over every device of ``--device``'s type).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from contextlib import nullcontext

import numpy as np
import torch

from repro_torch.core import volume as V
from repro_torch.core.rng import split_id64
from repro_torch.core import procs
from repro_torch.core.simulator import (SimResult, build_batched_fn,
                                        build_sim_fn, to_sim_result)
from repro_torch.core.volume import SimConfig, Volume
from repro_torch.detectors import (as_detectors, det_geometry,
                                   validate_detectors)
from repro_torch.kernels.photon_step.ops import resolve_device
from repro_torch.sources import stage_source
from repro_torch.sources.base import StagedSampler
from repro_torch.telemetry.trace import capture, device_label, phase

__all__ = [
    "CompileCache",
    "Scenario",
    "default_cache",
    "group_key",
    "make_batched",
    "simulate_many",
    "simulate_one",
]


# ---------------------------------------------------------------------------
# scenario description
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scenario:
    """One (volume, physics, source, detectors, budget) work item.

    ``source`` / ``detectors`` accept anything ``sources.as_source`` /
    ``detectors.as_detectors`` accept (instances, config dicts, None).
    ``id_offset`` is the 64-bit global photon-id base: scenarios with
    disjoint id ranges simulate disjoint photon sets even at one seed.
    """

    volume: Volume
    cfg: SimConfig
    n_photons: int
    seed: int = 1234
    source: object = None
    detectors: object = ()
    id_offset: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        """Build from the CLI's ``--scenarios`` JSON entry form.

        Keys: ``bench`` (B1|B2|B2a, default B1), ``size`` (cube edge,
        default 24), ``photons`` (required), ``seed``, ``source``
        (sources.to_dict form), ``detectors`` (list of disk dicts),
        ``time_gates``, ``steps_per_round``, ``tmax_ns``,
        ``do_reflect``, ``id_offset``.
        """
        d = dict(d)
        bench = d.pop("bench", "B1")
        size = int(d.pop("size", 24))
        shape = (size, size, size)
        if bench == "B1":
            vol, do_reflect = V.benchmark_b1(shape), False
        elif bench in ("B2", "B2a"):
            vol, do_reflect = V.benchmark_b2(shape), True
        else:
            raise ValueError(f"unknown bench {bench!r} (B1|B2|B2a)")
        cfg = SimConfig(
            do_reflect=bool(d.pop("do_reflect", do_reflect)),
            steps_per_round=int(d.pop("steps_per_round", 1)),
            n_time_gates=int(d.pop("time_gates", 1)))
        if "tmax_ns" in d:
            cfg = dataclasses.replace(cfg, tmax_ns=float(d.pop("tmax_ns")))
        sc = cls(volume=vol, cfg=cfg, n_photons=int(d.pop("photons")),
                 seed=int(d.pop("seed", 1234)),
                 source=d.pop("source", None),
                 detectors=tuple(d.pop("detectors", ()) or ()),
                 id_offset=int(d.pop("id_offset", 0)))
        if d:
            raise ValueError(f"unknown scenario keys: {sorted(d)}")
        return sc


@dataclasses.dataclass
class _Prep:
    """A scenario normalized for batching: staged source parameters,
    coerced detectors and their geometry, split id offset."""

    idx: int
    sc: Scenario
    src_cls: type
    staged: dict
    dets: tuple
    det_geom: np.ndarray | None
    id_lo: int
    id_hi: int


def _prepare(idx: int, sc: Scenario) -> _Prep:
    src_cls, staged = stage_source(sc.source)
    dets = as_detectors(sc.detectors)
    if dets:
        validate_detectors(dets, sc.volume.shape)
    det_geom = det_geometry(dets).numpy() if dets else None
    lo, hi = split_id64(int(sc.id_offset))
    return _Prep(idx=idx, sc=sc, src_cls=src_cls, staged=staged, dets=dets,
                 det_geom=det_geom, id_lo=lo, id_hi=hi)


# ---------------------------------------------------------------------------
# grouping: the structural shape of a batch
# ---------------------------------------------------------------------------

def group_key(sc: Scenario, n_lanes: int, mode: str = "dynamic",
              device=None) -> tuple:
    """Hashable structural signature of one scenario.

    Scenarios sharing this key run in one batched call: volume dims,
    unitinmm and media count, the full ``SimConfig``, the executor
    (lanes, mode, device), the source's staged structure (type and
    parameter shapes) and the detector count.  Per-scenario values
    (media tables, source parameters, seeds, photon budgets, detector
    coordinates) are not in it.
    """
    return _group_key(_prepare(0, sc), n_lanes, mode,
                      device_label(resolve_device(device)))


def _group_key(prep: _Prep, n_lanes, mode, device: str):
    v = prep.sc.volume
    src_struct = (prep.src_cls.type_name,
                  tuple((k, tuple(np.shape(prep.staged[k])))
                        for k in sorted(prep.staged)))
    return (tuple(int(x) for x in v.shape), float(v.unitinmm),
            int(v.media.shape[0]), prep.sc.cfg, int(n_lanes), mode, device,
            src_struct, len(prep.dets))


# ---------------------------------------------------------------------------
# executor cache
# ---------------------------------------------------------------------------

class CompileCache:
    """LRU cache of built batched executors for :func:`simulate_many`.

    Keys are ``(group key, padded batch size, labels shared?, mesh
    signature)``, the reference's keys.  ``max_entries`` bounds the cache
    with keyed LRU eviction; hit / miss / eviction counts are plain
    attributes (reported as telemetry counters by ``simulate_many``).
    """

    def __init__(self, max_entries: int | None = None):
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def get(self, key):
        """Look up an executor; counts a hit or a miss."""
        if key in self._entries:
            self._entries.move_to_end(key)
            self.hits += 1
            return self._entries[key]
        self.misses += 1
        return None

    def put(self, key, fn) -> None:
        self._entries[key] = fn
        self._entries.move_to_end(key)
        while (self.max_entries is not None
               and len(self._entries) > self.max_entries):
            self._entries.popitem(last=False)
            self.evictions += 1

    def clear(self) -> None:
        self._entries.clear()

    def stats(self) -> dict:
        """Counters and hit rate (1.0 on an all-hit repeat-shape run)."""
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "entries": len(self._entries),
                "hit_rate": self.hits / total if total else 0.0}


_DEFAULT_CACHE = CompileCache(max_entries=64)


def default_cache() -> CompileCache:
    """The process-wide cache ``simulate_many`` uses when none is given."""
    return _DEFAULT_CACHE


# ---------------------------------------------------------------------------
# the batched executor
# ---------------------------------------------------------------------------

def _raw_batched_fn(rep: _Prep, n_lanes, mode, device):
    """The executor of one group: ``fn(labels, media, staged, det_geom,
    n_photons, seeds, id_lo, id_hi) -> list[SimResult]``, the round loop
    of ``build_batched_fn`` sampling launches from the stacked staged
    source parameters."""
    vol, cfg, src_cls = rep.sc.volume, rep.sc.cfg, rep.src_cls
    n_det = len(rep.dets)

    def fn(labels, media, staged, det_geom, n_photons, seeds, id_lo, id_hi):
        run = build_batched_fn(vol.shape, vol.unitinmm, cfg, n_lanes, mode,
                               StagedSampler(src_cls, staged), device, n_det)
        return run(labels, media, det_geom, n_photons, seeds, id_lo, id_hi)

    return fn


def _mesh_signature(mesh) -> tuple | None:
    """The mesh's part of a cache key: its device labels, in order."""
    if mesh is None:
        return None
    return tuple(device_label(d) for d in mesh)


def _padded(members: list[_Prep], pad: int) -> tuple[list, list]:
    """The group's rows zero-photon-padded by ``pad`` copies of the first
    scenario (they launch nothing, so padding never changes a real
    result), and the rows' photon budgets."""
    rows = members + [members[0]] * pad
    return rows, [m.sc.n_photons for m in members] + [0] * pad


def _stack_group(members: list[_Prep], pad: int, share_labels: bool,
                 device):
    """Stack the group's per-scenario values on ``device``, padded as
    :func:`_padded` pads them."""
    return _stack_rows(*_padded(members, pad), share_labels, device)


def _stack_rows(rows: list[_Prep], n_photons: list[int], share_labels: bool,
                device):
    """Stack the values of ``rows`` (with these photon budgets) on
    ``device``."""

    def put(arrays, dtype=torch.float32):
        return torch.as_tensor(np.stack(arrays), dtype=dtype, device=device)

    if share_labels:
        labels = rows[0].sc.volume.labels.reshape(-1).to(device)
    else:
        labels = torch.stack([m.sc.volume.labels.reshape(-1).to(device)
                              for m in rows])
    media = torch.stack([m.sc.volume.media.to(device=device,
                                              dtype=torch.float32)
                         for m in rows])
    staged = {k: put([np.asarray(m.staged[k], np.float32) for m in rows])
              for k in rows[0].staged}
    det_geom = (put([m.det_geom for m in rows])
                if rows[0].det_geom is not None else None)
    seeds = [int(m.sc.seed) for m in rows]
    id_lo = [m.id_lo for m in rows]
    id_hi = [m.id_hi for m in rows]
    return (labels, media, staged, det_geom, n_photons, seeds, id_lo, id_hi)


def _share_labels(members: list[_Prep]) -> bool:
    first = members[0].sc.volume.labels
    for m in members[1:]:
        lab = m.sc.volume.labels
        if lab is first:
            continue
        if lab.shape != first.shape or not torch.equal(lab.cpu(),
                                                       first.cpu()):
            return False
    return True


def make_batched(scenarios, *, n_lanes: int = 1024, mode: str = "dynamic",
                 device=None):
    """The batched executor and its stacked arguments for scenarios that
    all share one group key: ``fn(*args)`` runs them.  Raises when the
    scenarios span several groups."""
    dev = resolve_device(device)
    preps = [_prepare(i, sc) for i, sc in enumerate(scenarios)]
    if not preps:
        raise ValueError("make_batched needs at least one scenario")
    label = device_label(dev)
    keys = {_group_key(p, n_lanes, mode, label) for p in preps}
    if len(keys) != 1:
        raise ValueError(
            f"make_batched needs a single scenario group, got {len(keys)} "
            f"distinct config shapes; group with group_key() first")
    share = _share_labels(preps)
    fn = _raw_batched_fn(preps[0], n_lanes, mode, dev)
    return fn, _stack_group(preps, 0, share, dev)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _sharded_batched_fn(rep: _Prep, n_lanes, mode, devices):
    """The executor of one group over a mesh: ``fn(per_device_args) ->
    list[SimResult]`` runs each device's stacked slice of the scenario
    axis (CPU values) as one batched call in its device's process, which
    builds the group's round loop, and returns the results in scenario
    order, converted here from the processes' int64 totals."""
    vol = rep.sc.volume
    work = procs.batched_work(vol.shape, vol.unitinmm, rep.sc.cfg, n_lanes,
                              mode, rep.src_cls, len(rep.dets))
    slots = procs.slots(devices)

    def fn(per_device_args):
        replies = procs.run_all([
            procs.Job(d, s, "batched", work, args)
            for d, s, args in zip(devices, slots, per_device_args)])
        return [to_sim_result(f) for r in replies for f in r.value]

    return fn


def _engine(dev: torch.device) -> str:
    """The round executor a device runs: the kernel or its plain
    version."""
    return "kernel" if dev.type == "cuda" else "plain"


def simulate_one(sc: Scenario, *, n_lanes: int = 1024,
                 mode: str = "dynamic", device=None) -> SimResult:
    """The sequential reference: one scenario through ``build_sim_fn``
    (the round loop with one scenario), on ``device`` (``None``:
    CUDA).  ``simulate_many`` gives each scenario these bits."""
    vol = sc.volume
    fn = build_sim_fn(vol.shape, vol.unitinmm, sc.cfg, n_lanes, mode,
                      sc.source, device, sc.detectors)
    return fn(vol.labels.reshape(-1), vol.media, sc.n_photons, sc.seed,
              *split_id64(int(sc.id_offset)))


def simulate_many(scenarios, *, n_lanes: int = 1024, mode: str = "dynamic",
                  device=None, mesh=None, cache: CompileCache | None = None,
                  tracer=None) -> list[SimResult]:
    """Run many scenarios through shared batched executors on ``device``
    (``None``: CUDA).

    Scenarios group by :func:`group_key`; each group becomes one batched
    call, one photon-step launch a round for the whole group, whose
    executor comes from ``cache`` (:func:`default_cache` when None).
    ``mesh`` (a sequence of devices, in place of ``device``) splits each
    group's scenario axis across its devices (zero-photon padding rounds
    the batch up to the device count), each device's slice one batched
    call in its device's process; the mesh's device list is part of
    the cache key.  ``tracer`` records one ``scenarios.batch`` span per
    group (ended after a device synchronisation; device ``"mesh"`` with
    a mesh), one ``scenarios.compile`` span per cache miss, and
    ``scenarios.cache.{hit,miss,evictions,hit_rate}`` counters.  Under a
    ``torch.profiler`` capture the call is a ``simulate_many`` span of
    the process-wide tracer (``telemetry.capture_tracer``), and the
    batch and compile spans go there too, so each group's round loop
    spans (``run``, ``round.*``) hang below its ``scenarios.batch``;
    without ``tracer`` they end without a synchronisation.

    Returns per-scenario ``SimResult``\\ s in input order, each
    bit-identical to its own :func:`simulate_one` on a device of the
    same type.
    """
    if mesh is not None and device is not None:
        raise ValueError("pass either device or mesh, not both")
    if mesh is not None:
        from repro_torch.core.multidevice import mesh_devices

        devices = mesh_devices(mesh)
        dev, label = devices[0], "mesh"
    else:
        dev = resolve_device(device)
        devices, label = [dev], device_label(dev)
    scenarios = list(scenarios)
    if not scenarios:
        return []
    cache = default_cache() if cache is None else cache
    engine = _engine(dev)
    preps = [_prepare(i, sc) for i, sc in enumerate(scenarios)]
    groups: OrderedDict = OrderedDict()
    for p in preps:
        groups.setdefault(_group_key(p, n_lanes, mode, label), []).append(p)
    n_dev = len(devices)
    out: list = [None] * len(scenarios)
    evictions0 = cache.evictions
    cap = capture()
    with phase(cap, "simulate_many", label, scenarios=len(scenarios)):
        for gkey, members in groups.items():
            share = _share_labels(members)
            pad = (-len(members)) % n_dev
            s_pad = len(members) + pad
            key = (gkey, s_pad, share,
                   _mesh_signature(devices if mesh is not None else None))
            fn = cache.get(key)
            hit = fn is not None
            if not hit:
                fn = (_sharded_batched_fn(members[0], n_lanes, mode, devices)
                      if mesh is not None
                      else _raw_batched_fn(members[0], n_lanes, mode, dev))
                cache.put(key, fn)
            if mesh is not None:
                rows, counts = _padded(members, pad)
                k = s_pad // n_dev
                args = ([_stack_rows(rows[i * k:(i + 1) * k],
                                     counts[i * k:(i + 1) * k], share, "cpu")
                         for i in range(n_dev)],)
            else:
                args = _stack_group(members, pad, share, dev)
            total_photons = int(sum(m.sc.n_photons for m in members))
            if tracer is not None:
                tracer.counter("scenarios.cache." + ("hit" if hit
                                                     else "miss"),
                               1, engine=engine, scenarios=len(members))
            owner = tracer if tracer is not None else cap
            # a capture alone adds no synchronisation to what it measures
            opts = dict(engine=engine, sync=tracer is not None,
                        also=cap if owner is tracer else None)
            with (nullcontext() if owner is None else owner.span(
                    "scenarios.batch", photons=total_photons,
                    device="mesh" if mesh is not None else dev,
                    scenarios=len(members), cache_hit=hit, **opts)):
                with (nullcontext() if owner is None or hit else owner.span(
                        "scenarios.compile", device=dev, scenarios=s_pad,
                        **opts)):
                    res = fn(*args)
            for j, m in enumerate(members):
                out[m.idx] = res[j]
    if tracer is not None:
        st = cache.stats()
        tracer.counter("scenarios.cache.hit_rate", st["hit_rate"],
                       engine=engine)
        tracer.counter("scenarios.cache.evictions",
                       cache.evictions - evictions0, engine=engine)
    return out
