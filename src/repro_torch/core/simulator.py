"""Lock-step vectorized photon simulation engine.

The paper's two thread-level workload strategies:

  * ``mode="dynamic"``: all lanes draw photons from a shared remaining
    counter; a lane whose photon terminated relaunches a new one.  The
    relaunch is a masked prefix sum over dead lanes, race-free.
  * ``mode="static"``: every lane is pre-assigned ``n_photons / n_lanes``
    photons and idles once its quota is done.

The loop runs in fused rounds of ``K = cfg.steps_per_round`` transport
segments: regeneration runs once per round, then one photon-step call
advances every lane K segments and adds the round's fluence and
exitance into the run's totals.  On a CUDA device that call is the
hand-written CUDA kernel, on the CPU the hand-written host kernel
(``kernels/photon_step/ops.py``).

The round loop runs S scenarios at once (``build_batched_fn``, which
``repro_torch.scenarios.simulate_many`` uses): lanes are ``(S,
n_lanes)``, scenario-major, and each scenario has its own media table,
staged source parameters, seed, photon budget, 64-bit id offset and
detector geometry; labels are shared or stacked.  One photon-step call
a round advances every scenario.  ``simulate`` runs the same code with
S = 1, so a scenario's result is the same bits batched or alone: every
total that feeds ``SimResult`` is an int64 fixed-point sum
(``kernels/photon_step/spec.py``), whose value does not depend on the
order or the shape of the reduction, and converted to float32 once at
the end.  A scenario whose photons are done freezes: it launches no
photon and adds nothing, and its ``steps`` and round counters stop.

With ``detectors`` the same call also returns the round's detector
TPSF and weighted partial pathlengths (the lanes carry their per-medium
path from round to round), with ``record_detected`` each lane's capture
of the round, which is appended to a fixed-capacity buffer of
``[id_lo, id_hi, det, gate]`` rows, and with ``cfg.collect_stats`` a
per-lane block of live segments that feeds the ``RoundStats`` counters.

Regeneration runs every round, also when no lane relaunches: an
all-False relaunch mask leaves every value as it was, and skipping it
would need a host read.  On a CUDA device, for a source of staged
parameters (``sources.base.StagedSampler``), it is one call of the
hand-written regeneration kernel a round
(``kernels/photon_step/regenerate.py``); on the CPU, or for a source
without ``stage()``, :class:`PlainRegeneration` runs, with the same
bits.  Either is bound once a run to the run's buffers (the lane state,
paths and ids, budgets and launch counts), and every round writes them
in place on every device: where the round is a graph the step writes
them in place, elsewhere the loop copies in the state the step returns.
The loop reads
the host once every ``ROUNDS_PER_READ`` rounds, for its condition:
each round leaves on the device whether any scenario has work left,
and the record cursor, the overflow count and the counters stay there
too.  With the regeneration kernel on the card a round is a fixed
chain of launches, so the loop captures it once a run as a CUDA graph
and replays it between reads (``graph_applies``).  Photon ids are
64-bit, carried as (lo, hi) 32-bit words with the carry propagated, so
campaigns beyond 2**32 photons keep distinct RNG streams.

The round loop returns a :class:`FixedResult` (``core.fixed``): the
run's int64 fixed-point totals, records and counters, still on its
device.  :func:`to_sim_result` converts one (or a sum of several,
:func:`merge_fixed`) to the float32 ``SimResult`` once.  A photon's
path depends only on ``(seed, global id)`` and each deposit is rounded
once, so the totals of runs over disjoint id ranges add up to the bits
of one run over their union, whatever the lanes, mode or order: shards,
chunks and workers (``core.multidevice``, ``resilience``) add
their ``FixedResult`` values and convert once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import photon as ph
from repro_torch.core import rng as xrng
from repro_torch.core.fixed import (COUNTER_FIELDS, SHIFTS, FixedResult,
                                    check_range, from_fixed, zero_fixed)
# simulator.merge_fixed stays a name of this module
from repro_torch.core.fixed import merge_fixed  # noqa: F401
from repro_torch.core.volume import SimConfig, Volume
from repro_torch.detectors import (as_detectors, det_geometry,
                                   validate_detectors)
from repro_torch.kernels.photon_step import spec
from repro_torch.kernels.photon_step.ops import photon_steps, resolve_device
from repro_torch.kernels.photon_step.photon_step import (add_launches,
                                                         check_errors,
                                                         deferred_launches)
from repro_torch.kernels.photon_step.regenerate import Regeneration, supports
from repro_torch.sources import PhotonSource, as_source
from repro_torch.sources.base import StagedSampler, staged_tensors
from repro_torch.telemetry.stats import RoundStats
from repro_torch.telemetry.trace import capture, phase

MODES = ("dynamic", "static")


class SimResult(NamedTuple):
    energy: torch.Tensor     # (nx, ny, nz) float32 deposited energy for the
    #                          CW case (cfg.n_time_gates == 1), else
    #                          (nx, ny, nz, ntg) binned over time gates
    exitance: torch.Tensor   # (nx, ny) float32 weight escaping the z=0 face
    escaped_w: torch.Tensor  # () float32 total escaped weight
    n_launched: torch.Tensor  # () int64 photons actually launched
    launched_w: torch.Tensor  # () float32 total initial weight launched
    steps: int              # lock-step iterations executed
    timed_out_w: torch.Tensor = np.float32(0.0)  # () weight retired by the
    #                          tmax_ns gate or the max_steps cap
    det_w: torch.Tensor = np.zeros((0, 1), np.float32)  # (n_det, ntg)
    #                          detected-weight TPSF histogram per detector
    det_ppath: torch.Tensor = np.zeros((0, 0), np.float32)  # (n_det,
    #                          n_media) weight-weighted partial path sums, mm
    det_rec: torch.Tensor = np.zeros((0, 4), np.int64)  # (capacity, 4)
    #                          int64 rows [id_lo, id_hi, det, gate], words in
    #                          [0, 2**32): the 64-bit global photon id,
    #                          detector and exit gate of each capture, in
    #                          capture order; the first det_rec_n are valid
    det_rec_n: torch.Tensor = np.int64(0)  # () valid record count
    det_rec_overflow: torch.Tensor = np.int64(0)  # () captures dropped once
    #                          the buffer was full (det_w still counts them)
    stats: RoundStats | None = None  # round counters with
    #                          cfg.collect_stats, else None


class RunCancelled(RuntimeError):
    """A run whose ``cancel`` event was set stopped at a round's host
    read."""


def to_sim_result(fixed: FixedResult) -> SimResult:
    """The float32 ``SimResult`` of a fixed-point result, on its device:
    each total converted once (``core.fixed.from_fixed``), the record and
    step fields passed through.  Under a ``torch.profiler`` capture it is
    a ``convert`` span (``telemetry.capture_tracer``)."""
    with phase(capture(), "convert", fixed.fluence.device):
        return _convert(fixed)


def _convert(fixed: FixedResult) -> SimResult:
    fw = SHIFTS
    escaped = from_fixed(fixed.escaped, fw["escaped"])
    timed_out = from_fixed(fixed.timed_out, fw["timed_out"])
    stats = None
    if fixed.counters is not None:
        c = dict(zip(COUNTER_FIELDS, fixed.counters.tolist()))
        stats = RoundStats(
            rounds=np.int32(c["rounds"]),
            regen_rounds=np.int32(c["regen_rounds"]),
            relaunched=np.int32(c["relaunched"]),
            live_segments=np.float32(c["live_segments"]),
            lane_segments=np.float32(c["lane_segments"]),
            deposited_w=np.float32(from_fixed(fixed.fluence.sum(),
                                              fw["fluence"]).item()),
            escaped_w=np.float32(escaped.item()),
            timed_out_w=np.float32(timed_out.item()),
            detected_w=np.float32(from_fixed(fixed.det_w.sum(),
                                             fw["det_w"]).item()))
    return SimResult(
        energy=from_fixed(fixed.fluence, fw["fluence"]),
        exitance=from_fixed(fixed.exitance, fw["exitance"]),
        escaped_w=escaped,
        timed_out_w=timed_out,
        n_launched=fixed.n_launched,
        launched_w=from_fixed(fixed.launched_w, fw["launched_w"]),
        steps=fixed.steps,
        det_w=from_fixed(fixed.det_w, fw["det_w"]),
        det_ppath=from_fixed(fixed.det_ppath, fw["det_ppath"]),
        det_rec=fixed.det_rec,
        det_rec_n=fixed.det_rec_n,
        det_rec_overflow=fixed.det_rec_overflow,
        stats=stats)


_TOTAL_SCALE = float(2**spec.TOTAL_SHIFT)


def _total_rows(x: torch.Tensor, S: int) -> torch.Tensor:
    """Per-scenario int64 sums of per-lane float32 values ``x`` (``(S *
    n,)`` or ``(S, n)``) in fixed point of ``2**-TOTAL_SHIFT``: each value
    rounded once, so the sum is the same in any order and shape."""
    return torch.round(x * _TOTAL_SCALE).to(torch.int64).view(S, -1).sum(1)


class PlainRegeneration:
    """Regeneration in PyTorch operations: the path of the CPU and of
    sources without ``stage()``, and the yardstick the card tests hold
    the regeneration kernel to.  It takes the arguments of
    ``kernels.photon_step.regenerate.Regeneration`` and keeps its
    contract, on any device and for any ``sample``.

    Bound to one run of S scenarios of ``n`` lanes: ``(S,)`` int64
    photon budgets ``remaining``, ``(S, n)`` int64 ``launched_per_lane``
    and ``quota``, ``(S,)`` int64 ``launched_w`` (2**-TOTAL_SHIFT
    units), ``(S, 1)`` int64 seed words, the media count of the per-lane
    paths (0 without detectors) and the ``(S * n, 2)`` int64 ``[lo,
    hi]`` ids of a recording run's lanes (or None).  ``sample(ids,
    seeds)`` turns ``(S, n)`` ids into ``(S, n, ...)`` launch states.

    ``regen(state, next_id, ppath=None)`` relaunches the dead lanes of a
    round by the workload mode (dynamic: a dead lane whose rank among
    its scenario's dead lanes is within the remaining budget; static: a
    dead lane below its quota) and writes in place: the state (flat
    ``(S * n, ...)``, scenario-major), ``ppath`` (relaunched rows
    zeroed), ``remaining``, ``launched_per_lane``, ``launched_w`` (the
    relaunched weight added) and ``lane_ids``.  ``next_id`` is each
    scenario's 64-bit next photon id as a ``(lo, hi)`` pair of ``(S,)``
    int64 words; the advanced ids are returned as the rows of
    ``next_out``, the ``(2, S)`` buffer each call overwrites.
    """

    def __init__(self, sample, mode: str, shape, remaining,
                 launched_per_lane, quota, launched_w, seeds,
                 n_media: int = 0, lane_ids=None):
        self.sample, self.mode, self.shape = sample, mode, shape
        self.remaining, self.launched, self.quota = (
            remaining, launched_per_lane, quota)
        self.launched_w, self.seeds = launched_w, seeds
        self.lane_ids = lane_ids
        self.next_out = torch.empty((2,) + tuple(remaining.shape),
                                    dtype=torch.int64,
                                    device=remaining.device)

    def __call__(self, state: ph.PhotonState, next_id, ppath=None):
        S = self.remaining.shape[0]
        dead = ~state.alive.view(S, -1)
        if self.mode == "dynamic":
            order = torch.cumsum(dead.to(torch.int64), 1)  # 1-based rank
            relaunch = dead & (order <= self.remaining[:, None])
        else:  # static pre-assigned quota per lane
            relaunch = dead & (self.launched < self.quota)
        rel = relaunch.to(torch.int64)
        n_relaunch = rel.sum(1)
        rank = torch.cumsum(rel, 1) - 1  # 0-based among relaunched
        # masked lanes may compute a garbage id (rank -1); their sample is
        # discarded by the merge
        ids = xrng.add_id(next_id[0][:, None], next_id[1][:, None], rank)
        pos, direc, w0, rng = (x.reshape((-1,) + x.shape[2:])
                               for x in self.sample(ids, self.seeds))
        relaunch = relaunch.reshape(-1)
        fresh = ph.launch(pos, direc, w0, rng, relaunch, self.shape)
        for new, old in zip(fresh[:-1], state[:-1]):
            old.copy_(torch.where(relaunch[:, None] if new.ndim > 1
                                  else relaunch, new, old))
        state.alive.logical_or_(relaunch)
        self.launched_w.add_(_total_rows(
            torch.where(relaunch, w0, torch.zeros_like(w0)), S))
        self.remaining.sub_(n_relaunch)
        self.launched.add_(rel)
        if ppath is not None:
            ppath.masked_fill_(relaunch[:, None], 0.0)
        if self.lane_ids is not None:
            self.lane_ids.copy_(torch.where(
                relaunch[:, None],
                torch.stack([ids.lo, ids.hi], dim=-1).reshape(-1, 2),
                self.lane_ids))
        torch.stack(xrng.add_id(*next_id, n_relaunch), out=self.next_out)
        return self.next_out[0], self.next_out[1]


def check_labels(labels_flat, media) -> None:
    """Every label must index a row of the media table (one host read)."""
    top = int(labels_flat.max()) if labels_flat.numel() else 0
    if top >= media.shape[-2]:
        raise ValueError(f"label {top} has no row in the {media.shape[-2]}-row "
                         f"media table")


def _append_records(rec, rec_n, overflow, lane_ids, capd, capg,
                    capacity: int):
    """Append a round's captures to each scenario's fixed-capacity
    record buffer.

    ``rec`` is ``(S, capacity + 1, 4)``, ``rec_n`` and ``overflow``
    ``(S,)``.  Slots come from a prefix sum over each scenario's
    captured lanes, so lanes never collide; masked and over-capacity
    writes land in the scenario's write-off row ``rec[s, capacity]``.
    ``rec``, ``rec_n`` and ``overflow`` are updated in place.
    """
    S = rec.shape[0]
    captured = (capd >= 0).view(S, -1)
    cap_i = captured.to(torch.int64)
    slot = rec_n[:, None] + torch.cumsum(cap_i, 1) - 1
    slot = torch.where(captured & (slot < capacity), slot,
                       torch.full_like(slot, capacity))
    slot = slot + torch.arange(S, device=slot.device)[:, None] * (capacity + 1)
    vals = torch.stack([lane_ids[:, 0], lane_ids[:, 1],
                        capd.to(torch.int64), capg.to(torch.int64)], dim=1)
    rec.view(-1, 4).index_copy_(0, slot.reshape(-1), vals)
    total = rec_n + cap_i.sum(1)
    new_n = torch.clamp(total, max=capacity)
    overflow += total - new_n
    rec_n.copy_(new_n)


# Rounds the loop issues between two host reads of its condition.  A read
# waits for the device to drain, so the rounds between reads run back to
# back (on the card, replays of one captured round: ``graph_applies``).
# A run overshoots its last round with work by at most R - 1 rounds in
# which no scenario has work: each is a no-op for every output (nothing
# relaunches, dead lanes deposit nothing, the round is not counted) and
# costs ~0.05 ms of device time at the cells' 262144 lanes (the step's
# dead warps draw their uniforms and leave, three regeneration launches,
# the small totals): at most ~0.75 ms against the 600-1000 rounds of
# ~0.16 ms of a 10^7-photon solution.  Each read leaves the device idle
# while the host reads the flag and issues the next replay, once in R
# rounds: ~40-60 reads a solution.
ROUNDS_PER_READ = 16


def graph_applies(device, regen) -> bool:
    """Whether the round loop captures its round as a CUDA graph and
    replays it: on a CUDA device with the regeneration kernel, where a
    round is a fixed chain of launches on buffers fixed for the run and
    reads nothing on the host.  Elsewhere (the CPU's host kernel, sources
    without ``stage()``) each round is issued eagerly."""
    return (torch.device(device).type == "cuda"
            and isinstance(regen, Regeneration))


class _Captures(threading.local):
    """Each thread's capture stream and last round graph, one a device:
    the thread's next capture runs on the same stream and shares the
    last graph's memory pool (a run's graph is never replayed once the
    run has returned), so the pool's blocks, which the allocator hands
    out again only on the stream that freed them, serve solution after
    solution instead of growing with each."""

    def __init__(self):
        self.by_device: dict = {}


_CAPTURES = _Captures()


def capture_round(round_fn, device):
    """Capture one round as a CUDA graph: ``round_fn()`` issues the
    round's launches on a side stream under capture, which runs none of
    them.  Returns the graph and the launch counts it holds
    (``launches_by`` keys), which each replay adds."""
    stream, last = _CAPTURES.by_device.get(device) or (
        torch.cuda.Stream(device), None)
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream), deferred_launches() as counts:
        graph.capture_begin(pool=None if last is None else last.pool(),
                            capture_error_mode="thread_local")
        try:
            round_fn()
        except BaseException:
            with contextlib.suppress(RuntimeError):
                graph.capture_end()
            raise
        graph.capture_end()
    _CAPTURES.by_device[device] = (stream, graph)
    return graph, counts


def build_round_loop(shape: tuple[int, int, int], unitinmm: float,
                     cfg: SimConfig, n_lanes: int, mode: str = "dynamic",
                     sample=None, device=None, n_det: int = 0,
                     record_detected: int = 0):
    """Build the round loop of S scenarios at once.

    Returns ``fn(labels, media, det_geom, n_photons, seeds, id_lo,
    id_hi, cancel=None) -> list[FixedResult]`` on ``device`` (``None``:
    CUDA): labels ``(nvox,)`` shared or ``(S, nvox)`` stacked uint8,
    media ``(S, n_media, 4)`` float32, ``det_geom`` ``(S, n_det, 3)``
    (or None without detectors), and per scenario the photon budget,
    seed and the low and high words of its 64-bit id offset (sequences
    of S ints).  ``sample(ids, seeds)`` gives the launch states of
    ``(S, n_lanes)`` ids for ``(S, 1)`` int64 seeds, as a source's
    ``sample_staged`` on stacked staged parameters does.  Each scenario
    runs ``n_lanes`` lanes; the result of each is the same bits as the
    scenario alone (S = 1).  ``cancel`` (anything with ``is_set()``: a
    ``threading.Event``, or a device process's cancel slot,
    ``core.procs``) is tested at each host read: once it is set the run
    raises :class:`RunCancelled`.

    The loop reads the host once every ``ROUNDS_PER_READ`` rounds: a
    flag each round leaves on the device (whether any scenario has work
    left), and the cancel test.  Where :func:`graph_applies`, the first
    round runs eagerly (its launches reach every lane), the round is
    then captured as a CUDA graph, and every later round is a replay;
    the step writes the lane state back in place, so each replay reads
    what the one before wrote.  ``launches_by`` counts a replay under
    ``round_graph`` and the graph's launches under their own keys, as
    the device runs them.

    Under a ``torch.profiler`` capture (read once a call) the call is a
    ``run`` span of the process-wide tracer (``telemetry.capture_tracer``;
    args photons, scenarios, lanes, K, rounds, host_reads and replays)
    holding ``round.host_read`` at each read, ``round.regenerate``,
    ``round.step`` (the host side of the photon-step call) and
    ``round.totals`` for each round issued eagerly and for the capture,
    ``round.replay`` around each graph launch, then ``run.finish``
    (everything after the loop).  None of them synchronises the device.
    """
    if mode not in MODES:
        raise ValueError(f"unknown workload mode: {mode}")
    dev = resolve_device(device)
    capacity = int(record_detected)
    if capacity < 0:
        raise ValueError(f"record_detected must be >= 0, got {capacity}")
    record = capacity > 0
    if record and not n_det:
        raise ValueError("record_detected > 0 requires detectors: the id "
                         "buffer records detector captures")
    K = int(cfg.steps_per_round)
    if K < 1:
        raise ValueError(f"cfg.steps_per_round must be >= 1, got {K}")
    ntg = int(cfg.n_time_gates)
    if ntg < 1:
        raise ValueError(f"cfg.n_time_gates must be >= 1, got {ntg}")
    collect = bool(cfg.collect_stats)
    n_lanes = int(n_lanes)
    # rounds of K segments until the segments reach cfg.max_steps
    max_rounds = -(-int(cfg.max_steps) // K)

    def fn(labels, media, det_geom, n_photons, seeds, id_lo, id_hi,
           cancel=None) -> list[FixedResult]:
        cap = capture()
        args = (labels, media, det_geom, n_photons, seeds, id_lo, id_hi,
                cancel)
        if cap is None:
            return loop(None, *args)[0]
        with cap.span("run", dev, sync=False,
                      photons=sum(int(n) for n in n_photons),
                      scenarios=len(n_photons), lanes=n_lanes, K=K) as span:
            out, reads, replays = loop(cap, *args)
            span.note(rounds=max(f.steps for f in out) // K,
                      host_reads=reads, replays=replays)
        return out

    def loop(cap, labels, media, det_geom, n_photons, seeds, id_lo, id_hi,
             cancel) -> tuple[list[FixedResult], int, int]:
        S = len(n_photons)
        labels = labels.to(dev).contiguous()
        media = media.to(device=dev, dtype=torch.float32).contiguous()
        if media.ndim != 3 or media.shape[0] != S:
            raise ValueError(f"media must be (S={S}, n_media, 4), got "
                             f"{tuple(media.shape)}")
        check_labels(labels, media)
        n_media = media.shape[1]
        if n_det:
            det_geom = det_geom.to(device=dev,
                                   dtype=torch.float32).contiguous()
        N = S * n_lanes
        f32 = dict(dtype=torch.float32, device=dev)
        i64 = dict(dtype=torch.int64, device=dev)

        def words(vals):
            return torch.tensor([int(v) & xrng.MASK32 for v in vals], **i64)

        photons = torch.tensor([int(v) for v in n_photons], **i64)
        seed_col = words(seeds)[:, None]
        first_lo = words(id_lo)
        # each scenario's next photon id, low and high words
        ids = torch.stack([first_lo, words(id_hi)])
        next_id = (ids[0], ids[1])
        # static mode: equal shares, the remainder spread over the first
        # (n_photons mod n_lanes) lanes, so exactly n_photons launch
        lane_idx = torch.arange(n_lanes, **i64)
        quota = photons[:, None] // n_lanes + (
            lane_idx[None] < (photons % n_lanes)[:, None]).to(torch.int64)
        state = ph.PhotonState(
            pos=torch.zeros((N, 3), **f32),
            dir=torch.tensor([0.0, 0.0, 1.0], **f32).repeat(N, 1),
            ivox=torch.zeros((N, 3), dtype=torch.int32, device=dev),
            w=torch.zeros((N,), **f32),
            s_left=torch.zeros((N,), **f32),
            t=torch.zeros((N,), **f32),
            rng=torch.zeros((N, 4), **i64),
            alive=torch.zeros((N,), dtype=torch.bool, device=dev),
        )
        # the run's buffers, fixed for the run: every round writes them
        # in place, and the photon-step call adds the grids into the
        # fixed-point totals
        acc = zero_fixed(shape, n_media, n_det, cfg, (S,), dev)
        grids = [acc.fluence.view(S, -1), acc.exitance.view(S, -1)]
        # each RoundStats counter's column, by name
        counters = (dict(zip(COUNTER_FIELDS, acc.counters.unbind(1)))
                    if collect else None)
        if n_det:
            grids += [acc.det_w.view(S, -1), acc.det_ppath]
        remaining = photons.clone()
        launched = torch.zeros((S, n_lanes), **i64)
        ppath = torch.zeros((N, n_media), **f32) if n_det else None
        # one write-off row past the capacity takes masked and
        # overflowing record writes
        rec = torch.zeros((S, capacity + 1 if record else 0, 4), **i64)
        lane_ids = torch.zeros((N, 2), **i64) if record else None
        rounds = torch.zeros((S,), **i64)
        # which scenarios have work at the start of the next round, and
        # whether any has: the flag the host reads
        work = torch.zeros((S,), dtype=torch.bool, device=dev)
        more = torch.zeros((), dtype=torch.bool, device=dev)
        # on the card, a staged source regenerates in one kernel call a
        # round; elsewhere in PyTorch operations, with the same bits
        regen = (Regeneration if supports(sample, dev) else PlainRegeneration)(
            sample, mode, shape, remaining, launched, quota, acc.launched_w,
            seed_col, n_media if n_det else 0, lane_ids)
        graphed = graph_applies(dev, regen)

        def find_work():
            alive = state.alive.view(S, n_lanes)
            if mode == "dynamic":
                torch.logical_or(alive.any(1), remaining > 0, out=work)
            else:
                torch.any(alive | (launched < quota), 1, out=work)
            torch.any(work, out=more)

        def one_round():
            with phase(cap, "round.regenerate", dev):
                new_id = regen(state, next_id, ppath)
            with phase(cap, "round.step", dev):
                # the graph steps the run's buffers in place, its addresses
                # being fixed; an eager round takes the state the step
                # returns (a copy onto itself does nothing)
                outs = photon_steps(labels, media, state, shape, unitinmm,
                                    cfg, K, ppath=ppath, det_geom=det_geom,
                                    record=record, stats=collect,
                                    totals=grids, inplace=graphed)
                for buf, new in zip(state, outs[0]):
                    buf.copy_(new)
            with phase(cap, "round.totals", dev):
                # a scenario with no work left is frozen: it relaunches
                # nothing, its lanes are dead, and its rounds stop here
                rounds.add_(work.to(torch.int64))
                _, _, _, esc, timed = outs[:5]
                acc.escaped.add_(_total_rows(esc, S))
                acc.timed_out.add_(_total_rows(timed, S))
                cur = 5
                if n_det:
                    ppath.copy_(outs[cur])
                    cur += 3
                if record:
                    _append_records(rec, acc.det_rec_n, acc.det_rec_overflow,
                                    lane_ids, outs[cur], outs[cur + 1],
                                    capacity)
                    cur += 2
                if collect:
                    # launches per round stay < 2**31, so the low-word
                    # difference is exact across a 2**32 boundary
                    rel = (new_id[0] - next_id[0]) & xrng.MASK32
                    counters["regen_rounds"].add_((rel > 0).to(torch.int64))
                    counters["relaunched"].add_(rel)
                    counters["live_segments"].add_(outs[cur][:, 0].to(
                        torch.int64).view(S, n_lanes).sum(1))
                ids.copy_(regen.next_out)
                find_work()

        find_work()
        issued = reads = replays = 0
        graph = None
        # a replay launches on the current stream of the current device
        with torch.cuda.device(dev) if graphed else contextlib.nullcontext():
            while issued < max_rounds:
                reads += 1
                with phase(cap, "round.host_read", dev):
                    if not bool(more):  # reprolint: disable=REP401 - the loop's one host read, once every ROUNDS_PER_READ rounds
                        break
                    if cancel is not None and cancel.is_set():
                        raise RunCancelled(f"run cancelled after "
                                           f"{issued * K} steps")
                before = replays
                for _ in range(min(ROUNDS_PER_READ, max_rounds - issued)):
                    if graph is None and graphed and issued:
                        graph, held = capture_round(one_round, dev)
                    if graph is None:
                        one_round()
                    else:
                        with phase(cap, "round.replay", dev):
                            graph.replay()
                        replays += 1
                    issued += 1
                if replays > before:
                    n = replays - before
                    add_launches({"round_graph": n,
                                  **{k: v * n for k, v in held.items()}})

        with phase(cap, "run.finish", dev):
            # weight still in flight when the max_steps cap fires is retired
            # deterministically, like the time gate
            acc.timed_out.add_(_total_rows(torch.where(
                state.alive, state.w, torch.zeros_like(state.w)), S))
            # a fixed-point total past 2**63 - 1 shows a negative value: the
            # kernel flags what its blocks add from their caches, this checks
            # every total once (one host read)
            check_range(grids + [acc.escaped, acc.timed_out, acc.launched_w])
            if dev.type == "cuda":
                check_errors(dev)
            if collect:
                counters["rounds"].copy_(rounds)
                counters["lane_segments"].copy_(rounds * (K * n_lanes))
            # launches per run stay < 2**31, so the low-word difference is
            # the exact count even across a 2**32 boundary
            fixed = acc._replace(
                n_launched=(next_id[0] - first_lo) & xrng.MASK32,
                det_rec=rec[:, :capacity])
            out = [FixedResult(*(x[i] if isinstance(x, torch.Tensor) else x
                                 for x in fixed))._replace(steps=steps)
                   for i, steps in enumerate((rounds * K).tolist())]
            return out, reads, replays

    return fn


def build_batched_fn(shape: tuple[int, int, int], unitinmm: float,
                     cfg: SimConfig, n_lanes: int, mode: str = "dynamic",
                     sample=None, device=None, n_det: int = 0,
                     record_detected: int = 0):
    """The round loop of :func:`build_round_loop` with each scenario's
    result converted: ``fn(labels, media, det_geom, n_photons, seeds,
    id_lo, id_hi) -> list[SimResult]``."""
    loop = build_round_loop(shape, unitinmm, cfg, n_lanes, mode, sample,
                            device, n_det, record_detected)

    def fn(*args) -> list[SimResult]:
        return [to_sim_result(f) for f in loop(*args)]

    return fn


def source_sampler(source, device):
    """``sample(ids, seeds)`` of one scenario's source for the round
    loop: a ``StagedSampler`` of its staged parameters, or, for a source
    without ``stage()``, its ``sample`` (one scenario only)."""
    source = as_source(source)
    if hasattr(source, "stage"):
        return StagedSampler(type(source),
                             staged_tensors(source.stage(), device))

    def sample(ids, seeds):
        one = source.sample(xrng.PhotonId(ids.lo[0], ids.hi[0]),
                            int(seeds[0, 0]))
        return tuple(x[None] for x in one)
    return sample


def build_fixed_fn(shape: tuple[int, int, int], unitinmm: float,
                   cfg: SimConfig, n_lanes: int, mode: str = "dynamic",
                   source: PhotonSource | None = None, device=None,
                   detectors=None, record_detected: int = 0):
    """Build the fixed-point simulation function of one scenario.

    Returns ``fixed_fn(labels_flat, media, n_photons, seed, id_offset=0,
    id_offset_hi=0, cancel=None) -> FixedResult`` running on ``device``
    (``None``: CUDA): the round loop of :func:`build_round_loop` with
    S = 1.  ``id_offset`` / ``id_offset_hi`` (the low and high 32-bit
    words of a 64-bit offset) give this run a disjoint global photon-id
    range; ``cancel`` is as there.  The arguments are those of
    :func:`build_sim_fn`.
    """
    dev = resolve_device(device)
    detectors = as_detectors(detectors)
    n_det = len(detectors)
    if n_det:
        validate_detectors(detectors, shape)
    det_geom = det_geometry(detectors, dev)[None] if n_det else None
    run = build_round_loop(shape, unitinmm, cfg, n_lanes, mode,
                           source_sampler(source, dev), dev, n_det,
                           record_detected)

    def fixed_fn(labels_flat, media, n_photons, seed, id_offset=0,
                 id_offset_hi=0, cancel=None) -> FixedResult:
        return run(labels_flat.reshape(-1), media[None], det_geom,
                   [n_photons], [seed], [id_offset], [id_offset_hi],
                   cancel)[0]

    return fixed_fn


def build_sim_fn(shape: tuple[int, int, int], unitinmm: float,
                 cfg: SimConfig, n_lanes: int, mode: str = "dynamic",
                 source: PhotonSource | None = None, device=None,
                 detectors=None, record_detected: int = 0):
    """Build the simulation function of one scenario.

    Returns ``sim_fn(labels_flat, media, n_photons, seed, id_offset=0,
    id_offset_hi=0) -> SimResult`` running on ``device`` (``None``:
    CUDA): :func:`build_fixed_fn`'s result converted by
    :func:`to_sim_result`.  ``id_offset`` / ``id_offset_hi`` (the low
    and high 32-bit words of a 64-bit offset) give this run a disjoint
    global photon-id range.  ``cfg.n_time_gates`` widens the energy
    grid to ``shape + (ntg,)``.

    ``detectors`` (``repro_torch.detectors`` spec) records, per detector
    disk on the z=0 face, the TPSF over the time gates and the
    weight-weighted per-medium partial pathlengths.
    ``record_detected`` > 0 (needs detectors) also records the global
    photon id, detector and exit gate of up to that many captures in
    ``SimResult.det_rec``; once it is full, captures still count in
    ``det_w`` / ``det_ppath`` and the dropped records are counted in
    ``det_rec_overflow``.  ``cfg.collect_stats`` returns
    ``RoundStats`` counters on ``SimResult.stats`` without changing any
    physics output.
    """
    fixed_fn = build_fixed_fn(shape, unitinmm, cfg, n_lanes, mode, source,
                              device, detectors, record_detected)

    def sim_fn(labels_flat, media, n_photons, seed, id_offset=0,
               id_offset_hi=0) -> SimResult:
        return to_sim_result(fixed_fn(labels_flat, media, n_photons, seed,
                                      id_offset, id_offset_hi))

    return sim_fn


def make_simulator(volume: Volume, cfg: SimConfig, n_lanes: int,
                   mode: str = "dynamic", source=None, device=None,
                   detectors=None, record_detected: int = 0):
    """Simulation function for a fixed (volume shape, cfg, lanes, mode,
    source, device, detectors, record capacity); call it with the
    volume's labels and media.  Detector disks are validated here
    against the volume's z=0 face."""
    return build_sim_fn(volume.shape, volume.unitinmm, cfg, n_lanes, mode,
                        source, device, detectors, record_detected)


def simulate_fixed(volume: Volume, cfg: SimConfig, n_photons: int,
                   n_lanes: int = 4096, seed: int = 1234, source=None,
                   mode: str = "dynamic", device=None, detectors=None,
                   record_detected: int = 0,
                   id_offset: int = 0) -> FixedResult:
    """:func:`simulate`'s run, returned as its fixed-point totals; its
    photons have the global ids ``id_offset .. id_offset + n_photons -
    1`` (a 64-bit offset)."""
    fixed_fn = build_fixed_fn(volume.shape, volume.unitinmm, cfg, n_lanes,
                              mode, source, device, detectors,
                              record_detected)
    return fixed_fn(volume.labels.reshape(-1), volume.media, n_photons, seed,
                    *xrng.split_id64(int(id_offset)))


def simulate(volume: Volume, cfg: SimConfig, n_photons: int,
             n_lanes: int = 4096, seed: int = 1234, source=None,
             mode: str = "dynamic", device=None, detectors=None,
             record_detected: int = 0) -> SimResult:
    """One-shot simulation on ``device`` (``None``: the CUDA device; a
    machine without one raises unless ``device="cpu"``).

    ``source`` accepts any registered source (repro_torch.sources), the
    legacy pencil :class:`Source`, or a ``sources.to_dict``-style dict;
    ``None`` is the paper's pencil beam.  ``detectors`` enables TPSF
    recording on the z=0 face; ``record_detected`` sets the capacity of
    the detected-photon record buffer for replay.  Under a
    ``torch.profiler`` capture it is a ``simulate`` span, the root of the
    run's and the conversion's spans.
    """
    with phase(capture(), "simulate", photons=int(n_photons)):
        return to_sim_result(simulate_fixed(
            volume, cfg, n_photons, n_lanes, seed, source, mode, device,
            detectors, record_detected))


# ---------------------------------------------------------------------------
# (lane count x steps-per-round) autotuning
# ---------------------------------------------------------------------------

def _synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def autotune_rounds(volume: Volume, cfg: SimConfig, n_pilot: int = 20_000,
                    lane_candidates=(1024, 2048, 4096, 8192, 16384),
                    round_candidates=(1, 4, 8, 16, 32),
                    seed: int = 7, source=None, repeats: int = 2,
                    mode: str = "dynamic", device=None,
                    ) -> tuple[tuple[int, int], dict[tuple[int, int], float]]:
    """2-D pilot sweep over ``(n_lanes, steps_per_round)`` on ``device``
    (``None``: CUDA).

    The paper's Opt2 picks the balanced thread number from hardware
    occupancy; here it is measured, and the fused-round depth K trades
    regeneration amortization against masked-lane waste, so the two are
    tuned together.  Each candidate runs once to warm up, then
    ``repeats`` times, each timed on the host clock to a device
    synchronisation; the best is kept.  Returns ``((best_lanes,
    best_k), timings_s)`` with timings keyed by ``(lanes, k)``.
    """
    dev = resolve_device(device)
    volume = volume.to(dev)
    labels_flat = volume.labels.reshape(-1)
    timings: dict[tuple[int, int], float] = {}
    for lanes in lane_candidates:
        for k in round_candidates:
            kcfg = dataclasses.replace(cfg, steps_per_round=int(k))
            sim_fn = make_simulator(volume, kcfg, lanes, mode, source, dev)
            args = (labels_flat, volume.media, n_pilot, seed)
            sim_fn(*args)  # warm up
            _synchronize(dev)
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()  # reprolint: disable=REP201 - autotune times its pilots on the host clock
                sim_fn(*args)
                _synchronize(dev)
                best = min(best, time.perf_counter() - t0)  # reprolint: disable=REP201 - autotune times its pilots on the host clock
            timings[(lanes, k)] = best
    best_cfg = min(timings, key=timings.get)
    return best_cfg, timings


def autotune_lanes(volume: Volume, cfg: SimConfig, n_pilot: int = 20_000,
                   candidates=(1024, 2048, 4096, 8192, 16384),
                   seed: int = 7, source=None, repeats: int = 2,
                   mode: str = "dynamic",
                   device=None) -> tuple[int, dict[int, float]]:
    """Pick the lane count with the highest pilot throughput: the 1-D
    slice of :func:`autotune_rounds` at the config's own
    ``steps_per_round`` (the paper's Opt2).  Returns
    ``(best_lane_count, timings_s)``."""
    (best_lanes, _), timings = autotune_rounds(
        volume, cfg, n_pilot, candidates,
        round_candidates=(int(cfg.steps_per_round),), seed=seed,
        source=source, repeats=repeats, mode=mode, device=device)
    return best_lanes, {lanes: t for (lanes, _), t in timings.items()}
