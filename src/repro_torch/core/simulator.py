"""Lock-step vectorized photon simulation engine.

The paper's two thread-level workload strategies:

  * ``mode="dynamic"``: all lanes draw photons from a shared remaining
    counter; a lane whose photon terminated relaunches a new one.  The
    relaunch is a masked prefix sum over dead lanes, race-free.
  * ``mode="static"``: every lane is pre-assigned ``n_photons / n_lanes``
    photons and idles once its quota is done.

The loop runs in fused rounds of ``K = cfg.steps_per_round`` transport
segments: regeneration runs once per round, then one photon-step call
advances every lane K segments and returns the round's fluence,
exitance and escaped / timed-out weight, which are added to the run's
totals.  On a CUDA device that call is the hand-written kernel, on the
CPU its plain PyTorch version (``kernels/photon_step/ops.py``).

With ``detectors`` the same call also returns the round's detector
TPSF and weighted partial pathlengths (the lanes carry their per-medium
path from round to round), with ``record_detected`` each lane's capture
of the round, which is appended to a fixed-capacity buffer of
``[id_lo, id_hi, det, gate]`` rows, and with ``cfg.collect_stats`` a
per-lane block of live segments and deposited weight that feeds the
``RoundStats`` counters.

Regeneration runs every round, also when no lane relaunches: an
all-False relaunch mask leaves every value as it was, and skipping it
would need a host read.  The one host read per round is the loop
condition; the record cursor, the overflow count and the counters stay
on the device.  Photon ids are 64-bit, carried as (lo, hi) 32-bit words
with the carry propagated, so campaigns beyond 2**32 photons keep
distinct RNG streams.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import photon as ph
from repro_torch.core import rng as xrng
from repro_torch.core.volume import SimConfig, Volume
from repro_torch.detectors import (as_detectors, det_geometry,
                                   validate_detectors)
from repro_torch.kernels.photon_step.ops import photon_steps, resolve_device
from repro_torch.sources import PhotonSource, as_source
from repro_torch.telemetry.stats import RoundStats

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


def _regenerate(state, remaining, launched_per_lane, next_id, quota,
                source, seed, mode, shape, ppath=None, lane_ids=None):
    """Relaunch photons in dead lanes according to the workload mode.

    ``next_id`` is the 64-bit global photon id counter as a ``(lo, hi)``
    pair of 0-d int64 word tensors; it is returned advanced.  Returns
    ``(state, remaining, launched_per_lane, next_id, launched_weight)``,
    then, when given, ``ppath`` (detector runs: the per-lane per-medium
    path, zeroed for relaunched lanes) and ``lane_ids`` (recording runs:
    the ``(n_lanes, 2)`` int64 ``[lo, hi]`` id of each lane's photon,
    updated for relaunched lanes).
    """
    dead = ~state.alive
    if mode == "dynamic":
        order = torch.cumsum(dead.to(torch.int64), 0)  # 1-based rank
        relaunch = dead & (order <= remaining)
    else:  # static pre-assigned quota per lane
        relaunch = dead & (launched_per_lane < quota)
    rel = relaunch.to(torch.int64)
    n_relaunch = rel.sum()
    rank = torch.cumsum(rel, 0) - 1  # 0-based among relaunched
    # masked lanes may compute a garbage id (rank -1); their sample is
    # discarded by the merge
    ids = xrng.add_id(*next_id, rank)
    pos, direc, w0, rng = source.sample(ids, seed)
    fresh = ph.launch(pos, direc, w0, rng, relaunch, shape)
    merged = ph.PhotonState(*(
        torch.where(relaunch[:, None] if new.ndim > 1 else relaunch, new, old)
        for new, old in zip(fresh, state)))
    merged = merged._replace(alive=state.alive | relaunch)
    w_new = torch.where(relaunch, w0, torch.zeros_like(w0)).sum()
    out = (merged, remaining - n_relaunch, launched_per_lane + rel,
           tuple(xrng.add_id(*next_id, n_relaunch)), w_new)
    if ppath is not None:
        out = out + (torch.where(relaunch[:, None], torch.zeros_like(ppath),
                                 ppath),)
    if lane_ids is not None:
        out = out + (torch.where(relaunch[:, None],
                                 torch.stack([ids.lo, ids.hi], dim=1),
                                 lane_ids),)
    return out


def check_labels(labels_flat, media) -> None:
    """Every label must index a row of the media table (one host read)."""
    top = int(labels_flat.max()) if labels_flat.numel() else 0
    if top >= media.shape[0]:
        raise ValueError(f"label {top} has no row in the {media.shape[0]}-row "
                         f"media table")


def _append_records(rec, rec_n, overflow, lane_ids, capd, capg,
                    capacity: int):
    """Append a round's captures to the fixed-capacity record buffer.

    Slots come from a prefix sum over the captured lanes, so lanes never
    collide; masked and over-capacity writes land in the write-off row
    ``rec[capacity]``.  ``rec_n`` and ``overflow`` are 0-d device
    tensors, updated in place with ``rec``.
    """
    captured = capd >= 0
    cap_i = captured.to(torch.int64)
    slot = rec_n + torch.cumsum(cap_i, 0) - 1
    slot = torch.where(captured & (slot < capacity), slot,
                       torch.full_like(slot, capacity))
    vals = torch.stack([lane_ids[:, 0], lane_ids[:, 1],
                        capd.to(torch.int64), capg.to(torch.int64)], dim=1)
    rec.index_copy_(0, slot, vals)
    total = rec_n + cap_i.sum()
    new_n = torch.clamp(total, max=capacity)
    overflow += total - new_n
    rec_n.copy_(new_n)


def build_sim_fn(shape: tuple[int, int, int], unitinmm: float,
                 cfg: SimConfig, n_lanes: int, mode: str = "dynamic",
                 source: PhotonSource | None = None, device=None,
                 detectors=None, record_detected: int = 0):
    """Build the simulation function.

    Returns ``sim_fn(labels_flat, media, n_photons, seed, id_offset=0,
    id_offset_hi=0) -> SimResult`` running on ``device`` (``None``:
    CUDA).  ``id_offset`` / ``id_offset_hi`` (the low and high 32-bit
    words of a 64-bit offset) give this run a disjoint global photon-id
    range.  ``cfg.n_time_gates`` widens the energy grid to gate-major
    ``(nvox * ntg,)``.

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
    if mode not in MODES:
        raise ValueError(f"unknown workload mode: {mode}")
    dev = resolve_device(device)
    source = as_source(source)
    detectors = as_detectors(detectors)
    n_det = len(detectors)
    if n_det:
        validate_detectors(detectors, shape)
    det_geom = det_geometry(detectors, dev) if n_det else None
    capacity = int(record_detected)
    if capacity < 0:
        raise ValueError(f"record_detected must be >= 0, got {capacity}")
    record = capacity > 0
    if record and not n_det:
        raise ValueError("record_detected > 0 requires detectors: the id "
                         "buffer records detector captures")
    nx, ny, nz = shape
    nvox, nxy = nx * ny * nz, nx * ny
    K = int(cfg.steps_per_round)
    if K < 1:
        raise ValueError(f"cfg.steps_per_round must be >= 1, got {K}")
    ntg = int(cfg.n_time_gates)
    if ntg < 1:
        raise ValueError(f"cfg.n_time_gates must be >= 1, got {ntg}")
    collect = bool(cfg.collect_stats)
    n_lanes = int(n_lanes)

    def sim_fn(labels_flat, media, n_photons, seed, id_offset=0,
               id_offset_hi=0) -> SimResult:
        labels_flat = labels_flat.to(dev).contiguous()
        media = media.to(device=dev, dtype=torch.float32).contiguous()
        check_labels(labels_flat, media)
        n_media = media.shape[0]
        n_photons = int(n_photons)
        seed = int(seed) & xrng.MASK32

        def word(v):
            return torch.tensor(int(v) & xrng.MASK32, dtype=torch.int64,
                                device=dev)

        id_lo = word(id_offset)
        next_id = (id_lo, word(id_offset_hi))
        # static mode: equal shares, the remainder spread over the first
        # (n_photons mod n_lanes) lanes, so exactly n_photons launch
        lane_idx = torch.arange(n_lanes, dtype=torch.int64, device=dev)
        quota = n_photons // n_lanes + (lane_idx < n_photons % n_lanes).to(
            torch.int64)
        f32 = dict(dtype=torch.float32, device=dev)
        i64 = dict(dtype=torch.int64, device=dev)
        state = ph.PhotonState(
            pos=torch.zeros((n_lanes, 3), **f32),
            dir=torch.tensor([0.0, 0.0, 1.0], **f32).repeat(n_lanes, 1),
            ivox=torch.zeros((n_lanes, 3), dtype=torch.int32, device=dev),
            w=torch.zeros((n_lanes,), **f32),
            s_left=torch.zeros((n_lanes,), **f32),
            t=torch.zeros((n_lanes,), **f32),
            rng=torch.zeros((n_lanes, 4), **i64),
            alive=torch.zeros((n_lanes,), dtype=torch.bool, device=dev),
        )
        # the round totals are updated in place
        energy = torch.zeros((nvox * ntg,), **f32)
        exitance = torch.zeros((nxy,), **f32)
        escaped_w = torch.zeros((), **f32)
        timed_out_w = torch.zeros((), **f32)
        launched_w = torch.zeros((), **f32)
        remaining = torch.tensor(n_photons, **i64)
        launched = torch.zeros((n_lanes,), **i64)
        det_w = torch.zeros((n_det * ntg,), **f32)
        det_ppath = torch.zeros((n_det, n_media), **f32)
        ppath = torch.zeros((n_lanes, n_media), **f32) if n_det else None
        # one write-off row past the capacity takes masked and
        # overflowing record writes
        rec = torch.zeros((capacity + 1 if record else 0, 4), **i64)
        rec_n = torch.zeros((), **i64)
        rec_overflow = torch.zeros((), **i64)
        lane_ids = torch.zeros((n_lanes, 2), **i64) if record else None
        if collect:
            counters = {k: torch.zeros((), **i64)
                        for k in ("regen_rounds", "relaunched")}
            counters.update({k: torch.zeros((), **f32) for k in (
                "live_segments", "deposited_w", "detected_w")})
        steps = rounds = 0

        while steps < cfg.max_steps:
            if mode == "dynamic":
                has_work = state.alive.any() | (remaining > 0)
            else:
                has_work = (state.alive | (launched < quota)).any()
            if not bool(has_work):  # the round's one host read
                break
            prev_lo = next_id[0]
            state, remaining, launched, next_id, w_new, *extra = _regenerate(
                state, remaining, launched, next_id, quota, source, seed,
                mode, shape, ppath, lane_ids)
            if n_det:
                ppath = extra.pop(0)
            if record:
                lane_ids = extra.pop(0)
            outs = photon_steps(labels_flat, media, state, shape, unitinmm,
                                cfg, K, ppath=ppath, det_geom=det_geom,
                                record=record, stats=collect)
            state, flu, exi, esc, timed = outs[:5]
            energy += flu
            exitance += exi
            escaped_w += esc.sum()
            timed_out_w += timed.sum()
            launched_w += w_new
            cur = 5
            if n_det:
                ppath, dw, dp = outs[cur:cur + 3]
                cur += 3
                det_w += dw
                det_ppath += dp
            if record:
                _append_records(rec, rec_n, rec_overflow, lane_ids,
                                outs[cur], outs[cur + 1], capacity)
                cur += 2
            if collect:
                # launches per round stay < 2**31, so the low-word
                # difference is exact across a 2**32 boundary
                rel = (next_id[0] - prev_lo) & xrng.MASK32
                counters["regen_rounds"] += (rel > 0).to(torch.int64)
                counters["relaunched"] += rel
                block = outs[cur]
                counters["live_segments"] += block[:, 0].sum()
                counters["deposited_w"] += block[:, 1].sum()
                if n_det:
                    counters["detected_w"] += dw.sum()
            steps += K
            rounds += 1

        # weight still in flight when the max_steps cap fires is retired
        # deterministically, like the time gate
        capped_w = torch.where(state.alive, state.w,
                               torch.zeros_like(state.w)).sum()
        timed_out_w = timed_out_w + capped_w
        stats = None
        if collect:
            host = {k: v.item() for k, v in counters.items()}
            stats = RoundStats(
                rounds=np.int32(rounds),
                regen_rounds=np.int32(host["regen_rounds"]),
                relaunched=np.int32(host["relaunched"]),
                live_segments=np.float32(host["live_segments"]),
                lane_segments=np.float32(steps * n_lanes),
                deposited_w=np.float32(host["deposited_w"]),
                escaped_w=np.float32(escaped_w.item()),
                timed_out_w=np.float32(timed_out_w.item()),
                detected_w=np.float32(host["detected_w"]))
        energy = (energy.reshape(tuple(shape) + (ntg,)) if ntg > 1
                  else energy.reshape(tuple(shape)))
        return SimResult(
            energy=energy,
            exitance=exitance.reshape(nx, ny),
            escaped_w=escaped_w,
            timed_out_w=timed_out_w,
            # launches per run stay < 2**31, so the low-word difference
            # is the exact count even across a 2**32 boundary
            n_launched=(next_id[0] - id_lo) & xrng.MASK32,
            launched_w=launched_w,
            steps=steps,
            det_w=det_w.reshape(n_det, ntg),
            det_ppath=det_ppath,
            det_rec=rec[:capacity],
            det_rec_n=rec_n,
            det_rec_overflow=rec_overflow,
            stats=stats,
        )

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
    the detected-photon record buffer for replay.
    """
    sim_fn = make_simulator(volume, cfg, n_lanes, mode, source, device,
                            detectors, record_detected)
    return sim_fn(volume.labels.reshape(-1), volume.media, n_photons, seed)
