"""Detected-photon replay: exact re-simulation and absorption Jacobians.

The counter-seeded RNG makes every photon's trajectory a function of
``(seed, photon_id)`` alone, and the port computes each step with one
strict IEEE float32 code path (the CUDA kernel, the host kernel and
their plain version agree bit for bit).  The record buffer of a forward run
(``SimResult.det_rec``) says which photon ids reached each detector.
Together they give the absorption sensitivity (Jacobian) of each
detector reading, what image reconstruction consumes.

For a detected packet exiting with weight ``w`` after ``L_v`` mm in
voxel ``v`` (exact Beer-Lambert deposition),
``w = w0 * exp(-sum_v mua_v * L_v)``, so ``dw/dmua_v = -w * L_v``.
:func:`replay_jacobian` relaunches exactly the recorded ids in two
lock-step passes through ``ops.photon_steps`` (the CUDA kernel on the
card, the host kernel on the CPU):

  pass A  re-runs the trajectories with detectors and capture records
          on, and reads off each packet's exit weight, detector and
          exit gate;
  pass B  re-runs them again and adds ``w_exit * seg_len`` of every
          segment into the Jacobian column of the packet's recorded
          detector (with ``gate_resolved=True``, detector and exit
          gate).

Both passes see the trajectories of the forward run bit for bit, so
every record comes back at its detector and gate, and the Jacobian's
per-medium sums equal the forward run's ``det_ppath`` up to the
rounding of each deposit (``analysis.jacobian_medium_sums``).

The replay never relaunches a lane: a lane is one record, and its
trajectory does not depend on how its segments are cut into launches.
So each pass runs in a few launches of up to ``spec.MAX_STEPS``
segments, with one host read of the lanes' liveness between two, and
stops where the reference's loop of rounds of ``cfg.steps_per_round``
stops: once every lane is dead, or at ``cfg.max_steps`` rounded up to a
whole round.  Every output is then the same bits as a replay in rounds.
The Jacobian is int64 fixed point (``spec.FIXED_SHIFT["jac"]``), so its
sums do not depend on their order: each launch of pass B adds into one
Jacobian total that stays on the device for the whole replay, and its
cells the replay reached cross to the host once, as float64.  The
fluence, exitance and detector sums the launches also make, which the
replay does not read, go into scratch grids zeroed once a replay.
Over a mesh of devices each batch splits across them, each device
adding into its own Jacobian total in its device's process
(``core.multidevice.sharded_replay_fn``); the totals add to the bits
of one device's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import photon as ph
from repro_torch.core import rng as xrng
from repro_torch.core.simulator import SimResult
from repro_torch.core.volume import SimConfig, Volume
from repro_torch.core.fixed import from_fixed
from repro_torch.detectors import as_detectors, validate_detectors
from repro_torch.kernels.photon_step import spec
from repro_torch.kernels.photon_step.ops import photon_steps, resolve_device
from repro_torch.sources import as_source


class ReplayResult(NamedTuple):
    """Output of :func:`replay_jacobian`."""

    jacobian: np.ndarray   # (nx, ny, nz, n_det) float64, or
    #                        (nx, ny, nz, n_det, ntg) with
    #                        gate_resolved=True: J[v, d(, g)] = sum over
    #                        the detector-d records of w_exit * L_v
    #                        (weight * mm); dW_d = -J[., d] . dmua
    w_exit: np.ndarray     # (n_records,) float32 replayed exit weight
    det: np.ndarray        # (n_records,) int32 detector of the record
    gate: np.ndarray       # (n_records,) int32 replayed exit gate (-1:
    #                        the replayed photon hit no detector)
    replayed_det: np.ndarray  # (n_records,) int32 detector of the
    #                        replayed exit (-1: none); equals ``det`` when
    #                        volume, cfg, source and seed match the
    #                        forward run
    n_records: int


def detected_records(result: SimResult) -> np.ndarray:
    """The valid records of a forward run as an ``(n, 4)`` uint32 array
    of ``[id_lo, id_hi, det, gate]`` rows, the reference's format.

    Takes a one-device result (a scalar ``det_rec_n``) and a sharded one
    (``core.multidevice.simulate_sharded``), whose ``det_rec`` is the
    concatenation of every shard's fixed-capacity buffer with the
    shards' valid counts in the rank-1 ``det_rec_n``.
    """
    rec = result.det_rec
    rec = (rec.cpu().numpy() if isinstance(rec, torch.Tensor)
           else np.asarray(rec)).reshape(-1, 4)
    n = result.det_rec_n
    n = n.cpu().numpy() if isinstance(n, torch.Tensor) else np.asarray(n)
    if n.ndim == 0:
        return rec[: int(n)].astype(np.uint32)
    n_shards = n.shape[0]
    if n_shards == 0 or rec.shape[0] % n_shards:
        raise ValueError(
            f"sharded det_rec of {rec.shape[0]} rows does not split over "
            f"{n_shards} shards")
    cap = rec.shape[0] // n_shards
    parts = [rec[i * cap: i * cap + int(k)] for i, k in enumerate(n)]
    return np.concatenate(parts, axis=0).astype(np.uint32)


def _build_replay_fn(shape, unitinmm, cfg: SimConfig, n_lanes: int,
                     source, det_geom, jac_cols: int, step=None,
                     steps_per_launch=None):
    """Two-pass replay of one batch of ``n_lanes`` records, each pass in
    launches of up to ``steps_per_launch`` segments (default
    ``spec.MAX_STEPS``), each launch one call of ``step``
    (``ops.photon_steps``'s arguments; by default this module's
    ``photon_steps``, looked up when the replay is built).

    Returns ``fn(labels_flat, media, id_lo, id_hi, jac_col, active,
    seed, jac, scratch) -> (w_exit, gate, replayed_det)``.  ``id_lo`` /
    ``id_hi`` are int64 id words, ``jac_col`` the int32 Jacobian column
    of each lane and ``active`` masks padding lanes, which launch with
    zero weight and add exactly nothing.  ``jac`` is the caller's
    ``(nvox * jac_cols,)`` int64 Jacobian total, which pass B adds into;
    ``scratch`` the int64 fluence, exitance, TPSF and path-sum grids
    (``ops.photon_steps``'s ``totals`` of pass A) the other sums go
    into.  Tensors live on ``det_geom``'s device.
    """
    source = as_source(source)
    step = photon_steps if step is None else step
    K = int(cfg.steps_per_round)
    if K < 1:
        raise ValueError(f"cfg.steps_per_round must be >= 1, got {K}")
    # the reference's loop runs rounds of K while steps < max_steps
    cap = -(-int(cfg.max_steps) // K) * K
    L = spec.MAX_STEPS if steps_per_launch is None else int(steps_per_launch)
    if not 1 <= L <= spec.MAX_STEPS:
        raise ValueError(f"steps_per_launch must be in [1, "
                         f"{spec.MAX_STEPS}], got {L}")

    def fn(labels_flat, media, id_lo, id_hi, jac_col, active, seed, jac,
           scratch):
        dev = id_lo.device
        n_media = media.shape[0]
        pos, direc, w0, rng = source.sample(xrng.PhotonId(id_lo, id_hi),
                                            int(seed) & xrng.MASK32)

        def launches(**groups):
            """Launches from the launch of the lanes until every lane is
            dead or the step cap is reached; yields each launch's
            outputs (one host read a launch)."""
            state = ph.launch(pos, direc, w0, rng, active, shape)
            steps = 0
            while steps < cap and bool(state.alive.any()):
                n = min(L, cap - steps)
                outs = step(labels_flat, media, state, shape, unitinmm,
                            cfg, n, **groups)
                yield outs
                state = outs[0]
                if "ppath" in groups:
                    groups["ppath"] = outs[5]
                steps += n

        # -- pass A: exit weight, gate and detector of each lane --------
        # (a lane escapes once, so one launch adds its exit weight)
        w_exit = torch.zeros((n_lanes,), dtype=torch.float32, device=dev)
        rdet = torch.full((n_lanes,), -1, dtype=torch.int32, device=dev)
        gate = torch.full((n_lanes,), -1, dtype=torch.int32, device=dev)
        ppath = torch.zeros((n_lanes, n_media), dtype=torch.float32,
                            device=dev)
        for outs in launches(ppath=ppath, det_geom=det_geom, record=True,
                             totals=scratch):
            w_exit = w_exit + outs[3]
            capd, capg = outs[8], outs[9]
            rdet = torch.where(capd >= 0, capd, rdet)
            gate = torch.where(capd >= 0, capg, gate)

        # -- pass B: w_exit * seg_len into J[., jac_col] ----------------
        # the same trajectories again, so the exit weight is known from
        # the first segment on
        wscale = torch.where(active, w_exit, torch.zeros_like(w_exit))
        for _ in launches(jac_w=wscale, jac_col=jac_col, jac_cols=jac_cols,
                          totals=[*scratch[:2], jac]):
            pass
        return w_exit, gate, rdet

    return fn


def _batch_arrays(records, start, n_lanes, gate_resolved, ntg):
    """Pad one record batch to ``n_lanes`` lanes; padding lanes carry
    id (0, 0) with ``active=False`` (their launch weight is zero, so
    they transport nothing, even when a real record has id 0)."""
    batch = records[start: start + n_lanes]
    nb = batch.shape[0]
    pad = n_lanes - nb
    id_lo = np.concatenate([batch[:, 0], np.zeros(pad, np.uint32)])
    id_hi = np.concatenate([batch[:, 1], np.zeros(pad, np.uint32)])
    det = batch[:, 2].astype(np.int32)
    col = det * ntg + batch[:, 3].astype(np.int32) if gate_resolved else det
    col = np.concatenate([col, np.zeros(pad, np.int32)]).astype(np.int32)
    active = np.concatenate([np.ones(nb, bool), np.zeros(pad, bool)])
    return nb, id_lo, id_hi, col, active


def replay_jacobian(volume: Volume, cfg: SimConfig, records, detectors,
                    source=None, seed: int = 1234, n_lanes: int = 4096,
                    gate_resolved: bool = False, device=None, mesh=None,
                    tracer=None) -> ReplayResult:
    """Replay detected-photon records into per-detector absorption
    Jacobian volumes, on ``device`` (``None``: the CUDA device).

    ``records`` is the ``(n, 4)`` uint32 ``[id_lo, id_hi, det, gate]``
    array of :func:`detected_records` (or a forward ``SimResult``).
    ``volume`` / ``cfg`` / ``detectors`` / ``source`` / ``seed`` must be
    the forward run's; every replayed trajectory is then the forward
    one, which ``ReplayResult.replayed_det`` / ``gate`` let callers
    check.  ``gate_resolved=True`` widens the scatter to
    ``(nvox, n_det, ntg)`` keyed by each record's exit gate; its
    gate-sum is the ungated Jacobian.  Records run in batches of
    ``n_lanes`` lanes, each pass of a batch in launches of up to
    ``spec.MAX_STEPS`` segments.  The Jacobian is summed on the
    device in int64 fixed point; the cells the replay reached are
    converted to float64 and copied to the host once.  A cell past the
    fixed-point range raises ``OverflowError``.

    ``mesh`` (a sequence of devices, in place of ``device``) splits each
    batch over its devices, ``n_lanes`` lanes a device (at most
    ``ceil(n_records / len(mesh))``), each in its device's process
    adding into its own int64 Jacobian, and adds those once at the end
    (``core.multidevice.sharded_replay_fn``): the result has the bits of
    the replay on one device of the same type.  ``tracer`` (a
    ``repro_torch.telemetry.Tracer``) records one ``replay_batch`` span
    per batch, tagged with its record count and ended after a device
    synchronisation (device ``"mesh"`` with a mesh).
    """
    from repro_torch.core.multidevice import mesh_devices, sharded_replay_fn

    if mesh is not None and device is not None:
        raise ValueError("pass either device or mesh, not both")
    if isinstance(records, SimResult):
        records = detected_records(records)
    records = np.asarray(records, np.uint32).reshape(-1, 4)
    detectors = as_detectors(detectors)
    n_det = len(detectors)
    if n_det == 0:
        raise ValueError("replay_jacobian needs the forward run's "
                         "detectors")
    validate_detectors(detectors, volume.shape)
    if records.shape[0] and int(records[:, 2].max()) >= n_det:
        raise ValueError(
            f"record refers to detector {int(records[:, 2].max())} but "
            f"only {n_det} detectors were given; records and detectors "
            f"must come from the same forward run")
    ntg = int(cfg.n_time_gates)
    if gate_resolved and records.shape[0] and \
            int(records[:, 3].max()) >= ntg:
        raise ValueError(
            f"record refers to time gate {int(records[:, 3].max())} but "
            f"cfg.n_time_gates={ntg}; gate-resolved replay needs the "
            f"forward run's gate count")
    devices = (mesh_devices(mesh) if mesh is not None
               else [resolve_device(device)])
    jac_cols = n_det * ntg if gate_resolved else n_det
    n_rec = records.shape[0]
    nx, ny, nz = volume.shape
    n_shards = len(devices)
    n_lanes = max(1, min(int(n_lanes), -(-max(n_rec, 1) // n_shards)))
    run_batch, jacobian = sharded_replay_fn(
        volume, cfg, detectors, devices, n_lanes, source, gate_resolved)
    batch_lanes = n_shards * n_lanes
    trace_dev = "mesh" if mesh is not None else devices[0]
    engine = "kernel" if devices[0].type == "cuda" else "plain"

    w_exit = np.zeros((n_rec,), np.float32)
    gate = np.full((n_rec,), -1, np.int32)
    rdet = np.full((n_rec,), -1, np.int32)
    for start in range(0, n_rec, batch_lanes):
        nb, id_lo, id_hi, col, active = _batch_arrays(
            records, start, batch_lanes, gate_resolved, ntg)
        span = None
        if tracer is not None:
            span = tracer.span("replay_batch", device=trace_dev,
                               engine=engine, records=nb, batch_start=start)
        w_b, g_b, rd_b = run_batch(id_lo, id_hi, col, active, seed)
        if span is not None:
            span.end()
        w_exit[start: start + nb] = w_b[:nb]
        gate[start: start + nb] = g_b[:nb]
        rdet[start: start + nb] = rd_b[:nb]

    jac = jacobian()
    if bool((jac < 0).any()):
        raise OverflowError("a replay Jacobian cell passed 2**63 - 1 units")
    # the cells the replay reached (a few percent of the grid), as
    # float64, in one copy to the host
    reached = torch.nonzero(jac).squeeze(1)
    jacobian_h = np.zeros((nx * ny * nz * jac_cols,), np.float64)  # reprolint: disable=REP301 - the Jacobian is float64 where it is handed over
    jacobian_h[reached.cpu().numpy()] = from_fixed(
        jac[reached], spec.FIXED_SHIFT["jac"], torch.float64).cpu().numpy()  # reprolint: disable=REP301 - the Jacobian is float64 where it is handed over
    shape_out = ((nx, ny, nz, n_det, ntg) if gate_resolved
                 else (nx, ny, nz, n_det))
    return ReplayResult(
        jacobian=jacobian_h.reshape(shape_out),
        w_exit=w_exit,
        det=records[:, 2].astype(np.int32),
        gate=gate,
        replayed_det=rdet,
        n_records=n_rec,
    )
