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

Regeneration runs every round, also when no lane relaunches: an
all-False relaunch mask leaves every value as it was, and skipping it
would need a host read.  The one host read per round is the loop
condition.  Photon ids are 64-bit, carried as (lo, hi) 32-bit words
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
from repro_torch.kernels.photon_step.ops import photon_steps, resolve_device
from repro_torch.sources import PhotonSource, as_source

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
    # -- detector / record / stats fields of the reference; they keep
    #    their empty defaults until those parts are ported --
    det_w: np.ndarray = np.zeros((0, 1), np.float32)
    det_ppath: np.ndarray = np.zeros((0, 0), np.float32)
    det_rec: np.ndarray = np.zeros((0, 4), np.uint32)
    det_rec_n: np.ndarray = np.int32(0)
    det_rec_overflow: np.ndarray = np.int32(0)
    stats: None = None


def _regenerate(state, remaining, launched_per_lane, next_id, quota,
                source, seed, mode, shape):
    """Relaunch photons in dead lanes according to the workload mode.

    ``next_id`` is the 64-bit global photon id counter as a ``(lo, hi)``
    pair of 0-d int64 word tensors; it is returned advanced.  Returns
    ``(state, remaining, launched_per_lane, next_id, launched_weight)``.
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
    pos, direc, w0, rng = source.sample(xrng.add_id(*next_id, rank), seed)
    fresh = ph.launch(pos, direc, w0, rng, relaunch, shape)
    merged = ph.PhotonState(*(
        torch.where(relaunch[:, None] if new.ndim > 1 else relaunch, new, old)
        for new, old in zip(fresh, state)))
    merged = merged._replace(alive=state.alive | relaunch)
    w_new = torch.where(relaunch, w0, torch.zeros_like(w0)).sum()
    return (merged, remaining - n_relaunch, launched_per_lane + rel,
            tuple(xrng.add_id(*next_id, n_relaunch)), w_new)


def check_labels(labels_flat, media) -> None:
    """Every label must index a row of the media table (one host read)."""
    top = int(labels_flat.max()) if labels_flat.numel() else 0
    if top >= media.shape[0]:
        raise ValueError(f"label {top} has no row in the {media.shape[0]}-row "
                         f"media table")


def build_sim_fn(shape: tuple[int, int, int], unitinmm: float,
                 cfg: SimConfig, n_lanes: int, mode: str = "dynamic",
                 source: PhotonSource | None = None, device=None):
    """Build the simulation function.

    Returns ``sim_fn(labels_flat, media, n_photons, seed, id_offset=0,
    id_offset_hi=0) -> SimResult`` running on ``device`` (``None``:
    CUDA).  ``id_offset`` / ``id_offset_hi`` (the low and high 32-bit
    words of a 64-bit offset) give this run a disjoint global photon-id
    range.  ``cfg.n_time_gates`` widens the energy grid to gate-major
    ``(nvox * ntg,)``.
    """
    if mode not in MODES:
        raise ValueError(f"unknown workload mode: {mode}")
    if cfg.collect_stats:
        raise NotImplementedError("cfg.collect_stats (round counters) is "
                                  "not ported yet")
    dev = resolve_device(device)
    source = as_source(source)
    nx, ny, nz = shape
    nvox, nxy = nx * ny * nz, nx * ny
    K = int(cfg.steps_per_round)
    if K < 1:
        raise ValueError(f"cfg.steps_per_round must be >= 1, got {K}")
    ntg = int(cfg.n_time_gates)
    if ntg < 1:
        raise ValueError(f"cfg.n_time_gates must be >= 1, got {ntg}")
    n_lanes = int(n_lanes)

    def sim_fn(labels_flat, media, n_photons, seed, id_offset=0,
               id_offset_hi=0) -> SimResult:
        labels_flat = labels_flat.to(dev).contiguous()
        media = media.to(device=dev, dtype=torch.float32).contiguous()
        check_labels(labels_flat, media)
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
        state = ph.PhotonState(
            pos=torch.zeros((n_lanes, 3), **f32),
            dir=torch.tensor([0.0, 0.0, 1.0], **f32).repeat(n_lanes, 1),
            ivox=torch.zeros((n_lanes, 3), dtype=torch.int32, device=dev),
            w=torch.zeros((n_lanes,), **f32),
            s_left=torch.zeros((n_lanes,), **f32),
            t=torch.zeros((n_lanes,), **f32),
            rng=torch.zeros((n_lanes, 4), dtype=torch.int64, device=dev),
            alive=torch.zeros((n_lanes,), dtype=torch.bool, device=dev),
        )
        # the round totals are updated in place
        energy = torch.zeros((nvox * ntg,), **f32)
        exitance = torch.zeros((nxy,), **f32)
        escaped_w = torch.zeros((), **f32)
        timed_out_w = torch.zeros((), **f32)
        launched_w = torch.zeros((), **f32)
        remaining = torch.tensor(n_photons, dtype=torch.int64, device=dev)
        launched = torch.zeros((n_lanes,), dtype=torch.int64, device=dev)
        steps = 0

        while steps < cfg.max_steps:
            if mode == "dynamic":
                has_work = state.alive.any() | (remaining > 0)
            else:
                has_work = (state.alive | (launched < quota)).any()
            if not bool(has_work):  # the round's one host read
                break
            state, remaining, launched, next_id, w_new = _regenerate(
                state, remaining, launched, next_id, quota, source, seed,
                mode, shape)
            state, flu, exi, esc, timed = photon_steps(
                labels_flat, media, state, shape, unitinmm, cfg, K)
            energy += flu
            exitance += exi
            escaped_w += esc.sum()
            timed_out_w += timed.sum()
            launched_w += w_new
            steps += K

        # weight still in flight when the max_steps cap fires is retired
        # deterministically, like the time gate
        capped_w = torch.where(state.alive, state.w,
                               torch.zeros_like(state.w)).sum()
        energy = (energy.reshape(tuple(shape) + (ntg,)) if ntg > 1
                  else energy.reshape(tuple(shape)))
        return SimResult(
            energy=energy,
            exitance=exitance.reshape(nx, ny),
            escaped_w=escaped_w,
            timed_out_w=timed_out_w + capped_w,
            # launches per run stay < 2**31, so the low-word difference
            # is the exact count even across a 2**32 boundary
            n_launched=(next_id[0] - id_lo) & xrng.MASK32,
            launched_w=launched_w,
            steps=steps,
        )

    return sim_fn


def make_simulator(volume: Volume, cfg: SimConfig, n_lanes: int,
                   mode: str = "dynamic", source=None, device=None):
    """Simulation function for a fixed (volume shape, cfg, lanes, mode,
    source, device); call it with the volume's labels and media."""
    return build_sim_fn(volume.shape, volume.unitinmm, cfg, n_lanes, mode,
                        source, device)


def simulate(volume: Volume, cfg: SimConfig, n_photons: int,
             n_lanes: int = 4096, seed: int = 1234, source=None,
             mode: str = "dynamic", device=None) -> SimResult:
    """One-shot simulation on ``device`` (``None``: the CUDA device; a
    machine without one raises unless ``device="cpu"``).

    ``source`` accepts any registered source (repro_torch.sources), the
    legacy pencil :class:`Source`, or a ``sources.to_dict``-style dict;
    ``None`` is the paper's pencil beam.
    """
    sim_fn = make_simulator(volume, cfg, n_lanes, mode, source, device)
    return sim_fn(volume.labels.reshape(-1), volume.media, n_photons, seed)
