"""The plain reference run: photons by id, to their end, in fixed point.

A photon's path depends only on ``(seed, global id)``: every segment
draws from the photon's own stream, and each deposit is rounded once to
a whole number of fixed-point units before it is added, so integer sums
of the deposits do not depend on which lane, round or launch carried
them.  The reference uses that to run fast where the port runs in
rounds of K segments over a fixed set of lanes: it keeps a batch of
photons, steps all of them (a dead lane adds exactly nothing), and every
``COMPACT_EVERY`` segments drops the dead ones and fills the batch from
the next ids.  Its totals, detector sums, records and Jacobian are then
the port's, bit for bit, whatever the port's lanes and K.  Several
scenarios (one volume, each its own source and id range) share one
batch, each with its own grids.

The fixed-point units are those of the port's output contract as of the
benchmark's first version (``repro_torch/kernels/photon_step/spec.py``):
grids in ``2**-36`` units (``2**-28`` for the path sums), the run totals
in ``2**-24`` units, each value rounded to nearest, ties to even.

``control=True`` computes in bfloat16 every value handed to a
fixed-point sum or a record (deposits, exit weights, the time that
picks a deposit's or a capture's gate); the trajectories stay float32,
so that every photon still ends.  It is the precision below the
configuration's, which the comparison has to reject.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from perfbench.reference import rng as xrng
from perfbench.reference import sources
from perfbench.reference.step import (Physics, State, exitance_bins, launch,
                                      step, time_gate_bins)

SHIFT = {"fluence": 36, "exitance": 36, "det_w": 36, "det_ppath": 28,
         "jac": 36}
TOTAL_SHIFT = 24
# photons stepped together, and segments between two compactions
BATCH = 1 << 21
COMPACT_EVERY = 8
# once every photon is launched and at most TAIL live, the batch runs to
# its end in GRAPH_STEPS segments at a time, shrinking as its photons die
# (to no fewer than GRAPH_MIN_LANES lanes)
TAIL = 1 << 16
GRAPH_STEPS = 16
GRAPH_MIN_LANES = 1024


def to_fixed(v: torch.Tensor, shift: int) -> torch.Tensor:
    return torch.round(v * float(2**shift)).to(torch.int64)


def _quantize(control: bool):
    if not control:
        return lambda v: v
    return lambda v: v.to(torch.bfloat16).to(torch.float32)


def detector_bins(esc_pos, esc_w, geom):
    """First detector disk holding each z=0-face exit, and its weight
    (0 for lanes that missed every disk)."""
    z_exit = esc_pos[:, 2] < 0.25
    dx = esc_pos[:, None, 0] - geom[None, :, 0]
    dy = esc_pos[:, None, 1] - geom[None, :, 1]
    inside = (dx * dx + dy * dy) <= geom[None, :, 2]
    hit = inside.any(dim=1) & z_exit & (esc_w > 0)
    didx = torch.argmax(inside.to(torch.uint8), dim=1)
    return didx, torch.where(hit, esc_w, torch.zeros_like(esc_w))


class Forward(NamedTuple):
    """A forward run's int64 outputs (on its device) and records."""

    fluence: torch.Tensor     # (nvox * ntg,) gate-major within a voxel
    exitance: torch.Tensor    # (nx * ny,)
    escaped: int
    timed_out: int
    launched_w: int
    n_launched: int
    live_segments: int
    det_w: torch.Tensor       # (n_det * ntg,)
    det_ppath: torch.Tensor   # (n_det, n_media)
    records: torch.Tensor     # (n_rec, 4) int64 [id_lo, id_hi, det, gate]
    w_exit: torch.Tensor      # (n_rec,) float32 exit weight of each record


class _Lanes(NamedTuple):
    """The batch: photon state and what each lane carries besides."""

    state: State
    sc: torch.Tensor        # scenario of the lane
    ids: torch.Tensor       # (n, 2) [id_lo, id_hi]
    ppath: torch.Tensor     # (n, n_media) path by medium, mm
    cap: torch.Tensor       # (n, 2) [det, gate] of the capture, det -1: none
    cap_w: torch.Tensor     # (n,) exit weight of the capture


class _Replayed(NamedTuple):
    """A replay batch: photon state, each lane's weight and column."""

    state: State
    jw: torch.Tensor
    col: torch.Tensor


def _tensors(carry) -> list:
    out = []
    for x in carry:
        out.extend(_tensors(x) if isinstance(x, tuple) else [x])
    return out


def _rebuild(like, it):
    return type(like)(*(_rebuild(x, it) if isinstance(x, tuple) else next(it)
                        for x in like))


def _select(carry, keep):
    return _rebuild(carry, iter([x.index_select(0, keep)
                                 for x in _tensors(carry)]))


def _cat(a, b):
    return _rebuild(a, iter([torch.cat([x, y]) for x, y in
                             zip(_tensors(a), _tensors(b))]))


def _assign(dst, src) -> None:
    """Write ``src``'s tensors into ``dst``'s, in place."""
    for d, s in zip(_tensors(dst), _tensors(src)):
        d.copy_(s)


def _to_end(carry, advance, harvest):
    """Advance ``carry`` until every lane is dead.

    ``advance(carry, n)`` runs ``n`` segments in place; a dead lane adds
    exactly nothing.  Every ``GRAPH_STEPS`` segments one host read asks
    whether a lane is alive, and once at most an eighth of the lanes
    are, the dead ones are handed to ``harvest`` and dropped.  On the
    card the ``GRAPH_STEPS`` segments of a batch are replayed as one
    CUDA graph of the same operations: few photons live long, and their
    segments would otherwise cost one host dispatch an operation."""
    while True:
        n = carry.state.w.shape[0]
        run = lambda: advance(carry, GRAPH_STEPS)  # noqa: E731
        if carry.state.w.is_cuda:
            run()   # the first segments eagerly, then the graph
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                advance(carry, GRAPH_STEPS)
            run = graph.replay
        while True:
            live = int(carry.state.alive.sum())
            if live == 0 or (live <= n // 8 and n > GRAPH_MIN_LANES):
                break
            run()
        dead = torch.nonzero(~carry.state.alive).squeeze(1)
        harvest(carry, dead)
        if live == 0:
            return
        carry = _select(carry, torch.nonzero(carry.state.alive).squeeze(1))


def forward_many(labels_flat, media, shape, unitinmm, phys: Physics,
                 scenario_sources: list, seed: int, first_ids: list,
                 n_photons: int, det_geom=None, record: bool = False,
                 control: bool = False) -> list:
    """Run the photons ``first_ids[s] .. first_ids[s] + n_photons - 1``
    of each scenario ``s`` (source ``scenario_sources[s]``) to their
    end; returns a :class:`Forward` a scenario.

    ``labels_flat`` ``(nvox,)`` uint8 and ``media`` ``(n_media, 4)``
    float32 on the device; ``det_geom`` ``(n_det, 3)`` float32 rows of
    ``(x, y, r**2)`` or None; ``record`` keeps each capture's id,
    detector, gate and exit weight."""
    dev = media.device
    nx, ny, nz = shape
    S = len(scenario_sources)
    ntg = int(phys.n_time_gates)
    n_media = media.shape[0]
    n_det = 0 if det_geom is None else det_geom.shape[0]
    nflu, nxy = nx * ny * nz * ntg, nx * ny
    q = _quantize(control)
    i64 = dict(dtype=torch.int64, device=dev)
    fluence = torch.zeros((S * nflu,), **i64)
    exitance = torch.zeros((S * nxy,), **i64)
    det_w = torch.zeros((S * n_det * ntg,), **i64)
    det_ppath = torch.zeros((S * n_det, n_media), **i64)
    # escaped, timed out, launched weight, live segments, a scenario
    sums = torch.zeros((4, S), **i64)
    med_cols = torch.arange(n_media, device=dev)[None, :]
    rec_rows, rec_w, rec_sc = [], [], []
    done = [0] * S

    def advance(lanes: _Lanes, n: int) -> None:
        for _ in range(n):
            st, sc = lanes.state, lanes.sc
            sums[3].index_add_(0, sc, st.alive.to(torch.int64))
            seg = step(st, labels_flat, media, shape, unitinmm, phys)
            gate = time_gate_bins(q(seg.dep_t), phys.tmax_ns, ntg)
            fluence.index_add_(0, sc * nflu + seg.dep_idx * ntg + gate,
                               to_fixed(q(seg.dep_w), SHIFT["fluence"]))
            xy, xw = exitance_bins(seg.esc_pos, seg.esc_w, shape)
            exitance.index_add_(0, sc * nxy + xy,
                                to_fixed(q(xw), SHIFT["exitance"]))
            sums[0].index_add_(0, sc, to_fixed(q(seg.esc_w), TOTAL_SHIFT))
            sums[1].index_add_(0, sc, to_fixed(q(seg.timed_w), TOTAL_SHIFT))
            ppath, cap, cap_w = lanes.ppath, lanes.cap, lanes.cap_w
            if n_det:
                ppath = ppath + torch.where(seg.seg_med[:, None] == med_cols,
                                            seg.seg_len[:, None],
                                            torch.zeros_like(ppath))
                didx, dwgt = detector_bins(seg.esc_pos, seg.esc_w, det_geom)
                det_w.index_add_(0, (sc * n_det + didx) * ntg + gate,
                                 to_fixed(q(dwgt), SHIFT["det_w"]))
                det_ppath.index_add_(0, sc * n_det + didx,
                                     to_fixed(q(dwgt[:, None] * ppath),
                                              SHIFT["det_ppath"]))
                if record:
                    # a lane captures once: its photon leaves at capture
                    newly = (dwgt > 0)[:, None]
                    cap = torch.where(newly, torch.stack([didx, gate], 1),
                                      cap)
                    cap_w = torch.where(newly[:, 0], q(seg.esc_w), cap_w)
            _assign(lanes, _Lanes(seg.state, sc, lanes.ids, ppath, cap,
                                  cap_w))

    def harvest(lanes: _Lanes, dead) -> None:
        at = dead[lanes.cap[dead, 0] >= 0]
        if record and at.numel():
            rec_rows.append(torch.cat([lanes.ids[at], lanes.cap[at]], 1))
            rec_w.append(lanes.cap_w[at])
            rec_sc.append(lanes.sc[at])

    def fill(lanes):
        free = BATCH - (0 if lanes is None else lanes.sc.shape[0])
        for s in range(S):
            k = min(free, n_photons - done[s])
            if k <= 0:
                continue
            lo, hi = xrng.id_words(first_ids[s] + done[s], k, dev)
            pos, direc, w0, rng = sources.sample(scenario_sources[s], seed,
                                                 lo, hi)
            sums[2, s] += to_fixed(q(w0), TOTAL_SHIFT).sum()
            fresh = _Lanes(
                launch(pos, direc, w0, rng, shape),
                torch.full((k,), s, **i64), torch.stack([lo, hi], 1),
                torch.zeros((k, n_media), dtype=torch.float32, device=dev),
                torch.full((k, 2), -1, **i64),
                torch.zeros((k,), dtype=torch.float32, device=dev))
            lanes = fresh if lanes is None else _cat(lanes, fresh)
            done[s] += k
            free -= k
        return lanes

    lanes = fill(None)
    while lanes is not None:
        if all(d == n_photons for d in done) and lanes.sc.shape[0] <= TAIL:
            _to_end(lanes, advance, harvest)
            break
        advance(lanes, COMPACT_EVERY)
        alive = lanes.state.alive
        harvest(lanes, torch.nonzero(~alive).squeeze(1))
        lanes = fill(_select(lanes, torch.nonzero(alive).squeeze(1)))
    rows = torch.cat(rec_rows) if rec_rows else torch.zeros((0, 4), **i64)
    ws = (torch.cat(rec_w) if rec_w
          else torch.zeros((0,), dtype=torch.float32, device=dev))
    rsc = torch.cat(rec_sc) if rec_sc else torch.zeros((0,), **i64)
    totals = sums.tolist()
    out = []
    for s in range(S):
        mine = torch.nonzero(rsc == s).squeeze(1)
        out.append(Forward(
            fluence[s * nflu:(s + 1) * nflu], exitance[s * nxy:(s + 1) * nxy],
            totals[0][s], totals[1][s], totals[2][s], int(n_photons),
            totals[3][s], det_w[s * n_det * ntg:(s + 1) * n_det * ntg],
            det_ppath[s * n_det:(s + 1) * n_det], rows[mine], ws[mine]))
    return out


def forward(labels_flat, media, shape, unitinmm, phys: Physics,
            source: dict, seed: int, first_id: int, n_photons: int,
            det_geom=None, record: bool = False,
            control: bool = False) -> Forward:
    """:func:`forward_many` of one scenario."""
    return forward_many(labels_flat, media, shape, unitinmm, phys, [source],
                        seed, [first_id], n_photons, det_geom, record,
                        control)[0]


def replay_jacobian(labels_flat, media, shape, unitinmm, phys: Physics,
                    source: dict, seed: int, records: torch.Tensor,
                    w_exit: torch.Tensor, jac_cols: int,
                    gate_resolved: bool,
                    control: bool = False) -> torch.Tensor:
    """The int64 ``(nvox * jac_cols,)`` Jacobian of detected photons:
    each record's photon run again, ``w_exit * seg_len`` of every
    segment added at the column of its detector (and exit gate)."""
    dev = media.device
    nx, ny, nz = shape
    ntg = int(phys.n_time_gates)
    q = _quantize(control)
    jac = torch.zeros((nx * ny * nz * jac_cols,), dtype=torch.int64,
                      device=dev)
    col_all = (records[:, 2] * ntg + records[:, 3] if gate_resolved
               else records[:, 2])

    def advance(carry: _Replayed, n: int) -> None:
        for _ in range(n):
            seg = step(carry.state, labels_flat, media, shape, unitinmm, phys)
            jac.index_add_(0, seg.dep_idx * jac_cols + carry.col,
                           to_fixed(q(carry.jw * seg.seg_len), SHIFT["jac"]))
            _assign(carry.state, seg.state)

    for start in range(0, records.shape[0], BATCH):
        part = slice(start, start + BATCH)
        lo, hi = records[part, 0], records[part, 1]
        pos, direc, w0, rng = sources.sample(source, seed, lo, hi)
        _to_end(_Replayed(launch(pos, direc, w0, rng, shape), w_exit[part],
                          col_all[part]), advance, lambda c, dead: None)
    return jac
