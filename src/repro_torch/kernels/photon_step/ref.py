"""Plain PyTorch version of the photon-step kernel.

Runs ``n_steps`` lock-step iterations of ``photon.step`` over all lanes,
accumulating deposition into a gate-major ``(nvox * ntg,)`` fluence
grid, z=0-face exits into a flat ``(nx * ny,)`` exitance image, and
escaped / timed-out weight per lane, and, as the flags ask, the
optional output groups: detector capture, capture records, the replay
Jacobian and the stats block.  It is the computation of the CUDA kernel
in ``csrc/photon_step.cu``, one PyTorch operation at a time.  The
dispatcher (``ops.photon_steps``) runs it for CPU tensors, and
``chip_smoke.py`` holds the kernel against it on the card.

Fluence, exitance, TPSF, detector path sums and the replay Jacobian
are int64 fixed point (``core/fixed.py``): each deposit is rounded once
to a whole number of units, as the kernel rounds it, and integer sums do
not depend on their order, so the kernel's grids equal these bit for
bit.

Once every lane is dead the loop stops: a dead lane only draws its 5
uniforms a segment, so each lane's RNG state is moved past the draws of
the remaining segments at once (``rng.skip``), as the kernel's dead
warps draw them before they leave.
"""

from __future__ import annotations

import torch

from repro_torch.core import photon as ph
from repro_torch.core import rng as xrng
from repro_torch.core.fixed import check_range, to_fixed
from repro_torch.core.volume import SimConfig
from repro_torch.detectors import accumulate_capture, update_capture
from repro_torch.kernels.photon_step import spec


def photon_steps_ref(labels_flat, media, state: ph.PhotonState,
                     shape, unitinmm, cfg: SimConfig, n_steps: int,
                     ppath=None, det_geom=None, record=False,
                     jac_w=None, jac_col=None, jac_cols: int = 0,
                     stats: bool = False, totals=None):
    """Returns ``(new_state, fluence, exitance, escaped_per_lane,
    timed_per_lane)``, then the optional groups in this order:

    * with detectors (``ppath`` ``(n, n_media)`` and ``det_geom``
      ``(n_det, 3)``): ``(ppath, det_w, det_ppath)``, the lane's
      per-medium path carried on, the gate-major ``(n_det * ntg,)``
      TPSF and the ``(n_det, n_media)`` weighted path sums;
    * with ``record``: per-lane int32 ``(cap_det, cap_gate)`` of the
      call's capture (-1: none);
    * with ``jac_cols > 0``: the ``(nvox * jac_cols,)`` replay Jacobian,
      ``jac_w * seg_len`` of every segment added at column ``jac_col``
      of the segment's voxel (weight * mm);
    * with ``stats``: an ``(n, 2)`` float32 block, always last:
      segments each lane entered alive, and its deposited weight.

    Fluence, exitance, TPSF, path sums and the Jacobian are int64 fixed
    point (``core.fixed``; ``from_fixed`` gives floats).  ``totals``
    (their int64 grids, in that order, as this call returns them) makes
    the call add into them in place and return them, as the kernel does
    with ``add_into``.  A ``(S, n_media, 4)`` media table makes the call
    S scenarios of ``n / S`` lanes each, scenario-major: labels are
    ``(nvox,)`` shared or ``(S, nvox)``, ``det_geom`` ``(S, n_det, 3)``,
    and every grid gains a leading scenario axis.  The kernels' round
    tail (``tail=``) is :func:`round_tail_ref` on this call's outputs.
    """
    n_det, record, jac_cols = spec.check_groups(ppath, det_geom, record,
                                                jac_w, jac_col, jac_cols)
    S, batched = spec.scenario_count(media)
    nx, ny, nz = (int(x) for x in shape)
    nvox, nxy = nx * ny * nz, nx * ny
    ntg = int(cfg.n_time_gates)
    n_flu = nvox * ntg
    n_media = media.shape[-2]
    n_all = state.w.shape[0]
    if n_all % S:
        raise ValueError(f"{n_all} lanes do not split into {S} scenarios")
    dev = state.w.device
    f32 = dict(dtype=torch.float32, device=dev)
    lane_sc = None
    label_base = media_base = None
    if batched:
        lane_sc = torch.arange(n_all, device=dev) // (n_all // S)
        media_base = lane_sc * n_media
        if labels_flat.ndim == 2:
            label_base = lane_sc * nvox
    labels = labels_flat.reshape(-1)
    media_rows = media.reshape(-1, 4)

    def at(index, stride):
        """A per-lane index into the scenario's part of a flat grid."""
        return index if lane_sc is None else index + lane_sc * stride

    fw = spec.FIXED_SHIFT
    # the call's int64 grids, flat: the caller's totals (added into in
    # place) or fresh zeroed ones
    sizes = {"fluence": S * n_flu, "exitance": S * nxy,
             "det_w": S * n_det * ntg, "det_ppath": S * n_det * n_media,
             "jac": S * nvox * jac_cols}
    names = ["fluence", "exitance"]
    if n_det:
        names += ["det_w", "det_ppath"]
    if jac_cols:
        names += ["jac"]
    if totals is not None and len(totals) != len(names):
        raise ValueError(f"totals must be the {len(names)} grids {names}")
    grid = {name: (torch.zeros((sizes[name],), dtype=torch.int64,
                               device=dev) if totals is None
                   else totals[i].view(-1)) for i, name in enumerate(names)}
    esc = torch.zeros_like(state.w)
    timed = torch.zeros_like(state.w)
    if n_det:
        pp = ppath
        geom = det_geom[lane_sc] if batched else det_geom
    if record:
        capd = torch.full((n_all,), -1, dtype=torch.int32, device=dev)
        capg = torch.zeros((n_all,), dtype=torch.int32, device=dev)
    if jac_cols:
        jac_col = jac_col.to(torch.int64)
    if stats:
        stbl = torch.zeros((n_all, 2), **f32)
    st = state
    n_steps = int(n_steps)
    for k in range(n_steps):
        if not bool(st.alive.any()):
            st = st._replace(rng=xrng.skip(st.rng, 5 * (n_steps - k)))
            break
        res = ph.step(st, labels, media_rows, shape, unitinmm, cfg,
                      label_base, media_base)
        gate = ph.time_gate_bins(res.dep_t, cfg.tmax_ns, ntg)
        grid["fluence"].index_add_(0, at(res.dep_idx * ntg + gate, n_flu),
                                   to_fixed(res.dep_w, fw["fluence"]))
        xy, xw = ph.exitance_bins(res.esc_pos, res.esc_w, shape)
        grid["exitance"].index_add_(0, at(xy, nxy),
                                    to_fixed(xw, fw["exitance"]))
        esc = esc + res.esc_w
        timed = timed + res.timed_w
        if n_det:
            pp, _, _ = accumulate_capture(
                pp, grid["det_w"], grid["det_ppath"].view(-1, n_media), res,
                gate, geom, ntg, lane_sc)
            if record:
                capd, capg = update_capture(capd, capg, res, gate, geom)
        if jac_cols:
            grid["jac"].index_add_(0, at(res.dep_idx * jac_cols + jac_col,
                                         nvox * jac_cols),
                                   to_fixed(jac_w * res.seg_len, fw["jac"]))
        if stats:
            stbl = stbl + torch.stack(
                [st.alive.to(torch.float32), res.dep_w], dim=1)
        st = res.state
    if any(bool((g < 0).any()) for g in grid.values()):
        raise OverflowError("a fixed-point grid sum passed 2**63 - 1 units")

    def shaped(name, *tail):
        """Grid ``name`` as the call returns it: the caller's total, or
        shaped."""
        if totals is not None:
            return totals[names.index(name)]
        return grid[name].view(S, *tail) if batched else grid[name].view(*tail)

    out = (st, shaped("fluence", n_flu), shaped("exitance", nxy), esc, timed)
    if n_det:
        out = out + (pp, shaped("det_w", n_det * ntg),
                     shaped("det_ppath", n_det, n_media))
    if record:
        out = out + (capd, capg)
    if jac_cols:
        out = out + (shaped("jac", nvox * jac_cols),)
    if stats:
        out = out + (stbl,)
    assert len(out) == spec.output_arity(n_det, record, jac_cols, stats)
    return out


def round_tail_ref(tail, esc, timed, alive) -> None:
    """The round's tail of a launch (``photon_step.RoundTail``) in
    PyTorch operations, in place: the per-lane escaped and timed-out
    weights ``esc`` and ``timed`` rounded once to ``2**-TOTAL_SHIFT``
    units and added into each scenario's totals, the round counted where
    the scenario had work, then its work (a lane ``alive`` after the
    launch, or budget left) and ``more``.  The CUDA kernel does this in
    its epilogue with the same bits, and the host kernel's wrapper calls
    this.  A weight of ``spec.DEPOSIT_LIMIT`` units or more raises
    ``OverflowError`` before anything is added, a total past
    ``2**63 - 1`` units after."""
    S = tail.rounds.shape[0]
    units = [to_fixed(x, spec.TOTAL_SHIFT).view(S, -1).sum(1)
             for x in (esc, timed)]
    tail.escaped.add_(units[0])
    tail.timed_out.add_(units[1])
    check_range((tail.escaped, tail.timed_out))
    tail.rounds.add_(tail.work.to(torch.int64))
    torch.logical_or(alive.view(S, -1).any(1), tail.remaining > 0,
                     out=tail.work)
    torch.any(tail.work, out=tail.more)
