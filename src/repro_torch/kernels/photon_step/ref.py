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
"""

from __future__ import annotations

import torch

from repro_torch.core import photon as ph
from repro_torch.core.volume import SimConfig
from repro_torch.detectors import accumulate_capture, update_capture
from repro_torch.kernels.photon_step import spec


def photon_steps_ref(labels_flat, media, state: ph.PhotonState,
                     shape, unitinmm, cfg: SimConfig, n_steps: int,
                     ppath=None, det_geom=None, record=False,
                     jac_w=None, jac_col=None, jac_cols: int = 0,
                     stats: bool = False):
    """Returns ``(new_state, fluence_flat, exitance_flat,
    escaped_per_lane, timed_per_lane)``, then the optional groups in
    this order:

    * with detectors (``ppath`` ``(n, n_media)`` and ``det_geom``
      ``(n_det, 3)``): ``(ppath, det_w_flat, det_ppath)``, the lane's
      per-medium path carried on, the gate-major ``(n_det * ntg,)``
      TPSF and the ``(n_det, n_media)`` weighted path sums;
    * with ``record``: per-lane int32 ``(cap_det, cap_gate)`` of the
      call's capture (-1: none);
    * with ``jac_cols > 0``: the ``(nvox * jac_cols,)`` replay Jacobian,
      ``jac_w * seg_len`` of every segment added at column ``jac_col``
      of the segment's voxel;
    * with ``stats``: an ``(n, 2)`` float32 block, always last:
      segments each lane entered alive, and its deposited weight.
    """
    n_det, record, jac_cols = spec.check_groups(ppath, det_geom, record,
                                                jac_w, jac_col, jac_cols)
    nvox = labels_flat.shape[0]
    ntg = int(cfg.n_time_gates)
    nxy = shape[0] * shape[1]
    n = state.w.shape[0]
    dev = state.w.device
    f32 = dict(dtype=torch.float32, device=dev)
    flu = torch.zeros((nvox * ntg,), **f32)
    exi = torch.zeros((nxy,), **f32)
    esc = torch.zeros_like(state.w)
    timed = torch.zeros_like(state.w)
    if n_det:
        pp = ppath
        dw = torch.zeros((n_det * ntg,), **f32)
        dp = torch.zeros((n_det, media.shape[0]), **f32)
    if record:
        capd = torch.full((n,), -1, dtype=torch.int32, device=dev)
        capg = torch.zeros((n,), dtype=torch.int32, device=dev)
    if jac_cols:
        jac = torch.zeros((nvox * jac_cols,), **f32)
        jac_col = jac_col.to(torch.int64)
    if stats:
        stbl = torch.zeros((n, 2), **f32)
    st = state
    for _ in range(int(n_steps)):
        res = ph.step(st, labels_flat, media, shape, unitinmm, cfg)
        gate = ph.time_gate_bins(res.dep_t, cfg.tmax_ns, ntg)
        flu.index_add_(0, res.dep_idx * ntg + gate, res.dep_w)
        xy, xw = ph.exitance_bins(res.esc_pos, res.esc_w, shape)
        exi.index_add_(0, xy, xw)
        esc = esc + res.esc_w
        timed = timed + res.timed_w
        if n_det:
            pp, dw, dp = accumulate_capture(pp, dw, dp, res, gate,
                                            det_geom, ntg)
            if record:
                capd, capg = update_capture(capd, capg, res, gate, det_geom)
        if jac_cols:
            jac.index_add_(0, res.dep_idx * jac_cols + jac_col,
                           jac_w * res.seg_len)
        if stats:
            stbl = stbl + torch.stack(
                [st.alive.to(torch.float32), res.dep_w], dim=1)
        st = res.state
    out = (st, flu, exi, esc, timed)
    if n_det:
        out = out + (pp, dw, dp)
    if record:
        out = out + (capd, capg)
    if jac_cols:
        out = out + (jac,)
    if stats:
        out = out + (stbl,)
    assert len(out) == spec.output_arity(n_det, record, jac_cols, stats)
    return out
