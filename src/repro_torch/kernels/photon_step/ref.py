"""Plain PyTorch version of the photon-step kernel.

Runs ``n_steps`` lock-step iterations of ``photon.step`` over all lanes,
accumulating deposition into a gate-major ``(nvox * ntg,)`` fluence
grid, z=0-face exits into a flat ``(nx * ny,)`` exitance image, and
escaped / timed-out weight per lane: the computation of the CUDA kernel
in ``csrc/photon_step.cu``, one PyTorch operation at a time.  The
dispatcher (``ops.photon_steps``) runs it for CPU tensors, and
``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core import photon as ph
from repro_torch.core.volume import SimConfig
from repro_torch.kernels.photon_step import spec


def photon_steps_ref(labels_flat, media, state: ph.PhotonState,
                     shape, unitinmm, cfg: SimConfig, n_steps: int,
                     ppath=None, det_geom=None, record=False,
                     jac_w=None, jac_col=None, jac_cols: int = 0,
                     stats: bool = False):
    """Returns ``(new_state, fluence_flat, exitance_flat,
    escaped_per_lane, timed_per_lane)``.  The optional output groups
    (detectors, records, replay Jacobian, stats) raise
    ``NotImplementedError`` until they are ported."""
    spec.reject_optional_groups(ppath, det_geom, record, jac_w, jac_col,
                                jac_cols, stats)
    nvox = labels_flat.shape[0]
    ntg = int(cfg.n_time_gates)
    nxy = shape[0] * shape[1]
    dev = state.w.device
    flu = torch.zeros((nvox * ntg,), dtype=torch.float32, device=dev)
    exi = torch.zeros((nxy,), dtype=torch.float32, device=dev)
    esc = torch.zeros_like(state.w)
    timed = torch.zeros_like(state.w)
    st = state
    for _ in range(int(n_steps)):
        res = ph.step(st, labels_flat, media, shape, unitinmm, cfg)
        gate = ph.time_gate_bins(res.dep_t, cfg.tmax_ns, ntg)
        flu.index_add_(0, res.dep_idx * ntg + gate, res.dep_w)
        xy, xw = ph.exitance_bins(res.esc_pos, res.esc_w, shape)
        exi.index_add_(0, xy, xw)
        esc = esc + res.esc_w
        timed = timed + res.timed_w
        st = res.state
    return st, flu, exi, esc, timed
