"""Solution post-processing + physics validation helpers (host numpy).

``fluence_cw`` follows MCX's normalization: the continuous-wave fluence
is the deposited energy divided by (mua * voxel volume * launched
weight); for a time-resolved run it is the gate sum of ``fluence_td``.
The validation helpers check a run against physics (energy
conservation; the diffusion-theory attenuation
mu_eff = sqrt(3 mua (mua + mus'))).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.simulator import SimResult
from repro_torch.core.volume import SimConfig, Volume


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def fluence_td(result: SimResult, volume: Volume) -> np.ndarray:
    """Time-resolved fluence per gate (1/mm^2 per unit launched weight),
    ``(nx, ny, nz, ntg)``; a CW result is a single all-covering gate."""
    energy = _host(result.energy)
    if energy.ndim == 3:
        energy = energy[..., None]
    labels = _host(volume.labels).astype(np.int64)
    mua = _host(volume.media)[:, 0][labels]  # (nx, ny, nz), 1/mm
    vvox = np.float32(volume.unitinmm**3)
    denom = np.maximum(mua * vvox * _host(result.launched_w),
                       np.float32(1e-20))
    with np.errstate(divide="ignore", invalid="ignore"):
        phi = energy / denom[..., None]
    return np.where((mua > 0)[..., None], phi, np.float32(0.0))


def fluence_cw(result: SimResult, volume: Volume) -> np.ndarray:
    """CW fluence (1/mm^2 per unit launched weight): the gate sum of
    :func:`fluence_td`, normalized by the launched weight."""
    return fluence_td(result, volume).sum(axis=-1)


def gate_times_ns(cfg: SimConfig) -> np.ndarray:
    """Gate-center times (ns) of the ``cfg.n_time_gates`` bins."""
    return (np.arange(cfg.n_time_gates) + 0.5) * cfg.gate_width_ns


def energy_balance(result: SimResult) -> dict[str, float]:
    """Launched = absorbed + escaped + timed_out (+ roulette residue),
    summed in float64 on the host.  ``residue_frac`` measures only the
    statistical Russian-roulette residue."""
    absorbed = float(_host(result.energy).sum(dtype=np.float64))
    escaped = float(_host(result.escaped_w))
    launched = float(_host(result.launched_w))
    timed_out = float(_host(result.timed_out_w))
    residue = launched - absorbed - escaped - timed_out
    return {
        "launched": launched,
        "absorbed": absorbed,
        "escaped": escaped,
        "timed_out": timed_out,
        "residue": residue,
        "residue_frac": residue / max(launched, 1.0),
    }


def mu_eff_theory(mua: float, mus: float, g: float) -> float:
    """Diffusion-theory effective attenuation coefficient, 1/mm."""
    musp = mus * (1.0 - g)
    return float(np.sqrt(3.0 * mua * (mua + musp)))


def fit_axial_decay(result: SimResult, volume: Volume,
                    z_range: tuple[int, int],
                    axis_xy: tuple[int, int] | None = None) -> float:
    """Fit the exp-decay slope of on-axis fluence vs depth; returns
    mu_fit (1/mm).

    Diffusion theory gives Phi(z) ~ exp(-mu_eff r) / r with r = z + z0
    (z0 ~ one transport mean free path), so ln(Phi * r) is fitted
    against z.  ``axis_xy`` is the beam axis in voxel coordinates (the
    volume center by default); the on-axis averaging patch is clamped
    to the volume.
    """
    phi = fluence_cw(result, volume)
    nx, ny, _ = volume.shape
    cx, cy = axis_xy if axis_xy is not None else (nx // 2, ny // 2)
    if not (0 <= cx < nx and 0 <= cy < ny):
        raise ValueError(f"axis_xy {(cx, cy)} outside volume {(nx, ny)}")
    x0, x1 = max(cx - 2, 0), min(cx + 3, nx)
    y0, y1 = max(cy - 2, 0), min(cy + 3, ny)
    line = phi[x0:x1, y0:y1, :].mean(axis=(0, 1))
    z0, z1 = z_range
    zs = (np.arange(z0, z1) + 0.5) * volume.unitinmm
    labels = _host(volume.labels)
    props = _host(volume.media)[labels[cx, cy, (z0 + z1) // 2]]
    musp = props[1] * (1.0 - props[2])
    src_depth = 1.0 / max(musp, 1e-6)  # transport mfp, mm
    vals = line[z0:z1] * (zs + src_depth)
    good = vals > 0
    if good.sum() < 3:
        raise ValueError("not enough nonzero fluence samples to fit decay")
    slope, _ = np.polyfit(zs[good], np.log(vals[good]), 1)
    return float(-slope)
