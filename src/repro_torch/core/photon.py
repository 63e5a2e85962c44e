"""Hop-drop-spin photon transport physics, vectorized over lanes.

One call to :func:`step` advances every lane by one segment: the photon
moves to its next scattering site or the next voxel wall, whichever
comes first, deposits absorbed weight along the way, then scatters
(Henyey-Greenstein) or crosses the wall (Snell/Fresnel or escape).

This is the plain PyTorch version of the per-lane loop body; the CUDA
kernel (``kernels/photon_step/csrc/photon_step.cu``) repeats the same
arithmetic in the same order, so on one device the two agree bit for
bit where the library math does.  Every step draws exactly 5 uniforms
on every lane, alive or not, so the RNG stream never depends on the
float physics.  Scalar constants are rounded to float32 once here, and
the one division by a constant divides by a tensor, so that PyTorch
performs IEEE division on every device.

Positions are in voxel units; optical coefficients are scaled by
``unitinmm`` on entry.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import rng as xrng
from repro_torch.core.volume import C_MM_PER_NS, SimConfig


def f32(x: float) -> float:
    """Round a Python float to the nearest float32 value."""
    return float(np.float32(x))


_EPS_STEP = 1e-4                       # minimum-progress guard, voxel units
_SEG_MIN = f32(_EPS_STEP * 0.01)
_INF = f32(1e30)
_DIR_EPS = f32(1e-9)
_TWO_PI = f32(2.0 * math.pi)

# Escape positions within this distance (voxel units) of the z=0 plane
# count as exits through the illuminated face and are binned into the
# 2-D exitance image.
Z_EXIT_FACE_VOX = 0.25


class PhotonState(NamedTuple):
    pos: torch.Tensor     # (N, 3) float32, voxel units
    dir: torch.Tensor     # (N, 3) float32, unit vectors
    ivox: torch.Tensor    # (N, 3) int32, authoritative voxel index
    w: torch.Tensor       # (N,)  float32 packet weight
    s_left: torch.Tensor  # (N,)  float32 remaining dimensionless scat. length
    t: torch.Tensor       # (N,)  float32 elapsed time, ns
    rng: torch.Tensor     # (N, 4) int64 xorshift128 words (core/rng.py)
    alive: torch.Tensor   # (N,)  bool


class StepResult(NamedTuple):
    state: PhotonState
    dep_idx: torch.Tensor  # (N,) int64 flat voxel index of deposition
    dep_w: torch.Tensor    # (N,) float32 deposited weight (0 for dead lanes)
    esc_w: torch.Tensor    # (N,) float32 weight escaping the domain this step
    esc_pos: torch.Tensor  # (N, 3) float32 exit position (voxel units)
    dep_t: torch.Tensor    # (N,) float32 photon time at the segment end, ns
    seg_med: torch.Tensor  # (N,) int64 medium label of the segment's voxel
    seg_len: torch.Tensor  # (N,) float32 segment length in mm (0: dead lanes)
    timed_w: torch.Tensor  # (N,) float32 weight retired by the tmax_ns gate


def state_from_arrays(pos, direc, ivox, w, s_left, t, rng, alive,
                      device="cpu") -> PhotonState:
    """Build a PhotonState from host arrays (e.g. another package's
    state turned into numpy); ``rng`` holds unsigned 32-bit words."""
    def tens(a, np_dtype):
        return torch.tensor(np.asarray(a, np_dtype), device=device)

    return PhotonState(
        pos=tens(pos, np.float32), dir=tens(direc, np.float32),
        ivox=tens(ivox, np.int32), w=tens(w, np.float32),
        s_left=tens(s_left, np.float32), t=tens(t, np.float32),
        rng=tens(np.asarray(rng).astype(np.uint32), np.int64),
        alive=tens(alive, np.bool_))


def state_to_numpy(state: PhotonState) -> dict[str, np.ndarray]:
    """Host copy of a PhotonState, with ``rng`` as uint32 words."""
    out = {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}
    out["rng"] = out["rng"].astype(np.uint32)
    return out


def launch(pos, direc, w0, rng, active, shape) -> PhotonState:
    """Assemble fresh photons from per-lane source samples.

    A sampled position outside ``[0, shape]`` is clamped onto the domain
    boundary so ``pos`` and the voxel index stay consistent; for
    in-domain sources both clamps are no-ops.
    """
    dev = pos.device
    hi = torch.tensor(shape, dtype=torch.float32, device=dev)
    pos = torch.minimum(torch.clamp(pos.to(torch.float32), min=0.0), hi)
    bounds = torch.tensor(shape, dtype=torch.int32, device=dev) - 1
    ivox = torch.minimum(torch.clamp(torch.floor(pos).to(torch.int32), min=0),
                         bounds)
    n = pos.shape[0]
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    return PhotonState(
        pos=pos, dir=direc.to(torch.float32).contiguous(), ivox=ivox,
        w=torch.where(active, w0, zero), s_left=zero, t=zero,
        rng=rng, alive=active)


def exitance_bins(esc_pos, esc_w, shape):
    """Bin z=0-face escapes into the flat (nx*ny) exitance image.

    Returns ``(flat_xy, w)``: a flat 2-D bin per lane and the weight to
    deposit there (0 for lanes that did not exit through the z=0 face).
    """
    nx, ny, _ = shape
    hit = (esc_w > 0) & (esc_pos[:, 2] < Z_EXIT_FACE_VOX)
    ex = torch.clamp(torch.floor(esc_pos[:, 0]).to(torch.int64), 0, nx - 1)
    ey = torch.clamp(torch.floor(esc_pos[:, 1]).to(torch.int64), 0, ny - 1)
    return ex * ny + ey, torch.where(hit, esc_w, torch.zeros_like(esc_w))


def gate_scale(tmax_ns: float, n_time_gates: int) -> float:
    """``n_time_gates / tmax_ns`` computed in double, rounded to f32 once."""
    return f32(float(n_time_gates) / float(tmax_ns))


def time_gate_bins(dep_t, tmax_ns, n_time_gates):
    """Time-gate index of a deposit at photon time ``dep_t`` (ns): gates
    split ``[0, tmax_ns]`` into equal bins; the partial segment that
    crosses ``tmax_ns`` clips into the last gate."""
    g = torch.floor(dep_t * gate_scale(tmax_ns, n_time_gates))
    return torch.clamp(g.to(torch.int64), 0, n_time_gates - 1)


def _flat_index(ivox, shape):
    nx, ny, nz = shape
    ix = torch.clamp(ivox[:, 0], 0, nx - 1).to(torch.int64)
    iy = torch.clamp(ivox[:, 1], 0, ny - 1).to(torch.int64)
    iz = torch.clamp(ivox[:, 2], 0, nz - 1).to(torch.int64)
    return (ix * ny + iy) * nz + iz


def _lookup_label(labels_flat, shape, ivox, base=None):
    flat = _flat_index(ivox, shape)
    at = flat if base is None else flat + base
    return labels_flat[at].to(torch.int64), flat


def _boundary_distance(pos, direc, ivox):
    """Distance (voxel units) to the voxel wall + crossing axis (the
    first axis of minimal distance)."""
    fvox = ivox.to(torch.float32)
    one = torch.ones_like(direc)
    pos_dir = direc > _DIR_EPS
    neg_dir = direc < -_DIR_EPS
    d_pos = (fvox + 1.0 - pos) / torch.where(pos_dir, direc, one)
    d_neg = (fvox - pos) / torch.where(neg_dir, direc, one)
    dists = torch.where(pos_dir, d_pos,
                        torch.where(neg_dir, d_neg, torch.full_like(d_pos,
                                                                    _INF)))
    dists = torch.clamp(dists, min=0.0)
    dx, dy, dz = dists.unbind(-1)
    # first minimal axis, written out so ties resolve as in the kernel
    axis = torch.where((dx <= dy) & (dx <= dz), 0, torch.where(dy <= dz, 1, 2))
    d_min = torch.minimum(torch.minimum(dx, dy), dz)
    return d_min, axis


def _hg_scatter(direc, g, u_cos, u_phi):
    """Henyey-Greenstein direction update (MCML rotation formulas)."""
    small_g = torch.abs(g) < f32(1e-5)
    g_safe = torch.where(small_g, torch.ones_like(g), g)
    frac = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * u_cos)
    cost_hg = (1.0 + g_safe * g_safe - frac * frac) / (2.0 * g_safe)
    cost = torch.where(small_g, 2.0 * u_cos - 1.0, cost_hg)
    cost = torch.clamp(cost, -1.0, 1.0)
    sint = torch.sqrt(torch.clamp(1.0 - cost * cost, min=0.0))
    phi = _TWO_PI * u_phi
    cosp = torch.cos(phi)
    sinp = torch.sin(phi)

    ux, uy, uz = direc.unbind(-1)
    near_pole = torch.abs(uz) > f32(0.99999)
    tmp = torch.sqrt(torch.clamp(1.0 - uz * uz, min=f32(1e-12)))
    nx = sint * (ux * uz * cosp - uy * sinp) / tmp + ux * cost
    ny = sint * (uy * uz * cosp + ux * sinp) / tmp + uy * cost
    nz = -sint * cosp * tmp + uz * cost
    px = sint * cosp
    py = sint * sinp
    pz = cost * torch.sign(uz)
    ox = torch.where(near_pole, px, nx)
    oy = torch.where(near_pole, py, ny)
    oz = torch.where(near_pole, pz, nz)
    # renormalize to fight fp drift; the sum order is fixed
    norm = torch.clamp(torch.sqrt(ox * ox + oy * oy + oz * oz),
                       min=f32(1e-12))
    return torch.stack([ox / norm, oy / norm, oz / norm], dim=-1)


def _fresnel(n_i, n_t, cos_i):
    """Unpolarized Fresnel reflectance + transmitted cosine.

    Returns (R, cos_t, tir_mask).
    """
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    eta = n_i / torch.clamp(n_t, min=f32(1e-6))
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    rs_num = n_i * cos_i - n_t * cos_t
    rs_den = n_i * cos_i + n_t * cos_t
    rp_num = n_i * cos_t - n_t * cos_i
    rp_den = n_i * cos_t + n_t * cos_i
    one = torch.ones_like(rs_den)
    rs = rs_num / torch.where(torch.abs(rs_den) < f32(1e-12), one, rs_den)
    rp = rp_num / torch.where(torch.abs(rp_den) < f32(1e-12), one, rp_den)
    r = torch.where(tir, one, 0.5 * (rs * rs + rp * rp))
    return torch.clamp(r, 0.0, 1.0), cos_t, tir


def step(state, labels_flat, media, shape, unitinmm,
         cfg: SimConfig, label_base=None, media_base=None) -> StepResult:
    """Advance every lane by one segment.

    ``label_base`` / ``media_base`` (per-lane int64 offsets, or None)
    let lanes of several scenarios read their own labels and media rows
    from stacked ``labels_flat`` / ``media``: lane i reads label
    ``labels_flat[label_base[i] + voxel]`` and medium row
    ``media[media_base[i] + label]``.  The arithmetic is the same.

    ``cfg.specialize`` selects the specialized step (only the configured
    physics) or the general one (reflection and both deposition formulas
    computed, then selected by flags).  They give the same trajectories;
    in exact deposition mode the general step forms ``w - (w - w*e)``
    where the specialized one forms ``w*e``, which may differ in the
    last bit of ``w``.
    """
    pos, direc, ivox, w, s_left, t, rstate, alive = state
    nx, ny, nz = shape
    dev = w.device
    unit = f32(unitinmm)

    label, dep_flat = _lookup_label(labels_flat, shape, ivox, label_base)
    props = media[label if media_base is None else label + media_base]
    mua = props[:, 0] * unit
    mus = props[:, 1] * unit
    g = props[:, 2]
    n_cur = props[:, 3]

    # --- draw the per-step uniforms (fixed count: reproducibility) ---
    rstate, u_path = xrng.next_uniform(rstate)
    rstate, u_cos = xrng.next_uniform(rstate)
    rstate, u_phi = xrng.next_uniform(rstate)
    rstate, u_fres = xrng.next_uniform(rstate)
    rstate, u_roul = xrng.next_uniform(rstate)

    zero = torch.zeros_like(w)

    # --- HOP: distance to scattering site vs voxel wall ---
    s_new = torch.where(s_left <= 0.0, -torch.log(u_path), s_left)
    d_wall, cross_axis = _boundary_distance(pos, direc, ivox)
    d_scat = s_new / torch.clamp(mus, min=_DIR_EPS)
    d_scat = torch.where(mus <= _DIR_EPS, torch.full_like(d_scat, _INF),
                         d_scat)
    hits_wall = d_wall < d_scat
    seg = torch.clamp(torch.where(hits_wall, d_wall, d_scat), min=_SEG_MIN)

    new_pos = pos + direc * seg[:, None]
    s_new = torch.where(hits_wall, s_new - seg * mus, zero)
    c_light = torch.full((), f32(C_MM_PER_NS), dtype=torch.float32,
                         device=dev)
    t_new = t + seg * unit * n_cur / c_light

    # --- DROP: Beer-Lambert deposition into the current voxel ---
    tau = mua * seg
    taylor = cfg.deposit_mode == "taylor"
    if taylor:
        dep = w * torch.clamp(tau, max=1.0)
        w_after = w - dep
    elif cfg.specialize:
        w_after = w * torch.exp(-tau)
        dep = w - w_after
    else:
        dep = w - w * torch.exp(-tau)
        w_after = w - dep
    dep_w = torch.where(alive, dep, zero)

    # --- SPIN: HG scatter for lanes that reached their scattering site ---
    scat_dir = _hg_scatter(direc, g, u_cos, u_phi)
    is_scatter = alive & ~hits_wall

    # --- BOUNDARY: next voxel, Fresnel, escape ---
    axis_onehot = torch.nn.functional.one_hot(cross_axis, 3).to(torch.int32)
    axis_f = axis_onehot.to(torch.float32)
    dir_axis = torch.gather(direc, 1, cross_axis[:, None])[:, 0]
    sgn = torch.sign(dir_axis).to(torch.int32)
    next_vox = ivox + axis_onehot * sgn[:, None]
    oob = ((next_vox[:, 0] < 0) | (next_vox[:, 0] >= nx)
           | (next_vox[:, 1] < 0) | (next_vox[:, 1] >= ny)
           | (next_vox[:, 2] < 0) | (next_vox[:, 2] >= nz))
    next_label, _ = _lookup_label(labels_flat, shape, next_vox, label_base)
    next_label = torch.where(oob, torch.zeros_like(next_label), next_label)
    n_next = media[next_label if media_base is None
                   else next_label + media_base, 3]
    mismatch = torch.abs(n_next - n_cur) > f32(1e-6)

    if cfg.specialize and not cfg.do_reflect:
        reflects = torch.zeros_like(hits_wall)
        new_dir_boundary = direc
    else:
        refl_r, cos_t, _tir = _fresnel(n_cur, n_next, torch.abs(dir_axis))
        reflects = hits_wall & mismatch & (u_fres < refl_r) & cfg.do_reflect
        # reflected direction: flip the crossing-axis component
        refl_dir = direc * (1.0 - 2.0 * axis_f)
        # transmitted (refracted): scale tangentials, set normal cosine
        eta = n_cur / torch.clamp(n_next, min=f32(1e-6))
        trans = (direc * (1.0 - axis_f) * eta[:, None]
                 + axis_f * (sgn.to(torch.float32) * cos_t)[:, None])
        tx, ty, tz = trans.unbind(-1)
        tnorm = torch.clamp(torch.sqrt(tx * tx + ty * ty + tz * tz),
                            min=f32(1e-12))
        trans = trans / tnorm[:, None]
        bend = mismatch & cfg.do_reflect
        trans = torch.where(bend[:, None], trans, direc)
        new_dir_boundary = torch.where(reflects[:, None], refl_dir, trans)

    crossing = alive & hits_wall
    new_dir = torch.where(is_scatter[:, None], scat_dir,
                          torch.where(crossing[:, None], new_dir_boundary,
                                      direc))

    escapes = crossing & ~reflects & (oob | (next_label == 0))
    esc_w = torch.where(escapes, w_after, zero)
    advances = crossing & ~reflects & ~escapes
    new_ivox = torch.where(advances[:, None], next_vox, ivox)

    # --- ROULETTE + time gate, in this order ---
    alive_after = alive & ~escapes
    low_w = alive_after & (w_after < f32(cfg.w_threshold))
    survives = u_roul < f32(1.0 / cfg.roulette_m)
    w_final = torch.where(
        low_w, torch.where(survives, w_after * f32(cfg.roulette_m), zero),
        w_after)
    alive_after = alive_after & ~(low_w & ~survives)
    gate_kill = alive_after & (t_new > f32(cfg.tmax_ns))
    alive_after = alive_after & ~gate_kill
    timed_w = torch.where(gate_kill, w_final, zero)
    w_final = torch.where(escapes, zero, w_final)

    alive2 = alive[:, None]
    new_state = PhotonState(
        pos=torch.where(alive2, new_pos, pos),
        dir=torch.where(alive2, new_dir, direc),
        ivox=torch.where(alive2, new_ivox, ivox),
        w=torch.where(alive, w_final, w),
        s_left=torch.where(alive, s_new, s_left),
        t=torch.where(alive, t_new, t),
        rng=rstate,
        alive=alive_after,
    )
    return StepResult(
        state=new_state,
        dep_idx=dep_flat,
        dep_w=dep_w,
        esc_w=torch.where(alive, esc_w, zero),
        esc_pos=new_pos,
        dep_t=t_new,
        seg_med=label,
        seg_len=torch.where(alive, seg * unit, zero),
        timed_w=torch.where(alive, timed_w, zero),
    )
