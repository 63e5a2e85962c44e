"""One hop-drop-spin segment for every lane, frozen.

A copy of ``repro_torch/core/photon.py``'s ``step`` as of the
benchmark's first version, in plain PyTorch, with the paths the
benchmark's configurations run: exact Beer-Lambert deposition, the
specialized step, reflection on or off.  Every step draws 5 uniforms
on every lane.  Scalar constants are rounded to float32 once; the one
division by a constant divides by a tensor, so that PyTorch performs
IEEE division on every device.  Positions are in voxel units.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from perfbench.reference import rng as xrng

C_MM_PER_NS = 299.792458


def f32(x: float) -> float:
    return float(np.float32(x))


_SEG_MIN = f32(1e-4 * 0.01)
_INF = f32(1e30)
_DIR_EPS = f32(1e-9)
_TWO_PI = f32(2.0 * math.pi)
Z_EXIT_FACE_VOX = 0.25


class Physics(NamedTuple):
    """The configuration's physics: the fields of the port's
    ``SimConfig`` that a CW or time-resolved run of the benchmark
    sets."""

    do_reflect: bool
    tmax_ns: float = 5.0
    w_threshold: float = 1e-4
    roulette_m: float = 10.0
    n_time_gates: int = 1


class State(NamedTuple):
    pos: torch.Tensor     # (N, 3) float32, voxel units
    dir: torch.Tensor     # (N, 3) float32
    ivox: torch.Tensor    # (N, 3) int32
    w: torch.Tensor       # (N,) float32
    s_left: torch.Tensor  # (N,) float32
    t: torch.Tensor       # (N,) float32, ns
    rng: torch.Tensor     # (N, 4) int64 words
    alive: torch.Tensor   # (N,) bool


class Segment(NamedTuple):
    state: State
    dep_idx: torch.Tensor
    dep_w: torch.Tensor
    esc_w: torch.Tensor
    esc_pos: torch.Tensor
    dep_t: torch.Tensor
    seg_med: torch.Tensor
    seg_len: torch.Tensor
    timed_w: torch.Tensor


def launch(pos, direc, w0, rng, shape) -> State:
    """Fresh photons, every lane alive; a position outside the domain
    is clamped onto it."""
    dev = pos.device
    hi = torch.tensor(shape, dtype=torch.float32, device=dev)
    pos = torch.minimum(torch.clamp(pos.to(torch.float32), min=0.0), hi)
    bounds = torch.tensor(shape, dtype=torch.int32, device=dev) - 1
    ivox = torch.minimum(torch.clamp(torch.floor(pos).to(torch.int32), min=0),
                         bounds)
    n = pos.shape[0]
    return State(pos=pos, dir=direc.to(torch.float32).contiguous(),
                 ivox=ivox, w=w0.clone(),
                 s_left=torch.zeros((n,), dtype=torch.float32, device=dev),
                 t=torch.zeros((n,), dtype=torch.float32, device=dev), rng=rng,
                 alive=torch.ones((n,), dtype=torch.bool, device=dev))


def exitance_bins(esc_pos, esc_w, shape):
    nx, ny, _ = shape
    hit = (esc_w > 0) & (esc_pos[:, 2] < Z_EXIT_FACE_VOX)
    ex = torch.clamp(torch.floor(esc_pos[:, 0]).to(torch.int64), 0, nx - 1)
    ey = torch.clamp(torch.floor(esc_pos[:, 1]).to(torch.int64), 0, ny - 1)
    return ex * ny + ey, torch.where(hit, esc_w, torch.zeros_like(esc_w))


def time_gate_bins(dep_t, tmax_ns, n_time_gates):
    scale = f32(float(n_time_gates) / float(tmax_ns))
    g = torch.floor(dep_t * scale)
    return torch.clamp(g.to(torch.int64), 0, n_time_gates - 1)


def _flat_index(ivox, shape):
    nx, ny, nz = shape
    ix = torch.clamp(ivox[:, 0], 0, nx - 1).to(torch.int64)
    iy = torch.clamp(ivox[:, 1], 0, ny - 1).to(torch.int64)
    iz = torch.clamp(ivox[:, 2], 0, nz - 1).to(torch.int64)
    return (ix * ny + iy) * nz + iz


def _boundary_distance(pos, direc, ivox):
    fvox = ivox.to(torch.float32)
    one = torch.ones_like(direc)
    pos_dir = direc > _DIR_EPS
    neg_dir = direc < -_DIR_EPS
    d_pos = (fvox + 1.0 - pos) / torch.where(pos_dir, direc, one)
    d_neg = (fvox - pos) / torch.where(neg_dir, direc, one)
    dists = torch.where(pos_dir, d_pos,
                        torch.where(neg_dir, d_neg,
                                    torch.full_like(d_pos, _INF)))
    dists = torch.clamp(dists, min=0.0)
    dx, dy, dz = dists.unbind(-1)
    axis = torch.where((dx <= dy) & (dx <= dz), 0, torch.where(dy <= dz, 1, 2))
    d_min = torch.minimum(torch.minimum(dx, dy), dz)
    return d_min, axis


def _hg_scatter(direc, g, u_cos, u_phi):
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
    norm = torch.clamp(torch.sqrt(ox * ox + oy * oy + oz * oz),
                       min=f32(1e-12))
    return torch.stack([ox / norm, oy / norm, oz / norm], dim=-1)


def _fresnel(n_i, n_t, cos_i):
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
    return torch.clamp(r, 0.0, 1.0), cos_t


def step(state: State, labels_flat, media, shape, unitinmm,
         phys: Physics) -> Segment:
    """Advance every lane by one segment (dead lanes draw and stay)."""
    pos, direc, ivox, w, s_left, t, rstate, alive = state
    nx, ny, nz = shape
    dev = w.device
    unit = f32(unitinmm)

    dep_flat = _flat_index(ivox, shape)
    label = labels_flat[dep_flat].to(torch.int64)
    props = media[label]
    mua = props[:, 0] * unit
    mus = props[:, 1] * unit
    g = props[:, 2]
    n_cur = props[:, 3]

    rstate, u_path = xrng.next_uniform(rstate)
    rstate, u_cos = xrng.next_uniform(rstate)
    rstate, u_phi = xrng.next_uniform(rstate)
    rstate, u_fres = xrng.next_uniform(rstate)
    rstate, u_roul = xrng.next_uniform(rstate)

    zero = torch.zeros_like(w)

    # hop
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

    # drop (exact Beer-Lambert, specialized form)
    tau = mua * seg
    w_after = w * torch.exp(-tau)
    dep = w - w_after
    dep_w = torch.where(alive, dep, zero)

    # spin
    scat_dir = _hg_scatter(direc, g, u_cos, u_phi)
    is_scatter = alive & ~hits_wall

    # boundary
    # one_hot(cross_axis, 3), as a comparison: no host read on the card
    axis_onehot = (cross_axis[:, None] == torch.arange(
        3, device=dev)).to(torch.int32)
    axis_f = axis_onehot.to(torch.float32)
    dir_axis = torch.gather(direc, 1, cross_axis[:, None])[:, 0]
    sgn = torch.sign(dir_axis).to(torch.int32)
    next_vox = ivox + axis_onehot * sgn[:, None]
    oob = ((next_vox[:, 0] < 0) | (next_vox[:, 0] >= nx)
           | (next_vox[:, 1] < 0) | (next_vox[:, 1] >= ny)
           | (next_vox[:, 2] < 0) | (next_vox[:, 2] >= nz))
    next_label = labels_flat[_flat_index(next_vox, shape)].to(torch.int64)
    next_label = torch.where(oob, torch.zeros_like(next_label), next_label)
    n_next = media[next_label, 3]
    mismatch = torch.abs(n_next - n_cur) > f32(1e-6)

    if not phys.do_reflect:
        reflects = torch.zeros_like(hits_wall)
        new_dir_boundary = direc
    else:
        refl_r, cos_t = _fresnel(n_cur, n_next, torch.abs(dir_axis))
        reflects = hits_wall & mismatch & (u_fres < refl_r)
        refl_dir = direc * (1.0 - 2.0 * axis_f)
        eta = n_cur / torch.clamp(n_next, min=f32(1e-6))
        trans = (direc * (1.0 - axis_f) * eta[:, None]
                 + axis_f * (sgn.to(torch.float32) * cos_t)[:, None])
        tx, ty, tz = trans.unbind(-1)
        tnorm = torch.clamp(torch.sqrt(tx * tx + ty * ty + tz * tz),
                            min=f32(1e-12))
        trans = trans / tnorm[:, None]
        trans = torch.where(mismatch[:, None], trans, direc)
        new_dir_boundary = torch.where(reflects[:, None], refl_dir, trans)

    crossing = alive & hits_wall
    new_dir = torch.where(is_scatter[:, None], scat_dir,
                          torch.where(crossing[:, None], new_dir_boundary,
                                      direc))
    escapes = crossing & ~reflects & (oob | (next_label == 0))
    esc_w = torch.where(escapes, w_after, zero)
    advances = crossing & ~reflects & ~escapes
    new_ivox = torch.where(advances[:, None], next_vox, ivox)

    # roulette, then the time gate
    alive_after = alive & ~escapes
    low_w = alive_after & (w_after < f32(phys.w_threshold))
    survives = u_roul < f32(1.0 / phys.roulette_m)
    w_final = torch.where(
        low_w, torch.where(survives, w_after * f32(phys.roulette_m), zero),
        w_after)
    alive_after = alive_after & ~(low_w & ~survives)
    gate_kill = alive_after & (t_new > f32(phys.tmax_ns))
    alive_after = alive_after & ~gate_kill
    timed_w = torch.where(gate_kill, w_final, zero)
    w_final = torch.where(escapes, zero, w_final)

    alive2 = alive[:, None]
    new_state = State(
        pos=torch.where(alive2, new_pos, pos),
        dir=torch.where(alive2, new_dir, direc),
        ivox=torch.where(alive2, new_ivox, ivox),
        w=torch.where(alive, w_final, w),
        s_left=torch.where(alive, s_new, s_left),
        t=torch.where(alive, t_new, t),
        rng=rstate,
        alive=alive_after,
    )
    return Segment(
        state=new_state, dep_idx=dep_flat, dep_w=dep_w,
        esc_w=torch.where(alive, esc_w, zero), esc_pos=new_pos,
        dep_t=t_new, seg_med=label,
        seg_len=torch.where(alive, seg * unit, zero),
        timed_w=torch.where(alive, timed_w, zero))
