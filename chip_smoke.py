"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises, so the
script exits non-zero and prints no result:

  env      torch / CUDA versions and the card (nvidia-smi name, power limit)
  build    nvcc builds the photon-step kernel from csrc/, one library per
           set of output groups, all started together (seconds); the
           base and detection-forward libraries' SASS instructions by
           source region (kernels/photon_step/sass.py)
  kernel   K1, the base group, against its plain PyTorch version on the
           card, from fresh pencil photons on 60^3 B1 and B2 (131072
           lanes, K=8; B2 also with 4 time gates and an off-axis pencil),
           and on a mid-run B1 and B2 state at the main path's shape
           (262144 lanes, K=16): the lane state bit-equal on every
           lane, totals within 1e-5 relative, every fluence / exitance
           cell and every lane's escaped / timed-out weight within
           4 sqrt(lanes K) 2^-24 of its array's largest value, and that
           check failing on
           outputs with deposits moved to a wrong voxel, gate or exitance
           bin; kernel and plain device times by CUDA events behind a
           spin kernel (the mid-run launches also as the host launches
           them), the bound of each mid-run launch, its lane- and
           warp-segments on each path (alive, scattering, Fresnel) and
           the least time to issue its SASS; then the launch's edge
           cases, base and detection forward: every lane dead at launch
           (only its uniforms drawn), a ragged lane count with half-dead
           warps, and every lane in one voxel with one direction
  groups   K2-K5, the optional groups (detectors, records, replay
           Jacobian, stats), each variant against the plain version on
           fresh B2 photons (60^3, 131072 lanes, K=8, 4 gates, three
           detectors) and on a mid-run B2 state at the detection path's
           shape (262144 lanes, K=16, 50 gates): ppath, records and stats
           lane by lane bit-equal, TPSF, detector path sums and Jacobian
           cell by cell within the same limit, the lane state bit-equal
           with the groups on and off, and the limit failing a detector
           index swapped, a gate off by one and a Jacobian column off by
           one; times and bounds as for K1
  main     repro_torch.launch.simulate for B1 and B2 at 60^3 with 10^7
           photons, 262144 lanes, K=16: exact photon accounting,
           energy-balance residue < 1e-4, the kernel launched at least
           once per round, B1's axial decay against diffusion theory
  detect   the detection path at the same size: B2 with 50 gates over
           5 ns, three detectors, 2^20 record slots, gate-resolved replay
           and round stats: exact accounting, no record overflow, every
           record replayed at its detector and gate, the Jacobian's
           medium sums equal to det_ppath within 1e-5, the stats'
           escaped weight equal to the result's
  replay   the replay of the detect run's records again, its launches'
           inputs kept: every launch of pass A (det+record) and pass B
           (jac) held against the plain version on its own inputs, at the
           replay's lane count, as in the groups phase; the kernel timed
           over all of them, each pass's launches back to back behind
           spin kernels, and its bound summed from each launch's inputs
  kernels  one entry per kernel variant the paths launch (launches in
           the main and detect runs, error against the plain version,
           times and bound at the shapes those runs give the variant;
           K1's weighted by the main runs' launches of each template
           instantiation)

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the repository's ``src/`` beside it, the script
exits non-zero.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
try:
    from repro_torch.kernels.photon_step import photon_step as K
except ModuleNotFoundError:
    sys.exit("chip_smoke.py needs the repository's src/ beside it")

# H100 SXM peaks (NVIDIA data sheet): HBM3 3.35 TB/s, float32 outside the
# tensor cores 67 TFLOP/s.  That rate counts an FMA as two operations;
# the kernel is built with --fmad=false and issues none, so its float32
# operations go at one per lane and clock, half of it.  Special functions
# (MUFU: rcp, sqrt, lg2, ex2, sin, cos) issue at 16 per clock per SM on
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput), at the 1.98 GHz boost clock of the SXM part.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2
MUFU_OPS_PER_S = 16 * 132 * 1.98e9

# Work of one live lane-segment of csrc/photon_step.cu, counted from the
# source (scatter path, the common one): 5 uniforms (2 float ops each),
# hop and wall distances (~30), deposit (~6), HG spin and renormalize
# (~60), position, time and roulette updates (~20), gate index (2).
F32_OPS_PER_SEGMENT = 130
# log, exp, sin, cos, 4 square roots, ~10 reciprocals for the IEEE
# divisions.
MUFU_OPS_PER_SEGMENT = 18
# Each deposit is one 4 B float atomic.  The fluence grid (864 KB at
# 60^3) stays in the 50 MB L2, so the atomics resolve there and are not
# HBM traffic: they are reported apart, not in the bytes bound.
ATOMIC_BYTES_PER_SEGMENT = 4

# Extra float32 operations of the optional groups: per live segment the
# path's product and sum (detectors), the Jacobian's product and its
# index (replay), the two counter sums (stats); per capture 5 for each
# disk tested and 2 for each medium of the path sums.
GROUP_F32_OPS_PER_SEGMENT = {"n_det": 2, "record": 0, "jac_cols": 3,
                             "stats": 2}

PHOTONS = 10_000_000
LANES = 262_144
K_MAIN = 16
CMP_LANES, CMP_K = 131_072, 8
SIZE = 60
# the detection path: 50 gates of 0.1 ns, 2 mm disks 10, 15 and 20 mm
# from the pencil at (30, 30), 2^20 record slots
DETECTORS = [{"x": 40, "y": 30, "radius": 2}, {"x": 45, "y": 30, "radius": 2},
             {"x": 50, "y": 30, "radius": 2}]
NTG_DETECT, TMAX_DETECT = 50, 5.0
SAVE_DETECTED = 1 << 20
SEED = 1234  # the CLI's default, which the detection path keeps
DETECT_ARGV = ["--bench", "B2", "--photons", str(PHOTONS), "--lanes",
               str(LANES), "--size", str(SIZE), "--steps-per-round",
               str(K_MAIN), "--time-gates", str(NTG_DETECT), "--tmax-ns",
               str(TMAX_DETECT), "--detectors", json.dumps(DETECTORS),
               "--save-detected", str(SAVE_DETECTED), "--replay",
               "--replay-gate-resolved", "--collect-stats"]
# the group bits of the kernel's variants, as the wrapper sets them
DET, RECORD, JAC, STATS = (K.GROUP_BITS[g]
                           for g in ("n_det", "record", "jac_cols", "stats"))
GROUP_ROWS = {DET: "K2", RECORD: "K3", JAC: "K4", STATS: "K5"}
# the variants the detection path launches, and where
FORWARD, PASS_A, PASS_B = DET | RECORD | STATS, DET | RECORD, JAC
PATH_VARIANTS = {FORWARD: "detection forward", PASS_A: "replay pass A",
                 PASS_B: "replay pass B"}
# the variants held against the plain version: each group alone, and
# the detection path's
CHECK_VARIANTS = (DET, DET | RECORD, JAC, STATS, DET | RECORD | STATS)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ~0.1 s of spinning at the 1.98 GHz boost clock
SPIN_CYCLES = 200_000_000


def time_cuda(fn, reps: int, warmup: int = 1, backlog: bool = True) -> float:
    """Mean milliseconds per call by CUDA events.

    With ``backlog`` a spin kernel holds the stream while the host
    enqueues the calls, so the events time the device work of the calls
    back to back.  Without it they time the loop as the host runs it,
    which is the host's rate wherever one call's host work (the
    wrapper's checks and allocations) takes longer than its device work.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if backlog:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# The kernel's grids are float32 sums in an order that changes from run
# to run.  They are held against the exact (float64) sum of the plain
# version's float32 deposits: its own float32 sum of many equal deposits
# into one cell drifts one way (the pencil's first cell, where about a
# third of the photons leave the voxel after exactly one unit of path,
# came out 4.0e-4 low on 131072 fresh lanes x 8 segments).  Against the
# exact sum a cell of n deposits is off by about sqrt(n) * 2^-24 of its
# value (a random walk of rounding errors), and no cell takes more
# deposits than the launch has lane-segments.  Cells are therefore held
# to CELL_SIGMAS * sqrt(lanes * K) * 2^-24 of the array's largest value;
# mutation checks show that this still fails a wrong voxel, gate or
# exitance bin.  Totals are held to 1e-5 relative.
EXACT = torch.float64
CELL_SIGMAS = 4.0
TOTAL_TOL = 1e-5


def cell_tol(n_lanes: int, n_steps: int) -> float:
    return CELL_SIGMAS * math.sqrt(max(n_lanes * n_steps, 1)) * 2.0**-24


def cells(name, a, b, tol, fails, out, lanes=None):
    """Hold an accumulated array against the plain version's: total
    within TOTAL_TOL relative, every cell (or, for a per-lane array,
    every lane of the ``lanes`` mask) within ``tol`` of the largest
    value, so a deposit into a wrong cell fails even where the totals
    agree.  Adds the numbers to ``out[name]`` and failures to ``fails``."""
    if a.shape != b.shape:
        fails.append(f"{name} shape {tuple(a.shape)} != {tuple(b.shape)}")
        return
    a, b = a.double(), b.double()
    ta, tb = float(a.sum()), float(b.sum())
    rel = abs(ta - tb) / max(abs(tb), 1e-12)
    if rel > TOTAL_TOL:
        fails.append(f"{name} totals differ by {rel:.3e} relative")
    if lanes is not None:
        a, b = a[lanes], b[lanes]
    cell = float((a - b).abs().max()) if a.numel() else 0.0
    cell_rel = cell / max(float(b.abs().max()) if b.numel() else 0.0, 1e-12)
    if cell_rel > tol:
        fails.append(f"{name} differs by {cell_rel:.3e} of its largest value "
                     f"in some cell")
    out[name] = {"total": tb, "total_rel": rel, "cell_max_abs": cell,
                 "cell_max_rel_to_max": cell_rel}


def measure(got, want, tol: float, min_equal: float = 0.9999):
    """Kernel outputs against the plain version's on the same inputs:
    ``(diffs, failures)``, the second a list of failed checks.

    Lane state is held lane by lane.  Fluence and exitance are held cell
    by cell, and escaped / timed-out weight lane by lane, each against
    ``tol`` of its array's largest value, so a deposit into a wrong
    voxel, gate or bin fails even where the totals agree.
    """
    fails = []
    gs, ws = got[0], want[0]
    if not torch.equal(gs.rng, ws.rng):
        fails.append("rng words differ")
    same = (gs.alive == ws.alive) & (gs.ivox == ws.ivox).all(dim=1)
    frac = float(same.float().mean())
    if frac < min_equal:
        fails.append(f"alive/ivox agree on only {frac:.6f} of lanes")
    # every lane's state bit for bit: the same IEEE operations in the
    # same order on the same device
    bit = torch.ones_like(gs.alive)
    for x, y in zip(gs, ws):
        bit &= (x == y).reshape(x.shape[0], -1).all(dim=1)
    lanes_bit_equal = int(bit.sum())
    if lanes_bit_equal != bit.numel():
        fails.append(f"lane state differs from the plain version on "
                     f"{bit.numel() - lanes_bit_equal} lanes")
    max_abs = max_rel = 0.0
    for name in ("pos", "dir", "w", "s_left", "t"):
        a, b = getattr(gs, name)[same].double(), getattr(ws, name)[same].double()
        d = (a - b).abs()
        if d.numel():
            max_abs = max(max_abs, float(d.max()))
            max_rel = max(max_rel, float((d / b.abs().clamp(min=1.0)).max()))
    if max_rel > 1e-5:
        fails.append(f"float state differs by {max_rel:.3e} relative")
    out = {"lanes_equal_frac": frac, "lanes_bit_equal": lanes_bit_equal,
           "state_max_abs": max_abs, "state_max_rel": max_rel}
    for name, a, b in zip(("fluence", "exitance", "escaped", "timed"),
                          got[1:], want[1:]):
        cells(name, a, b, tol, fails, out,
              same if name in ("escaped", "timed") else None)
        max_abs = max(max_abs, out.get(name, {}).get("cell_max_abs", 0.0))
    out["cell_tol"] = tol
    out["max_abs_err"] = max_abs
    return out, fails


def compare(got, want, tol: float) -> dict:
    diffs, fails = measure(got, want, tol)
    check(not fails, "; ".join(fails))
    return diffs


def check_sees_index_errors(got, want, shape, ntg, tol) -> dict:
    """The comparison must fail outputs whose deposits went to the wrong
    place: x and y swapped, z off by one voxel, the gate off by one, the
    exitance image transposed.  Returns, for each, the largest cell
    difference it makes, as a share of the array's largest value."""
    nx, ny, nz = shape
    flu = got[1].reshape(nx, ny, nz, ntg)
    mutations = {
        "fluence x/y swapped": ("fluence", 1, flu.transpose(0, 1)),
        "fluence z off by one": ("fluence", 1, flu.roll(1, dims=2)),
        "exitance transposed": ("exitance", 2, got[2].reshape(nx, ny).T),
    }
    if ntg > 1:
        mutations["fluence gate off by one"] = ("fluence", 1,
                                                flu.roll(1, dims=3))
    seen = {}
    for what, (name, i, wrong) in mutations.items():
        bad = list(got)
        bad[i] = wrong.reshape(-1)
        diffs, fails = measure(bad, want, tol)
        check(bool(fails), f"the comparison misses {what}")
        seen[what] = diffs[name]["cell_max_rel_to_max"]
    return seen


def measure_groups(got, want, base, groups, tol):
    """A group variant's outputs against the plain version's on the same
    inputs, and its lane state against the base variant's: ``(diffs,
    failures)``.  Per-lane outputs (ppath, records, stats) must be
    bit-equal on the lanes whose state agrees; grids are held by
    ``cells``."""
    diffs, fails = measure(got[:5], want[:5], tol)
    for name, x, y in zip(got[0]._fields, got[0], base[0]):
        if not torch.equal(x, y):
            fails.append(f"lane state {name} changes with groups {groups}")
    for i, name in ((3, "escaped"), (4, "timed")):
        if not torch.equal(got[i], base[i]):
            fails.append(f"{name} weight changes with groups {groups}")
    same = (got[0].alive == want[0].alive) & (
        got[0].ivox == want[0].ivox).all(dim=1)
    names = []
    if groups & DET:
        names += ["ppath", "det_w", "det_ppath"]
    if groups & RECORD:
        names += ["cap_det", "cap_gate"]
    if groups & JAC:
        names += ["jac"]
    if groups & STATS:
        names += ["stats"]
    check(len(got) == len(want) == 5 + len(names),
          f"groups {groups}: {len(got)} outputs, plain {len(want)}")
    for name, a, b in zip(names, got[5:], want[5:]):
        if name in ("ppath", "cap_det", "cap_gate", "stats"):
            if not torch.equal(a[same], b[same]):
                fails.append(f"{name} differs from the plain version")
            diffs[name] = {"lanes_equal": int(
                (a == b).reshape(a.shape[0], -1).all(dim=1).sum())}
            if name == "cap_det":
                diffs[name]["captures"] = int((b >= 0).sum())
        else:
            cells(name, a, b, tol, fails, diffs)
            diffs["max_abs_err"] = max(diffs["max_abs_err"],
                                       diffs[name]["cell_max_abs"])
    return diffs, fails


def check_groups_see_index_errors(got, want, base, groups, n_det, ntg,
                                  jac_cols, tol) -> dict:
    """The group comparison must fail a TPSF and path sums with the
    detectors rolled by one, a TPSF with the gate off by one, and a
    Jacobian with the column off by one.  Returns the largest cell
    difference each makes, as a share of the grid's largest value."""
    mutations = {}
    if groups & DET:
        dw = got[6].reshape(n_det, ntg)
        mutations["detector index swapped"] = {
            6: dw.roll(1, dims=0).reshape(-1), 7: got[7].roll(1, dims=0)}
        mutations["gate off by one"] = {6: dw.roll(1, dims=1).reshape(-1)}
    if groups & JAC:
        i = 5 + (3 if groups & DET else 0) + (2 if groups & RECORD else 0)
        mutations["jacobian column off by one"] = {
            i: got[i].reshape(-1, jac_cols).roll(1, dims=1).reshape(-1)}
    seen = {}
    for what, swaps in mutations.items():
        bad = list(got)
        for i, wrong in swaps.items():
            bad[i] = wrong
        diffs, fails = measure_groups(bad, want, base, groups, tol)
        check(bool(fails), f"the group comparison misses {what}")
        seen[what] = fails
    return seen


def group_bound(groups, lanes, live, captures, ntg, n_det, n_media,
                jac_cols, state_lane_bytes) -> dict:
    """Least time of one launch, in ms, from the bytes it must move and
    the operations it must do on these inputs (HBM rate; float32 and
    special-function rates), as K1's bound counts them."""
    nvox = SIZE**3
    lane_bytes = 2 * state_lane_bytes + 8
    grid_bytes = nvox + 4 * nvox * ntg + 4 * SIZE * SIZE
    if groups & DET:   # ppath in and out; geometry in; TPSF, sums out
        lane_bytes += 8 * n_media
        grid_bytes += 12 * n_det + 4 * n_det * ntg + 4 * n_det * n_media
    if groups & RECORD:  # cap_det, cap_gate out
        lane_bytes += 8
    if groups & JAC:   # jac_w, jac_col in; the Jacobian out
        lane_bytes += 8
        grid_bytes += 4 * nvox * jac_cols
    if groups & STATS:  # the (n, 2) block out
        lane_bytes += 8
    hbm = lane_bytes * lanes + grid_bytes
    f32 = (F32_OPS_PER_SEGMENT + sum(
        ops for name, ops in GROUP_F32_OPS_PER_SEGMENT.items()
        if groups & K.GROUP_BITS[name])) * live
    if groups & DET:
        f32 += captures * (5 * n_det + 2 * n_media)
    bound = {"bytes": hbm / HBM_BYTES_PER_S * 1e3,
             "operations": max(f32 / F32_OPS_PER_S,
                               MUFU_OPS_PER_SEGMENT * live
                               / MUFU_OPS_PER_S) * 1e3}
    bound_by = max(bound, key=bound.get)
    return {"hbm_bytes": hbm, "f32_ops": f32, "bytes_ms": bound["bytes"],
            "operations_ms": bound["operations"], "bound_ms": bound[bound_by],
            "bound_by": bound_by}


# Regions of csrc/photon_step.cu (its "// --- NAME" markers) by how often
# a warp runs them: every segment it holds a live lane, every segment one
# of its lanes scatters, every segment one crosses an index mismatch, and
# once a launch.
SEGMENT_REGIONS = ("LOOP", "UNIFORMS", "HOP", "DROP", "BOUNDARY", "ROULETTE",
                   "DEPOSIT")
PATH_REGIONS = {"alive": SEGMENT_REGIONS, "scatter": ("SPIN",),
                "fresnel": ("Fresnel",),
                "launch": ("BLOCK", "LANE", "WRITE-BACK", "FLUSH")}


def path_counts(state, labels, media, shape, cfg, n_steps):
    """Lane-segments and warp-segments (32 consecutive lanes, as a launch
    whose lanes are all alive at its start runs them) of one launch on
    each path, walked with the plain step: alive, scattering (the step
    ends with no scattering length left), and crossing a wall where the
    refractive index changes (Fresnel, with reflection on)."""
    from repro_torch.core import photon as ph
    lanes, warps = collections.Counter(), collections.Counter()
    hi = torch.tensor(shape, device=labels.device) - 1
    walk = state
    for _ in range(n_steps):
        res = ph.step(walk, labels, media, shape, 1.0, cfg)
        alive = walk.alive
        scatter = alive & (res.state.s_left == 0)
        _, axis = ph._boundary_distance(walk.pos, walk.dir, walk.ivox)
        step = torch.sign(walk.dir.gather(1, axis[:, None])).to(torch.int32)
        nv = walk.ivox + torch.nn.functional.one_hot(axis, 3).to(
            torch.int32) * step
        oob = ((nv < 0) | (nv > hi)).any(dim=1)

        def label(v):
            v = torch.minimum(v.clamp(min=0), hi)
            return labels[(v[:, 0] * shape[1] + v[:, 1]) * shape[2] + v[:, 2]]

        n_next = media[torch.where(oob, 0, label(nv).long()), 3]
        n_cur = media[label(walk.ivox).long(), 3]
        fresnel = alive & ~scatter & ((n_next - n_cur).abs() > 1e-6) \
            if cfg.do_reflect else torch.zeros_like(alive)
        for name, m in (("alive", alive), ("scatter", scatter),
                        ("fresnel", fresnel)):
            lanes[name] += int(m.sum())
            warps[name] += int(m.reshape(-1, 32).any(dim=1).sum())
        walk = res.state
    n = state.w.numel()
    lanes["launch"], warps["launch"] = n, -(-n // 32)
    return dict(lanes), dict(warps)


def sass_issue(regions, lanes, warps) -> dict:
    """Least issue time of a launch from its SASS counts by region: with
    each warp running every path any of its lanes takes (``warps``), and
    were the lanes of a path packed into full warps (``lanes``)."""
    from repro_torch.kernels.photon_step import sass

    def per(counts):
        return {r: counts[path] for path, rs in PATH_REGIONS.items()
                for r in rs}
    hot = {path: sum(regions.get(r, {}).get("hot", 0) for r in rs)
           for path, rs in PATH_REGIONS.items()}
    return {"instructions": hot,
            "per_live_segment": {"crossing": hot["alive"],
                                 "scatter": hot["alive"] + hot["scatter"],
                                 "fresnel": hot["alive"] + hot["fresnel"]},
            "issue_ms_warps": sass.issue_ms(regions, per(warps)),
            "issue_ms_packed": sass.issue_ms(
                regions, {r: n / 32 for r, n in per(lanes).items()})}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device "
                 "(torch.cuda.is_available() is false)")
    from repro_torch.core import analysis as A
    from repro_torch.core import photon as ph
    from repro_torch.core import volume as V
    from repro_torch.detectors import as_detectors, det_geometry
    from repro_torch import replay as R
    from repro_torch.kernels.photon_step import ops, sass
    from repro_torch.kernels.photon_step import spec
    from repro_torch.kernels.photon_step.ref import photon_steps_ref
    from repro_torch.launch import simulate as launch
    from repro_torch.launch.kernel_timing import mid_run_state

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = nvidia_smi()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=card)

    # --- build ------------------------------------------------------------
    seconds = K.build_all()
    K.load(K.VALID_GROUPS)
    ptxas = {}
    for g in K.VALID_GROUPS:
        log = K.library_path(g).with_suffix(".log")
        ptxas[K.group_names(g)] = [
            ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or "spill" in ln] if log.exists() else []
    # SASS instructions by source region of the base and the detection
    # forward libraries, keyed by template flags ("reflect/taylor")
    sass_counts = {g: sass.library_counts(K.library_path(g))
                   for g in (0, DET | RECORD | STATS)}
    emit("build", seconds=seconds, variants=len(K.VALID_GROUPS),
         libraries=[K.library_path(g).name for g in K.VALID_GROUPS],
         ptxas=ptxas, sass={K.group_names(g): {
             inst: {r: c["hot"] for r, c in regions.items()}
             for inst, regions in counts.items()}
             for g, counts in sass_counts.items()})

    # --- kernel against the plain version -------------------------------------
    def kernel_vs_plain(vol, cfg, state, n_steps, reps, mutations=True):
        args = (vol.labels.reshape(-1), vol.media, state, vol.shape,
                vol.unitinmm, cfg, n_steps)
        got = K.photon_step_cuda(*args)
        again = K.photon_step_cuda(*args)
        want = photon_steps_ref(*args, accumulate=EXACT)
        torch.cuda.synchronize()
        for x, y in zip(got[0], again[0]):
            check(torch.equal(x, y), "two kernel runs differ in lane state")
        tol = cell_tol(state.w.numel(), n_steps)
        diffs = compare(got, want, tol)
        if mutations:
            diffs["mutations_seen"] = check_sees_index_errors(
                got, want, vol.shape, cfg.n_time_gates, tol)
        ms = time_cuda(lambda: K.photon_step_cuda(*args), reps)
        plain_ms = time_cuda(lambda: photon_steps_ref(*args), 2)
        # the plain version's own float32 fluence against the exact sum
        flu32, flu = photon_steps_ref(*args)[1].double(), want[1].double()
        diffs["plain_float32_cell_rel_to_exact"] = float(
            (flu32 - flu).abs().max() / flu.abs().max().clamp(min=1e-30))
        return got, diffs, ms, plain_ms

    shape = (SIZE, SIZE, SIZE)
    # the gated case: 4 gates over 0.02 ns (4.4 mm of flight at n = 1.37)
    # spread K = 8 segments over every gate and time some photons out; its
    # pencil is off the x = y diagonal, so swapped axes change whole cells
    off_axis = {"type": "pencil", "pos": [20.0, 35.0, 0.0]}
    for bench, ntg, tmax, src in (("B1", 1, None, None), ("B2", 1, None, None),
                                  ("B2", 4, 0.02, off_axis)):
        vol, cfg = launch.get_bench(bench, SIZE, dev)
        if tmax is not None:
            cfg = dataclasses.replace(cfg, n_time_gates=ntg, tmax_ns=tmax)
        state = ops.fresh_state(vol, CMP_LANES, seed=1234, source=src)
        _, diffs, ms, plain_ms = kernel_vs_plain(vol, cfg, state, CMP_K, 10)
        emit("kernel", bench=bench, lanes=CMP_LANES, k=CMP_K, ntg=ntg,
             tmax_ns=cfg.tmax_ns, start="fresh pencil photons",
             source=src or "default pencil", ms=ms,
             plain_ms=plain_ms, **diffs)

    # a mid-run state at the main path's shape (launch.kernel_timing), for
    # each template instantiation the main path launches (B1:
    # DO_REFLECT=false, B2: true)
    def mid_run(bench):
        vol, cfg = launch.get_bench(bench, SIZE, dev)
        cfg = dataclasses.replace(cfg, steps_per_round=K_MAIN)
        labels = vol.labels.reshape(-1)
        st, _ = mid_run_state(vol, cfg)
        _, diffs, ms, plain_ms = kernel_vs_plain(vol, cfg, st, K_MAIN, 20)
        args = (labels, vol.media, st, shape, 1.0, cfg, K_MAIN)
        host_loop_ms = time_cuda(lambda: K.photon_step_cuda(*args), 20,
                             backlog=False)
        # live lane-segments of this launch and its paths, counted by the
        # plain step, and the least time to issue its SASS
        lanes, warps = path_counts(st, labels, vol.media, shape, cfg, K_MAIN)
        live = lanes["alive"]
        issue = sass_issue(sass_counts[0][f"{int(cfg.do_reflect)}/0"],
                           lanes, warps)
        nvox, ntg = SIZE**3, cfg.n_time_gates
        # HBM bytes: lane state in and out (81 B a lane: the int64 rng
        # words take 16 B more each way than uint32 words would), escaped
        # and timed-out weight out, labels in, fluence and exitance out
        bytes_moved = (2 * spec.STATE_LANE_BYTES_PORT + 8) * LANES + nvox \
            + 4 * nvox * ntg + 4 * SIZE * SIZE
        bound = {"bytes": bytes_moved / HBM_BYTES_PER_S * 1e3,
                 "operations": max(F32_OPS_PER_SEGMENT * live / F32_OPS_PER_S,
                                   MUFU_OPS_PER_SEGMENT * live
                                   / MUFU_OPS_PER_S) * 1e3}
        bound_by = max(bound, key=bound.get)
        emit("kernel", bench=bench, lanes=LANES, k=K_MAIN,
             do_reflect=cfg.do_reflect,
             start="after 12 regenerate+kernel rounds", ms=ms,
             host_loop_ms=host_loop_ms, plain_ms=plain_ms,
             live_segments=live, hbm_bytes=bytes_moved,
             bytes_ms=bound["bytes"], operations_ms=bound["operations"],
             bound_ms=bound[bound_by], bound_by=bound_by,
             l2_atomics=live, l2_atomic_bytes=ATOMIC_BYTES_PER_SEGMENT * live,
             path_lanes=lanes, path_warps=warps, sass=issue, **diffs)
        return {"ms": ms, "host_loop_ms": host_loop_ms, "sass": issue,
                "plain_ms": plain_ms, "bound": bound,
                "max_abs_err": diffs["max_abs_err"],
                "max_rel_diff": diffs["state_max_rel"]}

    timed = {bench: mid_run(bench) for bench in ("B1", "B2")}

    # --- K2-K5: the optional groups against the plain version ----------------
    geom = det_geometry(as_detectors(DETECTORS), dev)
    n_det = len(DETECTORS)

    def group_kwargs(vol, state, groups, ntg, ppath):
        n = state.w.shape[0]
        kw = {}
        if groups & DET:
            kw.update(ppath=ppath, det_geom=geom)
        if groups & RECORD:
            kw["record"] = True
        if groups & JAC:
            gen = torch.Generator(device=dev).manual_seed(5)
            kw.update(jac_w=torch.rand(n, device=dev, generator=gen),
                      jac_col=torch.randint(0, n_det * ntg, (n,), device=dev,
                                            generator=gen, dtype=torch.int32),
                      jac_cols=n_det * ntg)
        if groups & STATS:
            kw["stats"] = True
        return kw

    def groups_vs_plain(vol, cfg, state, ppath, n_steps, reps, start):
        args = (vol.labels.reshape(-1), vol.media, state, vol.shape,
                vol.unitinmm, cfg, n_steps)
        ntg, n_media = cfg.n_time_gates, vol.media.shape[0]
        lanes = state.w.numel()
        tol = cell_tol(lanes, n_steps)
        base = K.photon_step_cuda(*args)
        # live lane-segments and captures of this launch, from the plain
        # version's stats block and records
        work = photon_steps_ref(*args, **group_kwargs(
            vol, state, DET | RECORD | STATS, ntg, ppath))
        live = float(work[-1][:, 0].double().sum())
        captures = int((work[8] >= 0).sum())
        out = {}
        for groups in CHECK_VARIANTS:
            kw = group_kwargs(vol, state, groups, ntg, ppath)
            got = K.photon_step_cuda(*args, **kw)
            again = K.photon_step_cuda(*args, **kw)
            want = photon_steps_ref(*args, **kw, accumulate=EXACT)
            torch.cuda.synchronize()
            for x, y in zip(list(got[0]) + list(got[5:]),
                            list(again[0]) + list(again[5:])):
                if x.dtype != torch.float32 or x.shape[0] == lanes:
                    check(torch.equal(x, y), "two kernel runs differ lane "
                          "by lane")
            diffs, fails = measure_groups(got, want, base, groups, tol)
            check(not fails, f"groups {K.group_names(groups)}: "
                  + "; ".join(fails))
            seen = check_groups_see_index_errors(
                got, want, base, groups, n_det, ntg, n_det * ntg, tol)
            ms = time_cuda(lambda: K.photon_step_cuda(*args, **kw), reps)
            host_loop_ms = time_cuda(lambda: K.photon_step_cuda(*args, **kw),
                                     reps, backlog=False)
            plain_ms = time_cuda(lambda: photon_steps_ref(*args, **kw), 2)
            bound = group_bound(groups, lanes, live, captures, ntg, n_det,
                                n_media, n_det * ntg,
                                spec.STATE_LANE_BYTES_PORT)
            emit("groups", variant=K.variant_name(groups, cfg),
                 rows=[r for b, r in GROUP_ROWS.items() if groups & b],
                 start=start, lanes=lanes, k=n_steps, ntg=ntg,
                 tmax_ns=cfg.tmax_ns, n_det=n_det, ms=ms,
                 host_loop_ms=host_loop_ms, plain_ms=plain_ms,
                 live_segments=live, captures=captures,
                 mutations_seen={k: v[0] for k, v in seen.items()},
                 **bound, **diffs)
            out[groups] = {"variant": K.variant_name(groups, cfg), "ms": ms,
                           "host_loop_ms": host_loop_ms, "plain_ms": plain_ms,
                           "max_abs_err": diffs["max_abs_err"], **bound}
        return out

    # fresh photons from a pencil under the first detector; 4 gates over
    # 0.02 ns spread K = 8 segments over every gate
    vol, cfg = launch.get_bench("B2", SIZE, dev)
    cfg = dataclasses.replace(cfg, n_time_gates=4, tmax_ns=0.02)
    state = ops.fresh_state(vol, CMP_LANES, seed=1234, source={
        "type": "pencil", "pos": [40.0, 30.0, 0.0]})
    groups_vs_plain(vol, cfg, state, torch.zeros(
        (CMP_LANES, vol.media.shape[0]), device=dev), CMP_K, 10,
        "fresh pencil photons at (40, 30, 0)")

    # a mid-run state at the detection path's shape, its per-medium
    # paths carried round to round as the simulator carries them
    vol, cfg = launch.get_bench("B2", SIZE, dev)
    cfg = dataclasses.replace(cfg, steps_per_round=K_MAIN,
                              n_time_gates=NTG_DETECT, tmax_ns=TMAX_DETECT)
    st, pp = mid_run_state(vol, cfg, groups=dict(det_geom=geom, record=True,
                                                 stats=True))
    timed_groups = groups_vs_plain(vol, cfg, st, pp, K_MAIN, 20,
                                   "after 12 regenerate+kernel rounds")
    cfg_detect = cfg

    # --- the launch's edge cases against the plain version -------------------
    # every lane dead at launch (each only draws its uniforms), a ragged
    # lane count with half-dead warps (both on the mid-run detection
    # state, base and detection forward), and every lane in one voxel
    # with one direction (fresh B1 pencil photons: the most deposits
    # into one cell)
    n_rag = LANES // 2 + 77
    half = (torch.arange(n_rag, device=dev) % 32) < 16
    ragged = ph.PhotonState(*(x[:n_rag] for x in st))
    vol1, cfg1 = launch.get_bench("B1", SIZE, dev)
    cfg1 = dataclasses.replace(cfg1, steps_per_round=K_MAIN)
    edge_cases = {
        "all lanes dead at launch": (
            vol, cfg, st._replace(alive=torch.zeros_like(st.alive)), pp),
        "ragged lane count, half-dead warps": (
            vol, cfg, ragged._replace(alive=ragged.alive & half),
            pp[:n_rag]),
        "every lane in one voxel, one direction": (
            vol1, cfg1, ops.fresh_state(vol1, LANES, seed=7), None)}
    for what, (v, c, s0, p0) in edge_cases.items():
        dead = what.startswith("all lanes dead")
        got, diffs, ms, plain_ms = kernel_vs_plain(v, c, s0, K_MAIN, 10,
                                                   mutations=not dead)
        if dead:
            for name, x, y in zip(got[0]._fields, got[0], s0):
                check(name == "rng" or torch.equal(x, y),
                      f"a lane dead at launch changed its {name}")
            check(not torch.equal(got[0].rng, s0.rng),
                  "lanes dead at launch drew no uniforms")
            check(all(float(x.abs().sum()) == 0 for x in got[1:5]),
                  "lanes dead at launch deposited weight")
        emit("kernel", case=what, lanes=s0.w.numel(), k=K_MAIN,
             ntg=c.n_time_gates, ms=ms, plain_ms=plain_ms, **diffs)
        if p0 is None:
            continue
        args = (v.labels.reshape(-1), v.media, s0, shape, 1.0, c, K_MAIN)
        kw = group_kwargs(v, s0, FORWARD, c.n_time_gates, p0)
        diffs, fails = measure_groups(
            K.photon_step_cuda(*args, **kw),
            photon_steps_ref(*args, **kw, accumulate=EXACT),
            K.photon_step_cuda(*args), FORWARD,
            cell_tol(s0.w.numel(), K_MAIN))
        check(not fails, f"{what}, detection forward: " + "; ".join(fails))
        emit("groups", case=what, variant=K.variant_name(FORWARD, c),
             lanes=s0.w.numel(), **diffs)

    # --- main path ------------------------------------------------------------
    launches = {}
    for bench in ("B1", "B2"):
        K.reset_launches()
        t0 = time.perf_counter()
        res = launch.main(["--bench", bench, "--photons", str(PHOTONS),
                           "--lanes", str(LANES), "--size", str(SIZE),
                           "--steps-per-round", str(K_MAIN)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = sum(K.photon_step_cuda.launches_by.values())
        rounds = res.steps // K_MAIN
        bal = A.energy_balance(res)
        check(int(res.n_launched) == PHOTONS, "n_launched != photons")
        check(float(res.launched_w) == PHOTONS, "launched_w != photons")
        check(abs(bal["residue_frac"]) < 1e-4,
              f"energy residue {bal['residue_frac']:.3e}")
        check(n >= rounds >= 1, f"{n} kernel launches for {rounds} rounds")
        check(bool(torch.isfinite(res.energy).all())
              and tuple(res.energy.shape) == shape, "energy grid malformed")
        extra = {}
        if bench == "B1":
            vol_b1 = V.benchmark_b1(shape)
            mu_fit = A.fit_axial_decay(res, vol_b1, (10, 35), axis_xy=(30, 30))
            mu_th = A.mu_eff_theory(0.005, 1.0, 0.01)
            check(0.9 * mu_th < mu_fit < 1.25 * mu_th,
                  f"B1 mu_fit {mu_fit:.4f} vs theory {mu_th:.4f}")
            extra = {"mu_fit": mu_fit, "mu_theory": mu_th}
        launches[bench] = n
        emit("main", bench=bench, photons=PHOTONS, lanes=LANES, k=K_MAIN,
             seconds=wall, photons_per_ms=PHOTONS / wall / 1e3,
             rounds=rounds, kernel_launches=n,
             kernel_share_of_wall=n * timed[bench]["ms"] / (wall * 1e3),
             absorbed=bal["absorbed"], escaped=bal["escaped"],
             timed_out=bal["timed_out"], residue_frac=bal["residue_frac"],
             **extra)

    # --- detection path ---------------------------------------------------
    K.reset_launches()
    t0 = time.perf_counter()
    run = launch.run(DETECT_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_variant = dict(K.photon_step_cuda.launches_by)
    res, rep = run.result, run.replay
    bal = A.energy_balance(res)
    check(int(res.n_launched) == PHOTONS, "n_launched != photons")
    check(float(res.launched_w) == PHOTONS, "launched_w != photons")
    check(abs(bal["residue_frac"]) < 1e-4,
          f"energy residue {bal['residue_frac']:.3e}")
    check(tuple(res.energy.shape) == shape + (NTG_DETECT,)
          and bool(torch.isfinite(res.energy).all()), "energy grid malformed")
    check(tuple(res.det_w.shape) == (n_det, NTG_DETECT)
          and bool(torch.isfinite(res.det_w).all()), "TPSF malformed")
    check(int(res.det_rec_overflow) == 0,
          f"{int(res.det_rec_overflow)} records overflowed")
    rec = R.detected_records(res)
    check(rep is not None and rep.n_records == rec.shape[0] > 0,
          "no replay of the records")
    exact_det = int((rep.replayed_det == rep.det).sum())
    exact_gate = int((rep.gate == rec[:, 3].astype(np.int32)).sum())
    check(exact_det == exact_gate == rep.n_records,
          f"{exact_det} / {exact_gate} of {rep.n_records} records replayed "
          f"at their detector / gate")
    med = A.jacobian_medium_sums(rep.jacobian, V.benchmark_b2(shape))
    ppath_sums = res.det_ppath.double().cpu().numpy()
    identity = np.abs(med - ppath_sums) / np.maximum(np.abs(ppath_sums),
                                                     1e-30)
    identity = float(identity[ppath_sums != 0].max())
    check(identity <= 1e-5 and (med[ppath_sums == 0] == 0).all(),
          f"Jacobian medium sums miss det_ppath by {identity:.3e} relative")
    per_det = np.zeros(n_det)
    np.add.at(per_det, rep.det, rep.w_exit.astype(np.float64))
    det_tot = res.det_w.double().sum(dim=1).cpu().numpy()
    w_exit_rel = float((np.abs(per_det - det_tot) / det_tot).max())
    check(w_exit_rel <= 1e-5, f"replayed exit weight misses det_w by "
          f"{w_exit_rel:.3e}")
    check(res.stats.escaped_w == np.float32(res.escaped_w.item()),
          "RoundStats.escaped_w != SimResult.escaped_w")
    check(int(res.stats.relaunched) == PHOTONS, "stats relaunched != photons")
    for groups, where in PATH_VARIANTS.items():
        name = K.variant_name(groups, cfg_detect)
        check(by_variant.get(name, 0) >= 1, f"{name} ({where}) never launched")
    rounds = res.steps // K_MAIN
    fwd_variant = K.variant_name(DET | RECORD | STATS, cfg_detect)
    check(by_variant[fwd_variant] == rounds,
          f"{by_variant[fwd_variant]} forward launches for {rounds} rounds")
    emit("detect", argv=DETECT_ARGV, seconds=wall,
         forward_seconds=run.seconds,
         photons_per_ms=PHOTONS / run.seconds / 1e3,
         rounds=rounds, residue_frac=bal["residue_frac"],
         records=rep.n_records, replay_seconds=run.replay_seconds,
         replay_records_per_ms=rep.n_records / run.replay_seconds / 1e3,
         records_exact=exact_det, identity_max_rel=identity,
         w_exit_max_rel=w_exit_rel, detected_w=det_tot.tolist(),
         lane_occupancy=res.stats.lane_occupancy(),
         launches_by_variant=by_variant)

    # --- replay launches at the replay's own shape ----------------------------
    # the detect run's records replayed again as replay_jacobian replays
    # them (batches of at most LANES records, gate-resolved), with every
    # launch's inputs kept by variant
    kept = collections.defaultdict(list)

    def keep(*args, **kw):
        kept[PASS_A if "ppath" in kw else PASS_B].append((args, kw))
        return K.photon_step_cuda(*args, **kw)

    vol = launch.get_bench("B2", SIZE, dev)[0]
    cfg_replay = dataclasses.replace(cfg_detect, collect_stats=True)
    jac_cols = n_det * NTG_DETECT
    n_lanes = min(LANES, rec.shape[0])
    replay_fn = R._build_replay_fn(vol.shape, vol.unitinmm, cfg_replay,
                                   n_lanes, None, geom, jac_cols, step=keep)
    for first in range(0, rec.shape[0], n_lanes):
        nb, id_lo, id_hi, col, active = R._batch_arrays(
            rec, first, n_lanes, True, NTG_DETECT)
        _, _, _, rdet = replay_fn(
            vol.labels.reshape(-1), vol.media,
            torch.tensor(id_lo.astype(np.int64), device=dev),
            torch.tensor(id_hi.astype(np.int64), device=dev),
            torch.tensor(col, device=dev), torch.tensor(active, device=dev),
            SEED)
        check(bool((rdet[:nb].cpu().numpy() == rec[first:first + nb, 2]
                    .astype(np.int32)).all()),
              "the replay again misses a record's detector")
    K.check_errors(dev)

    def replay_vs_plain(groups, launches):
        """Every launch of one replay pass against the plain version on
        its own inputs (as in the groups phase, the comparison's power
        shown on the first launch with a capture), then the kernel timed
        over all of them and the bound summed from each one's work."""
        lanes = launches[0][0][2].w.numel()
        n_media = vol.media.shape[0]
        tol = cell_tol(lanes, K_MAIN)
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        plain_ms, bounds, seen = [], [], {}
        max_abs = cell_rel = 0.0
        live_total, captures_total = 0.0, 0
        for i, (args, kw) in enumerate(launches):
            base = K.photon_step_cuda(*args)
            got = K.photon_step_cuda(*args, **kw)
            # live lane-segments, from the stats block of the same launch
            live = float(K.photon_step_cuda(*args, **kw, stats=True)[-1][
                :, 0].double().sum())
            torch.cuda.synchronize()
            start.record()
            photon_steps_ref(*args, **kw)
            stop.record()
            torch.cuda.synchronize()
            plain_ms.append(start.elapsed_time(stop))
            want = photon_steps_ref(*args, **kw, accumulate=EXACT)
            diffs, fails = measure_groups(got, want, base, groups, tol)
            check(not fails, f"replay {K.group_names(groups)} launch {i}: "
                  + "; ".join(fails))
            captures = int((want[8] >= 0).sum()) if groups & RECORD else 0
            if not seen and (captures or not groups & DET):
                seen = check_groups_see_index_errors(
                    got, want, base, groups, n_det, NTG_DETECT, jac_cols, tol)
            max_abs = max(max_abs, diffs["max_abs_err"])
            cell_rel = max([cell_rel] + [
                v["cell_max_rel_to_max"] for v in diffs.values()
                if isinstance(v, dict) and "cell_max_rel_to_max" in v])
            live_total += live
            captures_total += captures
            bounds.append(group_bound(groups, lanes, live, captures,
                                      NTG_DETECT, n_det, n_media, jac_cols,
                                      spec.STATE_LANE_BYTES_PORT))
        check(bool(seen), f"replay {K.group_names(groups)}: no launch "
              f"to show the comparison's power on")

        def launch_all(part):
            def go():
                for args, kw in part:
                    K.photon_step_cuda(*args, **kw)
            return go

        # back to back behind a spin kernel, 64 launches at a time so the
        # launch queue never fills while the spin holds the stream
        n = len(launches)
        ms = sum(time_cuda(launch_all(launches[i:i + 64]), 1, warmup=0)
                 for i in range(0, n, 64)) / n
        host_loop_ms = time_cuda(launch_all(launches), 1, warmup=0,
                                 backlog=False) / n
        mean = {k: sum(b[k] for b in bounds) / n
                for k in ("bytes_ms", "operations_ms", "bound_ms",
                          "hbm_bytes", "f32_ops")}
        out = {"variant": K.variant_name(groups, cfg_detect), "ms": ms,
               "host_loop_ms": host_loop_ms,
               "plain_ms": sum(plain_ms) / n, "max_abs_err": max_abs,
               "bound_ms": mean["bound_ms"],
               "bound_by": ("bytes" if mean["bytes_ms"] >= mean["operations_ms"]
                            else "operations")}
        emit("replay", rows=[r for b, r in GROUP_ROWS.items() if groups & b],
             lanes=lanes, k=K_MAIN, ntg=NTG_DETECT, jac_cols=jac_cols,
             launches=n, live_segments=live_total, captures=captures_total,
             cell_tol=tol, cell_max_rel_to_max=cell_rel,
             mutations_seen={k: v[0] for k, v in seen.items()},
             bytes_ms=mean["bytes_ms"], operations_ms=mean["operations_ms"],
             hbm_bytes_per_launch=mean["hbm_bytes"],
             f32_ops_per_launch=mean["f32_ops"], **out)
        return out

    for groups in (PASS_A, PASS_B):
        name = K.variant_name(groups, cfg_detect)
        check(len(kept[groups]) == by_variant[name],
              f"the replay again made {len(kept[groups])} launches of {name}, "
              f"the detect run {by_variant[name]}")
        timed_groups[groups] = replay_vs_plain(groups, kept.pop(groups))
    emit("replay", kernel_share_of_replay_wall=sum(
        by_variant[timed_groups[g]["variant"]] * timed_groups[g]["ms"]
        for g in (PASS_A, PASS_B)) / (run.replay_seconds * 1e3))

    # --- kernel table ---------------------------------------------------------
    # one kernel source, two instantiations: its times and bound are the
    # mean over the main run's launches of each
    total = sum(launches.values())

    def per_launch(get):
        return sum(launches[b] * get(timed[b]) for b in launches) / total

    bound = {k: per_launch(lambda t: t["bound"][k])
             for k in ("bytes", "operations")}
    bound_by = max(bound, key=bound.get)
    emit("wall", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [{
        "name": "photon_step_base", "route": "cuda",
        "source": "src/repro_torch/kernels/photon_step/csrc/photon_step.cu",
        "replaces": "src/repro/kernels/photon_step/photon_step.py:396",
        "launches": total,
        "max_abs_err": max(t["max_abs_err"] for t in timed.values()),
        "max_rel_diff": max(t["max_rel_diff"] for t in timed.values()),
        "ms": per_launch(lambda t: t["ms"]),
        "host_loop_ms": per_launch(lambda t: t["host_loop_ms"]),
        "plain_ms": per_launch(lambda t: t["plain_ms"]),
        "bound_ms": bound[bound_by], "bound_by": bound_by,
        "library_ms": None,
        "instantiations": [
            {"bench": b, "do_reflect": b == "B2", "launches": launches[b],
             "ms": timed[b]["ms"], "host_loop_ms": timed[b]["host_loop_ms"],
             "plain_ms": timed[b]["plain_ms"],
             "bound_ms": max(timed[b]["bound"].values())}
            for b in launches]}] + [{
        "name": "photon_step_" + K.group_names(g).replace("+", "_"),
        "route": "cuda",
        "source": "src/repro_torch/kernels/photon_step/csrc/photon_step.cu",
        "replaces": "src/repro/kernels/photon_step/photon_step.py:396",
        "variant": timed_groups[g]["variant"], "path": where,
        "rows": [r for b, r in GROUP_ROWS.items() if g & b],
        "launches": by_variant[timed_groups[g]["variant"]],
        "max_abs_err": timed_groups[g]["max_abs_err"],
        "ms": timed_groups[g]["ms"],
        "host_loop_ms": timed_groups[g]["host_loop_ms"],
        "plain_ms": timed_groups[g]["plain_ms"],
        "bound_ms": timed_groups[g]["bound_ms"],
        "bound_by": timed_groups[g]["bound_by"], "library_ms": None}
        for g, where in PATH_VARIANTS.items()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
