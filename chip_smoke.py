"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises, so the
script exits non-zero and prints no result:

  env      torch / CUDA versions and the card (nvidia-smi name, power limit)
  build    nvcc builds the photon-step kernel from csrc/ (seconds)
  kernel   the kernel against its plain PyTorch version on the card, from
           fresh pencil photons on 60^3 B1 and B2 (131072 lanes, K=8;
           B2 also with 4 time gates and an off-axis pencil), and on a
           mid-run B1 and B2 state at the main path's shape (262144
           lanes, K=16): rng bit-equal, alive/ivox equal on >= 99.99% of
           lanes, float state within 1e-5 relative, totals within 1e-5
           relative, every fluence / exitance cell and every lane's
           escaped / timed-out weight within 4 sqrt(lanes K) 2^-24 of
           its array's largest value, and that check failing on outputs
           with deposits moved to a wrong voxel, gate or exitance bin;
           kernel and plain times by CUDA events, and the bound of each
           mid-run launch
  main     repro_torch.launch.simulate.main for B1 and B2 at 60^3 with
           10^7 photons, 262144 lanes, K=16: exact photon accounting,
           energy-balance residue < 1e-4, the kernel launched at least
           once per round, B1's axial decay against diffusion theory
  kernels  one entry per kernel of the path (launches in the main run,
           error against the plain version; times and bound weighted by
           the main run's launches of each template instantiation)

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the repository's ``src/`` beside it, the script
exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

import torch

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

PHOTONS = 10_000_000
LANES = 262_144
K_MAIN = 16
CMP_LANES, CMP_K = 131_072, 8
SIZE = 60


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_cuda(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call by CUDA events."""
    for _ in range(warmup):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# Fluence and exitance are float32 sums of atomics in both versions, in
# an order that changes from run to run.  Between two orders, a cell of n
# deposits moves by about sqrt(n) * 2^-24 of its value (a random walk of
# rounding errors), and no cell takes more deposits than the launch has
# lane-segments.  Cells are therefore held to CELL_SIGMAS * sqrt(lanes *
# K) * 2^-24 of the array's largest value; mutation checks show that this
# still fails a wrong voxel, gate or exitance bin.  Totals are held to
# 1e-5 relative.
CELL_SIGMAS = 4.0
TOTAL_TOL = 1e-5


def cell_tol(n_lanes: int, n_steps: int) -> float:
    return CELL_SIGMAS * math.sqrt(max(n_lanes * n_steps, 1)) * 2.0**-24


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
    max_abs = max_rel = 0.0
    for name in ("pos", "dir", "w", "s_left", "t"):
        a, b = getattr(gs, name)[same].double(), getattr(ws, name)[same].double()
        d = (a - b).abs()
        if d.numel():
            max_abs = max(max_abs, float(d.max()))
            max_rel = max(max_rel, float((d / b.abs().clamp(min=1.0)).max()))
    if max_rel > 1e-5:
        fails.append(f"float state differs by {max_rel:.3e} relative")
    out = {"lanes_equal_frac": frac, "state_max_abs": max_abs,
           "state_max_rel": max_rel}
    for name, a, b in zip(("fluence", "exitance", "escaped", "timed"),
                          got[1:], want[1:]):
        if a.shape != b.shape:
            fails.append(f"{name} shape {tuple(a.shape)} != {tuple(b.shape)}")
            continue
        a, b = a.double(), b.double()
        ta, tb = float(a.sum()), float(b.sum())
        rel = abs(ta - tb) / max(abs(tb), 1e-12)
        if rel > TOTAL_TOL:
            fails.append(f"{name} totals differ by {rel:.3e} relative")
        if name in ("escaped", "timed"):  # per lane
            a, b = a[same], b[same]
        cell = float((a - b).abs().max()) if a.numel() else 0.0
        cell_rel = cell / max(float(b.abs().max()) if b.numel() else 0.0,
                              1e-12)
        if cell_rel > tol:
            fails.append(f"{name} differs by {cell_rel:.3e} of its largest "
                         f"value in some cell")
        max_abs = max(max_abs, cell)
        out[name] = {"total_rel": rel, "cell_max_abs": cell,
                     "cell_max_rel_to_max": cell_rel}
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
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    from repro_torch.core import analysis as A
    from repro_torch.core import photon as ph
    from repro_torch.core import simulator as S
    from repro_torch.core import volume as V
    from repro_torch.kernels.photon_step import ops
    from repro_torch.kernels.photon_step import photon_step as K
    from repro_torch.kernels.photon_step import spec
    from repro_torch.kernels.photon_step.ref import photon_steps_ref
    from repro_torch.launch import simulate as launch
    from repro_torch.sources import Pencil

    dev = torch.device("cuda")
    card = nvidia_smi()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=card)

    # --- build ------------------------------------------------------------
    seconds = K.load()
    log = K.library_path().with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    emit("build", seconds=seconds, library=str(K.library_path().name),
         ptxas=ptxas)

    # --- kernel against the plain version -------------------------------------
    def kernel_vs_plain(vol, cfg, state, n_steps, reps):
        args = (vol.labels.reshape(-1), vol.media, state, vol.shape,
                vol.unitinmm, cfg, n_steps)
        got = K.photon_step_cuda(*args)
        again = K.photon_step_cuda(*args)
        want = photon_steps_ref(*args)
        torch.cuda.synchronize()
        for x, y in zip(got[0], again[0]):
            check(torch.equal(x, y), "two kernel runs differ in lane state")
        tol = cell_tol(state.w.numel(), n_steps)
        diffs = compare(got, want, tol)
        diffs["mutations_seen"] = check_sees_index_errors(
            got, want, vol.shape, cfg.n_time_gates, tol)
        ms = time_cuda(lambda: K.photon_step_cuda(*args), reps)
        plain_ms = time_cuda(lambda: photon_steps_ref(*args), 2)
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

    # a mid-run state at the main path's shape, for each template
    # instantiation the main path launches (B1: DO_REFLECT=false, B2: true)
    def mid_run(bench):
        vol, cfg = launch.get_bench(bench, SIZE, dev)
        cfg = dataclasses.replace(cfg, steps_per_round=K_MAIN)
        src = Pencil()
        st = ops.fresh_state(vol, LANES, seed=99)._replace(
            alive=torch.zeros(LANES, dtype=torch.bool, device=dev))
        remaining = torch.tensor(PHOTONS, device=dev)
        launched = torch.zeros(LANES, dtype=torch.int64, device=dev)
        next_id = (torch.tensor(0, device=dev), torch.tensor(0, device=dev))
        labels = vol.labels.reshape(-1)
        for _ in range(12):
            st, remaining, launched, next_id, _ = S._regenerate(
                st, remaining, launched, next_id, None, src, 99, "dynamic",
                shape)
            st = K.photon_step_cuda(labels, vol.media, st, shape, 1.0, cfg,
                                    K_MAIN)[0]
        st, *_ = S._regenerate(st, remaining, launched, next_id, None, src,
                               99, "dynamic", shape)
        _, diffs, ms, plain_ms = kernel_vs_plain(vol, cfg, st, K_MAIN, 20)
        # live lane-segments of this launch, counted by the plain step
        live, walk = 0, st
        for _ in range(K_MAIN):
            live += int(walk.alive.sum())
            walk = ph.step(walk, labels, vol.media, shape, 1.0, cfg).state
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
             plain_ms=plain_ms, live_segments=live, hbm_bytes=bytes_moved,
             bytes_ms=bound["bytes"], operations_ms=bound["operations"],
             bound_ms=bound[bound_by], bound_by=bound_by,
             l2_atomics=live, l2_atomic_bytes=ATOMIC_BYTES_PER_SEGMENT * live,
             **diffs)
        return {"ms": ms, "plain_ms": plain_ms, "bound": bound,
                "max_abs_err": diffs["max_abs_err"],
                "max_rel_diff": diffs["state_max_rel"]}

    timed = {bench: mid_run(bench) for bench in ("B1", "B2")}

    # --- main path ------------------------------------------------------------
    launches = {}
    for bench in ("B1", "B2"):
        K.photon_step_cuda.launches = 0
        t0 = time.perf_counter()
        res = launch.main(["--bench", bench, "--photons", str(PHOTONS),
                           "--lanes", str(LANES), "--size", str(SIZE),
                           "--steps-per-round", str(K_MAIN)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = K.photon_step_cuda.launches
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

    # --- kernel table ---------------------------------------------------------
    # one kernel source, two instantiations: its times and bound are the
    # mean over the main run's launches of each
    total = sum(launches.values())

    def per_launch(get):
        return sum(launches[b] * get(timed[b]) for b in launches) / total

    bound = {k: per_launch(lambda t: t["bound"][k])
             for k in ("bytes", "operations")}
    bound_by = max(bound, key=bound.get)
    print(json.dumps({"kernels": [{
        "name": "photon_step_base", "route": "cuda",
        "source": "src/repro_torch/kernels/photon_step/csrc/photon_step.cu",
        "replaces": "src/repro/kernels/photon_step/photon_step.py:396",
        "launches": total,
        "max_abs_err": max(t["max_abs_err"] for t in timed.values()),
        "max_rel_diff": max(t["max_rel_diff"] for t in timed.values()),
        "ms": per_launch(lambda t: t["ms"]),
        "ms_per_launch": per_launch(lambda t: t["ms"]),
        "plain_ms": per_launch(lambda t: t["plain_ms"]),
        "bound_ms": bound[bound_by], "bound_by": bound_by,
        "library_ms": None,
        "instantiations": [
            {"bench": b, "do_reflect": b == "B2", "launches": launches[b],
             "ms": timed[b]["ms"], "plain_ms": timed[b]["plain_ms"],
             "bound_ms": max(timed[b]["bound"].values())}
            for b in launches]}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
