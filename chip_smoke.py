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
           lane, the fixed-point fluence and exitance grids bit-equal
           (also between two kernel runs), escaped / timed-out weight
           lane by lane within 4 sqrt(lanes K) 2^-24 of its largest
           value, and the check failing on outputs with deposits moved
           to a wrong voxel, gate or exitance bin; kernel and plain
           device times by CUDA events behind a spin kernel (the mid-run
           launches also as the host launches them), the bound of each
           mid-run launch, its lane- and warp-segments on each path
           (alive, scattering, Fresnel) and the least time to issue its
           SASS; then the launch's edge cases, base and detection
           forward: every lane dead at launch (only its uniforms drawn),
           a ragged lane count with half-dead warps, and every lane in
           one voxel with one direction
  groups   K2-K5, the optional groups (detectors, records, replay
           Jacobian, stats), each variant against the plain version on
           fresh B2 photons (60^3, 131072 lanes, K=8, 4 gates, three
           detectors) and on a mid-run B2 state at the detection path's
           shape (262144 lanes, K=16, 50 gates): ppath, records, stats,
           TPSF, detector path sums and the Jacobian (all fixed point)
           bit-equal, the lane state bit-equal with the groups on and
           off, and the checks failing a detector index swapped, a gate
           off by one and a Jacobian column off by one; times and bounds
           as for K1, the detection forward's launch timed with the
           round's tail and records, as that path launches it
  regenerate  the regeneration kernel (csrc/regenerate.cu) at the
           benchmark cells' shapes, b1.cw (a pencil, 262144 lanes) and
           b2.sweep (8 disks of 32768 lanes, per-lane paths), on a
           mid-run round with one lane in twelve dead: every field and
           counter bit-equal to PlainRegeneration on the card;
           device µs a call, host µs a call, the plain path's device
           and host ms, and the bytes bound
  tail     the step kernel's launch with and without the round's tail
           (RoundTail) at the K1 base row's shape (B1 60^3, a mid-run
           state of 262144 lanes, K=16) and the det/x8 row's (the optode
           sweep's batched launch of round KEEP_ROUND, 8 x 32768 lanes,
           50 gates, 3 detectors): the tail equal to the plain version's,
           device ms a launch of each and what the tail adds
  records  the step kernel's launch with the tail, with and without the
           records' append (RoundRecords), at head5.td's shape (the
           five-layer head, 4 detectors, 50 gates, 262144 lanes, K=16,
           2^20 slots, a mid-run round): every output of the appending
           launch bit-equal to the launch without records and held to
           the plain version, the append bit-equal to
           simulator._append_records on the launch's captures, device µs
           of each launch, the plain append's device and host ms, the
           bounds, and a graphed run's RECORDS_KEY launches
  main     repro_torch.launch.simulate for B1 and B2 at 60^3 with 10^7
           photons, 262144 lanes, K=16: exact photon accounting,
           energy-balance residue < 1e-4, the kernel launched at least
           once per round and the regeneration kernel once a round,
           B1's axial decay against diffusion theory
  detect   the detection path at the same size: B2 with 50 gates over
           5 ns, three detectors, 2^20 record slots, gate-resolved replay
           and round stats: exact accounting, no record overflow, every
           record replayed at its detector and gate, the Jacobian's
           medium sums equal to det_ppath within 1e-5, the stats'
           escaped weight equal to the result's
  replay   the detect run's records replayed again, each pass in a few
           launches of up to 4095 segments, and in rounds of K=16 (the
           launch schedule of the parent design) in turns: walls,
           records/ms and launches a pass; every output bit-equal
           between all of them and the detect run's replay; the largest
           Jacobian cell and the smallest deposit against the fixed-point
           range; every launch of pass A (det+record) and pass B (jac)
           held against the plain version on its own inputs at the
           replay's lane count, as in the groups phase, and timed, with
           its bound from the Jacobian cells it reaches
  sources  every source type of the menu (pencil, isotropic, cone,
           gaussian, disk, planar with a pattern, line as a slit and
           isotropic) through the CLI on B2 at 60^3 with 10^6 photons:
           n_launched equal to the photons, residue < 1e-4
  determinism  the detection forward of the detect run again (10^7
           photons, 50 gates, 3 detectors, records, stats): every field
           of the result bit-equal between the two runs
  scenarios  two fleets of 8 scenarios, each through
           scenarios.simulate_many as one round loop with one launch a
           round of 262144 lanes (32768 a scenario): an optode sweep
           (disk sources stepping towards three detectors, B2 at 60^3,
           10^6 photons each, 50 gates) and pencil replicates on B1 with
           disjoint id ranges across 2^32; every scenario bit-equal to
           its own simulate_one, the fleet's photons/ms batched and
           sequential, the cache counters and spans from a Tracer, and
           one mid-run batched launch of each fleet held bit-equal to
           the plain version, timed, with its bound
  host     the CPU device's kernel (csrc/photon_step_cpu.cpp, built
           with g++ at first use) on the card machine's host, at the
           shapes the CPU runs: B1 and B2 base and the detection forward
           at CPU_LANES lanes (K=16, mid-run), base/x8 and det/x8 batched
           at as many lanes, and every launch of both replay passes on
           HOST_RECORDS of the detect run's records; each at one thread
           and on every core, adding into run totals, every output
           bit-equal to the plain version, the comparison failing on
           index mutations; ms a launch at both thread counts and the
           plain version's, live lane-segments, a bound from the host's
           vector peak and a measured copy rate; B1 photons/ms on the CPU
           alone at one thread and on every core
  multidevice  the paths above one device, each device in a process
           of its own (core/procs.py; every process warm before a timed
           run), each against an earlier phase's result: B2 (10^7
           photons) in two shards of the card (0.7 / 0.3), every int64
           total bit-equal to the main run; the paper's mixed fleet on
           B1: card and CPU fitted by pilots in their processes,
           partitioned S1-S3, the S3 partition run over [cuda:0, cpu]
           (shares, the CPU's S3 share, its host-kernel launches,
           seconds, predicted and measured makespans); the
           CPU's photons run again on the card, cell by cell (CPU
           against CUDA bits); the resilience pool on B1 (2 10^6
           photons, 8 chunks, three workers on the card, one throttled)
           under a seeded chaos schedule, bit-equal to one run; the
           optode sweep over a mesh of two (each scenario bit-equal to
           its own simulate_one) and the detect run's replay over a
           mesh of two (every output bit-equal); the phase's seconds
           and its processes; each line with the card's name and power
           limit
  examples  the reference's four example scripts as modules of the port
           (repro_torch.examples), each through its run() at the
           reference's own sizes on the card (K = 16 where the reference
           runs K = 1: the same bits in a sixteenth of the rounds):
           quickstart (B1 60^3, 5 10^4 photons: exact accounting,
           residue < 1e-4, fitted mu_eff within 0.9-1.25 x diffusion
           theory), source_gallery (every source on B1 40^3, 2 10^4
           photons each: exact accounting, residues), heterogeneous_lb
           (pilot fit with a positive slope, S1-S3 partitions summing to
           the photons, the run over the local devices and the chunk
           scheduler, whose int64 totals equal the local run's) and
           fault_tolerant_campaign (the chaos drill and the crash and
           restart, each bit-equal to the clean run, every chunk merged,
           at least one retry); a line each with its seconds and
           photons/ms, and the phase's seconds, each with the card's
           name and power limit
  lint     both tiers of the port's lint on this tree (clean), and the
           lint's ``sim`` target recorded once more with its round loop
           on the card: device operations and host reads a round
  kernels  one entry per kernel variant the paths launch (launches in
           the main, detect and scenario runs, error against the plain
           version, times and bound at the shapes those runs give the
           variant; K1's weighted by the main runs' launches of each
           template instantiation; the appending kernel's launches in
           the detect run, its times at head5.td's shape), and the host
           kernel's (route "host": its launches in the mixed fleet's CPU
           share, its times on every core at that shape)

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the repository's ``src/`` beside it, the script
exits non-zero.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
try:
    from repro_torch.kernels.photon_step import photon_step as K
    from repro_torch.kernels.photon_step import regenerate as RG
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
# Each deposit is one 8 B integer atomic (64-bit fixed point).  The
# fluence grid (1.7 MB at 60^3) stays in the 50 MB L2, so the atomics
# resolve there and are not HBM traffic: they are reported apart, not in
# the bytes bound.
ATOMIC_BYTES_PER_SEGMENT = 8
# Bytes a cell of the fixed-point grids (fluence, exitance, TPSF, path
# sums): int64.
FIXED_BYTES = 8

# Extra float32 operations of the optional groups: per live segment the
# path's product and sum (detectors), the Jacobian's product and its
# index (replay), the two counter sums (stats); per capture 5 for each
# disk tested and 2 for each medium of the path sums.
GROUP_F32_OPS_PER_SEGMENT = {"n_det": 2, "record": 0, "jac_cols": 3,
                             "stats": 2}

PHOTONS = 10_000_000
LANES = 262_144
# the sources phase: every source type on B2 at 60^3
SOURCE_PHOTONS = 1_000_000
# the scenarios phase: fleets of 8 scenarios of 10^6 photons, 32768
# lanes each (262144 in a launch); the inputs of the batched launch of
# round KEEP_ROUND are held against the plain version
SCENARIOS = 8
SCENARIO_PHOTONS = 1_000_000
SCENARIO_LANES = 32_768
KEEP_ROUND = 12
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
# the multidevice phase: B2 over two shards of one card, split 0.7 /
# 0.3; the mixed CPU+GPU fleet on B1 (the volume of the reference's
# Fig. 3b pilot), fitted by pilots (the card at the paper's 10^6 and
# 5 10^6 photons, the CPU's host kernel, at CPU_LANES lanes on the cores
# the card's process leaves, at eight and 32 times its lanes: on the card
# machine's host 8192 lanes ran B1 fastest on 7 threads, 44.9-45.8
# photons/ms against 28.1-29.3 at 2048 and 38.1-38.5 at 32768 lanes
# (launch/multidevice_timing.py), and a pilot of fewer photons is mostly
# its longest trajectory's rounds: pilots at two and 16 times the lanes
# fitted 64.7 photons/ms, and the share then ran at 36.2) and given
# the budget whose S3
# makespan is the CPU's fitted overhead plus MIXED_MARGIN_S, within
# MIXED_MAKESPAN_S (the margin sets most of the phase's time); the pool
# on B1 with POOL_PHOTONS in chunks of POOL_CHUNK, three workers on the
# card, one throttled, under a seeded chaos schedule
SHARD_SPLIT = 0.7
CPU_LANES = 8192
GPU_PILOT = (1_000_000, 5_000_000)
GPU_PILOT_REPEATS = 3
CPU_PILOT = (8 * CPU_LANES, 32 * CPU_LANES)
MIXED_MARGIN_S, MIXED_MAKESPAN_S = 1.5, (4.0, 15.0)
# the mixed fleet's step cap: the card's share of a makespan of up to 15 s
# runs ~115,000 rounds of K = 16 at ~0.13 ms a round, and B1's default
# cap of 500,000 segments (31,250 rounds, ~4 s) stopped a 4 s share at
# 640,974,941 of ~645 million photons on an H100
MIXED_MAX_STEPS = 4_000_000
POOL_PHOTONS, POOL_CHUNK = 2_000_000, 250_000
POOL_THROTTLE_S, POOL_TIMEOUT_S = 0.5, 0.3
# its fault schedule: with these chunks, chunk 750000 is corrupted at its
# first attempt, chunks 1500000 and 1750000 fail three dispatches, and
# worker w1 leaves the fleet after two
POOL_CHAOS = dict(seed=4, p_fail=0.25, p_nan=0.25, p_delay=0.25,
                  delay_s=0.4, dropout={"w1": 2})
# the host phase: the host kernel at the shapes the CPU runs (the mixed
# fleet's share: CPU_LANES lanes, K = 16; the detection forward and two
# batched fleets of 8 scenarios at as many lanes; HOST_RECORDS of the
# detect run's records replayed, both passes), at one thread and on
# every core, against the plain version; B1 on the CPU alone at
# HOST_SIM_PHOTONS photons.  The host's bound: float32 lanes of a vector
# at torch's CPU capability, HOST_VECTOR_OPS vector operations a cycle
# a core (two FMA ports), at the clock /proc/cpuinfo reports, and the
# memory rate of a copy measured in the phase
HOST_RECORDS = 2048
HOST_SIM_PHOTONS = 65536
HOST_VECTOR_LANES = {"AVX512": 16, "AVX2": 8}
HOST_VECTOR_OPS = 2
# the examples phase: each of the reference's example scripts at its own
# sizes (the defaults of repro_torch.examples, which run
# examples.STEPS_PER_ROUND segments a round), on the card
EXAMPLES = {
    "quickstart": dict(size=60, photons=50_000, lanes=4096),
    "source_gallery": dict(size=40, photons=20_000, lanes=2048),
    "heterogeneous_lb": dict(size=40, photons=40_000, pilot=(4000, 20_000),
                             lanes=2048, chunk_lanes=1024),
    "fault_tolerant_campaign": dict(size=30, photons=20_000, chunk=2_000,
                                    lanes=1024),
}
# B1's axial attenuation against diffusion theory (PERF.md section 2)
MU_EFF_RATIO = (0.9, 1.25)
# the port's tolerance between two arithmetics (its tests against the
# JAX package, tests/test_torch_simulator.py): totals within 2e-3 of the
# launched weight, fluence within 1e-3 of its largest cell
TOTALS_TOL, GRID_TOL = 2e-3, 1e-3
# the int64 grids and totals of a FixedResult
FIXED_GRIDS = ("fluence", "exitance", "det_w", "det_ppath")
FIXED_TOTALS = ("escaped", "timed_out", "launched_w", "n_launched")

# the group bits of the kernel's variants, as the wrapper sets them
DET, RECORD, JAC, STATS = (K.GROUP_BITS[g]
                           for g in ("n_det", "record", "jac_cols", "stats"))
GROUP_ROWS = {DET: "K2", RECORD: "K3", JAC: "K4", STATS: "K5"}
# the variants the detection path launches, and where
FORWARD, PASS_A, PASS_B = DET | RECORD | STATS, DET | RECORD, JAC
PATH_VARIANTS = {FORWARD: "detection forward", PASS_A: "replay pass A",
                 PASS_B: "replay pass B"}
# the variants held against the plain version: each group alone, and
# the detection path's (the replay's two among them)
CHECK_VARIANTS = (DET, DET | RECORD, JAC, STATS, FORWARD)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def issued_rounds(rounds: int) -> int:
    """Rounds a run issues for ``rounds`` with work: the loop reads the
    host once every ``ROUNDS_PER_READ`` rounds, and the rounds after the
    last with work up to the next read are no-ops."""
    from repro_torch.core.simulator import ROUNDS_PER_READ as every

    return -(-rounds // every) * every


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


# Fluence, exitance, TPSF, detector path sums and the replay Jacobian
# are int64 fixed point in the kernel and in the plain version, each
# deposit rounded the same way, so they are held bit for bit.  Per-lane
# float outputs (escaped and timed-out weight) are held lane by lane to
# CELL_SIGMAS * sqrt(lanes * K) * 2^-24 of the array's largest value
# (they are bit-equal where the lane state is), and totals to 1e-5
# relative.
CELL_SIGMAS = 4.0
TOTAL_TOL = 1e-5


def cell_tol(n_lanes: int, n_steps: int) -> float:
    return CELL_SIGMAS * math.sqrt(max(n_lanes * n_steps, 1)) * 2.0**-24


def as_float(name, x):
    """A fixed-point grid (int64) as the float values it holds."""
    from repro_torch.kernels.photon_step import spec
    from repro_torch.core.fixed import from_fixed
    if x.dtype == torch.int64:
        return from_fixed(x, spec.FIXED_SHIFT[name]).double()
    return x.double()


def cells(name, a, b, tol, fails, out, lanes=None):
    """Hold an accumulated array against the plain version's.  A
    fixed-point grid (int64) must be bit-equal.  A float array: total
    within TOTAL_TOL relative, every cell (or, for a per-lane array,
    every lane of the ``lanes`` mask) within ``tol`` of the largest
    value, so a deposit into a wrong cell fails even where the totals
    agree.  Adds the numbers to ``out[name]`` and failures to ``fails``."""
    if a.shape != b.shape:
        fails.append(f"{name} shape {tuple(a.shape)} != {tuple(b.shape)}")
        return
    if b.dtype == torch.int64 and not torch.equal(a, b):
        fails.append(f"{name}: fixed-point grid not bit-equal to the plain "
                     f"version ({int((a != b).sum())} cells differ)")
    a, b = as_float(name, a), as_float(name, b)
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
                jac_cols, state_lane_bytes, scenarios: int = 1,
                grid_bytes=None, nvox: int = SIZE**3) -> dict:
    """Least time of one launch, in ms, from the bytes it must move and
    the operations it must do on these inputs (HBM rate; float32 and
    special-function rates), as K1's bound counts them.  ``lanes`` are
    all the launch's lanes; a launch of ``scenarios`` scenarios reads
    their shared labels once and writes each one's grids.  A launch that
    adds into run totals moves only the cells its deposits reach, and
    a replay launch only those of the grids the replay reads: its
    caller passes their bytes as ``grid_bytes`` (the whole grids are
    counted otherwise).  ``nvox``: the labels' voxels."""
    grid_override = grid_bytes
    lane_bytes = 2 * state_lane_bytes + 8
    grid_bytes = (FIXED_BYTES * nvox * ntg + FIXED_BYTES * SIZE * SIZE
                  + 16 * n_media)
    if groups & DET:   # ppath in and out; geometry in; TPSF, sums out
        lane_bytes += 8 * n_media
        grid_bytes += (12 * n_det + FIXED_BYTES * n_det * ntg
                       + FIXED_BYTES * n_det * n_media)
    if groups & RECORD:  # cap_det, cap_gate out
        lane_bytes += 8
    if groups & JAC:   # jac_w, jac_col in; the Jacobian out
        lane_bytes += 8
        grid_bytes += FIXED_BYTES * nvox * jac_cols
    if groups & STATS:  # the (n, 2) block out
        lane_bytes += 8
    if grid_override is not None:
        grid_bytes = grid_override
    else:
        grid_bytes *= scenarios
    hbm = lane_bytes * lanes + nvox + grid_bytes
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


def equal_outputs(a, b) -> bool:
    """Two outputs of a launch (a tensor, a ``PhotonState`` or None) bit
    for bit."""
    if isinstance(a, tuple):
        return all(equal_outputs(x, y) for x, y in zip(a, b))
    return a is b is None or (a is not None and b is not None
                              and torch.equal(a, b))


def fixed_differences(a, b) -> list[str]:
    """The int64 grids and totals of two FixedResults that differ."""
    return [f for f in FIXED_GRIDS + FIXED_TOTALS
            if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())]


def kernel_counts() -> dict:
    """``launches_by`` less the keys that count no kernel launch:
    ``TAIL_KEY`` and ``RECORDS_KEY`` count the launches that did the
    round's tail and appended its records once more beside their
    variant, and ``round_graph`` counts graph replays, whose kernels are
    counted under their own keys."""
    return {k: n for k, n in K.photon_step_cuda.launches_by.items()
            if not k.endswith((K.TAIL_KEY, K.RECORDS_KEY))
            and k != "round_graph"}


def launched_kernels() -> int:
    return sum(kernel_counts().values())


def step_launches() -> int:
    """Photon-step launches alone (the regeneration kernel's calls are
    counted under ``regenerate/...`` beside them)."""
    return sum(n for k, n in kernel_counts().items()
               if not k.startswith("regenerate/"))


def host_clock_hz() -> float:
    """The host's fastest core clock, as /proc/cpuinfo reports it."""
    with open("/proc/cpuinfo") as f:
        mhz = [float(ln.split(":")[1]) for ln in f if ln.startswith("cpu MHz")]
    check(bool(mhz), "/proc/cpuinfo reports no clock")
    return max(mhz) * 1e6


def host_memory_rate(threads: int) -> float:
    """Bytes a second of a 256 MiB float32 copy on the host (read and
    written), the best of three, on ``threads`` threads."""
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        src = torch.ones(1 << 26)
        dst = torch.empty_like(src)
        best = math.inf
        for _ in range(3):
            t0 = time.perf_counter()
            dst.copy_(src)
            best = min(best, time.perf_counter() - t0)
    finally:
        torch.set_num_threads(saved)
    return 2 * src.numel() * 4 / best


# The regeneration kernel at the benchmark cells' shapes: b1.cw (a pencil,
# 262144 lanes, one scenario) and b2.sweep (8 disks stepping along x,
# 32768 lanes each, three detectors), mid-run, where about one lane in
# twelve relaunches a round
REGEN_CELLS = {"b1.cw": ("B1", 1, LANES), "b2.sweep": ("B2", SCENARIOS,
                                                       SCENARIO_LANES)}
REGEN_DEAD = 1 / 12
# the bytes a relaunched lane writes: pos, dir, ivox, w, s_left, t, rng,
# alive, and its launch count read and written
REGEN_LANE_BYTES = 12 + 12 + 12 + 4 + 4 + 4 + 32 + 1 + 16


def regenerate_phase(card, reps: int = 200) -> dict:
    """The regeneration kernel (csrc/regenerate.cu) at each of
    ``REGEN_CELLS``: a mid-run round's lanes, one in twelve dead, every
    field and counter bit-equal to ``simulator.PlainRegeneration`` on the
    card; device µs a call (CUDA events behind a spin kernel, less the
    copy that makes the same lanes dead again before each call), the
    host's µs a call as the loop issues it (with that copy's issue), the
    plain path's device and host ms at the same shape, measured the same
    way, and the bytes bound.  Returns each cell's row."""
    from repro_torch import sources as SRC
    from repro_torch.core import photon as ph
    from repro_torch.core import simulator as S
    from repro_torch.core import volume as V
    from repro_torch.sources.base import StagedSampler

    dev = torch.device("cuda")
    rows = {}
    for cell, (bench, n_sc, n) in REGEN_CELLS.items():
        vol = (V.benchmark_b1 if bench == "B1" else V.benchmark_b2)(
            (SIZE,) * 3, dev)
        srcs = ([SRC.Pencil()] if n_sc == 1 else [
            SRC.Disk(pos=(16.0 + 2.0 * i, 30.0, 0.0), radius=2.0)
            for i in range(n_sc)])
        staged = [x.stage() for x in srcs]
        sample = StagedSampler(type(srcs[0]), {k: torch.as_tensor(np.stack(
            [np.asarray(st[k], np.float32) for st in staged]), device=dev)
            for k in staged[0]})
        N, i64 = n_sc * n, dict(dtype=torch.int64, device=dev)
        n_media = vol.media.shape[0] if n_sc > 1 else 0
        seeds = torch.full((n_sc, 1), SEED, **i64)
        ids = torch.arange(N, **i64).view(n_sc, n)
        pos, direc, w0, rng = (x.reshape((N,) + x.shape[2:]) for x in sample(
            S.xrng.PhotonId(ids, torch.zeros_like(ids)), seeds))
        g = torch.Generator().manual_seed(SEED)
        alive = (torch.rand(N, generator=g) >= REGEN_DEAD).to(dev)
        state = ph.launch(pos, direc, w0, rng, alive, vol.shape)
        remaining = torch.full((n_sc,), PHOTONS, **i64)
        launched = torch.ones((n_sc, n), **i64)
        quota = torch.ones((n_sc, n), **i64)
        next_id = (torch.full((n_sc,), N, **i64), torch.zeros((n_sc,), **i64))
        launched_w = torch.zeros((n_sc,), **i64)
        ppath = (torch.rand((N, n_media), generator=g).to(dev)
                 if n_media else None)
        def bound(cls):
            """``cls`` bound to clones of the round's lanes and counters,
            and the clones."""
            st = ph.PhotonState(*(x.clone() for x in state))
            rem, lau, lw = (x.clone() for x in (remaining, launched,
                                                launched_w))
            pp = None if ppath is None else ppath.clone()
            regen = cls(sample, "dynamic", vol.shape, rem, lau, quota, lw,
                        seeds, n_media)
            return regen, st, rem, lau, lw, pp

        plain, *want = bound(S.PlainRegeneration)
        want_id = tuple(x.clone() for x in plain(want[0], next_id, want[4]))
        regen, *got = bound(RG.Regeneration)
        got_id = regen(got[0], next_id, got[4])
        torch.cuda.synchronize()
        for name, x, y in zip(ph.PhotonState._fields, got[0], want[0]):
            check(torch.equal(x.view(torch.int32) if x.is_floating_point()
                              else x, y.view(torch.int32)
                              if y.is_floating_point() else y),
                  f"regenerate {cell}: {name} differs from PlainRegeneration")
        check(all(torch.equal(x, y) for x, y in zip(got[1:4], want[1:4]))
              and torch.equal(got_id[0], want_id[0])
              and torch.equal(got_id[1], want_id[1])
              and (got[4] is None or torch.equal(got[4].view(torch.int32),
                                                 want[4].view(torch.int32))),
              f"regenerate {cell}: a counter differs from PlainRegeneration")
        relaunched = int((~alive).sum())
        check(int(want[1].sum()) == n_sc * PHOTONS - relaunched,
              f"regenerate {cell}: {relaunched} dead lanes, budget "
              f"{int(want[1].sum())}")

        def again(fn, st, pp):
            """A call of ``fn`` on the same dead lanes as the first."""
            def call():
                st.alive.copy_(alive)
                fn(st, next_id, pp)
            return call

        call = again(regen, got[0], got[4])
        plain_call = again(plain, want[0], want[4])
        copy_ms = time_cuda(lambda: got[0].alive.copy_(alive), reps)
        device_us = (time_cuda(call, reps) - copy_ms) * 1e3
        host_us = time_cuda(call, reps, backlog=False) * 1e3
        plain_ms = time_cuda(plain_call, 20) - copy_ms
        plain_host_ms = time_cuda(plain_call, 20, backlog=False)
        moved = N + relaunched * (REGEN_LANE_BYTES + 4 * n_media)
        rows[cell] = dict(
            source=type(srcs[0]).type_name, scenarios=n_sc, lanes=N,
            relaunched=relaunched, device_us=device_us, host_us=host_us,
            plain_device_ms=plain_ms, plain_host_ms=plain_host_ms,
            bytes=moved, bound_us=moved / HBM_BYTES_PER_S * 1e6,
            bound_by="bytes", bit_equal=True)
        emit("regenerate", cell=cell, card=card, **rows[cell])
    return rows


def tail_phase(card, reps: int = 20) -> dict:
    """The step kernel's launch with and without the round's tail
    (``photon_step.RoundTail``), at the K1 base row's shape (B1 60^3, a
    mid-run state of 262144 lanes, K=16, ``kernel_timing.mid_run_state``)
    and at the det/x8 row's (the optode sweep's batched launch of round
    KEEP_ROUND, its inputs kept from an eager run of the fleet): the
    tail held equal to the plain version's tail on the launch's own
    outputs; device ms a launch of each (CUDA events behind a spin
    kernel, adding into scratch totals) and the µs the tail adds.
    Returns each row."""
    from repro_torch import scenarios as SC
    from repro_torch.core import volume as V
    from repro_torch.kernels.photon_step import ref as R
    from repro_torch.launch import simulate as launch
    from repro_torch.launch.kernel_timing import kept_launch, mid_run_state

    dev = torch.device("cuda")
    i64 = dict(dtype=torch.int64, device=dev)
    cases = {}
    vol, cfg = launch.get_bench("B1", SIZE, dev)
    cfg = dataclasses.replace(cfg, steps_per_round=K_MAIN)
    st, _ = mid_run_state(vol, cfg)
    cases["K1 base"] = ((vol.labels.reshape(-1), vol.media, st, vol.shape,
                         1.0, cfg, K_MAIN), {})
    # the optode sweep's launch of round KEEP_ROUND, from an eager run
    vol_b2 = V.benchmark_b2((SIZE,) * 3)
    cfg_sweep = dataclasses.replace(V.b2_config(), steps_per_round=K_MAIN,
                                    n_time_gates=NTG_DETECT,
                                    tmax_ns=TMAX_DETECT)
    fleet = [SC.Scenario(vol_b2, cfg_sweep, SCENARIO_PHOTONS, seed=SEED,
                         source={"type": "disk",
                                 "pos": [16.0 + 2.0 * i, 30.0, 0.0],
                                 "radius": 2.0}, detectors=DETECTORS,
                         id_offset=i * SCENARIO_PHOTONS)
             for i in range(SCENARIOS)]
    cases["K2 det/x8"] = kept_launch(lambda: SC.simulate_many(
        fleet, n_lanes=SCENARIO_LANES, device=dev, cache=SC.CompileCache()),
        KEEP_ROUND)
    rows = {}
    for name, (args, kw) in cases.items():
        n_sc = args[1].shape[0] if args[1].ndim == 3 else 1

        def scratch():
            out = dict(kw)
            if "totals" in kw:
                out["totals"] = [t.clone() for t in kw["totals"]]
            return out

        remaining = torch.full((n_sc,), PHOTONS, **i64)
        tail = K.round_tail(torch.zeros((n_sc,), **i64),
                            torch.zeros((n_sc,), **i64), remaining)
        got = K.photon_step_cuda(*args, **scratch(), tail=tail)
        plain = K.photon_step_cuda(*args, **scratch())
        want = K.round_tail(torch.zeros((n_sc,), **i64),
                            torch.zeros((n_sc,), **i64), remaining)
        R.round_tail_ref(want, plain[3], plain[4], plain[0].alive)
        K.check_errors(dev)
        for x, y in zip(got[0], plain[0]):
            check(torch.equal(x, y), f"tail {name}: the lane state differs")
        for field, x, y in zip(K.RoundTail._fields, tail, want):
            check(torch.equal(x, y), f"tail {name}: {field} differs from "
                  f"the plain version's tail")
        totals = scratch()
        ms = time_cuda(lambda: K.photon_step_cuda(*args, **totals), reps)
        ms_tail = time_cuda(lambda: K.photon_step_cuda(*args, **totals,
                                                       tail=tail), reps)
        rows[name] = dict(variant=K.variant_name(
            K.group_mask(n_det=len(DETECTORS) if "ppath" in kw else 0),
            args[5]) + (f"/x{n_sc}" if n_sc > 1 else ""),
            lanes=args[2].w.numel(),
            k=K_MAIN, ms=ms, ms_tail=ms_tail,
            tail_us=(ms_tail - ms) * 1e3, tail_equal_to_plain=True)
        emit("tail", row=name, card=card, **rows[name])
    return rows


# the records phase: head5.td's launch of round RECORDS_ROUND (photons
# live ~68 rounds there), appending to a buffer of HEAD5_RECORD_SLOTS
# slots that holds RECORDS_KEPT rows, about half a solution's
RECORDS_ROUND = 60
RECORDS_KEPT = 8_000
# bytes of one record row: [id_lo, id_hi, det, gate], int64
RECORD_ROW_BYTES = 32


def records_phase(card, reps: int = 20) -> dict:
    """The step kernel's launch with the round's tail, with and without
    the records' append (``photon_step.RoundRecords``, which
    ``photon_step_append_kernel`` does), at head5.td's shape (the
    five-layer head, four detectors, 50 gates, 262144 lanes, K=16, 2^20
    record slots; the launch of round RECORDS_ROUND, its inputs kept from
    an eager run), each launch adding into fresh copies of the run's
    totals.  The appending launch gives every output of the launch
    without records bit for bit (lane state, fluence, exitance, paths,
    TPSF, path sums, captures, the tail), and so of the launch without a
    tail, whose per-lane weights give its tail (``ref.round_tail_ref``);
    with those weights its outputs are held to the plain version
    (``ref.photon_steps_ref``) as the groups phase holds a launch; its
    rows, kept and overflow counts are ``simulator._append_records``' on
    the launch's captures and on the plain version's.  Device µs of each
    launch (CUDA events behind a spin kernel), device and host ms of
    ``_append_records`` on those captures, the plain version's ms (its
    step, then ``_append_records``), the append's bytes bound (the
    capture flags read, RECORD_ROW_BYTES a row written, over HBM) and
    the launch's bound (``group_bound``: the cells its deposits reach,
    the append's staged and kept rows), and the ``RECORDS_KEY`` launches
    of a graphed run of 3*10^5 photons.  Returns the row."""
    from repro_torch.core import simulator as S
    from repro_torch.core import volume as V
    from repro_torch.kernels.photon_step import ref as R
    from repro_torch.kernels.photon_step import spec
    from repro_torch.launch.kernel_timing import kept_launch

    dev = torch.device("cuda")
    i64 = dict(dtype=torch.int64, device=dev)
    vol = V.benchmark_head5(dev)
    cfg = dataclasses.replace(V.head5_config(), steps_per_round=K_MAIN)
    cap = V.HEAD5_RECORD_SLOTS
    n_det, n_media = len(V.HEAD5_DETECTORS), vol.media.shape[0]

    def solve(photons):
        return S.simulate_fixed(vol, cfg, photons, LANES, seed=SEED,
                                source=V.HEAD5_SOURCE, device=dev,
                                detectors=V.HEAD5_DETECTORS,
                                record_detected=cap)

    args, kw = kept_launch(lambda: solve(3_000_000), RECORDS_ROUND)
    totals = kw.pop("totals")
    groups = K.group_mask(n_det=n_det, record=True, stats=bool(kw["stats"]))
    names = (["state", "fluence", "exitance", "escaped", "timed", "ppath",
              "det_w", "det_ppath", "cap_det", "cap_gate"]
             + (["stats"] if groups & STATS else []))

    def tail():
        return K.round_tail(torch.zeros((1,), **i64),
                            torch.zeros((1,), **i64),
                            torch.full((1,), PHOTONS, **i64))

    def buffers():
        return K.RoundRecords(
            torch.zeros((1, cap + 1, 4), **i64),
            torch.full((1,), RECORDS_KEPT, **i64), torch.zeros((1,), **i64),
            torch.randint(0, 2**32, (LANES, 2), **i64,
                          generator=torch.Generator(dev).manual_seed(1)),
            *K.record_scratch(1, LANES, dev))

    def launch(**extra):
        return K.photon_step_cuda(*args, **kw, **extra,
                                  totals=[t.clone() for t in totals])

    got, t_got, t_plain = buffers(), tail(), tail()
    outs = launch(tail=t_got, records=got)
    plain = launch(tail=t_plain)
    untailed = launch()
    want = R.photon_steps_ref(*args, **kw,
                              totals=[t.clone() for t in totals])
    base = K.photon_step_cuda(*args)
    K.check_errors(dev)
    check(len(outs) == len(plain) == len(untailed) == len(names),
          f"records: {len(outs)} outputs, {len(names)} expected")
    for name, x, y, z in zip(names, outs, plain, untailed):
        check(equal_outputs(x, y), f"records: {name} differs with the "
              f"append")
        check(name in ("escaped", "timed") or equal_outputs(x, z),
              f"records: {name} differs from the launch without a tail")
    t_want = tail()
    R.round_tail_ref(t_want, untailed[3], untailed[4], untailed[0].alive)
    for field, x, y, z in zip(K.RoundTail._fields, t_got, t_plain, t_want):
        check(torch.equal(x, y) and torch.equal(x, z),
              f"records: the tail's {field} differs with the append or "
              f"from the plain version's tail")
    # the appending launch's outputs, with the per-lane weights that its
    # tail added, against the plain version
    full = list(outs)
    full[3], full[4] = untailed[3], untailed[4]
    diffs, fails = measure_groups(full, want, base, groups,
                                  cell_tol(LANES, K_MAIN))
    check(not fails, "records against the plain version: " + "; ".join(fails))
    capd, capg = plain[8], plain[9]
    for what, (cd, cg) in (("the launch's", (capd, capg)),
                           ("the plain version's", (want[8], want[9]))):
        ref_buf = buffers()
        S._append_records(ref_buf.rec, ref_buf.kept, ref_buf.overflow,
                          ref_buf.lane_ids, cd, cg, cap)
        for field in ("rec", "kept", "overflow"):
            x, y = getattr(got, field), getattr(ref_buf, field)
            if field == "rec":
                x, y = x[:, :cap], y[:, :cap]
            check(torch.equal(x, y), f"records: {field} differs from "
                  f"_append_records' on {what} captures")
    check(not bool(got.counts.any()), "records: the block counts are not zero")
    captures = int((capd >= 0).sum())
    check(captures > 0, f"records: no capture in round {RECORDS_ROUND}")
    # live lane-segments from the plain version's stats block, and the
    # cells the launch's deposits reach in the run's totals
    work = R.photon_steps_ref(*args, **dict(kw, stats=True))
    live = float(work[-1][:, 0].double().sum())
    touched = sum(int((a != b).sum()) for a, b in zip(
        [outs[1], outs[2], outs[6], outs[7]], totals))
    blocks = got.counts.numel()
    # the append: each captured row staged, read back and written to the
    # buffer, its two id words read; each block's count written and read
    append_bytes = captures * (3 * RECORD_ROW_BYTES + 16) + 8 * blocks
    bound = group_bound(groups, LANES, live, captures, cfg.n_time_gates,
                        n_det, n_media, 0, spec.STATE_LANE_BYTES_PORT,
                        grid_bytes=2 * FIXED_BYTES * touched + 16 * n_media
                        + 12 * n_det + append_bytes,
                        nvox=vol.labels.numel())
    scratch = [t.clone() for t in totals]
    t_a, t_b = tail(), tail()
    ms = time_cuda(lambda: K.photon_step_cuda(*args, **kw, totals=scratch,
                                              tail=t_a), reps)
    timed = buffers()
    ms_rec = time_cuda(lambda: K.photon_step_cuda(
        *args, **kw, totals=scratch, tail=t_b, records=timed), reps)
    plain_buf = buffers()

    def plain_append():
        S._append_records(plain_buf.rec, plain_buf.kept, plain_buf.overflow,
                          plain_buf.lane_ids, capd, capg, cap)

    plain_append_ms = time_cuda(plain_append, reps)
    plain_host_ms = time_cuda(plain_append, reps, backlog=False)
    plain_step_ms = time_cuda(lambda: R.photon_steps_ref(
        *args, **kw, totals=scratch), 2)
    moved = LANES * 4 + RECORD_ROW_BYTES * captures
    # a graphed run: one append a step launch, every record kept
    K.reset_launches()
    res = solve(300_000)
    torch.cuda.synchronize()
    launches = dict(K.photon_step_cuda.launches_by)
    steps = step_launches()
    check(launches.get(K.RECORDS_KEY, 0) == steps == launches[K.TAIL_KEY]
          and launches["round_graph"] == steps - 1,
          f"records: {launches} for a graphed run")
    check(int(res.det_rec_overflow) == 0 and int(res.det_rec_n) > 0,
          "records: the graphed run kept no record or dropped some")
    row = dict(variant=K.variant_name(groups, cfg), lanes=LANES, k=K_MAIN,
               ntg=cfg.n_time_gates, slots=cap, round=RECORDS_ROUND,
               captures=captures, ms=ms, ms_records=ms_rec,
               append_us=(ms_rec - ms) * 1e3,
               plain_device_ms=plain_append_ms, plain_host_ms=plain_host_ms,
               plain_step_ms=plain_step_ms,
               plain_ms=plain_step_ms + plain_append_ms, bytes=moved,
               bound_us=moved / HBM_BYTES_PER_S * 1e6, bound_by="bytes",
               launch_bound_ms=bound["bound_ms"],
               launch_bound_by=bound["bound_by"],
               live_segments=live, cells_touched=touched,
               max_abs_err=diffs["max_abs_err"], outputs_bit_equal=True,
               bit_equal=True, record_launches=launches[K.RECORDS_KEY],
               step_launches=steps, records_kept=int(res.det_rec_n))
    emit("records", card=card, **row)
    return row


def host_phase(card, records, cfg_detect) -> dict:
    """The host kernel (csrc/photon_step_cpu.cpp, built with g++) on the
    card machine's CPU, at the shapes the CPU runs: each case at one
    thread and on every core, every output bit-equal to the plain
    version and between the two, adding into run totals as the
    simulator and the replay launch it; the comparison shown to catch
    index mutations; times per launch, the host's bound; B1 photons/ms
    on the CPU alone.  Returns the kernels-line row of the mixed fleet's
    shape (its launches come from the multidevice phase)."""
    from repro_torch import replay as R
    from repro_torch.detectors import as_detectors, det_geometry
    from repro_torch.kernels.photon_step import photon_step_cpu as H
    from repro_torch.kernels.photon_step import spec
    from repro_torch.launch import host_timing as HT
    from repro_torch.launch.simulate import get_bench

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    n_threads = HT.cores()
    threads = (1, n_threads)
    build_s = H.load()
    capability = torch.backends.cpu.get_cpu_capability()
    clock = host_clock_hz()
    peak_ops = (n_threads * HOST_VECTOR_LANES.get(capability, 4)
                * HOST_VECTOR_OPS * clock)
    mem_rate = host_memory_rate(n_threads)
    host = HT.cpu_name()
    emit("host", item="env", card=card, cpu=host, capability=capability,
         math=H.math_library(), build_s=build_s, threads=list(threads),
         clock_hz=clock, peak_f32_ops_per_s=peak_ops,
         memory_bytes_per_s=mem_rate, library=H.library_path().name)
    rows = {}

    def hold(name, args, kw, reps=HT.REPS, mutations=False):
        out = HT.time_launch(args, kw, threads, reps)
        got, want = out.pop("got"), out.pop("want")
        check(all(out["bit_equal"].values()), f"host kernel, {name}: not "
              f"bit-equal to the plain version ({out['bit_equal']})")
        lanes = args[2].w.numel()
        tol = cell_tol(lanes, args[6])
        diffs, fails = measure(got, want, tol)
        check(not fails, f"host kernel, {name}: {fails}")
        if mutations:
            out["mutations_seen"] = check_sees_index_errors(
                got, want, args[3], args[5].n_time_gates, tol)
        # each lane's state read and written, its escaped and timed-out
        # weight written, each grid cell the launch reached read and
        # written once (the run totals it adds into)
        cells = sum(int((g != 0).sum()) for g in HT.grids(want, kw))
        moved = (2 * spec.STATE_LANE_BYTES_PORT + 8) * lanes + 16 * cells
        bound = {"bytes": moved / mem_rate * 1e3,
                 "operations": (F32_OPS_PER_SEGMENT + MUFU_OPS_PER_SEGMENT)
                 * out["live_segments"] / peak_ops * 1e3}
        bound_by = max(bound, key=bound.get)
        row = {"lanes": lanes, "k": args[6], "scenarios":
               spec.scenario_count(args[1])[0], "ms": out["ms"][n_threads],
               "ms_1_thread": out["ms"][1], "plain_ms": out["plain_ms"],
               "plain_threads": out["plain_threads"],
               "live_segments": out["live_segments"],
               "ns_per_segment_thread": out["ns_per_segment_thread"],
               "cells_reached": cells, "bytes_ms": bound["bytes"],
               "operations_ms": bound["operations"],
               "bound_ms": bound[bound_by], "bound_by": bound_by,
               "max_abs_err": diffs["max_abs_err"]}
        rows[name] = row
        emit("host", item=name, card=card, bit_equal=out["bit_equal"],
             mutations_seen=out.get("mutations_seen"), **row)

    # the mixed fleet's shape and the detection forward, mid-run
    for name, bench, detect in (("B1 base", "B1", False),
                                ("B2 base", "B2", False),
                                ("detection forward", "B2", True)):
        vol, cfg = HT.case(bench, SIZE, detect)
        st, pp = HT.mid_flight(vol, cfg, CPU_LANES, detect)
        hold(name, (vol.labels.reshape(-1), vol.media, st, vol.shape,
                    vol.unitinmm, cfg, K_MAIN),
             HT.group_kwargs(vol, CPU_LANES, detect, pp),
             mutations=not detect)

    # two batched fleets of 8 scenarios, CPU_LANES lanes a launch: B1
    # replicates (base/x8) and B2 with 50 gates and three detectors
    # (det/x8), each scenario mid-run from its own seed
    for name, bench, detect in (("base/x8", "B1", False),
                                ("det/x8", "B2", True)):
        vol, cfg = HT.case(bench, SIZE, detect)
        per = CPU_LANES // SCENARIOS
        runs = [HT.mid_flight(vol, cfg, per, detect, seed=s)
                for s in range(SCENARIOS)]
        st = type(runs[0][0])(*[torch.cat(x) for x in
                                zip(*[r[0] for r in runs])])
        kw = {}
        if detect:
            kw = dict(ppath=torch.cat([r[1] for r in runs]),
                      det_geom=det_geometry(as_detectors(DETECTORS))[
                          None].repeat(SCENARIOS, 1, 1))
        hold(name, (vol.labels.reshape(-1),
                    vol.media[None].repeat(SCENARIOS, 1, 1).contiguous(),
                    st, vol.shape, vol.unitinmm, cfg, K_MAIN), kw)

    # the replay's two passes on HOST_RECORDS of the detect run's records,
    # each launch kept as the replay makes it, then held on its own inputs
    vol_d = get_bench("B2", SIZE, cpu)[0]
    geom = det_geometry(as_detectors(DETECTORS), cpu)
    jac_cols = len(DETECTORS) * NTG_DETECT
    kept = collections.defaultdict(list)

    def keep(*args, **kw):
        kept[PASS_A if "ppath" in kw else PASS_B].append(
            (args, {k: v for k, v in kw.items() if k != "totals"}))
        return H.photon_step_host(*args, **kw)

    batch = records[:HOST_RECORDS]
    n = batch.shape[0]
    fn = R._build_replay_fn(vol_d.shape, vol_d.unitinmm, cfg_detect, n, None,
                            geom, jac_cols, step=keep)
    _, id_lo, id_hi, col, active = R._batch_arrays(batch, 0, n, True,
                                                   NTG_DETECT)
    nvox, n_media = SIZE**3, vol_d.media.shape[0]

    def zeros(*size):
        return torch.zeros(size, dtype=torch.int64)

    fn(vol_d.labels.reshape(-1), vol_d.media, *(torch.tensor(x) for x in (
        id_lo.astype(np.int64), id_hi.astype(np.int64), col, active)), SEED,
       zeros(nvox * jac_cols), [zeros(nvox * NTG_DETECT), zeros(SIZE * SIZE),
                                zeros(len(DETECTORS) * NTG_DETECT),
                                zeros(len(DETECTORS), n_media)])
    for g, label in ((PASS_A, "replay pass A"), (PASS_B, "replay pass B")):
        check(len(kept[g]) >= 1, f"the replay made no {label} launch")
        for i, (args, kw) in enumerate(kept[g]):
            hold(f"{label}, launch {i + 1} of {len(kept[g])}", args, kw,
                 reps=1)

    # B1 on the CPU alone, as the mixed fleet's CPU process runs it
    vol1, cfg1 = HT.case("B1", SIZE)
    sims = [HT.sim_rate(vol1, cfg1, HOST_SIM_PHOTONS, CPU_LANES, t)
            for t in threads]
    emit("host", item="B1 on the CPU", card=card, cpu=host["model"],
         size=SIZE, runs=sims)
    emit("host", item="phase", card=card,
         seconds=time.perf_counter() - t_phase)
    return rows["B1 base"]


def multidevice_phase(card, main_b2, fleet, fleet_alone, records, replay,
                      cfg_detect, device: str = "cuda") -> None:
    """Items 1-5 of the multidevice phase on ``device`` (the card; the
    CPU only to rehearse the phase at a small size): two shards of one
    card against the main run, the mixed CPU+GPU fleet partitioned
    S1-S3, the CPU against the card bit for bit, the pool under chaos,
    and the mesh of scenarios and replay against the scenarios and
    detect phases.  Every check raises.  Returns the host kernel's
    launches in the mixed fleet's run (its CPU share)."""
    from repro_torch import replay as R
    from repro_torch import scenarios as SC
    from repro_torch import telemetry as T
    from repro_torch.core import analysis as A
    from repro_torch.core import loadbalance as LB
    from repro_torch.core import multidevice as M
    from repro_torch.core import procs
    from repro_torch.core import simulator as S
    from repro_torch.launch import simulate as launch
    from repro_torch.resilience import (DevicePool, DeviceSpec,
                                        FaultInjector, RetryPolicy)
    from repro_torch.telemetry.trace import device_label

    on_card = device == "cuda"
    gpu, cpu = torch.device(device, 0), torch.device("cpu")
    t_phase = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def launched(what):
        n = launched_kernels()
        check(n > 0 or not on_card, f"{what}: no kernel launched")
        return n

    def shard_spans(tracer):
        return sorted((e for e in tracer.events if e.name == "shard"),
                      key=lambda e: e.args["shard"])

    def shard_seconds(tracer):
        return [e.dur for e in shard_spans(tracer)]

    # every process the phase uses (two shards of the card and the pool's
    # third worker, the fleet's CPU), started at once
    start_s = timed(lambda: procs.run_all([
        procs.Job(d, slot, "call", None, (os.getpid, ()))
        for d, slot in ((gpu, 0), (gpu, 1), (gpu, 2), (cpu, 0))]))[1]

    # 1. two shards of one card against the main phase's B2 run
    vol2, cfg2 = launch.get_bench("B2", SIZE, gpu)
    cfg2 = dataclasses.replace(cfg2, steps_per_round=K_MAIN)
    first = round(PHOTONS * SHARD_SPLIT)
    counts = [first, PHOTONS - first]
    tracer = T.Tracer()
    shard_fn = M.sharded_sim_fn(vol2, cfg2, LANES, [gpu, gpu], tracer=tracer)
    # each shard's process started, its libraries loaded and its round
    # loop built, as the single run's were, before the timed run
    _, warm_s = timed(lambda: shard_fn([LANES] * 2, [0, LANES], SEED))
    tracer.events.clear()
    K.reset_launches()
    merged, wall = timed(lambda: S.merge_fixed(
        shard_fn(counts, M.shard_offsets(counts), SEED)))
    differ = fixed_differences(merged, main_b2.totals)
    check(not differ, f"two shards of one card differ from the single run "
          f"in {differ}")
    res = S.to_sim_result(merged)
    check(int(res.n_launched) == PHOTONS
          and abs(A.energy_balance(res)["residue_frac"]) < 1e-4,
          "sharded run: photon accounting or energy balance")
    emit("multidevice", item="sharded", card=card,
         mesh=[device_label(gpu)] * 2, partition=counts, photons=PHOTONS,
         lanes=LANES, k=K_MAIN, seconds=wall,
         photons_per_ms=PHOTONS / wall / 1e3,
         shard_seconds=shard_seconds(tracer),
         single_seconds=main_b2.seconds,
         single_photons_per_ms=PHOTONS / main_b2.seconds / 1e3,
         sharded_over_single=main_b2.seconds / wall,
         warm_up_seconds=warm_s,
         steps=merged.steps.tolist(), kernel_launches=launched("sharded"),
         int64_totals_bit_equal_to_single=True)

    # 2. the mixed CPU+GPU fleet on B1: pilots, S1-S3, the S3 partition;
    # each device pilots in the process its share runs in, the other
    # shard given no photons
    vol1, cfg1 = launch.get_bench("B1", SIZE, gpu)
    cfg1 = dataclasses.replace(cfg1, steps_per_round=K_MAIN,
                               max_steps=MIXED_MAX_STEPS)
    tracer = T.Tracer()
    mixed_fn = M.sharded_sim_fn(vol1, cfg1, [LANES, CPU_LANES], [gpu, cpu],
                                tracer=tracer)

    def pilot_run(i, repeats=1):
        def run(n):
            counts = [0, 0]
            counts[i] = int(n)
            best = math.inf
            for _ in range(repeats):
                tracer.events.clear()
                mixed_fn(counts, [0, 0], SEED)
                best = min(best, shard_seconds(tracer)[i])
            return best
        return run

    sms = (torch.cuda.get_device_properties(gpu).multi_processor_count
           if on_card else 1)
    pilot_run(0)(LANES)  # the processes warm
    # the card's pilots are quick: the best of GPU_PILOT_REPEATS each (one
    # slow first pilot fitted the card at twice its rate, PR 17 c2)
    models = [LB.run_pilot(pilot_run(0, GPU_PILOT_REPEATS), *GPU_PILOT,
                           name=device_label(gpu), cores=sms),
              LB.run_pilot(pilot_run(1), *CPU_PILOT,
                           name="cpu", cores=os.cpu_count() or 1)]
    lo, hi = MIXED_MAKESPAN_S
    makespan = min(hi, max(lo, models[1].t0 + MIXED_MARGIN_S))
    budget = int(sum(max(0.0, (makespan - m.t0) / m.a) for m in models))
    partitions = {st: M.heterogeneous_partition(budget, models, st)
                  for st in ("S1", "S2", "S3")}
    predicted = {st: LB.makespan(p, models) for st, p in partitions.items()}
    counts = partitions["S3"]
    check(counts[1] > 0 and models[1].predict(counts[1]) <= hi,
          f"the CPU's S3 share is {counts[1]} photons, "
          f"{models[1].predict(counts[1]):.1f} s by its fit")
    offsets = M.shard_offsets(counts)
    tracer.events.clear()
    K.reset_launches()
    shards, wall = timed(lambda: mixed_fn(counts, offsets, SEED))
    mixed_launches = launched("mixed fleet")
    host_launches = {k: n for k, n in kernel_counts().items()
                     if k.startswith("host/")}
    check(sum(host_launches.values()) > 0,
          "mixed fleet: the CPU's share never launched the host kernel")
    mixed = S.merge_fixed(shards)
    res = S.to_sim_result(mixed)
    bal = A.energy_balance(res)
    check(int(res.n_launched) == budget and abs(bal["residue_frac"]) < 1e-4,
          f"mixed fleet: {int(res.n_launched)} of {budget} photons launched "
          f"(shards {[int(x.n_launched) for x in shards]} of {counts}, "
          f"{[int(x.steps) for x in shards]} steps, cap {cfg1.max_steps}), "
          f"residue {bal['residue_frac']:.3e}")
    seconds = shard_seconds(tracer)
    emit("multidevice", item="mixed fleet", card=card, bench="B1",
         mesh=[device_label(gpu), "cpu"], lanes=[LANES, CPU_LANES],
         models=[dict(dataclasses.asdict(m), photons_per_ms=m.throughput
                      / 1e3) for m in models],
         cpu_pilot_photons=list(CPU_PILOT),
         gpu_pilot_photons=list(GPU_PILOT), target_makespan_s=makespan,
         budget=budget, partitions=partitions,
         predicted_makespan_s=predicted,
         ideal_makespan_s=LB.ideal_makespan(budget, models),
         measured_makespan_s=wall,
         measured_over_predicted_s3=wall / predicted["S3"],
         cpu_share_s3=counts[1] / budget, host_launches=host_launches,
         shares=[{"device": m.name, "photons": n, "seconds": t,
                  "photons_per_ms": n / t / 1e3,
                  "predicted_s": m.predict(n),
                  "threads": e.args["threads"]}
                 for m, n, t, e in zip(models, counts, seconds,
                                       shard_spans(tracer))],
         residue_frac=bal["residue_frac"], kernel_launches=mixed_launches)

    # 3. the CPU shard's photons again on the card, cell by cell
    again = S.simulate_fixed(vol1, cfg1, counts[1], LANES, SEED, device=gpu,
                             id_offset=offsets[1])
    cells = {f: [int((getattr(shards[1], f).cpu()
                      == getattr(again, f).cpu()).sum()),
                 getattr(again, f).numel()] for f in FIXED_GRIDS}
    totals = {f: [int(getattr(shards[1], f)), int(getattr(again, f))]
              for f in FIXED_TOTALS}
    bit_equal = all(e == n for e, n in cells.values()) and all(
        a == b for a, b in totals.values())
    # the CPU's share against its own photons on the card, scaled to the
    # share: its weight and its largest cell
    share, share_card = S.to_sim_result(shards[1]), S.to_sim_result(again)
    share_w = float(share_card.launched_w)
    apart = {
        "fluence_of_largest_cell": float(
            (share.energy.cpu() - share_card.energy.cpu()).abs().max()
            / share_card.energy.max().cpu()),
        **{f"{k}_of_launched": abs(float(getattr(share, k))
                                   - float(getattr(share_card, k))) / share_w
           for k in ("escaped_w", "timed_out_w")}}
    # one run on the card over the fleet's photons: its card shard and
    # the CPU's range run again on the card (item 1 holds such sums to
    # the bits of one run)
    one_device = S.merge_fixed([shards[0], again])
    got, want = S.to_sim_result(mixed), S.to_sim_result(one_device)
    fleet_apart = {
        "fluence_of_largest_cell": float(
            (got.energy - want.energy).abs().max() / want.energy.max()),
        **{f"{k}_of_launched": abs(float(getattr(got, k))
                                   - float(getattr(want, k)))
           / float(want.launched_w) for k in ("escaped_w", "timed_out_w")}}
    if bit_equal:
        differ = fixed_differences(mixed, one_device)
        check(not differ, f"the mixed fleet differs from one run in {differ}")
    else:
        check(int(share.n_launched) == int(share_card.n_launched)
              and float(share.launched_w) == share_w,
              "the CPU's share: launched photons or weight differ from "
              "the card's run of its photons")
        check(apart["fluence_of_largest_cell"] <= GRID_TOL
              and max(apart["escaped_w_of_launched"],
                      apart["timed_out_w_of_launched"]) <= TOTALS_TOL,
              f"the CPU's share misses its photons on the card by {apart}")
        # the fleet is the sum of its shares
        check(int(got.n_launched) == int(want.n_launched) == budget
              and torch.equal(mixed.launched_w, one_device.launched_w),
              "mixed fleet: launched photons or weight differ")
    emit("multidevice", item="cpu against cuda", card=card,
         photons=counts[1], id_offset=offsets[1], cells_equal=cells,
         totals=totals, bit_equal=bit_equal, share_against_card=apart,
         mixed_against_one_device=fleet_apart,
         tolerance=None if bit_equal else {"totals_of_share_launched":
                                           TOTALS_TOL,
                                           "fluence_of_share_largest_cell":
                                           GRID_TOL})

    # 4. the pool under a seeded chaos schedule against one run
    ref = S.simulate_fixed(vol1, cfg1, POOL_PHOTONS, LANES, SEED, device=gpu)
    specs = [DeviceSpec(device=gpu, n_lanes=LANES, label=f"w{i}")
             for i in range(2)] + [DeviceSpec(
                 device=gpu, n_lanes=LANES, label="lag",
                 throttle_s=POOL_THROTTLE_S)]
    # the workers' processes warm: a fault-free run of one chunk each
    DevicePool(vol1, cfg1, specs).run_fixed(3 * LANES, LANES, seed=SEED,
                                            deadline_s=300)
    injector = FaultInjector(**POOL_CHAOS)
    pool = DevicePool(vol1, cfg1, specs, fault_injector=injector,
                      chunk_timeout_s=POOL_TIMEOUT_S,
                      retry_policy=RetryPolicy(max_attempts=12,
                                               quarantine_after=50))
    K.reset_launches()
    (fixed, report), wall = timed(lambda: pool.run_fixed(
        POOL_PHOTONS, POOL_CHUNK, seed=SEED, deadline_s=300))
    differ = fixed_differences(fixed, ref)
    check(not differ, f"the pool under chaos differs from one run in "
          f"{differ}")
    c = report.counters()
    check(c["merged"] == c["chunks"] == POOL_PHOTONS // POOL_CHUNK
          and not report.quarantined_chunks, f"pool: {c}")
    check(c["injected_faults"] > 0 and c["retries"] > 0
          and c["validation_failures"] > 0 and c["speculative"] > 0
          and c["workers_quarantined"] == 1,
          f"the chaos schedule missed a fault kind: {c}")
    emit("multidevice", item="pool", card=card, photons=POOL_PHOTONS,
         chunk=POOL_CHUNK, lanes=LANES, k=K_MAIN,
         workers=[dataclasses.asdict(s) | {"device": device_label(gpu)}
                  for s in specs],
         injector=dataclasses.asdict(injector),
         chunk_timeout_s=POOL_TIMEOUT_S, seconds=wall,
         photons_per_ms=POOL_PHOTONS / wall / 1e3, report=c,
         worker_summaries=report.workers,
         kernel_launches=launched("pool"),
         int64_totals_bit_equal_to_single=True)

    # 5. the mesh: the optode sweep's scenarios and the detect run's replay
    K.reset_launches()
    many, wall = timed(lambda: SC.simulate_many(
        fleet, n_lanes=SCENARIO_LANES, mesh=[gpu, gpu],
        cache=SC.CompileCache()))
    for i, (got, want) in enumerate(zip(many, fleet_alone)):
        for name, x, y in zip(got._fields, got, want):
            same = (torch.equal(x.cpu(), y.cpu())
                    if isinstance(x, torch.Tensor) else x == y)
            check(same, f"mesh scenario {i}: {name} differs from its own "
                  f"simulate_one")
    emit("multidevice", item="scenario mesh", card=card,
         mesh=[device_label(gpu)] * 2, scenarios=len(fleet),
         lanes_each=SCENARIO_LANES, seconds=wall,
         photons_per_ms=sum(sc.n_photons for sc in fleet) / wall / 1e3,
         kernel_launches=launched("scenario mesh"),
         bit_equal_to_simulate_one=True)
    vol_d = launch.get_bench("B2", SIZE, gpu)[0]
    K.reset_launches()
    again, wall = timed(lambda: R.replay_jacobian(
        vol_d, cfg_detect, records, DETECTORS, seed=SEED, n_lanes=LANES,
        gate_resolved=True, mesh=[gpu, gpu]))
    for name, a, b in zip(replay._fields, replay, again):
        check(np.array_equal(a, b), f"replay over the mesh: {name} differs "
              f"from the detect run's replay")
    emit("multidevice", item="replay mesh", card=card,
         mesh=[device_label(gpu)] * 2, records=int(records.shape[0]),
         seconds=wall, records_per_ms=records.shape[0] / wall / 1e3,
         kernel_launches=launched("replay mesh"),
         every_output_bit_equal=True)
    emit("multidevice", item="phase", card=card,
         seconds=time.perf_counter() - t_phase, processes_start_s=start_s,
         processes={f"{lab}/{slot}": p.pid
                    for (lab, slot), p in procs.children().items()},
         parent_pid=os.getpid())
    return sum(host_launches.values())


def examples_phase(card, device: str = "cuda", sizes=None) -> None:
    """Each module of ``repro_torch.examples`` through its ``run`` at
    ``sizes`` (default EXAMPLES, the reference's own) on ``device`` (the
    card; the CPU only to rehearse the phase at a small size), each
    against the reference script's own checks and the port's bit
    contract.  Every check raises."""
    from repro_torch.examples import (fault_tolerant_campaign,
                                      heterogeneous_lb, quickstart,
                                      source_gallery)

    sizes = EXAMPLES if sizes is None else sizes
    on_card = device == "cuda"
    t_phase = time.perf_counter()

    def timed(name, module):
        K.reset_launches()
        t0 = time.perf_counter()
        out = module.run(device=device, **sizes[name])
        seconds = time.perf_counter() - t0
        n = launched_kernels()
        check(n > 0 or not on_card, f"{name}: no kernel launched")
        return out, seconds, n

    name = "quickstart"
    q, seconds, n = timed(name, quickstart)
    photons = sizes[name]["photons"]
    ratio = q["mu_fit"] / q["mu_theory"]
    check(int(q["result"].n_launched) == photons,
          f"{name}: {int(q['result'].n_launched)} photons launched")
    check(abs(q["balance"]["residue_frac"]) < 1e-4,
          f"{name}: residue {q['balance']['residue_frac']}")
    check(MU_EFF_RATIO[0] <= ratio <= MU_EFF_RATIO[1],
          f"{name}: fitted mu_eff {ratio:.3f} x diffusion theory")
    emit("examples", example=name, card=card, seconds=seconds,
         photons_per_ms=q["photons_per_ms"], kernel_launches=n,
         residue_frac=q["balance"]["residue_frac"], mu_fit=q["mu_fit"],
         mu_theory=q["mu_theory"], mu_ratio=ratio)

    name = "source_gallery"
    rows, seconds, n = timed(name, source_gallery)
    photons = sizes[name]["photons"]
    for row in rows:
        check(int(row["result"].n_launched) == photons,
              f"{name} {row['name']}: {int(row['result'].n_launched)} "
              f"photons launched")
        check(abs(row["balance"]["residue_frac"]) < 1e-4,
              f"{name} {row['name']}: residue "
              f"{row['balance']['residue_frac']}")
    emit("examples", example=name, card=card, seconds=seconds,
         kernel_launches=n, sources=len(rows),
         photons_per_ms={r["name"]: r["photons_per_ms"] for r in rows},
         steps={r["name"]: r["steps"] for r in rows},
         residue_frac={r["name"]: r["balance"]["residue_frac"]
                       for r in rows})

    name = "heterogeneous_lb"
    h, seconds, n = timed(name, heterogeneous_lb)
    photons = sizes[name]["photons"]
    check(h["model"].a > 0, f"{name}: pilot slope {h['model'].a}")
    for strat in ("S1", "S2", "S3"):
        part = h["partitions"][strat]["partition"]
        check(sum(part) == photons, f"{name}: {strat} partition {part}")
    check(sum(h["local_photons"].values()) == photons
          and int(h["local"].n_launched) == photons,
          f"{name}: the local run's photons {h['local_photons']}")
    check(sum(h["chunk_photons"].values()) == photons,
          f"{name}: the chunk scheduler's photons {h['chunk_photons']}")
    differ = fixed_differences(h["chunked"], h["local"])
    check(not differ, f"{name}: the chunk scheduler's {differ} differ from "
          f"the local run's")
    emit("examples", example=name, card=card, seconds=seconds,
         kernel_launches=n, pilot_a_s=h["model"].a, pilot_t0_s=h["model"].t0,
         pilot_photons_per_ms=h["pilot_photons_per_ms"],
         partitions=h["partitions"],
         devices=h["devices"], local_photons=h["local_photons"],
         local_seconds=h["local_seconds"],
         local_photons_per_ms=h["local_photons_per_ms"],
         chunk_photons=h["chunk_photons"], chunk_seconds=h["chunk_seconds"],
         chunk_photons_per_ms=h["chunk_photons_per_ms"],
         chunked_bit_equal_to_local=True)

    name = "fault_tolerant_campaign"
    c, seconds, n = timed(name, fault_tolerant_campaign)
    rep = c["report"]
    for what in ("chaos", "resumed"):
        differ = fixed_differences(c[what], c["reference"])
        check(not differ, f"{name}: the {what} run's {differ} differ from "
              f"the clean run's")
    check(rep.merged == rep.n_chunks,
          f"{name}: {rep.merged}/{rep.n_chunks} chunks merged")
    check(rep.retries >= 1, f"{name}: the chaos drill retried nothing")
    check(c["crash"] is not None, f"{name}: the campaign did not crash")
    emit("examples", example=name, card=card, seconds=seconds,
         kernel_launches=n, photons_per_ms=c["photons_per_ms"],
         part_seconds=c["seconds"], chaos=rep.counters(),
         crash=c["crash"], restored=list(c["restored"]),
         bit_equal_to_clean=["chaos", "resumed"])
    emit("examples", item="phase", card=card,
         seconds=time.perf_counter() - t_phase)


def lint_phase(card) -> None:
    """Both tiers of the port's lint on this tree (``python -m
    repro_torch.lint --tier all``), then the ``sim`` target's run once
    more with its round loop on the card: its device operations and
    host reads a round."""
    from repro_torch.lint import run_lint
    from repro_torch.lint.baseline import baseline_path, load_baseline
    from repro_torch.lint.traced import (allowlist_path, load_allowlist,
                                         run_traced_lint)
    from repro_torch.lint.traced.targets import make_sim

    root = pathlib.Path(__file__).resolve().parent
    t0 = time.perf_counter()
    reports = {"ast": run_lint(root, baseline=load_baseline(
        baseline_path(root))),
        "traced": run_traced_lint(root, allowlist=load_allowlist(
            allowlist_path(root)))}
    for tier, rep in reports.items():
        check(rep.clean, f"lint, {tier} tier: "
              f"{[f.format() for f in rep.findings]}")
    lint_s = time.perf_counter() - t0
    K.reset_launches()
    rounds = make_sim("cuda")(None).per_round()
    check(rounds["rounds"] > 0 and max(rounds["host_reads"]) <= 1,
          f"the round loop on the card reads the host {rounds['host_reads']} "
          f"times a round")
    check(launched_kernels() >= rounds["rounds"],
          "the recorded run on the card launched no kernel a round")
    ops = sorted(rounds["device_ops"])
    emit("lint", card=card, seconds=lint_s,
         ast={"modules": reports["ast"].n_modules,
              "pragmas": reports["ast"].suppressed_pragma},
         traced={"targets": reports["traced"].n_modules,
                 "allowed": reports["traced"].suppressed_pragma},
         rounds=rounds["rounds"], device_ops_a_round=ops[len(ops) // 2],
         device_ops_range=[ops[0], ops[-1]],
         host_reads_a_round=max(rounds["host_reads"]),
         kernel_launches=launched_kernels())


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
    from repro_torch import scenarios as SC
    from repro_torch import sources as SRC
    from repro_torch import telemetry as T
    from repro_torch.core import simulator as S
    from repro_torch.launch import simulate as launch
    from repro_torch.launch.kernel_timing import kept_launch, mid_run_state

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
        want = photon_steps_ref(*args)
        torch.cuda.synchronize()
        for x, y in zip(got[0], again[0]):
            check(torch.equal(x, y), "two kernel runs differ in lane state")
        tol = cell_tol(state.w.numel(), n_steps)
        diffs = compare(got, want, tol)
        if mutations:
            diffs["mutations_seen"] = check_sees_index_errors(
                got, want, vol.shape, cfg.n_time_gates, tol)
        for x, y in zip(got[1:3], again[1:3]):
            check(torch.equal(x, y), "two kernel runs differ in a grid")
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
        # (int64 fixed point)
        bytes_moved = (2 * spec.STATE_LANE_BYTES_PORT + 8) * LANES + nvox \
            + FIXED_BYTES * nvox * ntg + FIXED_BYTES * SIZE * SIZE
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

    def path_tail():
        zero = torch.zeros((1,), dtype=torch.int64, device=dev)
        return K.round_tail(zero.clone(), zero.clone(),
                            torch.full_like(zero, PHOTONS))

    def path_records(lanes):
        """The detection forward's record buffers, empty, on ``lanes``
        lanes of random photon ids."""
        i64 = dict(dtype=torch.int64, device=dev)
        return K.RoundRecords(
            torch.zeros((1, SAVE_DETECTED + 1, 4), **i64),
            torch.zeros((1,), **i64), torch.zeros((1,), **i64),
            torch.randint(0, 2**32, (lanes, 2), **i64,
                          generator=torch.Generator(dev).manual_seed(2)),
            *K.record_scratch(1, lanes, dev))

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
            want = photon_steps_ref(*args, **kw)
            torch.cuda.synchronize()
            for x, y in zip(list(got[0]) + list(got[1:3]) + list(got[5:]),
                            list(again[0]) + list(again[1:3])
                            + list(again[5:])):
                if x is not None and (x.dtype != torch.float32
                                      or x.shape[0] == lanes):
                    check(torch.equal(x, y), "two kernel runs differ lane "
                          "by lane")
            diffs, fails = measure_groups(got, want, base, groups, tol)
            check(not fails, f"groups {K.group_names(groups)}: "
                  + "; ".join(fails))
            seen = check_groups_see_index_errors(
                got, want, base, groups, n_det, ntg, n_det * ntg, tol)
            path_kw = dict(kw)
            if groups == FORWARD:
                # the detection forward launches with the round's tail and
                # records (photon_step_append_kernel): that launch is timed,
                # its outputs those of the launch without them
                path_kw.update(tail=path_tail(), records=path_records(lanes))
                appended = K.photon_step_cuda(*args, **path_kw)
                tailed = K.photon_step_cuda(*args, **kw, tail=path_tail())
                for i, (x, y, z) in enumerate(zip(appended, tailed, got)):
                    check(equal_outputs(x, y) and (
                        i in (3, 4) or equal_outputs(x, z)),
                        f"groups {K.group_names(groups)}: output {i} "
                        f"differs with the tail and records")
            ms = time_cuda(lambda: K.photon_step_cuda(*args, **path_kw), reps)
            host_loop_ms = time_cuda(
                lambda: K.photon_step_cuda(*args, **path_kw), reps,
                backlog=False)
            ms_no_tail = ms if groups != FORWARD else time_cuda(
                lambda: K.photon_step_cuda(*args, **kw), reps)
            plain_ms = time_cuda(lambda: photon_steps_ref(*args, **kw), 2)
            bound = group_bound(groups, lanes, live, captures, ntg, n_det,
                                n_media, n_det * ntg,
                                spec.STATE_LANE_BYTES_PORT)
            ms_is = ("launches with the round's tail and records"
                     if groups == FORWARD else "launches without a tail")
            emit("groups", variant=K.variant_name(groups, cfg),
                 rows=[r for b, r in GROUP_ROWS.items() if groups & b],
                 start=start, lanes=lanes, k=n_steps, ntg=ntg,
                 tmax_ns=cfg.tmax_ns, n_det=n_det, ms=ms, ms_is=ms_is,
                 ms_no_tail=ms_no_tail, host_loop_ms=host_loop_ms,
                 plain_ms=plain_ms,
                 live_segments=live, captures=captures,
                 mutations_seen={k: v[0] for k, v in seen.items()},
                 **bound, **diffs)
            out[groups] = {"variant": K.variant_name(groups, cfg), "ms": ms,
                           "ms_is": ms_is, "ms_no_tail": ms_no_tail,
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
            photon_steps_ref(*args, **kw),
            K.photon_step_cuda(*args), FORWARD,
            cell_tol(s0.w.numel(), K_MAIN))
        check(not fails, f"{what}, detection forward: " + "; ".join(fails))
        emit("groups", case=what, variant=K.variant_name(FORWARD, c),
             lanes=s0.w.numel(), **diffs)

    # --- regenerate: the regeneration kernel at the cells' shapes -----------
    regen_rows = regenerate_phase(card)

    # --- tail: the step launch with and without the round's tail ------------
    tail_rows = tail_phase(card)

    # --- records: the step launch with and without the records' append ------
    rec_row = records_phase(card)

    # --- main path ------------------------------------------------------------
    launches = {}
    main_runs = {}
    regen_calls = 0
    for bench in ("B1", "B2"):
        K.reset_launches()
        t0 = time.perf_counter()
        main_runs[bench] = launch.run([
            "--bench", bench, "--photons", str(PHOTONS), "--lanes",
            str(LANES), "--size", str(SIZE), "--steps-per-round", str(K_MAIN)])
        res = main_runs[bench].result
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = step_launches()
        rounds = res.steps // K_MAIN
        bal = A.energy_balance(res)
        check(int(res.n_launched) == PHOTONS, "n_launched != photons")
        check(float(res.launched_w) == PHOTONS, "launched_w != photons")
        check(abs(bal["residue_frac"]) < 1e-4,
              f"energy residue {bal['residue_frac']:.3e}")
        check(n >= rounds >= 1, f"{n} kernel launches for {rounds} rounds")
        regen = K.photon_step_cuda.launches_by[RG.source_key(SRC.Pencil, 1)]
        check(regen == issued_rounds(rounds), f"{regen} regeneration "
              f"calls for {rounds} rounds")
        regen_calls += regen
        tails = K.photon_step_cuda.launches_by[K.TAIL_KEY]
        check(tails == issued_rounds(rounds), f"{tails} launches with the "
              f"round's tail for {rounds} rounds")
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
             rounds=rounds, kernel_launches=n, tail_launches=tails,
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
    res_detect, rep_detect = res, rep
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
    check(by_variant[fwd_variant] == issued_rounds(rounds),
          f"{by_variant[fwd_variant]} forward launches for {rounds} rounds")
    check(by_variant.get(K.TAIL_KEY, 0) == issued_rounds(rounds),
          f"{by_variant.get(K.TAIL_KEY, 0)} launches with the round's tail "
          f"for {rounds} rounds")
    check(by_variant.get(K.RECORDS_KEY, 0) == issued_rounds(rounds),
          f"{by_variant.get(K.RECORDS_KEY, 0)} launches that appended the "
          f"records for {rounds} rounds")
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

    # --- replay: whole trajectories in a few launches -------------------------
    # the detect run's records replayed again in launches of up to 4095
    # segments (the default) and in rounds of K_MAIN (the launch schedule
    # of the parent design), in turns; every output bit-equal between all
    # of them and the detect run's replay
    vol = launch.get_bench("B2", SIZE, dev)[0]
    labels = vol.labels.reshape(-1)
    jac_cols = n_det * NTG_DETECT
    nvox, n_media = SIZE**3, vol.media.shape[0]
    pass_names = {g: K.variant_name(g, cfg_detect) for g in (PASS_A, PASS_B)}
    rounds_label = f"rounds of {K_MAIN}"
    schedules = {"long launches": None, rounds_label: K_MAIN}

    build_replay_fn = R._build_replay_fn

    def replay_again(label):
        # the launch length through the replay's own builder
        R._build_replay_fn = functools.partial(
            build_replay_fn, steps_per_launch=schedules[label])
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            again = R.replay_jacobian(vol, cfg_detect, rec, DETECTORS,
                                      seed=SEED, n_lanes=LANES,
                                      gate_resolved=True)
            torch.cuda.synchronize()
        finally:
            R._build_replay_fn = build_replay_fn
        wall = time.perf_counter() - t0
        for name, a, b in zip(rep._fields, rep, again):
            check(np.array_equal(a, b), f"replay in {label}: {name} differs "
                  f"from the detect run's replay")
        n = K.photon_step_cuda.launches_by
        return {"seconds": wall, "records_per_ms": rec.shape[0] / wall / 1e3,
                "launches": {K.group_names(g): n[pass_names[g]]
                             for g in (PASS_A, PASS_B)}}

    replays = collections.defaultdict(list)
    for label in (rounds_label, "long launches", "long launches",
                  rounds_label):
        replays[label].append(replay_again(label))
    for g in (PASS_A, PASS_B):
        check(1 <= by_variant[pass_names[g]] <= 4,
              f"{by_variant[pass_names[g]]} launches of {pass_names[g]} in "
              f"the detect run's replay")
    # the fixed-point range: the largest cell against 2^63 - 1 units
    jac_units = rep.jacobian * 2.0**spec.FIXED_SHIFT["jac"]
    check(bool((jac_units == np.rint(jac_units)).all()),
          "the Jacobian is not a whole number of fixed-point units")
    largest = float(jac_units.max())

    def zeros(*size):
        return torch.zeros(size, dtype=torch.int64, device=dev)

    def scratch_for(groups):
        """Zeroed int64 totals of a replay launch, as the replay gives
        them: fluence, exitance and the pass's own grids."""
        return [zeros(nvox * NTG_DETECT), zeros(SIZE * SIZE)] + (
            [zeros(n_det * NTG_DETECT), zeros(n_det, n_media)]
            if groups & DET else [zeros(nvox * jac_cols)])

    def replay_kept(records):
        """One replay of ``records`` as replay_jacobian runs it (batches
        of at most LANES lanes), each launch's inputs kept by pass
        (without the totals it added into) with its batch's first
        record."""
        kept = collections.defaultdict(list)
        batch = [0]

        def keep(*args, **kw):
            kept[PASS_A if "ppath" in kw else PASS_B].append(
                (args, {k: v for k, v in kw.items() if k != "totals"},
                 batch[0]))
            return K.photon_step_cuda(*args, **kw)

        n = min(LANES, records.shape[0])
        fn = R._build_replay_fn(vol.shape, vol.unitinmm, cfg_detect, n, None,
                                geom, jac_cols, step=keep)
        jac, scratch = zeros(nvox * jac_cols), scratch_for(PASS_A)
        for first in range(0, records.shape[0], n):
            batch[0] = first
            _, id_lo, id_hi, col, active = R._batch_arrays(
                records, first, n, True, NTG_DETECT)
            fn(labels, vol.media, *(torch.tensor(x, device=dev) for x in (
                id_lo.astype(np.int64), id_hi.astype(np.int64), col,
                active)), SEED, jac, scratch)
        return kept

    # every launch of one replay at the replay's own lane count: held
    # against the plain version on its own inputs, as in the groups phase;
    # its live lane-segments (stats block), captures and the Jacobian or
    # detector cells it reaches (its own grids), its bound, and its time
    # as the replay launches it (adding into totals, zeroing nothing).
    # The plain version's steps of pass B give the range of the Jacobian's
    # deposits (three reductions a step, inside pass B's plain time).
    kept = replay_kept(rec)
    K.check_errors(dev)
    # live segments of each record's lane, over its batch's launches
    segments = torch.zeros(rec.shape[0], dtype=torch.float64, device=dev)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    deposits = {"smallest": torch.full((), math.inf, device=dev),
                "largest": torch.zeros((), device=dev),
                "count": torch.zeros((), dtype=torch.int64, device=dev)}
    plain_step = ph.step

    def observed_step(jac_w):
        """``ph.step`` that adds the range of ``jac_w * seg_len`` of its
        segments to ``deposits``."""
        def step(*args, **kw):
            res = plain_step(*args, **kw)
            v = jac_w * res.seg_len
            pos = v > 0
            deposits["smallest"] = torch.minimum(
                deposits["smallest"], torch.where(pos, v, math.inf).min())
            deposits["largest"] = torch.maximum(deposits["largest"], v.max())
            deposits["count"] += pos.sum()
            return res
        return step

    for groups in (PASS_A, PASS_B):
        pass_launches = kept[groups]
        check(len(pass_launches) == by_variant[pass_names[groups]],
              f"the replay again made {len(pass_launches)} launches of "
              f"{pass_names[groups]}, the detect run "
              f"{by_variant[pass_names[groups]]}")
        bounds, lives, plain_ms, seen, max_abs = [], 0.0, [], {}, 0.0
        for i, (args, kw, first) in enumerate(pass_launches):
            outs = K.photon_step_cuda(*args, **kw, stats=True)
            live = outs[-1][:, 0].double()
            if groups == PASS_A:
                nb = min(live.numel(), rec.shape[0] - first)
                segments[first:first + nb] += live[:nb]
            grids = outs[6:8] if groups & DET else outs[-2:-1]
            touched = sum(int((x != 0).sum()) for x in grids)
            captures = int((outs[8] >= 0).sum()) if groups & DET else 0
            moved = 2 * FIXED_BYTES * touched + 16 * n_media + (
                12 * n_det if groups & DET else 0)
            lives += float(live.sum())
            lanes, n_steps = args[2].w.numel(), int(args[6])
            bounds.append(group_bound(
                groups, lanes, float(live.sum()), captures, NTG_DETECT, n_det,
                n_media, jac_cols, spec.STATE_LANE_BYTES_PORT,
                grid_bytes=moved) | {"cells_touched": touched})
            tol = cell_tol(lanes, n_steps)
            base = K.photon_step_cuda(*args)
            got = K.photon_step_cuda(*args, **kw)
            torch.cuda.synchronize()
            if groups & JAC:
                ph.step = observed_step(kw["jac_w"])
            try:
                start.record()
                want = photon_steps_ref(*args, **kw)
                stop.record()
                torch.cuda.synchronize()
            finally:
                ph.step = plain_step
            plain_ms.append(start.elapsed_time(stop))
            diffs, fails = measure_groups(got, want, base, groups, tol)
            check(not fails, f"replay {K.group_names(groups)} launch {i}: "
                  + "; ".join(fails))
            max_abs = max(max_abs, diffs["max_abs_err"])
            if not seen and (not groups & DET or int((want[8] >= 0).sum())):
                seen = check_groups_see_index_errors(
                    got, want, base, groups, n_det, NTG_DETECT, jac_cols, tol)
        check(bool(seen), f"replay {K.group_names(groups)}: no launch to "
              f"show the comparison's power on")
        scratch = scratch_for(groups)

        def go(pass_launches=pass_launches, scratch=scratch):
            for args, kw, _ in pass_launches:
                K.photon_step_cuda(*args, **kw, totals=scratch)
        n = len(pass_launches)
        ms = time_cuda(go, 3) / n
        host_loop_ms = time_cuda(go, 3, backlog=False) / n
        mean = {k: sum(b[k] for b in bounds) / n
                for k in ("bytes_ms", "operations_ms", "hbm_bytes", "f32_ops",
                          "cells_touched")}
        timed_groups[groups] = {
            "variant": pass_names[groups], "ms": ms,
            "host_loop_ms": host_loop_ms, "plain_ms": sum(plain_ms) / n,
            "max_abs_err": max_abs, "mutations_seen": list(seen),
            "bound_ms": max(mean["bytes_ms"], mean["operations_ms"]),
            "bound_by": ("bytes" if mean["bytes_ms"] >= mean["operations_ms"]
                         else "operations"),
            "lanes": int(pass_launches[0][0][2].w.numel()),
            "steps_per_launch": [int(a[6]) for a, _, _ in pass_launches],
            "live_segments": lives, **mean}
    longest_lane = float(segments.max())
    deposits = {k: v.item() for k, v in deposits.items()}
    # a deposit below one unit rounds to 0 or 1 unit; one of 2^44 units
    # or more, or a cell near 2^63, would be out of range
    unit = 2.0**-spec.FIXED_SHIFT["jac"]
    check(deposits["count"] > 0 and deposits["largest"]
          < spec.DEPOSIT_LIMIT * unit and largest < 2.0**62,
          f"Jacobian deposits or cells near the fixed-point range: "
          f"{deposits}, largest cell {largest} units")
    emit("replay", records=int(rec.shape[0]), replays=replays,
         every_output_bit_equal=True,
         launches={K.group_names(g): by_variant[pass_names[g]]
                   for g in (PASS_A, PASS_B)},
         jacobian_unit=unit, largest_cell_units=largest,
         largest_cell_weight_mm=largest * unit,
         headroom_bits=63 - math.log2(max(largest, 1.0)),
         deposits={**deposits, "smallest_units": deposits["smallest"] / unit},
         **{K.group_names(g): timed_groups[g] for g in (PASS_A, PASS_B)},
         longest_lane_segments=longest_lane,
         kernel_share_of_replay_wall=sum(
             by_variant[pass_names[g]] * timed_groups[g]["ms"]
             for g in (PASS_A, PASS_B)) / (run.replay_seconds * 1e3))

    # --- sources: every source type through the CLI -------------------------
    for name, src in SRC.demo_menu(SIZE).items():
        K.reset_launches()
        t0 = time.perf_counter()
        res = launch.main(["--bench", "B2", "--photons", str(SOURCE_PHOTONS),
                           "--lanes", str(LANES), "--size", str(SIZE),
                           "--steps-per-round", str(K_MAIN), "--source",
                           json.dumps(SRC.to_dict(src))])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = step_launches()
        rounds = res.steps // K_MAIN
        bal = A.energy_balance(res)
        check(int(res.n_launched) == SOURCE_PHOTONS,
              f"{name}: n_launched {int(res.n_launched)} != photons")
        check(abs(bal["residue_frac"]) < 1e-4,
              f"{name}: energy residue {bal['residue_frac']:.3e}")
        check(n >= rounds >= 1, f"{name}: {n} launches for {rounds} rounds")
        check(bool(torch.isfinite(res.energy).all())
              and tuple(res.energy.shape) == shape, f"{name}: energy grid")
        emit("sources", source=name, config=SRC.to_dict(src),
             photons=SOURCE_PHOTONS, lanes=LANES, k=K_MAIN, seconds=wall,
             photons_per_ms=SOURCE_PHOTONS / wall / 1e3, rounds=rounds,
             kernel_launches=n, launched_w=float(res.launched_w),
             absorbed=bal["absorbed"], escaped=bal["escaped"],
             residue_frac=bal["residue_frac"])

    # --- determinism: the detection forward again, bit for bit -------------
    vol_d = launch.get_bench("B2", SIZE, dev)[0]
    again = S.simulate(vol_d, dataclasses.replace(cfg_detect,
                                                  collect_stats=True),
                       PHOTONS, LANES, SEED, device=dev, detectors=DETECTORS,
                       record_detected=SAVE_DETECTED)
    fields = []
    for name, x, y in zip(res_detect._fields, res_detect, again):
        same = (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y)
        check(same, f"two detection forward runs differ in {name}")
        fields.append(name)
    emit("determinism", runs=2, photons=PHOTONS, ntg=NTG_DETECT,
         n_det=n_det, fields_bit_equal=fields,
         grids_bit_equal_to_plain="every kernel and groups phase launch, "
                                  "mid-run and edge cases")

    # --- scenarios: two fleets, each one batched round loop ----------------
    vol_b2, vol_b1 = V.benchmark_b2(shape), V.benchmark_b1(shape)
    cfg_sweep = dataclasses.replace(V.b2_config(), steps_per_round=K_MAIN,
                                    n_time_gates=NTG_DETECT,
                                    tmax_ns=TMAX_DETECT)
    cfg_rep = dataclasses.replace(V.b1_config(), steps_per_round=K_MAIN)
    fleets = {
        # an optode sweep: the disk source steps along x towards three
        # fixed detectors
        "optode sweep": ([SC.Scenario(
            vol_b2, cfg_sweep, SCENARIO_PHOTONS, seed=SEED,
            source={"type": "disk", "pos": [16.0 + 2.0 * i, 30.0, 0.0],
                    "radius": 2.0}, detectors=DETECTORS,
            id_offset=i * SCENARIO_PHOTONS) for i in range(SCENARIOS)], DET),
        # replicates: disjoint id ranges, the middle ones across 2^32
        "pencil replicates": ([SC.Scenario(
            vol_b1, cfg_rep, SCENARIO_PHOTONS, seed=SEED,
            id_offset=2**32 - SCENARIOS // 2 * SCENARIO_PHOTONS
            + i * SCENARIO_PHOTONS) for i in range(SCENARIOS)], 0)}
    tracer = T.Tracer(sinks=[T.InMemorySink()])
    cache = SC.CompileCache()
    captured = {}
    scen_rows = {}
    alone_runs = {}
    for fleet_name, (fleet, groups) in fleets.items():
        captured[fleet_name] = kept_launch(lambda: SC.simulate_many(
            fleet, n_lanes=SCENARIO_LANES, device=dev,
            cache=SC.CompileCache()), KEEP_ROUND)
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        many = SC.simulate_many(fleet, n_lanes=SCENARIO_LANES, device=dev,
                                cache=cache, tracer=tracer)
        torch.cuda.synchronize()
        batched_s = time.perf_counter() - t0
        batched_launches = dict(K.photon_step_cuda.launches_by)
        variant = K.variant_name(groups, fleet[0].cfg)
        rounds = max(r.steps for r in many) // K_MAIN
        src_cls = type(SRC.as_source(fleet[0].source))
        issued = issued_rounds(rounds)
        check(batched_launches == {f"{variant}/x{SCENARIOS}": issued,
                                   RG.source_key(src_cls, SCENARIOS): issued,
                                   K.TAIL_KEY: issued, "round_graph":
                                   issued - 1},
              f"{fleet_name}: batched launches {batched_launches} for "
              f"{rounds} rounds")
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alone = [SC.simulate_one(sc, n_lanes=SCENARIO_LANES, device=dev)
                 for sc in fleet]
        torch.cuda.synchronize()
        sequential_s = time.perf_counter() - t0
        alone_runs[fleet_name] = alone
        seq_launches = step_launches()
        for i, (got, want) in enumerate(zip(many, alone)):
            for name, x, y in zip(got._fields, got, want):
                same = (torch.equal(x, y) if isinstance(x, torch.Tensor)
                        else x == y)
                check(same, f"{fleet_name} scenario {i}: {name} batched "
                      f"differs from its own simulate_one")
            bal = A.energy_balance(got)
            check(int(got.n_launched) == SCENARIO_PHOTONS,
                  f"{fleet_name} scenario {i}: n_launched")
            check(abs(bal["residue_frac"]) < 1e-4,
                  f"{fleet_name} scenario {i}: residue "
                  f"{bal['residue_frac']:.3e}")
        photons = SCENARIOS * SCENARIO_PHOTONS
        scen_rows[fleet_name] = {
            "variant": variant, "groups": groups, "launches": rounds,
            "batched_s": batched_s, "sequential_s": sequential_s}
        emit("scenarios", fleet=fleet_name, scenarios=SCENARIOS,
             photons_each=SCENARIO_PHOTONS, lanes_each=SCENARIO_LANES,
             lanes_in_launch=SCENARIOS * SCENARIO_LANES, k=K_MAIN,
             batched_seconds=batched_s, sequential_seconds=sequential_s,
             batched_photons_per_ms=photons / batched_s / 1e3,
             sequential_photons_per_ms=photons / sequential_s / 1e3,
             batched_launches=rounds, sequential_launches=seq_launches,
             steps=[r.steps for r in many], bit_identical=True,
             detected_w=[float(r.det_w.double().sum()) for r in many])
    emit("scenarios", cache=cache.stats(),
         spans=[(e.name, e.args.get("scenarios"), e.dur)
                for e in tracer.events],
         counters=[(e["name"], e["value"]) for e in tracer.sinks[0].events
                   if e["type"] == "counter"])

    # one mid-run batched launch of each fleet against the plain version
    for fleet_name, (args, kw) in captured.items():
        groups = scen_rows[fleet_name]["groups"]
        lanes = args[2].w.numel()
        media = args[1]
        totals = kw.pop("totals")
        got = K.photon_step_cuda(*args, **kw,
                                 totals=[t.clone() for t in totals])
        want = photon_steps_ref(*args, **kw,
                                totals=[t.clone() for t in totals])
        base = K.photon_step_cuda(*args)
        torch.cuda.synchronize()
        diffs, fails = measure_groups(got, want, base, groups,
                                      cell_tol(lanes, K_MAIN))
        check(not fails, f"{fleet_name} batched launch: " + "; ".join(fails))
        # the launch adds into the run totals: it reads and writes the
        # cells its deposits reach (media and geometry rows beside)
        touched = sum(int((a != b).sum()) for a, b in zip(
            [g for g in got[1:3]] + ([got[6], got[7]] if groups & DET
                                     else []), totals))
        moved = 2 * FIXED_BYTES * touched + SCENARIOS * (
            16 * media.shape[1] + (12 * n_det if groups & DET else 0))
        # live lane-segments and captures from the plain version's
        # stats block and records on the same inputs
        n_media = media.shape[1]
        work_kw = dict(kw, record=True, stats=True) if groups & DET else \
            dict(stats=True)
        work = photon_steps_ref(*args, **work_kw)
        live = float(work[-1][:, 0].double().sum())
        captures = int((work[8] >= 0).sum()) if groups & DET else 0
        scratch = [t.clone() for t in totals]
        ms = time_cuda(lambda: K.photon_step_cuda(*args, **kw, totals=scratch),
                       20)
        host_loop_ms = time_cuda(
            lambda: K.photon_step_cuda(*args, **kw, totals=scratch), 20,
            backlog=False)
        tail = K.round_tail(*(torch.zeros((SCENARIOS,), dtype=torch.int64,
                                          device=dev) for _ in range(2)),
                            torch.full((SCENARIOS,), SCENARIO_PHOTONS,
                                       dtype=torch.int64, device=dev))
        ms_tail = time_cuda(lambda: K.photon_step_cuda(
            *args, **kw, totals=scratch, tail=tail), 20)
        plain_ms = time_cuda(lambda: photon_steps_ref(*args, **kw), 1)
        bound = group_bound(groups, lanes, live, captures,
                            args[5].n_time_gates, n_det if groups & DET else 0,
                            n_media, 0, spec.STATE_LANE_BYTES_PORT,
                            scenarios=SCENARIOS, grid_bytes=moved)
        scen_rows[fleet_name].update(
            ms=ms, ms_tail=ms_tail, host_loop_ms=host_loop_ms,
            plain_ms=plain_ms, max_abs_err=diffs["max_abs_err"], **bound)
        emit("scenarios", fleet=fleet_name, launch=f"round {KEEP_ROUND}",
             variant=f"{scen_rows[fleet_name]['variant']}/x{SCENARIOS}",
             lanes=lanes, k=K_MAIN, ms=ms, ms_tail=ms_tail,
             host_loop_ms=host_loop_ms, plain_ms=plain_ms,
             live_segments=live, captures=captures,
             cells_touched=touched, **bound, **diffs)

    # --- host: the CPU device's kernel against the plain version -------------
    host_row = host_phase(card, rec, cfg_detect)

    # --- multidevice: shards, the mixed fleet, the pool, the mesh --------------
    host_launches = multidevice_phase(
        card, main_runs["B2"], fleet=fleets["optode sweep"][0],
        fleet_alone=alone_runs["optode sweep"], records=rec,
        replay=rep_detect, cfg_detect=cfg_detect)

    # --- examples: the reference's four scripts as modules of the port -------
    examples_phase(card)

    # --- lint: both tiers, and the round's operations on the card --------------
    lint_phase(card)

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
        # the main path's launches do the round's tail too: B1's launch
        # with and without it (the tail phase's K1 base row)
        "ms_tail_b1": tail_rows["K1 base"]["ms_tail"],
        "ms_no_tail_b1": tail_rows["K1 base"]["ms"],
        "ms_is": "launches without the round's tail",
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
        "bound_by": timed_groups[g]["bound_by"], "library_ms": None, **{
            k: timed_groups[g][k] for k in (
                "ms_is", "ms_no_tail", "lanes", "steps_per_launch",
                "cells_touched")
            if k in timed_groups[g]}}
        for g, where in PATH_VARIANTS.items()] + [{
        # the detection forward's appending kernel (launched once a round
        # there), timed and held at head5.td's shape (the records phase)
        "name": "photon_step_append_kernel", "route": "cuda",
        "source": "src/repro_torch/kernels/photon_step/csrc/photon_step.cu",
        "replaces": "src/repro/core/simulator.py:470",
        "variant": rec_row["variant"], "path": "detection forward; head5.td",
        "launches": by_variant.get(K.RECORDS_KEY, 0),
        "max_abs_err": rec_row["max_abs_err"], "ms": rec_row["ms_records"],
        "ms_is": "launches with the round's tail and records",
        "ms_no_records": rec_row["ms"], "plain_ms": rec_row["plain_ms"],
        "bound_ms": rec_row["launch_bound_ms"],
        "bound_by": rec_row["launch_bound_by"], "library_ms": None,
        "lanes": rec_row["lanes"], "k": rec_row["k"],
        "captures": rec_row["captures"]}] + [{
        "name": "photon_step_" + K.group_names(row["groups"]).replace(
            "+", "_") + "_batched",
        "route": "cuda",
        "source": "src/repro_torch/kernels/photon_step/csrc/photon_step.cu",
        "replaces": "src/repro/kernels/photon_step/photon_step.py:396",
        "variant": f"{row['variant']}/x{SCENARIOS}",
        "path": f"scenarios: {fleet_name}", "scenarios": SCENARIOS,
        "launches": row["launches"], "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "ms_tail": row["ms_tail"],
        "host_loop_ms": row["host_loop_ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None}
        for fleet_name, row in scen_rows.items()] + [{
        "name": "regenerate", "route": "cuda",
        "source": "src/repro_torch/kernels/photon_step/csrc/regenerate.cu",
        "replaces": None, "launches": regen_calls, "library_ms": None,
        "cells": regen_rows}] + [{
        "name": "photon_step_host", "route": "host",
        "source": "src/repro_torch/kernels/photon_step/csrc/"
                  "photon_step_cpu.cpp",
        "replaces": "src/repro/kernels/photon_step/photon_step.py:396",
        "device": "cpu", "variant": "host/noreflect/exact/base",
        "path": "multidevice: the mixed fleet's CPU share (B1)",
        "launches": host_launches, "max_abs_err": host_row["max_abs_err"],
        "ms": host_row["ms"], "ms_1_thread": host_row["ms_1_thread"],
        "plain_ms": host_row["plain_ms"], "bound_ms": host_row["bound_ms"],
        "bound_by": host_row["bound_by"], "library_ms": None,
        "lanes": host_row["lanes"], "k": host_row["k"]}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
