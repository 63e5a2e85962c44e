"""Fault-tolerant photon campaign: chaos, checkpoints, crash, restart.

Simulates the large-run lifecycle end to end:

  1. a resilient chunk-scheduler run under a *seeded* chaos schedule —
     injected dispatch failures, NaN-corrupted results (rejected by the
     merge guard) and delays — is bit-identical to the fault-free run;
  2. an ElasticSimulator campaign auto-checkpoints every merged chunk,
     the host "crashes" (FaultInjector.kill_after_merges), and a fresh
     simulator restores from the atomic keep-k Checkpointer and finishes
     — again bit-identical to an uninterrupted run (counter-based RNG
     keys photons by global id, and the totals are int64 fixed point,
     so every replay is exact).

Both runs use every device of ``--device``'s type; each identity is
checked and a failure raises.

  PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_campaign \
      [--device cpu] [--checkpoint-dir DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core import analysis as A
from repro_torch.core import simulator as S
from repro_torch.core import volume as V
from repro_torch.core.multidevice import ChunkScheduler, ElasticSimulator
from repro_torch.examples import STEPS_PER_ROUND
from repro_torch.kernels.photon_step.ops import (resolve_device,
                                                 visible_devices)
from repro_torch.resilience import FaultInjector, InjectedCrash, RetryPolicy

SEED = 5
TOTALS = ("fluence", "exitance", "escaped", "timed_out", "launched_w",
          "n_launched", "det_w", "det_ppath")


def same_totals(a: S.FixedResult, b: S.FixedResult) -> bool:
    """Every int64 grid and total of two runs bit-equal."""
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in TOTALS)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def run(size: int = 30, photons: int = 20_000, chunk: int = 2_000,
        lanes: int = 1024, device="cuda",
        checkpoint_dir: str | None = None) -> dict:
    """The campaign on B2; returns what :func:`main` prints.  Raises if
    the chaos run or the restarted campaign differs from the clean run
    in any int64 total.  Checkpoints go to ``checkpoint_dir`` (a new
    temporary directory, removed at the end, by default)."""
    if checkpoint_dir is None:
        with tempfile.TemporaryDirectory(prefix="repro_campaign_") as d:
            return run(size, photons, chunk, lanes, device, d)
    dev = resolve_device(device)
    devices = visible_devices(dev.type)
    vol = V.benchmark_b2((size,) * 3, dev)
    cfg = dataclasses.replace(V.b2_config(), steps_per_round=STEPS_PER_ROUND)

    # ---- 1. chaos drill: faults change no output bit ----
    t0 = time.perf_counter()
    ref, _ = ChunkScheduler(vol, cfg, n_lanes=lanes,
                            devices=devices).run_fixed(photons, chunk,
                                                       seed=SEED)
    clean_s = time.perf_counter() - t0
    chaos = ChunkScheduler(
        vol, cfg, n_lanes=lanes, devices=devices,
        fault_injector=FaultInjector(seed=3, p_fail=0.25, p_nan=0.15,
                                     p_delay=0.2, delay_s=0.02),
        retry_policy=RetryPolicy(max_attempts=10))
    t0 = time.perf_counter()
    res, _ = chaos.run_fixed(photons, chunk, seed=SEED, deadline_s=600)
    chaos_s = time.perf_counter() - t0
    _check(same_totals(res, ref),
           "the chaos drill's totals differ from the fault-free run's")

    # ---- 2. crash mid-campaign + restart from auto-checkpoint ----
    ck = Checkpointer(checkpoint_dir, keep=2)
    sim = ElasticSimulator(vol, cfg, photons, chunk, n_lanes=lanes,
                           seed=SEED,
                           fault_injector=FaultInjector(kill_after_merges=4),
                           checkpointer=ck, checkpoint_every=1)
    crash = None
    t0 = time.perf_counter()
    try:
        sim.run_to_completion(devices)
    except InjectedCrash as e:
        crash = str(e)
    latest = ck.latest_step()
    manifest = ck.manifest()["extra"]

    # ---- a new simulator: restore and finish (no injector this time) ----
    sim2 = ElasticSimulator(vol, cfg, photons, chunk, n_lanes=lanes,
                            seed=SEED)
    _, state = ck.restore(sim2.state_dict())
    sim2.load_state_dict(state)
    restored = (len(sim2.completed), len(sim2.pending))
    sim2.run_to_completion(devices)
    campaign_s = time.perf_counter() - t0
    resumed = sim2.totals()
    _check(same_totals(resumed, ref),
           "the restarted campaign's totals differ from the uninterrupted "
           "run's")
    return {
        "reference": ref, "chaos": res, "report": chaos.last_report,
        "crash": crash, "latest_step": latest, "manifest": manifest,
        "restored": restored, "resumed": resumed,
        "balance": A.energy_balance(S.to_sim_result(resumed)),
        "seconds": {"clean": clean_s, "chaos": chaos_s,
                    "campaign": campaign_s},
        "photons_per_ms": {"clean": photons / clean_s / 1e3,
                           "chaos": photons / chaos_s / 1e3,
                           "campaign": photons / campaign_s / 1e3},
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=30)
    ap.add_argument("--photons", type=int, default=20_000)
    ap.add_argument("--chunk", type=int, default=2_000)
    ap.add_argument("--lanes", type=int, default=1024)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="where the campaign checkpoints (default: a new "
                         "temporary directory, removed at the end)")
    args = ap.parse_args(argv)

    out = run(args.size, args.photons, args.chunk, args.lanes, args.device,
              args.checkpoint_dir)
    rep, rate = out["report"], out["photons_per_ms"]
    print(f"fault-free run: {rate['clean']:.2f} photons/ms")
    print(f"chaos drill: {rep.merged}/{rep.n_chunks} chunks merged with "
          f"{rep.retries} retries ({rep.validation_failures} rejected merges, "
          f"{rep.dispatch_failures} failed dispatches), "
          f"{rate['chaos']:.2f} photons/ms")
    print("OK: bit-identical to the fault-free run under injected faults\n")
    print(f"host crash: {out['crash']}")
    print(f"newest checkpoint: step {out['latest_step']} ({out['manifest']})")
    done, to_go = out["restored"]
    print(f"restored: {done} chunks done, {to_go} to go")
    print(f"resumed campaign: {out['balance']}, crash and restart "
          f"{rate['campaign']:.2f} photons/ms")
    print("OK: crash + restart reproduced the uninterrupted result "
          "bit-exactly")
    return out


if __name__ == "__main__":
    main()
