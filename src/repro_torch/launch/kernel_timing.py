"""Device and host time of the photon-step kernel at the main path's shapes.

    python -m repro_torch.launch.kernel_timing [--reps 20]

Builds the mid-run states ``chip_smoke.py`` holds the kernel on: B1 and
B2 at 60^3 with 262144 lanes and K = 16, after 12 rounds of
regeneration and kernel launches as the simulator runs them, and B2
with 50 time gates and three detectors for the detection forward
(det+record+stats).  For each it prints one JSON line: the device ms of
a launch (CUDA events around ``--reps`` launches queued behind a spin
kernel; where the wrapper takes ``totals``, also adding into run totals
as the simulator launches it, ``device_ms_add_into``), the ms a launch
of the loop as the host issues it, and the
wrapper's host µs a call (median and quartiles over 25 loops of 40
calls, each queued behind a spin kernel so that the device never holds
the host back).  It needs a CUDA device.  ``kept_launch`` keeps the
inputs of one round's launch of any run, to time and check that launch
alone.

To compare two checkouts' kernels on one card, run this file by its
path under each one's ``PYTHONPATH`` in turns (parent, change, change,
parent): it uses only entry points both have.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import time

import torch

from repro_torch.core import photon as ph
from repro_torch.detectors import as_detectors, det_geometry
from repro_torch.kernels.photon_step import ops
from repro_torch.kernels.photon_step import photon_step as K
from repro_torch.launch.simulate import get_bench
from repro_torch.sources import Pencil

SIZE, LANES, K_STEPS, PHOTONS = 60, 262_144, 16, 10_000_000
# the detection path of chip_smoke.py: 50 gates over 5 ns, 2 mm disks
# 10, 15 and 20 mm from the pencil
DETECTORS = [{"x": 40, "y": 30, "radius": 2}, {"x": 45, "y": 30, "radius": 2},
             {"x": 50, "y": 30, "radius": 2}]
# ~0.1 s of spinning at the 1.98 GHz boost clock
SPIN_CYCLES = 200_000_000


def _relaunch(st, remaining, next_lo, src, seed, shape, pp=None):
    """Dynamic regeneration of one scenario, as the simulator runs it:
    dead lanes, in lane order, take the next ``remaining`` photon ids
    (below 2**32 here).  Returns ``(state, remaining, next_lo, pp)``."""
    dead = ~st.alive
    relaunch = dead & (torch.cumsum(dead.to(torch.int64), 0) <= remaining)
    rel = relaunch.to(torch.int64)
    ids = next_lo + torch.cumsum(rel, 0) - 1
    fresh = ph.launch(*src.sample(ids, seed), relaunch, shape)
    st = ph.PhotonState(*(
        torch.where(relaunch[:, None] if new.ndim > 1 else relaunch, new, old)
        for new, old in zip(fresh, st)))._replace(alive=st.alive | relaunch)
    if pp is not None:
        pp = torch.where(relaunch[:, None], torch.zeros_like(pp), pp)
    n = rel.sum()
    return st, remaining - n, next_lo + n, pp


def mid_run_state(vol, cfg, lanes: int = LANES, photons: int = PHOTONS,
                  n_steps: int = K_STEPS, groups=None):
    """The lanes after 12 rounds of regeneration and a kernel launch, as
    the simulator runs them, and regenerated once more; with
    ``groups`` (the detector keywords of ``photon_step_cuda``) the
    per-medium paths are carried too.  Returns ``(state, ppath)``.
    Uses only entry points that earlier checkouts of the port have too,
    so one file times both."""
    dev, shape = vol.device, vol.shape
    src = Pencil()
    st = ops.fresh_state(vol, lanes, seed=99)._replace(
        alive=torch.zeros(lanes, dtype=torch.bool, device=dev))
    pp = (torch.zeros((lanes, vol.media.shape[0]), device=dev)
          if groups else None)
    remaining = torch.tensor(photons, device=dev)
    next_lo = torch.tensor(0, device=dev)
    for i in range(13):
        st, remaining, next_lo, pp = _relaunch(st, remaining, next_lo, src,
                                               99, shape, pp)
        if i == 12:
            return st, pp
        kw = dict(groups, ppath=pp) if groups else {}
        outs = K.photon_step_cuda(vol.labels.reshape(-1), vol.media, st,
                                  shape, 1.0, cfg, n_steps, **kw)
        st, pp = outs[0], (outs[5] if groups else None)


class _Kept(Exception):
    """Ends a run once the launch it was run for is kept."""


def kept_launch(run, round_no: int):
    """``(args, kwargs)`` of the photon-step call of round ``round_no``
    of ``run()``, cloned, without the round's tail, records and
    ``inplace``: the rounds are issued eagerly (a graphed run calls the
    step only in round 1 and in the capture), and the run ends at that
    call.  Raises RuntimeError if the run ends before it."""
    from repro_torch.core import simulator as S

    step_fn, applies, calls, kept = S.photon_steps, S.graph_applies, [], []

    def keep(*args, tail=None, records=None, inplace=False, **kw):
        calls.append(1)
        if len(calls) == round_no:
            kept.append((
                [a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args],
                {k: ([t.clone() for t in v] if k == "totals" else
                     v.clone() if isinstance(v, torch.Tensor) else v)
                 for k, v in kw.items()}))
            raise _Kept
        return step_fn(*args, tail=tail, records=records, inplace=inplace,
                       **kw)

    S.photon_steps, S.graph_applies = keep, lambda *a: False
    try:
        run()
    except _Kept:
        pass
    finally:
        S.photon_steps, S.graph_applies = step_fn, applies
    if not kept:
        raise RuntimeError(f"the run ended before round {round_no}")
    return kept[0]


def device_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls queued behind a spin
    kernel."""
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_loop_ms(fn, reps: int) -> float:
    """Mean ms a call of the loop as the host issues it (no spin)."""
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_us(fn, loops: int = 25, calls: int = 40) -> list[float]:
    """Host µs a call of ``fn``: the sorted per-call means of ``loops``
    loops of ``calls`` calls, each loop queued behind a spin kernel."""
    out = []
    for _ in range(loops):
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(out)


def cases(dev):
    """``{name: (volume, cfg, state, keywords)}`` of the timed launches."""
    out = {}
    for bench in ("B1", "B2"):
        vol, cfg = get_bench(bench, SIZE, dev)
        cfg = dataclasses.replace(cfg, steps_per_round=K_STEPS)
        out[bench] = (vol, cfg, mid_run_state(vol, cfg)[0], {})
    vol, cfg = get_bench("B2", SIZE, dev)
    cfg = dataclasses.replace(cfg, steps_per_round=K_STEPS, n_time_gates=50,
                              tmax_ns=5.0)
    groups = dict(det_geom=det_geometry(as_detectors(DETECTORS), dev),
                  record=True, stats=True)
    st, pp = mid_run_state(vol, cfg, groups=groups)
    out["B2 detection forward"] = (vol, cfg, st, dict(groups, ppath=pp))
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_timing needs a CUDA device")
    dev = torch.device("cuda")
    results = []
    for name, (vol, cfg, st, kw) in cases(dev).items():
        def call():
            return K.photon_step_cuda(vol.labels.reshape(-1), vol.media, st,
                                      vol.shape, 1.0, cfg, K_STEPS, **kw)
        hosts = host_us(call)
        q = len(hosts) // 4
        out = {"case": name, "lanes": LANES, "k": K_STEPS,
               "ntg": cfg.n_time_gates,
               "device_ms": device_ms(call, args.reps),
               "host_loop_ms": host_loop_ms(call, args.reps),
               "host_us": hosts[len(hosts) // 2],
               "host_us_quartiles": [hosts[q], hosts[-1 - q]],
               "device": torch.cuda.get_device_name(0)}
        if "totals" in inspect.signature(K.photon_step_cuda).parameters:
            # as the simulator launches it: adding into the run's
            # fixed-point totals, with no grid zeroed
            first = call()
            totals = [torch.zeros_like(first[i]) for i in (
                (1, 2, 6, 7) if kw else (1, 2))]

            def call_into():
                return K.photon_step_cuda(
                    vol.labels.reshape(-1), vol.media, st, vol.shape, 1.0,
                    cfg, K_STEPS, totals=totals, **kw)
            out["device_ms_add_into"] = device_ms(call_into, args.reps)
        print(json.dumps(out), flush=True)
        results.append(out)
    return results


if __name__ == "__main__":
    main()
