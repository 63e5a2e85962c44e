"""The benchmark of the PyTorch and CUDA port, one cell a run.

    python3 perfbench/run.py --workload b1.cw --seed 7 --seconds 10 --trace 0

Runs from the root of a checkout that holds ``BENCHMARK.json``,
``perfbench/`` and the port (``src/repro_torch``).  A run:

  1. sets up: imports, the CUDA context, the cell's kernel variants
     (built into the checkout's ``build/`` at a checkout's first run),
     the volume on the device, one short solution as warm-up
     (``setup_s``, from the start of the process);
  2. runs whole solutions back to back until ``--seconds`` have passed;
     the window runs from the start of the first solution to the
     synchronised end of the last; of their outputs it keeps only one
     solution's, drawn from the seed as the window runs;
  3. with ``--trace 1``, runs the cell's profiled solutions under
     ``torch.profiler`` after the window;
  4. reads the device's peak memory, releases the port's state, and
     holds one solution drawn from the seed against the plain reference
     (``perfbench/reference``), every int64 output exact;
  5. prints the numbers compared beside their limits on standard error,
     and as its last line of standard output one JSON object:
     ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
     end-to-end metrics, or with ``--trace 1`` its per-layer ones),
     ``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last.

It exits with 2, printing no result, without a CUDA device or with
fewer than the cell's chips, without the port beside it, or when a
module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# modules that must never load in a run: JAX, and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# every compared number counts entries or solutions that differ from the
# plain reference's bits; the sums are exact, so the limit is 0
LIMIT = 0


def _environment() -> None:
    """Keep every cache of the run inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, taken whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _fail(msg: str, code: int = 2):
    print(f"perfbench: {msg}", file=sys.stderr)
    sys.exit(code)


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def _window(drv, seconds: float, sample):
    """Whole solutions back to back until ``seconds`` have passed:
    ``(their stats, faults, failed, attempted, window_s)``; each
    completed solution is offered to ``sample`` and then dropped.  A
    solution that raises or fails its quick checks counts as failed."""
    stats, faults, failed, attempted = [], [], 0, 0
    t0 = time.perf_counter()
    t_end = t0
    while t_end - t0 < seconds:
        attempted += 1
        t_sol = t_end
        try:
            sol = drv.solve(attempted - 1)
        except Exception as e:
            failed += 1
            faults.append(f"solution {attempted - 1}: "
                          f"{type(e).__name__}: {e}")
            t_end = time.perf_counter()
            continue
        t_end = time.perf_counter()
        bad = drv.quick_check(sol)
        if bad:
            failed += 1
            faults.extend(bad)
        else:
            stats.append(dict(drv.stats(sol), wall_s=t_end - t_sol))
        sample.offer(sol)
        sol = None
    return stats, faults, failed, attempted, t_end - t0


def run(argv=None, device=None) -> dict:
    """One run; returns the result line.  ``device`` (tests only) runs
    the cell on that device and skips the look for a card."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from perfbench import harness

    bench = harness.benchmark(ROOT)
    if not (ROOT / "src" / "repro_torch").is_dir():
        _fail("the port (src/repro_torch) is not in this checkout")
    import torch

    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        _fail(f"no workload {args.workload!r} in BENCHMARK.json")
    if device is None:
        if not torch.cuda.is_available():
            _fail("no CUDA device")
        if torch.cuda.device_count() < chips:
            _fail(f"{args.workload} needs {chips} cards, "
                  f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cell = harness.find_cell(bench, args.workload, ROOT, args.seed, device)
    drv = harness.driver(cell)
    drv.set_up()
    drv.warm_up()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T_START

    sample = harness.Sample(args.seed)
    stats, faults, failed, attempted, window_s = _window(
        drv, args.seconds, sample)

    trace, profiled = None, []
    if args.trace:
        from perfbench import profiling

        n_prof = int(cell.workload.get("profile_solutions", 1))
        profiled, trace = profiling.profiled(
            lambda: [drv.solve(attempted + k) for k in range(n_prof)])
        for sol in profiled:
            faults.extend(drv.quick_check(sol))
        profiled = [drv.stats(sol) for sol in profiled]

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    # -- the comparison with the plain reference --------------------------
    checks = {"solutions_failed": failed}
    sample = sample.kept
    drv.release()
    t_ref = time.perf_counter()
    if sample is not None:
        checks.update(drv.compare(sample, drv.reference(sample)))
    sample = None
    ref_s = time.perf_counter() - t_ref
    correct = (bool(stats) and not faults
               and all(v <= LIMIT for v in checks.values()))

    # -- the metrics -----------------------------------------------------
    record = {"cell": cell, "setup_s": setup_s, "window_s": window_s,
              "attempted": attempted, "solutions": stats, "trace": trace,
              "profiled": profiled}
    metrics = {}
    for m in harness.metrics_of(bench, args.workload, bool(args.trace)):
        value = harness.reader(ROOT, m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    bad = forbidden_modules()
    if bad:
        _fail(f"modules of JAX or the JAX package were loaded: {bad}")
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": int(chips), "memory_peak_bytes": int(peak)}
    if trace is not None:
        dev_info.update(busy_s=trace.busy_s, window_s=trace.window_s)
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev_info}
    if trace is not None:
        out["breakdown"] = {"device_ops": trace.device_ops,
                            "idle_gaps": trace.idle_gaps}
    out["checks"] = {k: {"value": v, "limit": LIMIT}
                     for k, v in checks.items()}
    for f in faults[:20]:
        print(f"perfbench: fault: {f}", file=sys.stderr)
    print(f"perfbench: setup {setup_s:.3f} s, window {window_s:.3f} s, "
          f"reference {ref_s:.3f} s, solutions "
          f"{[round(s['wall_s'], 4) for s in stats]}", file=sys.stderr)
    if device.type == "cuda":
        print(f"perfbench: card {_power_limit()}", file=sys.stderr)
    for k, v in checks.items():
        print(f"perfbench: check {k} = {v} (limit {LIMIT})",
              file=sys.stderr)
    return out


def main() -> None:
    out = run()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
