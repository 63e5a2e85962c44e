"""Device-level workload partitioning (paper Fig. 3b).

The paper models per-device runtime as ``T = a * n + T0`` (slope ``a``
per photon, fixed overhead ``T0``), fits (a, T0) from two pilot runs
(n1 = 1e6, n2 = 5e6 in the paper; scaled down here), and compares three
partitioning strategies for the total photon budget N:

  S1  proportional to core count (the naive baseline),
  S2  proportional to throughput 1/a,
  S3  the minimax linear program  min_T max_i (a_i n_i + T0_i)
      s.t. sum n_i = N  — the paper solves it with MATLAB ``fminimax``;
      we exploit monotonicity:  n_i(T) = max(0, (T - T0_i) / a_i) is
      nondecreasing in T, so the optimal T is found by bisection
      (waterfilling), no solver dependency.

The same machinery drives elastic re-partitioning: when the device set
changes mid-run, the remaining photon budget is re-partitioned over the
surviving devices (multidevice.py).

The port keeps its own copy of the reference's module, which has no
JAX in it (``repro/core/loadbalance.py``), line for line: the
partitioners and fits give the same numbers in both.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Fitted linear runtime model of one device (group).

    ``a`` must be a positive finite seconds-per-photon slope: the
    partitioners divide by it (S2's throughput, S3's waterfilling), so a
    zero/negative/NaN slope would silently produce negative or NaN
    shares that ``_largest_remainder_round`` then mangles into a
    nonsense partition.  Validated here so every entry point — hand-built
    models included — fails loudly instead.
    """

    name: str
    a: float      # seconds per photon
    t0: float     # fixed overhead, seconds
    cores: int = 1

    def __post_init__(self):
        if not (math.isfinite(self.a) and self.a > 0.0):
            raise ValueError(
                f"device model {self.name!r} needs a positive finite "
                f"seconds-per-photon slope, got a={self.a!r} — refit the "
                f"pilot (fit_pilot) with larger photon counts or more "
                f"repeats")
        if not (math.isfinite(self.t0) and self.t0 >= 0.0):
            raise ValueError(
                f"device model {self.name!r} needs a nonnegative finite "
                f"overhead, got t0={self.t0!r}")

    def predict(self, n: float) -> float:
        return self.a * max(n, 0.0) + (self.t0 if n > 0 else 0.0)

    @property
    def throughput(self) -> float:
        """Photons per second, ignoring overhead (the paper's 1/a)."""
        return 1.0 / self.a


def fit_pilot(ns: Sequence[float], times: Sequence[float], name: str = "dev",
              cores: int = 1) -> DeviceModel:
    """Fit T = a*n + T0.  Two points reproduce the paper; more -> lstsq."""
    if len(ns) != len(times) or len(ns) < 2:
        raise ValueError("need >= 2 pilot (n, time) pairs")
    if len(set(ns)) < 2:
        # a degenerate design (all pilot sizes equal) cannot fit a slope:
        # the two-point path would divide by zero and hand an inf/NaN
        # device model to partition_s3, whose bisection then never
        # converges — fail loudly at the fit instead
        raise ValueError(
            f"pilot sizes must contain at least two distinct photon "
            f"counts to fit a slope, got {list(ns)}")
    if len(ns) == 2:
        (n1, n2), (t1, t2) = ns, times
        a = (t2 - t1) / (n2 - n1)
        t0 = t1 - a * n1
    else:
        import numpy as np

        A = np.stack([np.asarray(ns, np.float64),  # reprolint: disable=REP301 - host-side lstsq on pilot timings
                      np.ones(len(ns))], axis=1)
        (a, t0), *_ = np.linalg.lstsq(
            A, np.asarray(times, np.float64), rcond=None)  # reprolint: disable=REP301 - host-side lstsq on pilot timings
    a = float(a)
    if not (math.isfinite(a) and a > 0.0):
        # a noisy pilot (e.g. the larger run timed *faster* than the
        # smaller one) fits a non-positive slope; the old silent
        # clamp-to-1e-12 made the device look ~infinitely fast and the
        # partitioners handed it essentially the whole photon budget —
        # fail loudly with the measurements instead
        raise ValueError(
            f"pilot fit for {name!r} produced a non-positive photon cost "
            f"slope a={a:.3g} (times {list(times)} s at photon counts "
            f"{list(ns)}): timing noise exceeded the signal — rerun the "
            f"pilot with larger photon counts, more repeats, or a warmed-up "
            f"device")
    return DeviceModel(name=name, a=a, t0=max(float(t0), 0.0), cores=cores)


def model_from_samples(samples: Sequence[tuple[float, float]],
                       name: str = "dev", cores: int = 1) -> DeviceModel | None:
    """Fit a DeviceModel from runtime ``(photons, seconds)`` samples.

    The shared fitting rule for measured-throughput feedback (telemetry
    ``fit_device_models``, the resilience pool's per-worker deadline
    models): samples spanning >= 2 distinct photon counts get the
    paper's full ``T = a*n + T0`` fit; equal-size samples (the common
    fixed chunk-size case) fall back to the aggregate-throughput model
    ``a = sum(T)/sum(n), t0 = 0``.  A degenerate fit (timing noise
    producing a non-positive slope) falls back the same way rather than
    raising — live feedback must tolerate noisy early samples.  Returns
    None when the samples carry no usable signal (no positive photon
    count or elapsed time).
    """
    ns = [float(n) for n, _ in samples]
    ts = [float(t) for _, t in samples]
    if len(set(ns)) >= 2:
        try:
            return fit_pilot(ns, ts, name=name, cores=cores)
        except ValueError:
            pass  # noisy fit: fall through to aggregate throughput
    total_n, total_t = sum(ns), sum(ts)
    if total_n <= 0 or total_t <= 0:
        return None
    return DeviceModel(name=name, a=total_t / total_n, t0=0.0, cores=cores)


def run_pilot(run_fn: Callable[[int], float], n1: int, n2: int,
              name: str = "dev", cores: int = 1) -> DeviceModel:
    """Fit a model by timing ``run_fn`` (returns wall seconds) at n1, n2."""
    t1 = run_fn(n1)
    t2 = run_fn(n2)
    return fit_pilot([n1, n2], [t1, t2], name=name, cores=cores)


def _largest_remainder_round(fractions: Sequence[float], total: int) -> list[int]:
    """Round nonnegative real shares to ints summing exactly to ``total``."""
    floors = [int(math.floor(f)) for f in fractions]
    deficit = total - sum(floors)
    order = sorted(
        range(len(fractions)), key=lambda i: fractions[i] - floors[i],
        reverse=True,
    )
    out = list(floors)
    for i in order[:deficit]:
        out[i] += 1
    return out


def partition_s1(n_total: int, devices: Sequence[DeviceModel]) -> list[int]:
    """S1: split proportional to stream-processor / core counts."""
    total_cores = sum(d.cores for d in devices)
    shares = [n_total * d.cores / total_cores for d in devices]
    return _largest_remainder_round(shares, n_total)


def partition_s2(n_total: int, devices: Sequence[DeviceModel]) -> list[int]:
    """S2: split proportional to measured throughput 1/a."""
    total_tp = sum(d.throughput for d in devices)
    shares = [n_total * d.throughput / total_tp for d in devices]
    return _largest_remainder_round(shares, n_total)


def partition_s3(n_total: int, devices: Sequence[DeviceModel],
                 iters: int = 60) -> list[int]:
    """S3: minimax makespan via bisection on the finish time T."""
    if n_total == 0:
        return [0] * len(devices)

    def photons_at(T: float) -> float:
        return sum(max(0.0, (T - d.t0) / d.a) for d in devices)

    lo = min(d.t0 for d in devices)
    hi = max(d.t0 for d in devices) + n_total * min(d.a for d in devices) + 1.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if photons_at(mid) >= n_total:
            hi = mid
        else:
            lo = mid
    shares = [max(0.0, (hi - d.t0) / d.a) for d in devices]
    scale = n_total / max(sum(shares), 1e-12)
    return _largest_remainder_round([s * scale for s in shares], n_total)


def makespan(partition: Sequence[int], devices: Sequence[DeviceModel]) -> float:
    """Predicted wall time of a partition = slowest device's finish time."""
    return max(d.predict(n) for d, n in zip(devices, partition))


def ideal_makespan(n_total: int, devices: Sequence[DeviceModel]) -> float:
    """The paper's 'ideal' bound: summed device speeds, zero overhead."""
    total_tp = sum(d.throughput for d in devices)
    return n_total / total_tp


PARTITIONERS = {"S1": partition_s1, "S2": partition_s2, "S3": partition_s3}
