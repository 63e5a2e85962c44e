"""The photon-step kernel's share of its roofline in the profiled CW
solutions, in percent: their least time (``perfbench/roofline.py``,
from the live segments a photon frozen in the cell's file) over the
kernel's device time in the trace."""

from perfbench import roofline


def read(run):
    t = run["trace"]
    live = run["cell"].workload.get("live_segments_per_photon")
    if t is None or live is None or not t.step_s:
        return None
    vol = run["cell"].config["volume"]
    nx, ny, nz = vol["shape"]
    n_media = 2 + len(vol.get("inclusions", ()))
    least = sum(roofline.least_seconds(live["mean"] * s["photons"],
                                       nx * ny * nz, nx * ny, n_media)
                ["seconds"] for s in run["profiled"])
    return 100.0 * least / t.step_s
