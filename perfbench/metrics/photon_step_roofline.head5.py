"""The photon-step kernel's share of its roofline in the profiled
five-layer head forwards (its detector and record variant), in percent:
their least time over the kernel's device time in the trace.

The operations are ``perfbench/roofline.py``'s frozen counts a live
lane-segment, times the live segments a photon frozen in the cell's
file.  The bytes are what a forward must move, counted here: the labels
and media read once; the int64 grids written once (fluence over every
gate, exitance, the TPSF of each detector and gate, the path sums of
each detector and medium); and 32 bytes a record kept."""

from perfbench import roofline

RECORD_BYTES = 32


def least_seconds(live_segments: float, nvox: int, nxy: int, n_media: int,
                  n_det: int, ntg: int, records: int) -> float:
    f32 = roofline.F32_OPS_PER_SEGMENT * live_segments / roofline.F32_OPS_PER_S
    mufu = (roofline.MUFU_OPS_PER_SEGMENT * live_segments
            / roofline.MUFU_OPS_PER_S)
    grids = nvox * ntg + nxy + n_det * ntg + n_det * n_media
    hbm = (nvox + 16 * n_media + roofline.FIXED_BYTES * grids
           + RECORD_BYTES * records) / roofline.HBM_BYTES_PER_S
    return max(f32, mufu, hbm)


def read(run):
    t = run["trace"]
    cell = run["cell"]
    live = cell.workload.get("live_segments_per_photon")
    if t is None or live is None or not t.step_s:
        return None
    vol = cell.config["volume"]
    nx, ny, nz = vol["shape"]
    n_media = 1 + len(vol["media"])
    n_det = len(cell.workload.get("detectors", cell.config["detectors"]))
    ntg = int(cell.workload["time_gates"])
    least = sum(least_seconds(live["mean"] * s["photons"], nx * ny * nz,
                              nx * ny, n_media, n_det, ntg, s["records"])
                for s in run["profiled"])
    return 100.0 * least / t.step_s
