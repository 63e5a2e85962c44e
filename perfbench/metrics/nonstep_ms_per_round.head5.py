"""Device milliseconds of every kernel, copy and set but the photon
step, over the profiled five-layer head forwards' rounds: regeneration,
totals and the records' append."""


def read(run):
    t, rounds = run["trace"], sum(s["rounds"] for s in run["profiled"])
    return None if t is None or not rounds else t.other_s * 1e3 / rounds
