"""Photons of the window's completed fleets over the whole window."""


def read(run):
    done = sum(s["photons"] for s in run["solutions"])
    return done / (run["window_s"] * 1e3) if done else None
