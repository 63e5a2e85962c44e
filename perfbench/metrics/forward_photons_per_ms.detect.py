"""Photons over the host-clock seconds of the window's detection
forwards (``simulate`` to its records, ended by a synchronisation)."""


def read(run):
    s = run["solutions"]
    secs = sum(x["forward_s"] for x in s)
    return sum(x["photons"] for x in s) / (secs * 1e3) if secs else None
