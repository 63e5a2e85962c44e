"""Records replayed over the host-clock seconds of the window's
``replay_jacobian`` calls (each ended by a synchronisation)."""


def read(run):
    s = run["solutions"]
    secs = sum(x["replay_s"] for x in s)
    return sum(x["records"] for x in s) / (secs * 1e3) if secs else None
