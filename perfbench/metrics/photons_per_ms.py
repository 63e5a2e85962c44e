"""Photons of the window's completed CW solutions over the whole window
(host clock, to the synchronised end of the last): the paper's metric."""


def read(run):
    done = sum(s["photons"] for s in run["solutions"])
    return done / (run["window_s"] * 1e3) if done else None
