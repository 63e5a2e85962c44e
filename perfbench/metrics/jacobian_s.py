"""Window seconds over the window's completed solutions, a solution
being a detection forward and its gate-resolved replay Jacobian: what a
DOT or fNIRS user waits for before each inversion."""


def read(run):
    n = len(run["solutions"])
    return run["window_s"] / n if n else None
