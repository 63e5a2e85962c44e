"""Share of the profiled skin-vessel solutions' wall in which no kernel,
copy or set ran on the device (union of the trace's device intervals)."""


def read(run):
    t = run["trace"]
    return None if t is None else 1.0 - t.busy_s / t.window_s
