"""Kernels, copies and sets of the profiled solutions' trace, over their
rounds (``SimResult.steps / K``): what fusing the round would cut."""


def read(run):
    t, rounds = run["trace"], sum(s["rounds"] for s in run["profiled"])
    return None if t is None or not rounds else t.device_events / rounds
