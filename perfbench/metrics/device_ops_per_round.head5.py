"""Kernels, copies and sets of the profiled five-layer head forwards'
trace, over their rounds (``SimResult.steps / K``): the graph's nodes a
round, the records' append among them."""


def read(run):
    t, rounds = run["trace"], sum(s["rounds"] for s in run["profiled"])
    return None if t is None or not rounds else t.device_events / rounds
