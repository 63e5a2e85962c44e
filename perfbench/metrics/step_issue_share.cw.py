"""Share of the traced window the host spent in ``round.step`` spans: the
photon-step call's host side (``prepare``, ``pack``, the launch), summed
over the profiled CW solutions."""

from perfbench import spans


def read(run):
    return spans.share(run, "round.step")
