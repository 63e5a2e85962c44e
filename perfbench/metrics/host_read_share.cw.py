"""Share of the traced window the host spent in ``round.host_read`` spans:
the loop condition's blocking read and the cancel test, summed over the
profiled CW solutions."""

from perfbench import spans


def read(run):
    return spans.share(run, "round.host_read")
