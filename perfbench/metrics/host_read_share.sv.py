"""Share of the traced window the host spent in ``round.host_read`` spans,
summed over the profiled skin-vessel solutions: the host waiting for the
card, which rises as the kernel takes the lead."""

from perfbench import spans


def read(run):
    return spans.share(run, "round.host_read")
