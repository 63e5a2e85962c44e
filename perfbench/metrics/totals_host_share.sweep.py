"""Share of the traced window the host spent in ``round.totals`` spans: the
round's totals, records and counters, summed over the profiled fleets."""

from perfbench import spans


def read(run):
    return spans.share(run, "round.totals")
