"""Share of the traced window the host spent in ``round.regenerate`` spans:
regeneration (``_regenerate``, relaunching dead lanes), summed over the
profiled fleets."""

from perfbench import spans


def read(run):
    return spans.share(run, "round.regenerate")
