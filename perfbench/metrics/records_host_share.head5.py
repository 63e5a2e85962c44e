"""Share of the traced window the host spent in ``round.records`` spans
(the append of a round's captures to the record buffer), summed over the
profiled five-layer head forwards: near 0 while the append is a part of
the captured round, which the host issues once a run; it rises if the
append falls out of the graph.  A port without the span gives none."""

from perfbench import spans


def read(run):
    return spans.share(run, "round.records")
