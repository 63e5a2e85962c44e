"""Milliseconds of each window fleet's wall outside its
``scenarios.batch`` spans (scenario preparation, stacking, grouping,
the cache's look-up), averaged over the fleets."""


def read(run):
    s = run["solutions"]
    if not s:
        return None
    return sum(x["fleet_s"] - x["batch_s"] for x in s) * 1e3 / len(s)
