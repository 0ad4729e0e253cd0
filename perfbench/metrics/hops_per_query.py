"""hops_per_query: the mean over the window's queries of the nodes each
expanded or probed (``n_hops`` of the search's result, per query).  For a
seed it is a count that repeats."""


def read(ctx):
    calls = [c for c in ctx["calls"] if c.get("hops_sum") is not None]
    queries = sum(c["queries"] for c in calls)
    if queries == 0:
        return None
    return sum(c["hops_sum"] for c in calls) / queries
