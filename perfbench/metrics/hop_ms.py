"""hop_ms: milliseconds of a lock-step iteration of the probing loop, by
the host's clock: the seconds inside the window's search calls over their
iterations.  An iteration launches the RaBitQ estimate once
(``kernels.bitdot.ops.LAUNCHES["fused_estimate"]``, a counter of the
port), so the launches a call adds are its iterations."""


def read(ctx):
    calls = ctx["calls"]
    iterations = sum(c["iterations"] for c in calls)
    if iterations == 0:
        return None
    return 1000.0 * sum(c["search_seconds"] for c in calls) / iterations
