"""idle_share: the share of a call's wall time in which no operation ran
on the device, in %.  The busy seconds are the union of the device's
operations in the profiler's trace of a replay of the window's first call
(the same inputs, so the same device work); the wall time is that call's
own, untraced: the profiler slows the host's launches, and its window
would count that as idle."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or trace["busy_s"] <= 0 or trace["untraced_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["untraced_s"])
