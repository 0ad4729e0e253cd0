"""estimate_ms: the RaBitQ estimate kernel's device milliseconds a pass of
the probing loop: its device time in the traced replay of the window's
first call over that call's iterations (each launches the estimate once,
``kernels.bitdot.ops.LAUNCHES["fused_estimate"]``).  None where the trace
holds another number of launches than the call's iterations."""

from pbench.trace import kernel_seconds

NAME = "estimate_ms"
DEVICE = r"fused_estimate_kernel"


def read(ctx):
    trace, calls = ctx.get("trace"), ctx.get("calls")
    if not trace or not calls or not calls[0].get("iterations"):
        return None
    secs, launches = kernel_seconds(trace, DEVICE)
    if launches != calls[0]["iterations"] or secs <= 0:
        ctx.setdefault("notes", []).append(
            f"{NAME}: {calls[0]['iterations']} iterations, {launches} "
            "estimate launches traced")
        return None
    return 1000.0 * secs / launches
