"""serve_mfu: the whole call's useful FLOPs (the frozen counts in
``pbench.peaks``) over the window's seconds and the card's float32 peak,
in %.  It bounds every kernel's gain: a kernel taken off the path leaves
its roofline silent, not this."""

from pbench.peaks import H100_FP32_FLOPS


def read(ctx):
    flops = sum(c["flops"] for c in ctx["calls"])
    if flops <= 0 or ctx["window_s"] <= 0:
        return None
    return 100.0 * flops / ctx["window_s"] / H100_FP32_FLOPS
