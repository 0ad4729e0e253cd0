"""A kernel's share of its roofline: the least time the bytes its launches
need take at the card's bandwidth, over the time the kernel ran on the
device (from the traced call).  Every kernel the ANN cells time is bound
by bytes: its operations are a few per byte read."""

from __future__ import annotations

from .peaks import H100_HBM_BYTES_PER_S
from .trace import kernel_seconds


def share(ctx: dict, metric: str, device_pattern: str):
    """The share in %, or None where the traced call ran no such kernel or
    the counted launches are not the traced ones."""
    trace, counted = ctx.get("trace"), (ctx.get("bytes") or {}).get(metric)
    if not trace or not counted or counted[1] == 0:
        return None
    secs, launches = kernel_seconds(trace, device_pattern)
    if launches != counted[1] or secs <= 0:
        ctx.setdefault("notes", []).append(
            f"{metric}: {counted[1]} launches counted, {launches} traced")
        return None
    return 100.0 * counted[0] / H100_HBM_BYTES_PER_S / secs
