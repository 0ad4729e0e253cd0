"""wide_estimate_roofline: the RaBitQ estimate kernel at the wide cell's
code width (W = 30 words at d 960: three full chunks of 8 words and a last
of 6) as a share of its roofline (bytes at 3.35 TB/s over its device time),
in %.

The bytes a launch needs are ``fused_estimate_roofline``'s count, read from
that reader's file so that both hold the kernel to one count."""

from pathlib import Path

from pbench.cell import load_module
from pbench.roofline import share

NAME = "wide_estimate_roofline"
_COUNT = load_module(Path(__file__).with_name("fused_estimate_roofline.py"),
                     "perfbench_metric_fused_estimate_roofline_count")
HOOK = _COUNT.HOOK
DEVICE = _COUNT.DEVICE
launch_bytes = _COUNT.launch_bytes
bytes_needed = _COUNT.bytes_needed


def read(ctx):
    return share(ctx, NAME, DEVICE)
