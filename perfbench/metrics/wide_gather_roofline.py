"""wide_gather_roofline: the exact tier's gather-L2 past d = 256
(``gather_l2_tiled`` at d 960: the probing loop's [B, 1] gather, on
whichever kernel the wrapper's route picks at that width, today
``gather_l2.cu``'s block kernel) as a share of its roofline (bytes at HBM's
3.35 TB/s over its device time), in %.  The wide cell's vectors do not fit
the L2, so its rows are read from HBM.

The bytes a launch needs, and the kernels the trace is read for, are
``gather_l2_roofline``'s, read from that reader's file."""

from pathlib import Path

from pbench.cell import load_module
from pbench.roofline import share

NAME = "wide_gather_roofline"
_COUNT = load_module(Path(__file__).with_name("gather_l2_roofline.py"),
                     "perfbench_metric_gather_l2_roofline_count")
HOOK = _COUNT.HOOK
DEVICE = _COUNT.DEVICE
launch_bytes = _COUNT.launch_bytes
bytes_needed = _COUNT.bytes_needed


def read(ctx):
    return share(ctx, NAME, DEVICE)
