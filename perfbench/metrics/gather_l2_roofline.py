"""gather_l2_roofline: the exact tier's gather-L2 kernel
(``gather_l2_tiled``) as a share of its roofline (bytes at 3.35 TB/s over
its device time), in %.

Bytes a launch needs: each base row the ids name, once, the ids, the query
line of every query row with a valid id, and the distances written.
Padding ids (-1) read nothing."""

from pbench.launches import distinct_rows, rows_with_work
from pbench.roofline import share

NAME = "gather_l2_roofline"
HOOK = ("repro_torch.kernels.l2dist.ops", "gather_l2_tiled")
# the three kernels gather_l2_tiled picks from (csrc/l2_rows.cuh's register
# kernels in their gathering instances, and gather_l2.cu's block kernel)
DEVICE = r"l2rows::(rows|ragged)_kernel<true|gather_l2_kernel"


def launch_bytes(base, ids, queries):
    """Bytes of one launch on the card (a CPU call launches nothing)."""
    if ids.device.type != "cuda" or ids.numel() == 0:
        return 0
    return bytes_needed(base, ids)


def bytes_needed(base, ids) -> int:
    row = base.shape[1] * 4
    return (distinct_rows(ids) * row + ids.numel() * 4
            + rows_with_work(ids) * row + ids.numel() * 4)


def read(ctx):
    return share(ctx, NAME, DEVICE)
