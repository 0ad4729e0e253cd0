"""fused_estimate_roofline: the RaBitQ estimate kernel's share of its
roofline (bytes at 3.35 TB/s over its device time), in %.

Bytes a launch needs, from the algorithm's shapes: each code row the ids
name, once (code words, ‖v − c‖ and ⟨x̄, o⟩), the ids, the query context of
every query row with a valid id (its rotated unit direction, Σ and norm),
√d, and the estimates written.  Padding ids (-1) read nothing."""

from pbench.launches import distinct_rows, rows_with_work
from pbench.roofline import share

NAME = "fused_estimate_roofline"
HOOK = ("repro_torch.kernels.bitdot.ops", "fused_estimate")
DEVICE = r"fused_estimate_kernel"


def launch_bytes(codes, norms, ip_xo, ids, q_unit, sum_q, norm_q, sqrt_d):
    """Bytes of one launch on the card (a CPU call launches nothing)."""
    if ids.device.type != "cuda" or ids.numel() == 0:
        return 0
    return bytes_needed(codes, ids, q_unit)


def bytes_needed(codes, ids, q_unit) -> int:
    row_bytes = codes.shape[1] * 4 + 4 + 4
    query_bytes = q_unit.shape[1] * 4 + 4 + 4
    return (distinct_rows(ids) * row_bytes + ids.numel() * 4
            + rows_with_work(ids) * query_bytes + 4 + ids.numel() * 4)


def read(ctx):
    return share(ctx, NAME, DEVICE)
