"""Plain PyTorch version of the top-C merge kernel."""

from __future__ import annotations

import torch


def merge_topc_ref(ids_a, d2_a, vis_a, ids_b, d2_b, vis_b, cap: int):
    """[B, Ca] ⊎ [B, Cb] → the ``cap`` smallest d2 of each row, ascending,
    with their ids and flags: the rows concatenated, sorted stably (the
    lower position wins a tie, so the first part before the second) and
    cut.  Returns new tensors (ids, d2, vis)."""
    ids = torch.cat((ids_a, ids_b), dim=1)
    d2 = torch.cat((d2_a, d2_b), dim=1)
    vis = torch.cat((vis_a, vis_b), dim=1)
    d2_s, idx = torch.sort(d2, dim=-1, stable=True)
    d2_s, idx = d2_s[..., :cap], idx[..., :cap]
    return ids.gather(1, idx), d2_s, vis.gather(1, idx)
