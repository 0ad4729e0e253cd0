"""Plain PyTorch version of the gather-L2 kernels (the CPU path, and what
the CUDA kernel is held against on the card)."""

from __future__ import annotations

import torch


def gather_l2_ref(base: torch.Tensor, ids: torch.Tensor,
                  queries: torch.Tensor) -> torch.Tensor:
    """base f32[n, d], ids int32[B, M] (-1 = invalid), queries f32[B, d] →
    f32[B, M] squared distances by the difference form; +inf at invalid
    ids."""
    rows = base[ids.clamp_min(0).long()]                  # [B, M, d]
    diff = rows - queries[:, None, :]
    d2 = (diff * diff).sum(-1)
    return torch.where(ids >= 0, d2, torch.full_like(d2, float("inf")))
