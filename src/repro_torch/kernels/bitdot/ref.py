"""Plain PyTorch version of the bitdot kernel."""

from __future__ import annotations

import torch


def unpack_bits_ref(codes: torch.Tensor, dim: int) -> torch.Tensor:
    """int32[..., W] (uint32 bit patterns) → f32[..., dim] of {0, 1}."""
    shifts = torch.arange(32, dtype=torch.int32, device=codes.device)
    bits = (codes[..., None] >> shifts) & 1
    return bits.reshape(*codes.shape[:-1], -1)[..., :dim].float()


def bitdot_ref(codes: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """S₊[b, k] = Σ_{j: bit j of codes[b, k] set} q[b, j].

    codes int32[B, K, W], q f32[B, d] with d ≤ 32·W → f32[B, K].
    """
    bits = unpack_bits_ref(codes, q.shape[-1])
    return torch.bmm(bits, q[:, :, None].float())[..., 0]
