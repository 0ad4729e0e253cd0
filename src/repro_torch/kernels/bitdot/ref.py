"""Plain PyTorch versions of the bitdot and fused-estimate kernels."""

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


def estimate_from_s_plus(s_plus, ids, norms, ip_xo, sum_q, norm_q, sqrt_d):
    """The RaBitQ estimator algebra on S₊ f32[B, K] for ids int32[B, K]:
    ``max(nv² + nq² − 2·nv·nq·((2S₊ − Σq)/√d)/max(ip_xo, 1e-6), 0)``, +inf
    at ids < 0.  norms / ip_xo f32[n] are the code table's; sum_q / norm_q
    f32[B]; sqrt_d a scalar tensor."""
    safe = ids.clamp_min(0).long()
    sum_q = sum_q[:, None]
    ip_xq = (2.0 * s_plus - sum_q) / sqrt_d
    est_cos = ip_xq / torch.clamp_min(ip_xo[safe], 1e-6)
    nv = norms[safe]
    norm_q = norm_q[:, None]
    d2 = nv * nv + norm_q * norm_q - 2.0 * nv * norm_q * est_cos
    d2 = torch.clamp_min(d2, 0.0)
    return torch.where(ids >= 0, d2, torch.full_like(d2, float("inf")))


def fused_estimate_ref(codes, norms, ip_xo, ids, q_unit, sum_q, norm_q,
                       sqrt_d):
    """Estimated squared distances f32[B, K] for ids int32[B, K] (-1 → +inf)
    from the code table int32[n, W], norms / ip_xo f32[n], and the batched
    query context (q_unit f32[B, d], sum_q / norm_q f32[B], √d).

    S₊ comes from the ±1 signs, ``S₊ = (signs·q + Σq) / 2``, as the JAX
    package's ``rabitq.estimate_sqdist`` computes it.
    """
    rows = codes[ids.clamp_min(0).long()]                     # [B, K, W]
    signs = 2.0 * unpack_bits_ref(rows, q_unit.shape[-1]) - 1.0
    s_plus = 0.5 * (torch.bmm(signs, q_unit[:, :, None])[..., 0]
                    + sum_q[:, None])
    return estimate_from_s_plus(s_plus, ids, norms, ip_xo, sum_q, norm_q,
                                sqrt_d)
