"""Plain full-matrix attention: the flash-attention kernel's plain version
(the CPU path of ``ops.flash_attention``, and what the CUDA kernel is held
against on the card).  Counterpart of ``repro.kernels.flashattn.ref``."""

from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window=None) -> torch.Tensor:
    """q [B,S,H,hd], k/v [B,S,H,hd] (already GQA-broadcast) → [B,S,H,hd].

    The full S×S score matrix in f32; the output in q's dtype.
    """
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p.masked_fill(~mask, 0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


# The bound that a bf16 output of the kernel is held to against the plain
# version computed in float32 on the same input values.  The kernel keeps
# scores, p, the running max and sums in f32 and rounds only its output to
# bf16, so each element may be off by half a bf16 ulp of its value (at most
# 2^-8 of it) plus the f32 sums' difference in order, which a small share
# of the row's RMS covers with room (it is near 1e-6 of the row).  Scaled to
# each row, so the late rows of a long causal sequence, whose outputs are
# small, are held as tightly as the early ones.
BF16_REL = 2.0 ** -8
BF16_ROW = 2.0 ** -12


def err_ratio(out: torch.Tensor, want: torch.Tensor) -> float:
    """max |out − want| / (BF16_REL·|want| + BF16_ROW·rms(want's row)) over
    every element of [B, S, H, hd] outputs, want in f32; the row is one
    (b, s, h) vector of hd.  At most 1 when out is within the bound."""
    want = want.float()
    rms = want.square().mean(-1, keepdim=True).sqrt()
    lim = BF16_REL * want.abs() + BF16_ROW * rms
    return float(((out.float() - want).abs() / lim.clamp_min(1e-30)).max())
