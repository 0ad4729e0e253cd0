"""Plain full-matrix attention and its backward: the flash-attention
kernels' plain versions (the CPU paths of ``ops.flash_attention`` and
``ops.flash_attention_bwd``, and what the CUDA kernels are held against on
the card).  ``attention_ref`` is the counterpart of
``repro.kernels.flashattn.ref``; ``attention_bwd_ref`` has none there (the
JAX package differentiates its attention with ``jax.grad``)."""

from __future__ import annotations

import math

import torch

LOG2_E = 1.0 / math.log(2.0)


def _mask(S: int, causal: bool, window, device) -> torch.Tensor:
    pos = torch.arange(S, device=device)
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window=None, return_lse: bool = False):
    """q [B,S,H,hd], k/v [B,S,H,hd] (already GQA-broadcast) → [B,S,H,hd].

    The full S×S score matrix in f32; the output in q's dtype.  With
    ``return_lse`` also each row's log-sum-exp of its masked scaled scores
    in log2 units, f32 [B,H,S]: what the bf16 forward kernel writes for
    its backward.
    """
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _mask(S, causal, window, q.device)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p.masked_fill(~mask, 0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, -1) * LOG2_E
    return out


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, causal: bool = True,
                      window=None) -> tuple:
    """The backward of attention by its explicit formulas on the full
    matrices, in f32: q, o, do [B,S,H,hd], k, v [B,S,KV,hd] (query head h
    reads KV head h // (H / KV)) → (dq [B,S,H,hd], dk, dv [B,S,KV,hd]) in
    the inputs' dtype.

    P comes from each row's log-sum-exp, D = rowsum(dO ∘ O) from the given
    output, dS = P ∘ (dP − D) with dP = dO Vᵀ; dQ = dS K / √hd, dK = dSᵀ Q
    / √hd and dV = Pᵀ dO, the last two summed over each KV head's group.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf, of, dof = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    mask = _mask(S, causal, window, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    p = p.masked_fill(~mask, 0.0)
    del s
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    dsum = (dof * of).sum(-1).permute(0, 2, 1)[..., None]       # [B,H,S,1]
    ds = p * (dp - dsum)
    del dp
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    del ds
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(B, S, KV, G, hd).sum(3)
    dv = dv.reshape(B, S, KV, G, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


# The backward kernel's gradients are held to the same per-element bound,
# plus a floor at 2^-16 of the whole gradient's RMS.  dS = P ∘ (dP − D)
# cancels where a row's keys are few: the first row of a causal sequence
# has one key, P = 1 and dP = D, so its dQ (and the last key's dK) is zero
# in exact arithmetic and f32 rounding noise in both versions (~2^-23 of
# |dP|); the row's own RMS is then that noise.  The floor is ~10x that
# noise and 1/16 of the row term at the gradient's typical scale.
GRAD_FLOOR = 2.0 ** -16


def grad_err_ratio(out: torch.Tensor, want: torch.Tensor) -> float:
    """max |out − want| / (BF16_REL·|want| + BF16_ROW·rms(want's row) +
    GRAD_FLOOR·rms(want)) over every element of [B, S, heads, hd]
    gradients, want in f32.  At most 1 when out is within the bound."""
    want = want.float()
    rms = want.square().mean(-1, keepdim=True).sqrt()
    lim = (BF16_REL * want.abs() + BF16_ROW * rms
           + GRAD_FLOOR * float(want.square().mean().sqrt()))
    return float(((out.float() - want).abs() / lim.clamp_min(1e-30)).max())
