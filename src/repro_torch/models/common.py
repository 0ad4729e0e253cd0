"""Shared LM building blocks, on PyTorch.  Counterpart of the LM part of
``repro.models.common`` (the GRU helpers come with the recsys slice).

Parameters are plain dicts of tensors; initializers draw from an explicit
``torch.Generator`` (it gives other numbers than ``jax.random`` from the
same seed: tests carry the reference's parameters across instead).

  * ``rms_norm`` / ``swiglu`` / ``dense_init``
  * ``rope_freqs`` / ``apply_rope`` — rotary embeddings, half-split
    convention (``x1, x2 = split(x, 2)``), angles in f32
  * ``flash_attention`` — the blockwise online-softmax attention of the
    reference on the CPU (or anywhere with ``backend="jnp"``), and the CUDA
    flash-attention kernel on a CUDA tensor, with its backward kernel when
    autograd needs one
  * ``decode_attention`` — one new token against a KV cache (plain PyTorch:
    it is jnp in the reference, not a Pallas kernel)
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.flashattn import ops as flash_ops

BACKENDS = ("auto", "jnp")


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale=None, device=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device or gen.device)
    return (w * scale).to(dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x [..., S, H, hd], positions [..., S] (int) → same shape."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)          # [hd/2]
    ang = positions[..., None].float() * freqs               # [..., S, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    block_q: int = 512, block_k: int = 512,
                    backend: str = "auto") -> torch.Tensor:
    """q [B, S, H, hd], k/v [B, S, KV, hd] → [B, S, H, hd] in q's dtype.

    ``backend="auto"``: the CUDA kernel on a CUDA tensor (its tiles are its
    own; ``block_q``/``block_k`` are not read), differentiable through the
    backward kernel (``flash_ops.attention``), and the plain blockwise
    version on a CPU tensor, which autograd differentiates as ``jax.grad``
    differentiates the reference's.  ``backend="jnp"``: the plain blockwise
    version on any device.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "auto" and q.device.type != "cpu":
        return flash_ops.attention(q, k, v, causal=causal, window=window)
    return _blockwise_attention(q, k, v, causal, window, block_q, block_k)


def _blockwise_attention(q, k, v, causal, window, block_q, block_k):
    """The reference's online softmax over KV blocks (``common.py``'s
    ``flash_attention``): -inf masking with a finite-max guard, p rounded to
    V's dtype before the PV product, f32 sums.  Blocks are sliced, not
    padded, and key blocks wholly outside the causal / window band are
    skipped: neither changes the result beyond float rounding."""
    B, S, H, hd = q.shape
    groups = H // k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    block_q, block_k = min(block_q, S), min(block_k, S)
    kf = k.repeat_interleave(groups, dim=2)
    vf = v.repeat_interleave(groups, dim=2)
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=q.device)
    pos = torch.arange(S, device=q.device)
    for q0 in range(0, S, block_q):
        q1 = min(q0 + block_q, S)
        qb = q[:, q0:q1].float()
        qpos = pos[q0:q1]
        acc = torch.zeros((B, q1 - q0, H, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, q1 - q0, H), float("-inf"), device=q.device)
        denom = torch.zeros((B, q1 - q0, H), device=q.device)
        for k0 in range(0, S, block_k):
            k1 = min(k0 + block_k, S)
            if causal and k0 > q1 - 1:
                break
            if window is not None and (q0 - (k1 - 1)) >= window:
                continue
            kpos = pos[k0:k1]
            s = torch.einsum("bqhd,bkhd->bqhk", qb, kf[:, k0:k1].float()) * scale
            mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window is not None:
                mask &= (qpos[:, None] - kpos[None, :]) < window
            mask4 = mask[None, :, None, :]
            s = s.masked_fill(~mask4, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new,
                                 torch.zeros_like(m_new))
            p = torch.exp(s - m_safe[..., None]).masked_fill(~mask4, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                               torch.zeros_like(m))
            pv = torch.einsum("bqhk,bkhd->bqhd", p.to(v.dtype).float(),
                              vf[:, k0:k1].float())
            acc = acc * corr[..., None] + pv
            denom = denom * corr + p.sum(-1)
            m = m_safe
        out[:, q0:q1] = acc / denom.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """q [B, H, hd] (one new token a sequence), caches [B, S, KV, hd], pos
    [B] (the number of valid cache entries) → [B, H, hd]."""
    B, S, KV, hd = k_cache.shape
    H = q.shape[1]
    groups = H // KV
    scale = 1.0 / math.sqrt(hd)
    q3 = q.reshape(B, KV, groups, hd).to(k_cache.dtype).float()
    s = torch.einsum("bkgd,bskd->bkgs", q3, k_cache.float()) * scale
    idx = torch.arange(S, device=q.device)[None, :]
    mask = idx < pos[:, None]
    if window is not None:
        mask &= idx >= (pos[:, None] - window)
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype)
