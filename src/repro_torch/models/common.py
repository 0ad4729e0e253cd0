"""Shared model building blocks, on PyTorch.  Counterpart of
``repro.models.common``: the LM blocks, and the GRU and MLP of the recsys
models.

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
  * ``gru_init`` / ``gru_cell`` / ``gru_scan`` — DIEN's GRU and AUGRU, a
    Python loop over time where the reference scans
  * ``mlp_init`` / ``mlp_apply`` — ReLU towers
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


# ---------------------------------------------------------------------------
# GRU (for DIEN), a loop over time
# ---------------------------------------------------------------------------

def gru_init(gen: Optional[torch.Generator], d_in: int, d_h: int,
             dtype=torch.float32, device=None) -> dict:
    dev = device or gen.device
    return {
        "w_x": dense_init(gen, d_in, 3 * d_h, dtype, device=dev),
        "w_h": dense_init(gen, d_h, 3 * d_h, dtype, device=dev),
        "b": torch.zeros((3 * d_h,), dtype=dtype, device=dev),
    }


def gru_cell(p: dict, h: torch.Tensor, x: torch.Tensor,
             att: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One GRU step, the reference's arithmetic: ``n`` is computed again
    from the last d_h columns of ``w_x``, ``w_h`` and ``b`` with ``r * h``.
    ``att`` (a scalar a row) scales the update gate: AUGRU (DIEN eq. 5).
    ``x`` may have one row against ``h``'s many: it broadcasts."""
    zx = x @ p["w_x"] + h @ p["w_h"] + p["b"]
    z, r, n = zx.chunk(3, dim=-1)
    z = torch.sigmoid(z)
    r = torch.sigmoid(r)
    d_h = n.shape[-1]
    n = torch.tanh(x @ p["w_x"][:, -d_h:] + (r * h) @ p["w_h"][:, -d_h:]
                   + p["b"][-d_h:])
    if att is not None:
        z = z * att[..., None]
    return (1.0 - z) * h + z * n


def gru_scan(p: dict, xs: torch.Tensor, h0: Optional[torch.Tensor] = None,
             atts: Optional[torch.Tensor] = None, keep_states: bool = True
             ) -> tuple[Optional[torch.Tensor], torch.Tensor]:
    """xs [B, T, d_in] → (all states [B, T, d_h], final state [B, d_h]).

    ``h0`` [B', d_h] may have more rows than ``xs`` has (one): every row
    then reads the same inputs (DIEN's retrieval runs one user's states
    against each candidate's attention).  ``keep_states=False`` returns
    None for the states and keeps only the running one."""
    d_h = p["w_h"].shape[0]
    if h0 is None:
        h0 = torch.zeros((xs.shape[0], d_h), dtype=xs.dtype, device=xs.device)
    h, states = h0, []
    for t in range(xs.shape[1]):
        h = gru_cell(p, h, xs[:, t], None if atts is None else atts[:, t])
        if keep_states:
            states.append(h)
    return (torch.stack(states, 1) if keep_states else None), h


def mlp_init(gen: Optional[torch.Generator], dims: list, dtype=torch.float32,
             device=None) -> dict:
    dev = device or gen.device
    n = len(dims) - 1
    return {
        **{f"w{i}": dense_init(gen, dims[i], dims[i + 1], dtype, device=dev)
           for i in range(n)},
        **{f"b{i}": torch.zeros((dims[i + 1],), dtype=dtype, device=dev)
           for i in range(n)},
    }


def mlp_apply(p: dict, x: torch.Tensor, n_layers: int,
              final_act: bool = False) -> torch.Tensor:
    for i in range(n_layers):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n_layers - 1 or final_act:
            x = torch.relu(x)
    return x
