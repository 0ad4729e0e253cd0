"""Mixture-of-Experts FFN layer (capacity-based, grouped sort-dispatch), on
PyTorch.  Counterpart of ``repro.models.moe``.

Top-k routing with a fixed per-expert capacity, computed within
``n_groups`` independent token groups (lowered until it divides T).  Per
group the capacity is ``C = max(int(ceil(Tg·k/E) · cf), 8)``, capped at
``Tg·k``; an entry whose position within its expert is ≥ C is dropped and
adds nothing.  Aux outputs: the Switch load-balance loss, the router
z-loss and the dropped share.

The reference's semantics are kept where they decide a result:

* top-k is taken from the f32 probabilities with ties broken as
  ``jax.lax.top_k`` breaks them, lowest expert first (a stable
  descending sort; ``torch.topk`` orders ties otherwise);
* the dispatch order is a stable argsort of the flat expert ids, and an
  entry's position within its expert is its sorted index less
  ``searchsorted(..., side="left")`` of its expert;
* the combine adds each token's kept contributions in ``x.dtype`` in
  expert-ascending order, the order of the reference's scatter-add.  Here
  each token reads its k slots back through the dispatch permutation and
  adds them one after another, with no atomics: the result is the same on
  every run, on the card too.

Differences from the reference, none of which changes a result: the
expert tiles are gathered straight from the tokens through a slot → token
map (the reference scatters the gathered rows into a buffer with a dump
row), and ``hints.constrain`` (XLA sharding hints) is left out.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import dense_init


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype, device=None) -> dict:
    """The router ``[d, E]`` in f32 and the expert stacks ``w_gate``,
    ``w_up`` ``[E, d, f]`` and ``w_down`` ``[E, f, d]`` in ``dtype``."""
    device = device or gen.device

    def stack(d_in, d_out):
        w = torch.randn((n_experts, d_in, d_out), generator=gen,
                        dtype=torch.float32, device=device)
        return (w * (1.0 / math.sqrt(d_in))).to(dtype)

    return {
        "router": dense_init(gen, d_model, n_experts, torch.float32,
                             device=device),
        "w_gate": stack(d_model, d_ff),
        "w_up": stack(d_model, d_ff),
        "w_down": stack(d_ff, d_model),
    }


def capacity(T: int, top_k: int, n_experts: int,
             capacity_factor: float = 1.25, n_groups: int = 1):
    """(G, C): the dispatch groups and the per-group expert capacity for T
    tokens, as the reference computes them."""
    G = max(min(n_groups, T), 1)
    while T % G:
        G -= 1
    Tg = T // G
    C = max(int(((Tg * top_k + n_experts - 1) // n_experts)
                * capacity_factor), 8)
    return G, min(C, Tg * top_k)


def moe_apply(p: dict, x: torch.Tensor, top_k: int,
              capacity_factor: float = 1.25,
              n_groups: int = 1) -> tuple[torch.Tensor, dict]:
    """x [T, d] → (out [T, d] in x's dtype, aux {lb_loss, z_loss,
    frac_dropped} as f32 scalars)."""
    T, d = x.shape
    E = p["router"].shape[1]
    k = top_k
    G, C = capacity(T, k, E, capacity_factor, n_groups)
    Tg = T // G

    xg = x.reshape(G, Tg, d)
    logits = xg.float() @ p["router"]                           # [G, Tg, E]
    probs = torch.softmax(logits, dim=-1)
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = ranked.values[..., :k]                          # [G, Tg, k]
    expert_ids = ranked.indices[..., :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- dispatch (batched over groups) ----
    flat_expert = expert_ids.reshape(G, Tg * k)
    order = torch.argsort(flat_expert, dim=1, stable=True)
    sorted_expert = flat_expert.gather(1, order)
    first_pos = torch.searchsorted(sorted_expert, sorted_expert, side="left")
    pos = torch.arange(Tg * k, device=x.device) - first_pos
    keep = pos < C
    slot = torch.where(keep, sorted_expert * C + pos, E * C)
    # slot → token (Tg, a zero row, where no entry landed; the dump slot
    # E·C takes every dropped entry and is never read); flat entry i is
    # token i // k
    src = torch.full((G, E * C + 1), Tg, dtype=torch.long, device=x.device)
    src.scatter_(1, slot, order // k)
    xpad = torch.cat([xg, xg.new_zeros(G, 1, d)], dim=1)
    tiles = xpad.gather(1, src[:, :E * C, None].expand(G, E * C, d))
    del src, xpad

    # ---- expert computation ----
    tiles = tiles.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    h = F.silu(torch.bmm(tiles, p["w_gate"])) * torch.bmm(tiles, p["w_up"])
    del tiles
    y = torch.bmm(h, p["w_down"])                               # [E, G·C, d]
    del h
    y = y.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)

    # ---- combine: each token's kept contributions, expert-ascending ----
    # a token's slots in ascending order are its experts in ascending
    # order (one slot an expert), its dropped entries (slot E·C) last
    entry_slot = torch.empty_like(slot).scatter_(1, order, slot)
    entry_slot, choice = torch.sort(entry_slot.view(G, Tg, k), dim=-1)
    gate = gate_vals.gather(2, choice).view(G, Tg * k, 1)
    entry_slot = entry_slot.view(G, Tg * k, 1)
    picked = y.gather(1, entry_slot.clamp_max(E * C - 1).expand(G, Tg * k, d))
    contrib = torch.where(entry_slot < E * C, picked * gate, 0.0)
    contrib = contrib.to(x.dtype).view(G, Tg, k, d)
    out = contrib[:, :, 0]
    for c in range(1, k):
        out = out + contrib[:, :, c]
    out = out.reshape(T, d)

    # ---- aux losses ----
    me = probs.mean(dim=(0, 1))                                 # [E]
    top1 = expert_ids[..., :1] == torch.arange(E, device=x.device)
    ce = top1.float().mean(dim=(0, 1))
    aux = {"lb_loss": E * (me * ce).sum(),
           "z_loss": (torch.logsumexp(logits, dim=-1) ** 2).mean(),
           "frac_dropped": 1.0 - keep.float().mean()}
    return out, aux
