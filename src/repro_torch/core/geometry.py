"""Occlusion-region predicates and neighbor-selection rules.

Counterpart of ``repro.core.geometry``.  Every rule works on *squared*
distances, as there.  ``select_neighbors`` is the sequential greedy
selector of Algorithms 2 and 4: the loop over the L distance-sorted
candidates stays a loop (each decision depends on the kept set), but each
step runs for a whole block of nodes at once — the batch dimension the JAX
package got from ``vmap`` — and its kept-to-candidate distances are one
``batched_l2`` call (the CUDA kernel on the card, the plain difference form
on the CPU).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels.l2dist import ops as l2ops
from .types import INVALID_ID


def occludes_delta(d2_uv, d2_uw, d2_wv, delta):
    """Def. 9:  d(x,u) < d(u,v)  ∧  d²(x,v) + 2δ·d(u,v)·d(x,u) < d²(u,v)."""
    d_uv = torch.sqrt(d2_uv)
    d_uw = torch.sqrt(d2_uw)
    return (d2_uw < d2_uv) & (d2_wv + 2.0 * delta * d_uv * d_uw < d2_uv)


def occludes_mrng(d2_uv, d2_uw, d2_wv, _unused=0.0):
    """MRNG lune: w strictly closer to both u and v than d(u,v)."""
    return (d2_uw < d2_uv) & (d2_wv < d2_uv)


def occludes_vamana(d2_uv, d2_uw, d2_wv, alpha=1.2):
    """Vamana robust prune: prune v if α·d(w,v) ≤ d(u,v) for a kept w."""
    return (d2_uw < d2_uv) & (alpha * alpha * d2_wv <= d2_uv)


def occludes_taumg(d2_uv, d2_uw, d2_wv, tau=0.1):
    """τ-MG shifted lune: prune v if d(u,w) < d(u,v) ∧ d(w,v) < d(u,v) − 3τ."""
    d_uv = torch.sqrt(d2_uv)
    shifted = torch.clamp_min(d_uv - 3.0 * tau, 0.0)
    return (d2_uw < d2_uv) & (d2_wv < shifted * shifted)


OCCLUSION_RULES: dict[str, Callable] = {
    "delta_emg": occludes_delta,
    "mrng": occludes_mrng,
    "vamana": occludes_vamana,
    "tau_mg": occludes_taumg,
}


# Navigable-ball and occlusion-region membership (Lemma 1, Def. 9) — used
# by property tests; points on their inputs' device, the last axis the
# coordinates.

def in_navigable_ball(q, u, v, delta):
    """True iff d(q, v) < δ·d(q, u): q lies in the ball where Lemma 1 bites."""
    d2_qv = torch.sum((q - v) ** 2, dim=-1)
    d2_qu = torch.sum((q - u) ** 2, dim=-1)
    return d2_qv < delta * delta * d2_qu


def in_occlusion_region(x, u, v, delta):
    """Point-level Def. 9 membership (tests / visual debugging)."""
    d2_xu = torch.sum((x - u) ** 2, dim=-1)
    d2_xv = torch.sum((x - v) ** 2, dim=-1)
    d2_uv = torch.sum((u - v) ** 2, dim=-1)
    return occludes_delta(d2_uv, d2_xu, d2_xv, delta)


def select_neighbors(cand_vecs: torch.Tensor, cand_d2: torch.Tensor,
                     cand_ids: torch.Tensor, deltas: torch.Tensor,
                     rule: str = "delta_emg", max_keep: int = 64):
    """Greedy neighbor selection for a block of N nodes.

    cand_vecs f32[N, L, d] (ascending d(u, ·)), cand_d2 f32[N, L],
    cand_ids int32[N, L] (-1 = padding), deltas f32[N, L] (the per-candidate
    rule parameter) → (kept_ids int32[N, max_keep], kept_count int32[N]).

    Candidate i is kept iff it is valid and no already-kept w occludes it.
    (The JAX version also takes ``u_vec``, which the rule never reads.)
    """
    N, L, d = cand_vecs.shape
    occl = OCCLUSION_RULES[rule]
    dev = cand_vecs.device
    kept_vecs = torch.zeros((N, max_keep, d), dtype=cand_vecs.dtype,
                            device=dev)
    kept_d2 = torch.full((N, max_keep), float("inf"), device=dev)
    kept_ids = torch.full((N, max_keep), INVALID_ID, dtype=torch.int32,
                          device=dev)
    count = torch.zeros(N, dtype=torch.int32, device=dev)
    slots = torch.arange(max_keep, device=dev)[None, :]
    rows = torch.arange(N, device=dev)
    for i in range(L):
        v = cand_vecs[:, i]
        d2_uv = cand_d2[:, i]
        ids = cand_ids[:, i]
        valid = (ids >= 0) & torch.isfinite(d2_uv) & (d2_uv > 0.0)
        # distances kept-node → candidate (padding rows are masked below)
        d2_wv = l2ops.batched_l2(kept_vecs, v)
        hit = occl(d2_uv[:, None], kept_d2, d2_wv, deltas[:, i, None])
        occluded = (hit & (kept_ids >= 0)).any(1)
        take = valid & ~occluded & (count < max_keep)
        slot = torch.clamp_max(count, max_keep - 1)
        put = take[:, None] & (slots == slot[:, None])
        # one [N, d] row written in place, so that a step reads the kept
        # set [N, max_keep, d] once (batched_l2) and writes none of it
        at = (rows, slot.long())
        kept_vecs[at] = torch.where(take[:, None], v, kept_vecs[at])
        kept_d2 = torch.where(put, d2_uv[:, None], kept_d2)
        kept_ids = torch.where(put, ids[:, None], kept_ids)
        count = count + take.to(torch.int32)
    return kept_ids, count


def adaptive_deltas(cand_d2: torch.Tensor, t) -> torch.Tensor:
    """Alg. 4's schedule  δ_t(u, v_i) = 1 − d(u, v_i) / d(u, v_(t)).

    ``cand_d2`` f32[N, L] must be ascending per row; ``t`` (1-indexed) is an
    int or a per-row int tensor.  Negative on edges longer than d(u, v_(t)).
    """
    L = cand_d2.shape[1]
    t = torch.as_tensor(t, device=cand_d2.device).long()
    t_idx = torch.clamp(t - 1, 0, L - 1).expand(cand_d2.shape[0])
    d2_t = cand_d2.gather(1, t_idx[:, None])
    d_t = torch.sqrt(torch.clamp_min(d2_t, 1e-30))
    return 1.0 - torch.sqrt(cand_d2) / d_t
