"""Batched, fixed-shape beam search on proximity graphs.

Counterpart of ``repro.core.search``: Algorithm 1 (greedy beam search) and
Algorithm 3 (error-bounded adaptive top-k search) as one lock-step engine
over a whole query batch.  Each hop selects the ``beam_width`` (W) best
unvisited in-window candidates per query, gathers all ``B×W×M`` neighbor
ids at once, dedups them against a packed visited bitset, and evaluates
every fresh distance in one fused gather+L2 call over ``[B, W·M]`` ids —
on the card the hand-written CUDA kernel ``gather_l2_tiled``.  Queries whose
window is exhausted take the adaptive-α transition (grow ``l`` or stop) in
the same hop; finished queries are masked no-ops.

``jax.lax.while_loop`` becomes a host loop with one ``.any()`` sync per
hop.  The engine relies on a stable top-k (the lower index wins a tie) to
keep masked queries frozen, as ``lax.top_k`` is; the port sorts stably and
slices (``types.stable_topk_smallest``).

Semantics, including ``faithful_prune`` (the literal Alg.-3 top-(l+1)
prune with visited-bit clearing), are those of the JAX package; see its
module docstring for the reasoning.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..kernels.l2dist import ops as l2ops
from ..kernels.l2dist import ref as l2ref
from .bitset import (
    bitset_clear,
    bitset_make,
    bitset_set,
    bitset_test,
    unique_per_row,
)
from .types import (
    INVALID_ID,
    GraphIndex,
    SearchParams,
    SearchResult,
    stable_topk_smallest,
)

BACKENDS = ("auto", "jnp", "kernel", "kernel_tiled")


def resolve_backend(backend: str, device: torch.device) -> str:
    """``auto`` is ``kernel_tiled`` on a CUDA device and the plain path
    (``jnp``) on the CPU."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown distance backend: {backend!r}")
    if backend == "auto":
        return "kernel_tiled" if device.type == "cuda" else "jnp"
    return backend


def make_batch_dist_fn(vectors: torch.Tensor, backend: str = "auto"
                       ) -> Callable:
    """batch_dist(queries f32[B, d], ids int32[B, K]) → d2 f32[B, K].

    Backends (the JAX package's names):
      * ``jnp``          — plain PyTorch gather + reduce, on any device.
      * ``kernel``       — CUDA ``gather_l2`` (one row per block).
      * ``kernel_tiled`` — CUDA ``gather_l2_tiled`` (eight rows per block).
      * ``auto``         — ``kernel_tiled`` on a CUDA tensor, ``jnp`` on CPU.

    ``vectors`` is used as it is (float32, contiguous): nothing is copied
    per hop.
    """
    backend = resolve_backend(backend, vectors.device)
    if backend == "jnp":
        return lambda queries, ids: l2ref.gather_l2_ref(vectors, ids, queries)
    fn = l2ops.gather_l2_tiled if backend == "kernel_tiled" else l2ops.gather_l2
    return lambda queries, ids: fn(vectors, ids, queries)


def _cat_sort(parts_ids, parts_d2, parts_vis, cap: int):
    """Concatenate along the row and keep the ``cap`` smallest d2, stably."""
    ids = torch.cat(parts_ids, dim=1)
    d2 = torch.cat(parts_d2, dim=1)
    vis = torch.cat(parts_vis, dim=1)
    d2_s, idx = stable_topk_smallest(d2, cap)
    return ids.gather(1, idx), d2_s, vis.gather(1, idx)


def batch_merge_topc(ids_a, d2_a, vis_a, ids_b, d2_b, vis_b, cap: int):
    """Batched merge: [B, Ca] ⊎ [B, Cb] → top-``cap`` smallest d2 per row.

    The sort is stable, so appending the new entries after the buffer keeps
    the buffer's order for no-op merges — which keeps masked queries frozen.
    """
    return _cat_sort((ids_a, ids_b), (d2_a, d2_b), (vis_a, vis_b), cap)


class _BeamState(NamedTuple):
    cand_ids: torch.Tensor   # int32[B, C]
    cand_d2: torch.Tensor    # f32[B, C]   squared dists, ascending
    cand_vis: torch.Tensor   # bool[B, C]
    seen: torch.Tensor       # int64[B, nw] packed visited bitset
    l: torch.Tensor          # int32[B]    current candidate window
    n_dist: torch.Tensor     # int32[B]    exact distance evaluations
    n_enc: torch.Tensor      # int32[B]    candidate encounters (pre-dedup)
    n_hops: torch.Tensor     # int32[B]    expansions
    done: torch.Tensor       # bool[B]
    saturated: torch.Tensor  # bool[B]


def select_top_w(d2: torch.Tensor, mask: torch.Tensor, w: int):
    """Per-row W best (smallest d2) slots among ``mask``.

    Returns (sel int64[B, W], valid bool[B, W]); the stable sort gives W=1
    the lowest-index tie-break of ``argmin``.
    """
    masked = torch.where(mask, d2, torch.full_like(d2, float("inf")))
    vals, sel = stable_topk_smallest(masked, w)
    return sel, torch.isfinite(vals)


def resolve_beam_width(p: SearchParams, cap: int) -> int:
    """Validate and clamp ``p.beam_width`` against the buffer capacity."""
    if p.beam_width < 1:
        raise ValueError(
            f"beam_width must be ≥ 1, got {p.beam_width} (0 would never "
            "expand a frontier and the lock-step loop could not terminate)")
    return min(p.beam_width, cap)


def adaptive_transition(p: SearchParams, cand_d2: torch.Tensor,
                        l: torch.Tensor, done: torch.Tensor,
                        saturated: torch.Tensor, conv: torch.Tensor):
    """Alg.-3 line 11 lock-step transition for window-exhausted queries
    (``conv``); the others pass through.  Returns (l, done, saturated)."""
    if not p.adaptive:
        return l, done | conv, saturated
    C = cand_d2.shape[1]
    # float32(α·α) with the product taken in Python double, as the JAX
    # package does; a host scalar, so the hop makes no host-to-device copy
    alpha2 = float(np.float32(p.alpha * p.alpha))
    # stop iff d(q, C[l]) ≥ α · d(q, C[k])
    d2_l = cand_d2.gather(1, torch.clamp_max(l - 1, C - 1).long()[:, None])[:, 0]
    d2_k = cand_d2[:, p.k - 1]
    stop = d2_l >= alpha2 * d2_k
    at_cap = l >= p.l_max
    new_l = torch.clamp_max(l + p.l_step, p.l_max)
    return (
        torch.where(conv & ~stop, new_l, l),
        done | (conv & (stop | at_cap)),
        saturated | (conv & at_cap & ~stop),
    )


def faithful_prune_merge(cand_ids, cand_d2, cand_vis, new_ids, d2_new,
                         seen, l, cap: int):
    """Literal Alg.-3 line-9 merge: full sort of buffer ∪ fresh, keep the
    top ``l+1`` per row, and clear the visited bits of pruned candidates
    that were never expanded so they can re-enter once ``l`` grows.

    Returns (cand_ids, cand_d2, cand_vis, seen), buffers trimmed to ``cap``
    columns; ``seen`` is updated in place.
    """
    width = cand_ids.shape[1] + new_ids.shape[1]
    ids_s, d2_s, vis_s = _cat_sort(
        (cand_ids, new_ids), (cand_d2, d2_new),
        (cand_vis, torch.zeros_like(new_ids, dtype=torch.bool)), width)
    pos = torch.arange(width, device=ids_s.device)[None, :]
    keep = pos <= l[:, None]
    invalid = torch.full_like(ids_s, INVALID_ID)
    # pruned ∧ unexpanded → clearable; ids are unique per row
    seen = bitset_clear(seen, torch.where(keep | vis_s, invalid, ids_s))
    return (torch.where(keep, ids_s, invalid)[:, :cap],
            torch.where(keep, d2_s, torch.full_like(d2_s, float("inf")))[:, :cap],
            (keep & vis_s)[:, :cap],
            seen)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(1, dtype=torch.int32)


def _beam_search_batch(graph: GraphIndex, queries: torch.Tensor,
                       start: torch.Tensor, p: SearchParams,
                       batch_dist: Callable,
                       faithful_prune: bool = False) -> _BeamState:
    B = queries.shape[0]
    C = p.l_max + 1
    W = resolve_beam_width(p, C)
    M = graph.neighbors.shape[1]
    dev = queries.device
    i32 = dict(dtype=torch.int32, device=dev)

    pos = torch.arange(C, device=dev)[None, :]
    start = start.to(**i32)
    cand_ids = torch.full((B, C), INVALID_ID, **i32)
    cand_ids[:, 0] = start
    cand_d2 = torch.full((B, C), float("inf"), device=dev)
    cand_d2[:, 0] = batch_dist(queries, start[:, None])[:, 0]
    cand_vis = torch.zeros((B, C), dtype=torch.bool, device=dev)
    seen = bitset_set(bitset_make(B, graph.n, dev), start[:, None])
    l = torch.full((B,), min(max(p.l0, p.k), p.l_max), **i32)
    n_dist = torch.ones(B, **i32)
    n_enc = torch.ones(B, **i32)
    n_hops = torch.zeros(B, **i32)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    saturated = torch.zeros(B, dtype=torch.bool, device=dev)

    while True:
        active = ~done & (n_hops < p.max_hops)
        if not bool(active.any()):          # the one host sync per hop
            break
        window = (pos < l[:, None]) & (cand_ids >= 0) & ~cand_vis \
            & active[:, None]
        has_frontier = window.any(1)

        # -- frontier selection: W best unvisited in-window per query -------
        sel, selv = select_top_w(cand_d2, window, W)
        selv &= (active & has_frontier)[:, None]
        cand_vis = cand_vis.scatter(1, sel, cand_vis.gather(1, sel) | selv)
        u_ids = torch.where(selv, cand_ids.gather(1, sel),
                            torch.full_like(selv, INVALID_ID, dtype=torch.int32))

        # -- neighbor gather + bitset dedup ---------------------------------
        nbrs = graph.neighbors[u_ids.clamp_min(0).long()]          # [B, W, M]
        nbrs = torch.where(selv[:, :, None], nbrs,
                           torch.full_like(nbrs, INVALID_ID)).reshape(B, W * M)
        n_enc = n_enc + _count(nbrs >= 0)
        fresh = (nbrs >= 0) & ~bitset_test(seen, nbrs)
        new_ids = unique_per_row(nbrs, fresh)                       # [B, W·M]
        seen = bitset_set(seen, new_ids)

        # -- the hot path: one fused gather+L2 over the whole batch ---------
        d2_new = batch_dist(queries, new_ids)
        n_dist = n_dist + _count(new_ids >= 0)
        n_hops = n_hops + _count(selv)

        if faithful_prune:
            cand_ids, cand_d2, cand_vis, seen = faithful_prune_merge(
                cand_ids, cand_d2, cand_vis, new_ids, d2_new, seen, l, C)
        else:
            cand_ids, cand_d2, cand_vis = batch_merge_topc(
                cand_ids, cand_d2, cand_vis, new_ids, d2_new,
                torch.zeros_like(fresh), C)

        # -- adaptive transition for window-exhausted queries ---------------
        conv = active & ~has_frontier
        l, done, saturated = adaptive_transition(
            p, cand_d2, l, done, saturated, conv)

    return _BeamState(cand_ids, cand_d2, cand_vis, seen, l, n_dist, n_enc,
                      n_hops, done, saturated)


def as_queries(queries, device: torch.device) -> torch.Tensor:
    """Queries as a float32 tensor on the index's device."""
    return torch.as_tensor(queries, dtype=torch.float32, device=device)


def default_start(medoid: int, B: int, device) -> torch.Tensor:
    return torch.full((B,), medoid, dtype=torch.int32, device=device)


def _true_dists(d2: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def search(graph: GraphIndex, queries, params: SearchParams,
           start: Optional[torch.Tensor] = None,
           faithful_prune: bool = False, with_candidates: bool = False,
           backend: str = "auto"):
    """Batched Alg. 1 / Alg. 3 search on the lock-step beam engine.

    Returns SearchResult (and, with ``with_candidates``, the final
    candidate ids and true distances).  ``params.beam_width`` sets the
    per-hop frontier width W; ``backend`` selects the exact-distance
    implementation (see ``make_batch_dist_fn``).
    """
    queries = as_queries(queries, graph.device)
    B = queries.shape[0]
    if start is None:
        start = default_start(graph.medoid, B, graph.device)
    batch_dist = make_batch_dist_fn(graph.vectors, backend)
    st = _beam_search_batch(graph, queries, start, params, batch_dist,
                            faithful_prune=faithful_prune)
    k = params.k
    res = SearchResult(
        ids=st.cand_ids[:, :k],
        dists=_true_dists(st.cand_d2[:, :k]),
        n_dist_comps=st.n_dist,
        n_approx_comps=torch.zeros_like(st.n_dist),
        n_hops=st.n_hops,
        final_l=st.l,
        saturated=st.saturated,
        n_encounters=st.n_enc,
    )
    if with_candidates:
        return res, st.cand_ids, _true_dists(st.cand_d2)
    return res


def greedy_search(graph: GraphIndex, queries, k: int, l: int,
                  start: Optional[torch.Tensor] = None, max_hops: int = 512,
                  beam_width: int = 1, backend: str = "auto") -> SearchResult:
    """Algorithm 1 with fixed candidate width l (the ablation δ-EMG-GS)."""
    p = SearchParams(k=k, l0=l, l_max=l, adaptive=False, max_hops=max_hops,
                     beam_width=beam_width)
    return search(graph, queries, p, start=start, backend=backend)


def error_bounded_search(graph: GraphIndex, queries, k: int, alpha: float,
                         l_max: int = 256, l_step: int = 1,
                         start: Optional[torch.Tensor] = None,
                         max_hops: int = 2048, beam_width: int = 1,
                         **kw) -> SearchResult:
    """Algorithm 3: adaptive candidate width with the α stop rule."""
    p = SearchParams(k=k, l0=k, l_max=l_max, l_step=l_step, alpha=alpha,
                     adaptive=True, max_hops=max_hops, beam_width=beam_width)
    return search(graph, queries, p, start=start, **kw)
