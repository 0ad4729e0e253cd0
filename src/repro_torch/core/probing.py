"""Algorithm 5 — probing top-k ANN search on δ-EMQG, and AGS.

Counterpart of ``repro.core.probing``.  Two-tier traversal on one lock-step
engine over the batch: per hop each query either *probes* its W best
unprobed approximate candidates (exact distances in one fused gather+L2
call over ``[B, W]`` ids) or *expands* its W best unvisited exact
candidates (``B×W×M`` neighbor ids deduped against a packed visited
bitset, RaBitQ estimates in one batched call over ``[B, W·M]`` ids — on a
CUDA index one ``fused_estimate`` launch per hop, or one ``bitdot`` launch
plus plain algebra with ``use_kernel=True``).  The NeedProbing rule
(lines 22-28) decides per query; finished queries are masked no-ops.

AGS (approximate greedy search + exact rerank) runs the generic
``_beam_search_batch`` with a RaBitQ ``batch_dist`` and reranks the final
buffers with one exact call.
"""

from __future__ import annotations

import itertools
from typing import Callable, NamedTuple, Optional

import torch

from ..kernels.bitdot import ops as bitdot_ops
from ..obs.tracing import Tracer, maybe_span
from . import rabitq
from .bitset import bitset_make, bitset_set, bitset_test, unique_per_row
from .search import (
    _beam_search_batch,
    _count,
    _true_dists,
    adaptive_transition,
    as_queries,
    batch_merge_topc,
    default_start,
    make_batch_dist_fn,
    resolve_backend,
    resolve_beam_width,
    seen_keys,
    select_top_w,
)
from .types import (
    INVALID_ID,
    EMQGIndex,
    SearchParams,
    SearchResult,
    stable_topk_smallest,
)


class _BeamPState(NamedTuple):
    ce_ids: torch.Tensor     # int32[B, C]  exact tier
    ce_d2: torch.Tensor      # f32[B, C]
    ce_vis: torch.Tensor     # bool[B, C]
    ca_ids: torch.Tensor     # int32[B, C]  approx tier
    ca_d2: torch.Tensor      # f32[B, C]
    ca_prb: torch.Tensor     # bool[B, C]
    seen: torch.Tensor       # int64[B, nw] every id that entered either tier
    d2_last: torch.Tensor    # f32[B]  exact d² of the last expanded node
    l: torch.Tensor          # int32[B]
    n_dist: torch.Tensor     # int32[B]
    n_approx: torch.Tensor   # int32[B]
    n_enc: torch.Tensor      # int32[B]  candidate encounters (pre-dedup)
    n_hops: torch.Tensor     # int32[B]
    done: torch.Tensor       # bool[B]
    saturated: torch.Tensor  # bool[B]


def _beam_probing_batch(neighbors: torch.Tensor, n_nodes: int,
                        batch_exact: Callable, batch_approx: Callable,
                        queries: torch.Tensor, start: torch.Tensor,
                        p: SearchParams,
                        seen_base: Optional[torch.Tensor] = None,
                        tracer: Optional[Tracer] = None) -> _BeamPState:
    """The lock-step probing loop; the visited bitset covers ``n_nodes``
    rows, from each row's ``seen_base`` on where given (``search.
    seen_keys``).

    A ``tracer`` receives a ``probe.iter`` span a pass (``i``, ``rows``
    and ``active``, the rows still searching, read in the pass's one host
    sync; the last pass finds none and ends the loop), holding the pass's
    phases in order: ``probe.sync``, ``probe.select`` (NeedProbing and the
    probe branch's select), ``probe.exact``, ``probe.select`` (the expand
    branch's), ``probe.dedup``, ``probe.estimate``, ``probe.merge`` and
    ``probe.transition`` (with the counters).  Without one the loop makes
    no span and adds no op and no sync."""
    B = queries.shape[0]
    C = p.l_max + 1
    W = resolve_beam_width(p, C)
    M = neighbors.shape[1]
    dev = queries.device
    i32 = dict(dtype=torch.int32, device=dev)
    inf = float("inf")

    pos = torch.arange(C, device=dev)[None, :]
    start = start.to(**i32)
    d2_s = batch_exact(queries, start[:, None])[:, 0]
    ce_ids = torch.full((B, C), INVALID_ID, **i32)
    ce_ids[:, 0] = start
    ce_d2 = torch.full((B, C), inf, device=dev)
    ce_d2[:, 0] = d2_s
    ce_vis = torch.zeros((B, C), dtype=torch.bool, device=dev)
    ca_ids = torch.full((B, C), INVALID_ID, **i32)
    ca_d2 = torch.full((B, C), inf, device=dev)
    ca_prb = torch.zeros((B, C), dtype=torch.bool, device=dev)
    seen = bitset_set(bitset_make(B, n_nodes, dev),
                      seen_keys(start[:, None], seen_base))
    d2_last = d2_s
    l = torch.full((B,), min(max(p.l0, p.k), p.l_max), **i32)
    n_dist = torch.ones(B, **i32)
    n_approx = torch.zeros(B, **i32)
    n_enc = torch.ones(B, **i32)
    n_hops = torch.zeros(B, **i32)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    saturated = torch.zeros(B, dtype=torch.bool, device=dev)
    # the flags the merges give their new entries, made once: the probed
    # ids enter the exact tier unexpanded, the estimates the approximate
    # tier unprobed
    unexpanded_w = torch.zeros((B, W), dtype=torch.bool, device=dev)
    unprobed_wm = torch.zeros((B, W * M), dtype=torch.bool, device=dev)

    for i in itertools.count():
        with maybe_span(tracer, "probe.iter", i=i, rows=B) as pass_span:
            with maybe_span(tracer, "probe.sync"):
                active = ~done & (n_hops < p.max_hops)
                # the one host sync per hop; a tracer reads the count there
                if tracer is None:
                    going = bool(active.any())
                else:
                    n_active = int(active.sum())
                    pass_span.set(active=n_active)
                    going = n_active > 0
            if not going:
                break

            # -- probe branch: exact distances for W best unprobed approx ---
            with maybe_span(tracer, "probe.select"):
                in_l = (pos < l[:, None]) & active[:, None]
                win_e = in_l & (ce_ids >= 0) & ~ce_vis
                win_a = in_l & (ca_ids >= 0) & ~ca_prb
                has_u = win_e.any(1)
                has_w = win_a.any(1)
                d2_u = torch.where(win_e, ce_d2, inf).amin(1)
                d2_w = torch.where(win_a, ca_d2, inf).amin(1)

                # NeedProbing (lines 22-28): probe when the exact frontier
                # stopped improving and the approx tier has something closer.
                need_probe = torch.where(
                    ~has_u, has_w, (d2_u > d2_last) & has_w & (d2_w < d2_u))
                probing = active & need_probe
                expanding = active & ~need_probe & has_u
                conv = active & ~has_u & ~has_w

                sel_w, selv_w = select_top_w(ca_d2, win_a, W)
                selv_w &= probing[:, None]
                ca_prb = ca_prb.scatter(1, sel_w,
                                        ca_prb.gather(1, sel_w) | selv_w)
                w_ids = torch.where(selv_w, ca_ids.gather(1, sel_w),
                                    torch.full_like(selv_w, INVALID_ID,
                                                    dtype=torch.int32))
            with maybe_span(tracer, "probe.exact"):
                d2_probe = batch_exact(queries, w_ids)             # [B, W]

            # -- expand branch: approx distances for W·M neighbor ids -------
            with maybe_span(tracer, "probe.select"):
                sel_u, selv_u = select_top_w(ce_d2, win_e, W)
                selv_u &= expanding[:, None]
                ce_vis = ce_vis.scatter(1, sel_u,
                                        ce_vis.gather(1, sel_u) | selv_u)
                u_ids = torch.where(selv_u, ce_ids.gather(1, sel_u),
                                    torch.full_like(selv_u, INVALID_ID,
                                                    dtype=torch.int32))
                d2_u_sel = torch.where(selv_u, ce_d2.gather(1, sel_u), -inf)
                # "last expanded" = the worst of this hop's frontier (W=1:
                # exactly u)
                d2_last = torch.where(expanding, d2_u_sel.amax(1), d2_last)

            with maybe_span(tracer, "probe.dedup"):
                nbrs = neighbors[u_ids.clamp_min(0).long()]
                nbrs = torch.where(selv_u[:, :, None], nbrs,
                                   torch.full_like(nbrs, INVALID_ID)
                                   ).reshape(B, W * M)
                fresh = (nbrs >= 0) & ~bitset_test(seen,
                                                   seen_keys(nbrs, seen_base))
                new_ids = unique_per_row(nbrs, fresh)
                seen = bitset_set(seen, seen_keys(new_ids, seen_base))
            with maybe_span(tracer, "probe.estimate"):
                d2a = batch_approx(new_ids)                        # [B, W·M]

            # -- merges (per query only one branch contributes real entries)
            with maybe_span(tracer, "probe.merge"):
                ce_ids, ce_d2, ce_vis = batch_merge_topc(
                    ce_ids, ce_d2, ce_vis, w_ids, d2_probe, unexpanded_w, C)
                ca_ids, ca_d2, ca_prb = batch_merge_topc(
                    ca_ids, ca_d2, ca_prb, new_ids, d2a, unprobed_wm, C)

            # -- adaptive transition for exhausted queries, and the counters
            with maybe_span(tracer, "probe.transition"):
                l, done, saturated = adaptive_transition(
                    p, ce_d2, l, done, saturated, conv)
                n_dist = n_dist + _count(w_ids >= 0)
                n_approx = n_approx + _count(new_ids >= 0)
                # encounters: valid neighbor ids pre-dedup, plus probed
                # candidates
                n_enc = n_enc + _count(nbrs >= 0) + _count(w_ids >= 0)
                n_hops = n_hops + _count(selv_w) + _count(selv_u)

    return _BeamPState(ce_ids, ce_d2, ce_vis, ca_ids, ca_d2, ca_prb, seen,
                       d2_last, l, n_dist, n_approx, n_enc, n_hops, done,
                       saturated)


def traced_kw(tracer: Optional[Tracer]) -> dict:
    """The loop's ``tracer`` keyword, given only where there is a tracer:
    an untraced call passes the loop no new keyword, so a wrapper written
    to the loop's untraced signature (``perfbench``'s planted faults)
    still runs."""
    return {} if tracer is None else {"tracer": tracer}


def make_batch_approx_fn(index: EMQGIndex, queries: torch.Tensor,
                         backend: str = "auto", use_kernel: bool = False
                         ) -> Callable:
    """batch_approx(ids int32[B, K]) → RaBitQ d² estimates f32[B, K] for
    the query batch.

    ``use_kernel`` plugs the bitdot kernel into the S₊ contraction (the
    reference's plug; the algebra stays plain tensor code).  Otherwise
    ``backend="jnp"`` runs the plain estimate on any device, and every other
    backend runs ``fused_estimate``: the CUDA kernel on a CUDA index, the
    plain version on a CPU index.
    """
    codes = index.codes
    ctx = rabitq.prepare_query(codes, queries)
    if use_kernel:
        return lambda ids: rabitq.estimate_sqdist(
            codes, ctx, ids, bitdot_fn=bitdot_ops.bitdot)
    if resolve_backend(backend, index.device) == "jnp":
        return lambda ids: rabitq.estimate_sqdist_plain(codes, ctx, ids)
    return lambda ids: rabitq.estimate_sqdist(codes, ctx, ids)


def probing_search(index: EMQGIndex, queries, params: SearchParams,
                   start: Optional[torch.Tensor] = None,
                   use_kernel: bool = False, with_candidates: bool = False,
                   backend: str = "auto", tracer: Optional[Tracer] = None):
    """Batched Algorithm 5 on the lock-step beam engine.

    ``backend`` selects both tiers' implementations: ``"jnp"`` is the plain
    PyTorch path on any device, exact and approximate; ``"auto"`` is the
    CUDA kernels on a CUDA index (``gather_l2_tiled`` and
    ``fused_estimate``) and the plain path on the CPU (see
    ``make_batch_dist_fn`` and ``make_batch_approx_fn``).  ``use_kernel``
    routes the S₊ contraction through the bitdot kernel (its plain version
    on a CPU tensor) whatever the backend.  A ``tracer`` receives the
    loop's spans (``_beam_probing_batch``).
    """
    g = index.graph
    queries = as_queries(queries, g.device)
    B = queries.shape[0]
    if start is None:
        start = default_start(g.medoid, B, g.device)
    batch_exact = make_batch_dist_fn(g.vectors, backend)
    batch_approx = make_batch_approx_fn(index, queries, backend, use_kernel)

    st = _beam_probing_batch(g.neighbors, g.n, batch_exact, batch_approx,
                             queries, start, params, **traced_kw(tracer))
    k = params.k
    res = SearchResult(
        ids=st.ce_ids[:, :k],
        dists=_true_dists(st.ce_d2[:, :k]),
        n_dist_comps=st.n_dist,
        n_approx_comps=st.n_approx,
        n_hops=st.n_hops,
        final_l=st.l,
        saturated=st.saturated,
        n_encounters=st.n_enc,
    )
    if with_candidates:
        return res, st.ce_ids, _true_dists(st.ce_d2)
    return res


def error_bounded_probing_search(index: EMQGIndex, queries, k: int,
                                 alpha: float, l_max: int = 256,
                                 l_step: int = 1, max_hops: int = 4096,
                                 beam_width: int = 1, **kw) -> SearchResult:
    p = SearchParams(k=k, l0=k, l_max=l_max, l_step=l_step, alpha=alpha,
                     adaptive=True, max_hops=max_hops, beam_width=beam_width)
    return probing_search(index, queries, p, **kw)


def ags_search(index: EMQGIndex, queries, params: SearchParams,
               start: Optional[torch.Tensor] = None,
               backend: str = "auto") -> SearchResult:
    """Batched AGS: the generic beam traversal on RaBitQ estimates, then one
    fused exact rerank of the final candidate buffers.  ``backend`` selects
    both tiers as in :func:`probing_search` (``"jnp"``: plain on any device).

    Counters: ``n_approx_comps`` is the traversal's estimator evaluations;
    ``n_dist_comps`` is the exact rerank cost (valid buffer entries).
    """
    g = index.graph
    queries = as_queries(queries, g.device)
    B = queries.shape[0]
    if start is None:
        start = default_start(g.medoid, B, g.device)
    approx = make_batch_approx_fn(index, queries, backend)
    st = _beam_search_batch(g, queries, start, params,
                            lambda qs, ids: approx(ids))

    # exact rerank of the whole final buffer, one fused call
    batch_exact = make_batch_dist_fn(g.vectors, backend)
    d2 = batch_exact(queries, st.cand_ids)
    d2, order = stable_topk_smallest(d2, d2.shape[1])
    ids = st.cand_ids.gather(1, order)
    k = params.k
    return SearchResult(
        ids=ids[:, :k],
        dists=_true_dists(d2[:, :k]),
        n_dist_comps=_count(st.cand_ids >= 0),
        n_approx_comps=st.n_dist,
        n_hops=st.n_hops,
        final_l=st.l,
        saturated=st.saturated,
        n_encounters=st.n_enc,
    )
