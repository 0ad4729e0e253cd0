"""Algorithm 4 — near-linear approximate δ-EMG construction.

Counterpart of ``repro.core.build_approx``, on the vectors' device.  The
beam searches and the occlusion pruning run over node blocks as there; the
graph surgery between iterations (reverse edges, reverse lists, degree
alignment) is written as whole-array tensor code in place of the JAX
package's per-edge and per-row Python loops, which at n = 1M would run
~24M iterations.  Each vectorised helper gives the same output as its
reference on the same input (``tests/test_torch_core.py``).  Only the
connectivity repair keeps a host loop: its steps depend on each other, and
it touches the few nodes that the BFS finds unreachable.

Distance forms follow the reference: ``_prep_candidates`` and the selector
use the difference form, ``pairwise_sqdist`` the norm identity.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..obs.tracing import maybe_span
from .distances import brute_force_knn, medoid as find_medoid, pairwise_sqdist
from .geometry import adaptive_deltas, select_neighbors
from .search import search
from .types import GraphIndex, SearchParams, resolve_device, stable_topk_smallest


def _build_event(metrics, verbose: bool, phase: str, **fields) -> None:
    """Structured build progress: with a ``metrics`` registry the event is
    recorded (``build_progress`` event, ``build_phase_seconds{phase}``
    histogram, ``build_nodes_total`` counter); ``verbose`` prints it."""
    if metrics is not None:
        metrics.event("build_progress", phase=phase, **fields)
        if "elapsed_s" in fields:
            metrics.histogram("build_phase_seconds",
                              {"phase": phase}).observe(fields["elapsed_s"])
        if "nodes" in fields:
            metrics.counter("build_nodes_total").inc(fields["nodes"])
    if verbose:
        body = " ".join(
            f"{k}={v:.1f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in fields.items())
        print(f"[build_approx] {phase}: {body}")


@dataclasses.dataclass(frozen=True)
class BuildParams:
    max_degree: int = 32          # M
    beam_width: int = 64          # L (candidate set size)
    t: int = 16                   # neighborhood-scale parameter (t ≤ L)
    iters: int = 3                # refinement iterations I
    delta: Optional[float] = None  # None → adaptive δ_t rule; float → fixed δ
    rule: str = "delta_emg"
    align_degree: bool = False    # δ-EMQG: binary-search t so |N(u)| == M
    block: int = 512              # nodes per device batch
    max_hops: int = 1024
    seed: int = 0


def _gather_candidates(vectors, cand_ids, cand_dists):
    d2 = torch.where(cand_ids >= 0, cand_dists * cand_dists,
                     torch.full_like(cand_dists, float("inf")))
    return vectors[cand_ids.clamp_min(0).long()], d2


def _select_block(vectors, cand_ids, cand_dists, t: int, rule: str,
                  max_keep: int, fixed_delta: Optional[float]):
    """LocallySelectNeighbors over a block of nodes (rows of cand_ids)."""
    vecs, d2 = _gather_candidates(vectors, cand_ids, cand_dists)
    if fixed_delta is None:
        deltas = adaptive_deltas(d2, t)
    else:
        deltas = torch.full_like(d2, fixed_delta)
    return select_neighbors(vecs, d2, cand_ids, deltas, rule=rule,
                            max_keep=max_keep)


def _select_block_per_node_t(vectors, cand_ids, cand_dists, t_vec, rule: str,
                             max_keep: int):
    """Like _select_block but with a per-node t (degree-alignment search)."""
    vecs, d2 = _gather_candidates(vectors, cand_ids, cand_dists)
    return select_neighbors(vecs, d2, cand_ids, adaptive_deltas(d2, t_vec),
                            rule=rule, max_keep=max_keep)


def _bfs_reachable(neighbors: torch.Tensor, start: int) -> torch.Tensor:
    """Frontier BFS over fixed-width adjacency.  bool[n]."""
    n = neighbors.shape[0]
    seen = torch.zeros(n, dtype=torch.bool, device=neighbors.device)
    seen[start] = True
    frontier = torch.tensor([start], device=neighbors.device)
    while frontier.numel():
        nxt = neighbors[frontier].reshape(-1).long()
        nxt = torch.unique(nxt[nxt >= 0])
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    return seen


def _edges(nbr: torch.Tensor):
    """(src, dst) int64 of every valid entry, in row-major order."""
    n, m = nbr.shape
    src = torch.arange(n, device=nbr.device).repeat_interleave(m)
    dst = nbr.reshape(-1).long()
    ok = dst >= 0
    return src[ok], dst[ok]


def _rank_in_group(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Position of each entry within its run of equal keys (keys sorted)."""
    first = torch.searchsorted(sorted_keys, sorted_keys, side="left")
    return torch.arange(sorted_keys.numel(), device=sorted_keys.device) - first


def _add_reverse_edges(nbr: torch.Tensor, deg: torch.Tensor, M: int) -> None:
    """Line 14: add (v, u) for every (u, v), respecting the degree cap; in
    place on ``nbr`` and ``deg``.

    The reference walks the edges grouped by destination u (sources
    ascending) and appends v to row u unless v == u, v is already among
    ``nbr[u, :deg[u]]``, or the row is full.  Row u's outcome depends only
    on row u and the edges into u, so all rows are done at once: keep the
    qualifying edges, rank them within their destination, and write the
    first ``M − deg[u]`` at positions ``deg[u], deg[u]+1, …``.
    """
    n = nbr.shape[0]
    src, dst = _edges(nbr)
    # (u, x) pairs among the first deg[u] entries of each row
    pos = torch.arange(nbr.shape[1], device=nbr.device)[None, :]
    head = (nbr >= 0) & (pos < deg[:, None])
    rows = torch.arange(n, device=nbr.device)[:, None].expand_as(nbr)
    present = (rows * n + nbr.long())[head]
    key = dst * n + src                               # "is src in row dst?"
    ok = (src != dst) & ~torch.isin(key, present)
    # group by destination, sources ascending; a repeated (u, v) counts once
    key = torch.unique(key[ok])                       # sorted
    dst, src = key // n, key % n
    rank = _rank_in_group(dst)
    keep = rank < (M - deg[dst])
    dst, src, rank = dst[keep], src[keep], rank[keep]
    nbr[dst, deg[dst].long() + rank] = src.to(nbr.dtype)
    deg += torch.bincount(dst, minlength=n).to(deg.dtype)


def _repair_connectivity(vectors: torch.Tensor, nbr: torch.Tensor,
                         deg: torch.Tensor, M: int, med: int,
                         max_rounds: int = 8) -> int:
    """Line 15: link unreachable nodes from their nearest reachable node; in
    place on ``nbr`` and ``deg``.  The link loop is sequential (a node's
    degree changes as it gains links) and runs on host copies: for each
    chunk of 1024 nodes, every vector it can read (the nearest reachable
    nodes, their rows' ids and the chunk's own) comes off the device once,
    and a full row's longest edge is found in numpy in the reference's own
    expression, so its comparisons round as the reference's do."""
    n = nbr.shape[0]
    total_fixed = 0
    for _ in range(max_rounds):
        seen = _bfs_reachable(nbr, med)
        bad = torch.nonzero(~seen)[:, 0]
        if bad.numel() == 0:
            break
        good = torch.nonzero(seen)[:, 0]
        gv = vectors[good]
        nbr_h, deg_h = nbr.cpu().numpy(), deg.cpu().numpy()
        for s in range(0, bad.numel(), 1024):
            chunk = bad[s:s + 1024]
            d2 = pairwise_sqdist(vectors[chunk], gv)
            nearest = good[torch.argmin(d2, dim=1)]
            xs, rs = chunk.cpu().numpy(), nearest.cpu().numpy()
            # id -1 in a full row reads the last vector, as numpy's -1 does
            ids = np.concatenate([rs, nbr_h[np.unique(rs)].ravel(), xs])
            need = np.unique(np.where(ids < 0, n - 1, ids))
            vh = vectors[torch.from_numpy(need).to(vectors.device)].cpu().numpy()

            def loc(i):
                return np.searchsorted(need, np.where(i < 0, n - 1, i))

            # each link's length and the edge lengths of every row full at
            # the chunk's start, each in one numpy call (it sums every row
            # as the reference's per-row call does); a row's lengths are
            # kept current as its longest edge is replaced
            lx, lr = loc(xs), loc(rs)
            x_len = ((vh[lx] - vh[lr]) ** 2).sum(-1)
            full = np.unique(rs[deg_h[rs] >= M])
            lens = dict(zip(full.tolist(), (
                (vh[loc(nbr_h[full, :M])] - vh[loc(full)][:, None]) ** 2
            ).sum(-1)))
            for i, (x, r) in enumerate(zip(xs.tolist(), rs.tolist())):
                if deg_h[r] < M:
                    nbr_h[r, deg_h[r]] = x
                    deg_h[r] += 1
                    continue
                # replace r's longest out-edge (keeps the cap; the evicted
                # edge is recoverable in the next refinement iteration)
                d2row = lens.get(r)
                if d2row is None:           # filled up inside this chunk
                    d2row = lens[r] = ((vh[loc(nbr_h[r, :M])]
                                        - vh[lr[i]]) ** 2).sum(-1)
                worst = int(np.argmax(d2row))
                nbr_h[r, worst] = x
                d2row[worst] = x_len[i]
            total_fixed += xs.size
        nbr.copy_(torch.from_numpy(nbr_h))
        deg.copy_(torch.from_numpy(deg_h))
    return total_fixed


def _candidate_search(graph: GraphIndex, queries: torch.Tensor, L: int,
                      max_hops: int):
    """Line 6: R_u ← GreedySearch(G, v_s, u, L, L), returning candidates
    and how many of the searches ended at ``max_hops`` (a device
    scalar)."""
    p = SearchParams(k=min(L, graph.n), l0=L, l_max=L, adaptive=False,
                     max_hops=max_hops)
    res, cand_ids, cand_dists = search(graph, queries, p,
                                       with_candidates=True)
    return cand_ids, cand_dists, (res.n_hops >= max_hops).sum()


def _reverse_lists(nbr: torch.Tensor, cap: int) -> torch.Tensor:
    """int32[n, cap] of reverse neighbors (nodes pointing at each row): the
    first ``cap`` sources of each destination in row-major edge order."""
    n = nbr.shape[0]
    src, dst = _edges(nbr)
    dst, order = torch.sort(dst, stable=True)
    src = src[order]
    rank = _rank_in_group(dst)
    keep = rank < cap
    out = torch.full((n, cap), -1, dtype=torch.int32, device=nbr.device)
    out[dst[keep], rank[keep]] = src[keep].to(torch.int32)
    return out


def _dedup_rows(ids: torch.Tensor, self_ids: torch.Tensor) -> torch.Tensor:
    """Per-row dedup: later duplicates (and self) → -1."""
    s, order = torch.sort(ids, dim=1, stable=True)
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)
    s = torch.where(dup, torch.full_like(s, -1), s)
    out = torch.full_like(ids, -1).scatter(1, order, s)
    return torch.where(out == self_ids[:, None], torch.full_like(out, -1), out)


def _prep_candidates(vectors, u_ids, merged_ids, L: int):
    """Exact d(u, ·) for merged candidate ids, sorted ascending, top L+1."""
    # squared in place: one [block, L + 2M, d] tensor alive at a time
    # (4.3 MB a node at d = 960, GIST1M's width)
    diff = vectors[merged_ids.clamp_min(0).long()]
    diff -= vectors[u_ids.long()][:, None, :]
    d2 = diff.mul_(diff).sum(-1)
    d2 = torch.where(merged_ids >= 0, d2, torch.full_like(d2, float("inf")))
    d2, idx = stable_topk_smallest(d2, min(L + 1, merged_ids.shape[1]))
    return merged_ids.gather(1, idx), torch.sqrt(torch.clamp_min(d2, 0.0))


def _fill_from_pool(kept, cnt, pool, self_ids, M: int):
    """Pad rows with fewer than M kept ids with the nearest unselected pool
    candidates (pool order), skipping invalid ids, self and ids already in
    ``kept[:cnt]``.  Returns (kept, cnt)."""
    slots = torch.arange(kept.shape[1], device=kept.device)
    head = slots[None, :] < cnt[:, None]
    in_row = ((pool[:, :, None] == kept[:, None, :]) & head[:, None, :]).any(-1)
    qual = (pool >= 0) & (pool != self_ids[:, None]) & ~in_row
    rank = torch.cumsum(qual.to(torch.int32), dim=1) - 1
    take = qual & (rank < (M - cnt)[:, None])
    r, j = torch.nonzero(take, as_tuple=True)
    kept = kept.clone()
    kept[r, cnt[r].long() + rank[r, j].long()] = pool[r, j]
    return kept, cnt + take.sum(1, dtype=cnt.dtype)


def _align_degrees(vectors, nbr, deg, cand_ids_all, cand_dists_all,
                   p: BuildParams) -> None:
    """Sec. 6.1: binary-search the smallest t whose pruned neighborhood has
    ≥ M entries, then keep the M closest → every node has exactly M
    neighbors.  In place on ``nbr`` and ``deg``."""
    M, L = p.max_degree, p.beam_width
    deficient = torch.nonzero(deg < M)[:, 0]
    steps = int(np.ceil(np.log2(max(L, 2)))) + 1
    for s in range(0, deficient.numel(), p.block):
        idx = deficient[s:s + p.block]
        ids, dst = cand_ids_all[idx], cand_dists_all[idx]
        lo = torch.ones(idx.numel(), dtype=torch.int32, device=idx.device)
        hi = torch.full_like(lo, L)
        # nodes with fewer than M candidates can never reach M — take all
        feasible = (ids >= 0).sum(1) >= M + 1
        best = hi.clone()
        for _ in range(steps):
            mid = (lo + hi) // 2
            _, cnt = _select_block_per_node_t(vectors, ids, dst, mid,
                                              rule=p.rule, max_keep=M + 1)
            enough = cnt >= M
            best = torch.where(enough & (mid < best), mid, best)
            hi = torch.where(enough, torch.clamp_min(mid - 1, 1), hi)
            lo = torch.where(enough, lo, torch.clamp_max(mid + 1, L))
            if bool((lo > hi).all()):
                break
        t_final = torch.where(feasible, best, torch.full_like(best, L))
        kept, cnt = _select_block_per_node_t(vectors, ids, dst, t_final,
                                             rule=p.rule, max_keep=M)
        kept, cnt = _fill_from_pool(kept, cnt, ids, idx, M)
        nbr[idx] = kept
        deg[idx] = cnt


class BuildPhases:
    """The build's phases as ``with phases(name, **attrs) as phase:``
    blocks; ``phase["seconds"]`` is set when the block ends.

    With a ``tracer`` each phase is a span of that name.  With a tracer or
    a ``metrics`` registry the device is synchronised as a phase starts
    and before it ends, so a phase is billed the device work it enqueued,
    not the work still queued from the one before, and with a tracer its
    seconds are its span's duration.  With neither it waits for nothing
    (its seconds then read the host's enqueueing alone)."""

    def __init__(self, device: torch.device, metrics=None, tracer=None):
        self.tracer = tracer
        self.sync = device.type == "cuda" and (
            tracer is not None or metrics is not None)
        self.device = device

    def _wait(self) -> None:
        if self.sync:
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str, **attrs):
        phase = {}
        self._wait()
        t0 = time.perf_counter()
        with maybe_span(self.tracer, name, **attrs) as span:
            yield phase
            self._wait()
        phase["seconds"] = span.duration_s if span is not None \
            else time.perf_counter() - t0


def on_device(vectors, device) -> torch.Tensor:
    """The corpus as a contiguous float32 tensor on ``device``."""
    return torch.as_tensor(vectors, dtype=torch.float32).to(
        resolve_device(device)).contiguous()


def build_approx(vectors, params: BuildParams = BuildParams(),
                 verbose: bool = False, metrics=None,
                 device="cuda", tracer=None) -> GraphIndex:
    """Algorithm 4 on ``device``.  Returns a localized, degree-balanced
    approximate δ-EMG.  ``metrics`` (an ``obs.MetricsRegistry``) receives
    structured build events per phase; a ``tracer`` (an ``obs.Tracer``)
    a ``build`` span (``n``) holding the phases' (``approx_graph``);
    observation only."""
    vectors = on_device(vectors, device)
    phases = BuildPhases(vectors.device, metrics, tracer)
    with phases("build", n=vectors.shape[0]):
        return approx_graph(vectors, params, phases, verbose, metrics)


def approx_graph(vectors: torch.Tensor, p: BuildParams, phases: BuildPhases,
                 verbose: bool = False, metrics=None) -> GraphIndex:
    """Algorithm 4 over ``vectors`` (on their device) in ``phases``:
    ``build.bootstrap`` (medoid and k-NN graph); per refinement ``it``,
    ``build.refine`` (``iter``) holding a ``build.search`` (the beam
    searches) and a ``build.select`` (the candidates' dedup, re-rank and
    selection) a block, then ``build.repair`` (``iter``: reverse edges and
    the connectivity repair); with degree alignment ``build.align`` and
    its ``build.repair`` (``iter`` "align")."""
    dev = vectors.device
    n = vectors.shape[0]
    M, L = p.max_degree, min(p.beam_width, n)

    with phases("build.bootstrap") as boot:
        med = find_medoid(vectors, seed=p.seed)
        # line 2: bootstrap from a top-M approximate NN graph
        _, knn_ids = brute_force_knn(vectors, vectors, min(M, n - 1),
                                     exclude_self=True)
        nbr = torch.full((n, M), -1, dtype=torch.int32, device=dev)
        nbr[:, :knn_ids.shape[1]] = knn_ids

    def make_graph(nbr, kind="delta_emg_approx"):
        return GraphIndex(vectors, nbr, med, kind=kind, delta=p.delta or 0.0)

    graph = make_graph(nbr)
    elapsed = boot["seconds"]
    _build_event(metrics, verbose, "bootstrap", nodes=n, elapsed_s=elapsed,
                 nodes_per_s=n / max(elapsed, 1e-9))

    cand_ids_all = torch.full((n, L + 1), -1, dtype=torch.int32, device=dev)
    cand_dists_all = torch.full((n, L + 1), float("inf"), device=dev)

    for it in range(p.iters):
        with phases("build.refine", iter=it) as refine:
            new_nbr = torch.full((n, M), -1, dtype=torch.int32, device=dev)
            new_deg = torch.zeros(n, dtype=torch.int32, device=dev)
            # candidate enrichment: beam-search candidates ∪ current
            # out-neighbors ∪ reverse neighbors (see the reference's comment)
            cur_nbr = graph.neighbors
            rev_nbr = _reverse_lists(cur_nbr, M)
            capped = torch.zeros((), dtype=torch.int64, device=dev)
            for s in range(0, n, p.block):
                e = min(s + p.block, n)
                ids_blk = torch.arange(s, e, dtype=torch.int32, device=dev)
                with phases("build.search"):
                    cand_ids, _, cut = _candidate_search(graph, vectors[s:e],
                                                         L, p.max_hops)
                    capped += cut
                with phases("build.select"):
                    merged = torch.cat([cand_ids, cur_nbr[s:e],
                                        rev_nbr[s:e]], dim=1)
                    merged = _dedup_rows(merged, ids_blk)
                    cand_ids, cand_dists = _prep_candidates(vectors, ids_blk,
                                                            merged, L)
                    kept, cnt = _select_block(vectors, cand_ids, cand_dists,
                                              t=min(p.t, L), rule=p.rule,
                                              max_keep=M, fixed_delta=p.delta)
                    new_nbr[s:e] = kept
                    new_deg[s:e] = cnt
                    if it == p.iters - 1:
                        cand_ids_all[s:e] = cand_ids
                        cand_dists_all[s:e] = cand_dists

        with phases("build.repair", iter=it) as repair:
            _add_reverse_edges(new_nbr, new_deg, M)
            n_fixed = _repair_connectivity(vectors, new_nbr, new_deg, M, med)
        graph = make_graph(new_nbr)
        elapsed = refine["seconds"] + repair["seconds"]
        _build_event(metrics, verbose, f"refine_iter{it}", nodes=n,
                     elapsed_s=elapsed, nodes_per_s=n / max(elapsed, 1e-9),
                     mean_deg=float((new_nbr >= 0).sum(1).float().mean()),
                     repaired=n_fixed, capped=int(capped))

    if p.align_degree:
        with phases("build.align") as align:
            nbr = graph.neighbors.clone()
            deg = (nbr >= 0).sum(1, dtype=torch.int32)
            short = int((deg < M).sum())
            _align_degrees(vectors, nbr, deg, cand_ids_all, cand_dists_all, p)
        with phases("build.repair", iter="align") as repair:
            _repair_connectivity(vectors, nbr, deg, M, med)
        graph = make_graph(nbr, kind="delta_emqg")
        elapsed = align["seconds"] + repair["seconds"]
        _build_event(metrics, verbose, "align_degree", nodes=n,
                     elapsed_s=elapsed, nodes_per_s=n / max(elapsed, 1e-9),
                     short=short)
    return graph
