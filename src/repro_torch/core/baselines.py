"""Baseline index builders the paper compares against (Sec. 7, Exp-1/2/9).

Counterpart of ``repro.core.baselines``, on the vectors' device.  All share
the ``GraphIndex`` container and the occlusion machinery of ``geometry.py``
— each is a different pruning rule (or insertion order) over the same
candidate-generation substrate:

* ``build_knn_graph``  — plain top-M kNN graph (GNNS/IEH substrate).
* ``build_nsg``        — MRNG lune rule (δ→0), greedy-search candidates,
                         reverse edges + connectivity repair.
* ``build_taumg``      — τ-MG shifted-lune rule.
* ``build_vamana``     — DiskANN robust-prune (α ≥ 1) rule.
* ``build_nsw``        — navigable small world by wave-batched incremental
                         insertion (flat; the medoid start replaces HNSW's
                         hierarchy).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .build_approx import BuildParams, _repair_connectivity, build_approx
from .distances import brute_force_knn, medoid as find_medoid, pairwise_sqdist
from .search import SearchParams, search
from .types import GraphIndex, resolve_device


def _on_device(vectors, device) -> torch.Tensor:
    dev = resolve_device(device)
    return torch.as_tensor(vectors, dtype=torch.float32).to(dev).contiguous()


def build_knn_graph(vectors, k: int = 32, device="cuda") -> GraphIndex:
    vectors = _on_device(vectors, device)
    _, ids = brute_force_knn(vectors, vectors, min(k, vectors.shape[0] - 1),
                             exclude_self=True)
    return GraphIndex(vectors=vectors, neighbors=ids,
                      medoid=find_medoid(vectors), kind="knn")


def build_nsg(vectors, max_degree: int = 32, beam_width: int = 64,
              iters: int = 2, device="cuda", **kw) -> GraphIndex:
    p = BuildParams(max_degree=max_degree, beam_width=beam_width, iters=iters,
                    delta=0.0, rule="mrng", **kw)
    g = build_approx(vectors, p, device=device)
    return dataclasses.replace(g, kind="nsg")


def build_taumg(vectors, tau: float = 0.05, max_degree: int = 32,
                beam_width: int = 64, iters: int = 2, device="cuda",
                **kw) -> GraphIndex:
    p = BuildParams(max_degree=max_degree, beam_width=beam_width, iters=iters,
                    delta=tau, rule="tau_mg", **kw)
    g = build_approx(vectors, p, device=device)
    return dataclasses.replace(g, kind="tau_mg", delta=tau)


def build_vamana(vectors, alpha: float = 1.2, max_degree: int = 32,
                 beam_width: int = 64, iters: int = 2, device="cuda",
                 **kw) -> GraphIndex:
    p = BuildParams(max_degree=max_degree, beam_width=beam_width, iters=iters,
                    delta=alpha, rule="vamana", **kw)
    g = build_approx(vectors, p, device=device)
    return dataclasses.replace(g, kind="vamana", delta=alpha)


def build_nsw(vectors, max_degree: int = 32, ef: int = 64, wave: int = 256,
              seed: int = 0, device="cuda") -> GraphIndex:
    """Flat NSW by wave-batched incremental insertion.

    Every point in a wave searches the graph built from all previous waves
    (one batched search on the device), then connects bidirectionally to its
    ef-best candidates (top max_degree).  The adjacency lives on the host
    between waves, as in the JAX package: the per-node linking is
    sequential.  The insertion order is ``np.random.default_rng(seed)``'s,
    the reference's.
    """
    vectors = _on_device(vectors, device)
    n = vectors.shape[0]
    M = max_degree
    order = np.random.default_rng(seed).permutation(n)

    nbr = np.full((n, M), -1, np.int32)
    deg = np.zeros(n, np.int32)

    # seed clique
    seed_ids = order[:min(M + 1, n)]
    sv = vectors[torch.as_tensor(seed_ids, device=vectors.device)]
    d2 = pairwise_sqdist(sv, sv).cpu().numpy()
    for i, u in enumerate(seed_ids):
        others = np.argsort(d2[i])
        picks = [int(seed_ids[j]) for j in others if seed_ids[j] != u][:M]
        nbr[u, :len(picks)] = picks
        deg[u] = len(picks)

    inserted = list(seed_ids)
    pos = len(seed_ids)
    while pos < n:
        wave_ids = order[pos:pos + wave]
        inserted_arr = np.asarray(inserted)
        # the subgraph of inserted nodes, in local ids
        remap = -np.ones(n, np.int64)
        remap[inserted_arr] = np.arange(len(inserted))
        sub_nbr = nbr[inserted_arr]
        sub_nbr = np.where(sub_nbr >= 0, remap[np.maximum(sub_nbr, 0)], -1)
        sub = GraphIndex(
            vectors[torch.as_tensor(inserted_arr, device=vectors.device)],
            torch.as_tensor(sub_nbr.astype(np.int32), device=vectors.device),
            0, kind="nsw")
        p = SearchParams(k=min(M, len(inserted)), l0=ef, l_max=ef,
                         adaptive=False, max_hops=4 * ef)
        res = search(sub, vectors[torch.as_tensor(wave_ids,
                                                  device=vectors.device)], p)
        ids_local = res.ids.cpu().numpy()
        for j, u in enumerate(wave_ids):
            cands = ids_local[j]
            cands = inserted_arr[cands[cands >= 0]][:M]
            nbr[u, :len(cands)] = cands
            deg[u] = len(cands)
            for v in cands:  # reverse link, never destructive: replacing a
                # full node's farthest link strips the early long-range edges
                # NSW navigation depends on
                if deg[v] < M:
                    nbr[v, deg[v]] = u
                    deg[v] += 1
        inserted.extend(int(u) for u in wave_ids)
        pos += len(wave_ids)

    med = find_medoid(vectors)
    nbr_t = torch.from_numpy(nbr).to(vectors.device)
    deg_t = torch.from_numpy(deg).to(vectors.device)
    _repair_connectivity(vectors, nbr_t, deg_t, M, med)
    return GraphIndex(vectors=vectors, neighbors=nbr_t, medoid=med,
                      kind="nsw")


BUILDERS = {
    "knn": build_knn_graph,
    "nsg": build_nsg,
    "tau_mg": build_taumg,
    "vamana": build_vamana,
    "nsw": build_nsw,
}
