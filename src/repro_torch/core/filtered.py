"""Filtered (predicate-constrained) error-bounded search.

Counterpart of ``repro.core.filtered``; see its module docstring for the
strategy: traverse the unfiltered graph (filtering edges would break
monotonicity) and keep the result set over passing nodes only, with the
candidate window widened by the filter's selectivity.  The filter is a
per-node bitmask.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .search import SearchParams, search
from .types import GraphIndex, SearchResult, stable_topk_smallest


def _filter_topk(ids: torch.Tensor, dists: torch.Tensor, mask: torch.Tensor,
                 k: int):
    """Keep the k closest candidates whose filter bit is set (the lower
    position wins a tie, as ``lax.top_k`` orders them)."""
    ok = (ids >= 0) & mask[ids.clamp_min(0).long()]
    d = torch.where(ok, dists, torch.full_like(dists, float("inf")))
    out_d, idx = stable_topk_smallest(d, k)
    out_ids = ids.gather(1, idx)
    return torch.where(torch.isfinite(out_d), out_ids,
                       torch.full_like(out_ids, -1)), out_d


def filtered_search(graph: GraphIndex, queries, filter_mask, k: int,
                    alpha: float = 1.2, l_max: int = 256,
                    selectivity: Optional[float] = None,
                    max_hops: int = 4096,
                    backend: str = "auto") -> SearchResult:
    """Error-bounded top-k among nodes with ``filter_mask[id] == True``.

    ``selectivity`` (fraction of passing nodes; estimated from the mask when
    omitted) sizes the traversal: the unfiltered search must see ~k/sel
    candidates for k filtered survivors.  ``backend`` selects the distance
    implementation, as in :func:`search`.
    """
    mask = torch.as_tensor(filter_mask, dtype=torch.bool).to(graph.device)
    sel = float(selectivity if selectivity is not None
                else max(float(mask.float().mean()), 1e-3))
    k_wide = int(min(l_max, max(k + 4, int(np.ceil(1.5 * k / sel)))))
    p = SearchParams(k=k_wide, l0=k_wide, l_max=max(l_max, k_wide),
                     alpha=alpha, adaptive=True, max_hops=max_hops)
    res, cand_ids, cand_dists = search(graph, queries, p,
                                       with_candidates=True, backend=backend)
    ids, dists = _filter_topk(cand_ids, cand_dists, mask, k)
    return SearchResult(ids=ids, dists=dists,
                        n_dist_comps=res.n_dist_comps,
                        n_approx_comps=res.n_approx_comps,
                        n_hops=res.n_hops, final_l=res.final_l,
                        saturated=res.saturated,
                        n_encounters=res.n_encounters)
