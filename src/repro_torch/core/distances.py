"""Distance primitives: blocked pairwise distances and exact brute force.

Counterpart of ``repro.core.distances``.  Precision: float32 throughout.
On the card a float32 matrix product runs in TF32 when
``torch.backends.cuda.matmul.allow_tf32`` is set.  That flag is the
process's, so these functions leave it alone; the port's entry points
(``launch.serve``, ``chip_smoke.py``) turn it off once, so the norm
identity keeps full float32 (about seven decimal digits), as the JAX
package computes it.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import stable_topk_smallest


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """f32[m, n] squared distances between rows of x (m, d) and y (n, d),
    by the norm identity ‖x‖² + ‖y‖² − 2⟨x, y⟩, clamped at 0."""
    x = x.float()
    y = y.float()
    x2 = (x * x).sum(-1)[:, None]
    y2 = (y * y).sum(-1)[None, :]
    xy = x @ y.T
    return torch.clamp_min(x2 + y2 - 2.0 * xy, 0.0)


def sqdist_one_to_many(q: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """f32[n] squared distances from one query (d,) to rows of ys (n, d),
    by the difference form."""
    diff = ys.float() - q.float()[None, :]
    return (diff * diff).sum(-1)


_FULL_SORT_COLS = 8192   # rows this wide are sorted whole
_TIE_MARGIN = 16


def _smallest_k(d2: torch.Tensor, k: int):
    """k smallest per row, ascending, lower column winning a tie (the order
    ``lax.top_k`` gives).

    A row of up to ``_FULL_SORT_COLS`` columns is sorted whole.  A wider row
    (the bootstrap at n = 1M) is first narrowed by ``torch.topk`` to
    ``k + _TIE_MARGIN`` columns, which are then ordered by (value, column);
    the result equals the full stable sort unless more than ``_TIE_MARGIN``
    columns tie with the k-th smallest value.
    """
    if d2.shape[1] <= _FULL_SORT_COLS:
        return stable_topk_smallest(d2, k)
    vals, cols = torch.topk(d2, min(k + _TIE_MARGIN, d2.shape[1]), dim=1,
                            largest=False, sorted=False)
    cols, by_col = torch.sort(cols, dim=1)
    v, o = stable_topk_smallest(torch.gather(vals, 1, by_col), k)
    return v, torch.gather(cols, 1, o)


def brute_force_knn(queries, base, k: int, block: int = 1024,
                    exclude_self: bool = False):
    """Exact top-k by blocked brute force on ``base``'s device.

    Returns (dists f32[m, k], ids int32[m, k]) as tensors on that device;
    distances are true (not squared) Euclidean.  ``exclude_self`` drops the
    self match of row ``s + i`` (construction: queries == base).
    """
    base = torch.as_tensor(base)
    queries = torch.as_tensor(queries).to(base.device)
    kk = min(k + 1 if exclude_self else k, base.shape[0])
    out_d, out_i = [], []
    for s in range(0, queries.shape[0], block):
        d2, idx = _smallest_k(pairwise_sqdist(queries[s:s + block], base), kk)
        if exclude_self:
            rows = torch.arange(s, s + d2.shape[0], device=d2.device)
            d2 = torch.where(idx == rows[:, None],
                             torch.full_like(d2, float("inf")), d2)
            d2, order = stable_topk_smallest(d2, k)
            idx = torch.gather(idx, 1, order)
        out_d.append(torch.sqrt(torch.clamp_min(d2, 0.0)))
        out_i.append(idx.to(torch.int32))
    return torch.cat(out_d), torch.cat(out_i)


def medoid(vectors, sample: int = 4096, seed: int = 0) -> int:
    """Approximate medoid: the dataset point nearest the (sampled) mean.

    The sample and the mean are drawn with numpy exactly as the JAX package
    does, so both packages pick the same point.
    """
    v = torch.as_tensor(vectors)
    rng = np.random.default_rng(seed)
    if v.shape[0] > sample:
        idx = rng.choice(v.shape[0], sample, replace=False)
        mean = v[torch.as_tensor(idx, device=v.device)].cpu().numpy().mean(0)
    else:
        mean = v.cpu().numpy().mean(axis=0)
    d2 = sqdist_one_to_many(torch.as_tensor(mean, device=v.device), v)
    return int(torch.argmin(d2))
