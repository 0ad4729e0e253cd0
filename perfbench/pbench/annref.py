"""Plain reference pieces the ANN configurations share: exact top-k by L2
distance or inner product, and the checks of a served list and of a built
index.  Plain PyTorch in float64 (or, for the control, float32 with TF32
matrix products); it imports nothing of the port and reads the port's
outputs only to judge them.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

BLOCK_ELEMS = 1 << 28         # query rows × base rows of one distance block


@contextlib.contextmanager
def exact_products():
    """TF32 off for every float32 product: the library's products are
    float32, and a control's TF32 is made explicit by ``tf32_round``."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa (to nearest), the
    rounding a tensor core applies to a product's inputs; a product of
    such inputs accumulated in float32 is a TF32 product, on any device."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def exact_topk(base: torch.Tensor, queries: torch.Tensor, k: int,
               metric: str = "l2", dtype=torch.float64, control=False):
    """Exact top-k of every query over ``base``: (ids int64 [Q, k], scores
    [Q, k] in ``dtype``), ascending L2 distance (``metric="l2"``) or
    descending inner product (``"ip"``), ties to the lower id.  Blocks of
    queries keep the score matrix under ``BLOCK_ELEMS``.  ``control``
    computes in float32 with TF32 products, the precision below the
    configuration's float32."""
    dtype = torch.float32 if control else dtype
    x = tf32_round(base) if control else base.to(dtype)
    x2 = (x * x).sum(1)
    step = max(1, BLOCK_ELEMS // max(base.shape[0], 1))
    out_i, out_s = [], []
    with exact_products():
        for lo in range(0, queries.shape[0], step):
            q = queries[lo:lo + step].to(x.device, dtype)
            if control:
                q = tf32_round(q)
            ip = q @ x.T
            if metric == "l2":
                score = ((q * q).sum(1, keepdim=True) + x2[None, :]
                         - 2.0 * ip).clamp_min(0.0)
                s, i = _topk_stable(score, k, largest=False)
                s = s.sqrt()
            else:
                s, i = _topk_stable(ip, k, largest=True)
            out_i.append(i)
            out_s.append(s)
    return torch.cat(out_i), torch.cat(out_s)


def _topk_stable(score: torch.Tensor, k: int, largest: bool):
    """top-k with ties to the lower index (a full stable sort of the
    ``4k`` best candidates)."""
    cand_s, cand_i = torch.topk(score, min(4 * k, score.shape[1]), dim=1,
                                largest=largest, sorted=False)
    key = -cand_s if largest else cand_s
    order = torch.argsort(cand_i, dim=1)
    key, cand_i = key.gather(1, order), cand_i.gather(1, order)
    rank = torch.argsort(key, dim=1, stable=True)[:, :k]
    i = cand_i.gather(1, rank)
    return score.gather(1, i), i


def l2_of(base: torch.Tensor, queries: torch.Tensor,
          ids: torch.Tensor) -> torch.Tensor:
    """float64 L2 distance of each query to each of its ids (ids < 0 →
    nan)."""
    x = base.to(torch.float64)
    q = queries.to(x.device, torch.float64)
    safe = ids.clamp_min(0).long()
    d = (x[safe] - q[:, None, :]).norm(dim=-1)
    return torch.where(ids >= 0, d, torch.full_like(d, float("nan")))


def ip_of(base: torch.Tensor, queries: torch.Tensor,
          ids: torch.Tensor) -> torch.Tensor:
    """float64 inner product of each query with each of its ids."""
    x = base.to(torch.float64)
    q = queries.to(x.device, torch.float64)
    return torch.einsum("bkd,bd->bk", x[ids.clamp_min(0).long()], q)


def bad_rows(ids: torch.Tensor, scores: torch.Tensor, n: int,
             ascending: bool = True) -> int:
    """Served rows that are not a valid answer: an id outside [0, n), an id
    twice, a score that is not finite, or scores out of order."""
    ids = ids.long()
    bad = ((ids < 0) | (ids >= n)).any(1) | ~torch.isfinite(scores).all(1)
    srt = ids.sort(1).values
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    step = scores[:, 1:] - scores[:, :-1]
    bad |= ((step < 0) if ascending else (step > 0)).any(1)
    return int(bad.sum())


def recall_hits(ids: torch.Tensor, exact_ids: torch.Tensor) -> int:
    """How many of the exact top-k ids each served row holds, summed."""
    return int((ids.long()[:, :, None] == exact_ids[:, None, :])
               .any(1).sum())


def graph_bad(neighbors: torch.Tensor, max_degree: int, n: int) -> int:
    """Nodes whose adjacency row is malformed: wider than M, an entry out
    of [-1, n), a self-loop, a neighbour twice, or no neighbour at all."""
    nb = neighbors.long()
    if nb.shape != (n, max_degree):
        return n
    own = torch.arange(n, device=nb.device)[:, None]
    bad = ((nb < -1) | (nb >= n) | (nb == own)).any(1)
    srt = nb.sort(1).values
    bad |= ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(1)
    bad |= (nb < 0).all(1)
    return int(bad.sum())


def code_bits_off(vectors: torch.Tensor, codes: torch.Tensor,
                  rotation: torch.Tensor, band: float = 1e-4) -> int:
    """RaBitQ sign bits that differ from the signs of the rotated, centred
    vectors worked out again in float64, counted where a coordinate lies
    more than ``band`` of its row's norm from zero (nearer, float32's
    rounding may set either bit).  The centre is the reference's own mean;
    the rotation is the index's, held orthogonal first: one that is not
    makes every bit count."""
    r64 = rotation.to(torch.float64)
    eye = torch.eye(r64.shape[0], dtype=torch.float64, device=r64.device)
    n, d = vectors.shape
    if (r64 @ r64.T - eye).abs().max() > 1e-5:
        return n * d
    x = vectors.to(torch.float64)
    r = (x - x.mean(0)) @ r64.T
    sure = r.abs() > band * r.norm(dim=1, keepdim=True)
    words = codes.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, device=words.device)
    bits = ((words[:, :, None] >> shifts) & 1).reshape(n, -1)[:, :d]
    return int(((bits == 1) != (r > 0))[sure].sum())


def degree_short(neighbors: torch.Tensor, max_degree: int) -> int:
    """Nodes with fewer than ``max_degree`` neighbours: the degree
    alignment (``align_degree``) fills every row."""
    return int(((neighbors >= 0).sum(1) < max_degree).sum())


def graph_search(vectors: torch.Tensor, neighbors: torch.Tensor, start: int,
                 queries: torch.Tensor, beam: int, max_hops: int
                 ) -> torch.Tensor:
    """Plain best-first beam search in float64 over a graph (rows of
    ``neighbors``, -1 padded) from ``start``: each hop expands every row's
    nearest unexpanded candidate and keeps the ``beam`` nearest seen,
    until none is left or ``max_hops``.  Returns ids int64 [Q, beam] by
    ascending L2 distance (-1 where fewer were seen)."""
    x = vectors.to(torch.float64)
    q = queries.to(x.device, torch.float64)
    nb = neighbors.to(x.device).long()
    Q, n = q.shape[0], x.shape[0]
    rows = torch.arange(Q, device=x.device)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=x.device)
    ids = torch.full((Q, beam), -1, dtype=torch.long, device=x.device)
    dist = torch.full((Q, beam), float("inf"), dtype=torch.float64,
                      device=x.device)
    done = torch.zeros((Q, beam), dtype=torch.bool, device=x.device)
    seen = torch.zeros((Q, n), dtype=torch.bool, device=x.device)
    ids[:, 0] = start
    dist[:, 0] = (q - x[start]).norm(dim=1)
    seen[:, start] = True
    for _ in range(max_hops):
        open_d = torch.where(done | (ids < 0), inf, dist)
        best_d, best = open_d.min(1)
        live = torch.isfinite(best_d)
        if not bool(live.any()):
            break
        done[rows, best] |= live
        cand = nb[ids[rows, best].clamp_min(0)]                  # [Q, M]
        safe = cand.clamp_min(0)
        new = (cand >= 0) & live[:, None] & ~seen.gather(1, safe)
        seen[rows[:, None].expand_as(cand)[new], cand[new]] = True
        d = torch.where(new, (x[safe] - q[:, None, :]).norm(dim=-1), inf)
        all_d = torch.cat([dist, d], 1)
        all_i = torch.cat([ids, torch.where(new, cand, -1)], 1)
        all_e = torch.cat([done, torch.zeros_like(new)], 1)
        keep = torch.argsort(all_d, dim=1, stable=True)[:, :beam]
        dist, ids, done = (all_d.gather(1, keep), all_i.gather(1, keep),
                           all_e.gather(1, keep))
    return torch.where(torch.isfinite(dist), ids, -1)


def sample_rows(total: int, size: int, seed: int, device) -> torch.Tensor:
    """``size`` distinct rows of ``total``, drawn from ``seed``."""
    rng = np.random.default_rng([int(seed), 7])
    pick = rng.choice(total, size=min(size, total), replace=False)
    return torch.from_numpy(np.sort(pick)).to(device)
